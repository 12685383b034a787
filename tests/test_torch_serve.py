"""Port parity for the serving driver: ``repro_torch.launch.serve.Server.run``
against ``repro.launch.serve.Server.run`` on the reduced Qwen3 config on
the CPU, with the reference's params carried across. In f32 the generated
tokens are equal; in bf16 the port's own server keeps the properties that
``tests/test_system.py::test_server_generates_tokens`` asserts of the
reference."""

import jax
import numpy as np
import pytest
import torch

from repro.launch.serve import Request as RRequest
from repro.launch.serve import Server as RServer
from repro.models import Model as RModel
from repro_torch.convert import params_from_numpy
from repro_torch.launch import Request, Server
from repro_torch.models import Model
from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _f32_servers(batch, max_len):
    """The reference's and the port's server on the reduced config in f32,
    the port holding the reference's params."""
    ref = RServer("qwen3-8b", batch=batch, max_len=max_len)
    cfg = ref.cfg.replace(dtype="float32", param_dtype="float32")
    ref.cfg, ref.model = cfg, RModel(cfg)
    ref.params = jax.jit(ref.model.init)(jax.random.PRNGKey(0))
    ref._prefill = jax.jit(lambda p, b: ref.model.prefill(p, b, max_len))
    ref._decode = jax.jit(ref.model.decode_step)

    port = Server("qwen3-8b", batch=batch, max_len=max_len, device="cpu")
    port.cfg = port.cfg.replace(dtype="float32", param_dtype="float32")
    port.model = Model(port.cfg)
    port._decode = port.model.decode_step
    port.params = params_from_numpy(jax.tree.map(np.asarray, ref.params), "cpu")
    return ref, port


def _prompts(n, lo, hi, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize(
    "batch,max_len,n,lo,hi,max_new",
    [
        (4, 128, 8, 4, 16, 12),  # serve.py:main's requests (vocab cut to 512)
        (2, 12, 3, 3, 9, 6),  # the max_len - S - 1 cap, a half-empty last batch
    ],
    ids=["serve_main", "length_cap"],
)
def test_server_run_generates_the_reference_tokens_in_f32(batch, max_len, n, lo, hi, max_new):
    ref, port = _f32_servers(batch, max_len)
    prompts = _prompts(n, lo, hi, 512)
    want = ref.run([RRequest(i, p, max_new=max_new) for i, p in enumerate(prompts)])
    got = port.run([Request(i, p, max_new=max_new) for i, p in enumerate(prompts)])
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(r.done for r in got)
    if max_len == 12:  # S = 8 -> at most 12 - 8 - 1 = 3 tokens
        assert all(len(r.generated) == 3 for r in got)


def test_server_generates_tokens_in_bf16():
    """The properties of test_system.py::test_server_generates_tokens, on
    the port's own bf16 server (params drawn from a seeded generator)."""
    server = Server("qwen3-8b", batch=2, max_len=64, device="cpu")
    assert server.params["embed"].dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, 100, size=6).astype(np.int32), max_new=4) for i in range(4)]
    done = server.run(reqs)
    assert len(done) == 4
    assert all(len(r.generated) == 4 for r in done)
    assert all(0 <= t < server.cfg.padded_vocab for r in done for t in r.generated)


def test_server_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device is CUDA here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server("qwen3-8b")
