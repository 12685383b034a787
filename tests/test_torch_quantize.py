"""Port parity: the quantize family on the CPU. The same numpy inputs go
through the reference's jnp oracles (``repro/kernels/ref.py``) and Pallas
kernels in interpret mode, and through the port's plain versions and its
kernel wrappers (which run the plain version for CPU tensors). int8 codes
and bf16 bits must be equal, not close. The hand-written CUDA kernels are
held to the plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import quantize as p_q
from repro_torch.kernels import ref as p_ref
from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rows(R, N, seed=0, spread=2.5):
    return (np.random.default_rng(seed).standard_normal((R, N)) * spread).astype(np.float32)


def _scales(x):
    return (np.maximum(np.abs(x).max(axis=-1), np.float32(1e-12)) / np.float32(127.0)).astype(
        np.float32
    )


def _bits(a):
    """bf16 arrays of either package as their uint16 bit patterns."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("N", [1, 10, 100, 2048, 2049, 9999])
def test_quantize_rows_codes_equal_reference(N):
    x = _rows(3, N, seed=N)
    s = _scales(x)
    expect = np.asarray(r_ref.quantize_rows_ref(jnp.asarray(x), jnp.asarray(s)))
    xt, st = torch.from_numpy(x), torch.from_numpy(s)
    plain = p_ref.quantize_rows_ref(xt, st)
    wrapped = p_ops.quantize_rows(xt, st)
    assert plain.dtype == wrapped.dtype == torch.int8
    assert np.array_equal(plain.numpy(), expect)
    assert np.array_equal(wrapped.numpy(), expect)
    # round trip bounded by half a quantum per row
    deq = p_q.dequantize_rows(wrapped, st).numpy()
    assert np.max(np.abs(deq - x) / s[:, None]) <= 0.5 + 1e-6


@pytest.mark.parametrize("N", [100, 2049])
def test_quantize_rows_codes_equal_pallas_interpret(N):
    x = _rows(3, N, seed=7)
    s = _scales(x)
    pallas = np.asarray(r_ops.quantize_rows(jnp.asarray(x), jnp.asarray(s), interpret=True))
    got = p_ops.quantize_rows(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    assert np.array_equal(got, pallas)


def test_quantize_rows_half_boundaries_round_up():
    """Quotients exactly on .5 round up (floor(y + 0.5)), as the reference
    does; round-half-even would differ on every even one."""
    s = np.array([1.0, 0.5], np.float32)
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 126.5, 200.0, -300.0],
                  [0.25, 0.75, 1.25, -0.25, -0.75, 63.25, 0.0, -0.0]], np.float32)
    expect = np.asarray(r_ref.quantize_rows_ref(jnp.asarray(x), jnp.asarray(s)))
    got = p_ops.quantize_rows(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    assert np.array_equal(got, expect)
    assert got[0].tolist() == [1, 2, 3, 0, -1, 127, 127, -127]


def test_quantize_rows_zero_row():
    x = np.stack([np.zeros(300, np.float32), np.linspace(-1.0, 1.0, 300, dtype=np.float32)])
    s = _scales(x)
    q = p_ops.quantize_rows(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    assert not q[0].any() and q[1].any()
    assert np.array_equal(q, np.asarray(r_ref.quantize_rows_ref(jnp.asarray(x), jnp.asarray(s))))


@pytest.mark.parametrize("N", [128, 2050])
def test_downcast_bf16_bits_equal_reference(N):
    x = _rows(2, N, seed=1, spread=1.0)
    # values halfway between two bf16 numbers exercise round-to-nearest-even
    x[0, :4] = np.array([1.00390625, 1.01171875, -1.00390625, 3.0e-39], np.float32)
    expect = r_ref.downcast_bf16_rows_ref(jnp.asarray(x))
    pallas = r_ops.downcast_bf16_rows(jnp.asarray(x), interpret=True)
    plain = p_ref.downcast_bf16_rows_ref(torch.from_numpy(x))
    wrapped = p_ops.downcast_bf16_rows(torch.from_numpy(x))
    assert wrapped.dtype == torch.bfloat16
    for got in (plain, wrapped):
        assert np.array_equal(_bits(got), _bits(expect))
        assert np.array_equal(_bits(got), _bits(pallas))


@pytest.mark.parametrize("N", [100, 4096, 9999])
def test_quantize_stochastic_equal_reference_with_shared_bits(N):
    rng = np.random.default_rng(N)
    x = (rng.standard_normal(N) * 3.0).astype(np.float32)
    u = rng.random(N, dtype=np.float32)
    scale = np.float32(np.maximum(np.abs(x).max(), 1e-12) / np.float32(127.0))
    expect = np.asarray(r_ref.quantize_stochastic_ref(jnp.asarray(x), jnp.asarray(u), scale))
    pallas = np.asarray(
        r_ops.quantize_stochastic_flat(jnp.asarray(x), jnp.asarray(u), scale, interpret=True)
    )
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    for got in (p_ref.quantize_stochastic_ref(xt, ut, float(scale)),
                p_q.quantize_stochastic_flat(xt, ut, torch.tensor(scale))):
        assert got.dtype == torch.int8
        assert np.array_equal(got.numpy(), expect)
        assert np.array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("n", [100, 4096, 9999])
def test_quantize_tree_round_trip(n):
    """The port of ``tests/test_kernels.py::test_quantize_sweep``: error
    bounded by one quantum, codes equal to the plain version given the
    same uniform bits, and the scale equal to the reference's."""
    x = (np.random.default_rng(n).standard_normal(n) * 3.0).astype(np.float32)
    tree = {"a": torch.from_numpy(x), "b": torch.from_numpy(x[: n // 3] * 0.5)}
    payload = p_ops.quantize_tree(tree, torch.Generator().manual_seed(1))
    deq = p_ops.dequantize_tree(payload, tree)
    for k in tree:
        assert deq[k].shape == tree[k].shape
        assert float(torch.max(torch.abs(deq[k] - tree[k]))) <= float(payload["scale"]) * 1.01
    vec = torch.cat([tree["a"], tree["b"]])
    uniform = torch.rand(vec.shape, generator=torch.Generator().manual_seed(1))
    assert torch.equal(payload["q"], p_ref.quantize_stochastic_ref(vec, uniform, payload["scale"]))
    r_payload = r_ops.quantize_tree(
        {k: jnp.asarray(v.numpy()) for k, v in tree.items()}, jax.random.PRNGKey(1), interpret=True
    )
    assert np.float32(payload["scale"]) == np.float32(r_payload["scale"])


def test_quantize_stochastic_unbiased():
    x = {"x": torch.full((20000,), 0.3)}
    accum = torch.zeros(20000)
    for s in range(5):
        payload = p_ops.quantize_tree(x, torch.Generator().manual_seed(s))
        accum += p_ops.dequantize_tree(payload, x)["x"]
    assert abs(float(torch.mean(accum / 5)) - 0.3) < 2e-3


@pytest.mark.parametrize("R", [1, 10])
def test_grouped_quantize_rows_codes_equal_reference_per_leaf(R):
    """All leaves of a tree (the CNN's 8 leaf sizes and ragged ones) in one
    grouped call: each leaf's codes equal the reference's per-leaf codes,
    jnp oracle and Pallas interpret, bitwise."""
    sizes = [16, 144, 32, 4608, 128, 10, 1280, 1, 3, 2049, 12345]
    xs = [_rows(R, n, seed=i) for i, n in enumerate(sizes)]
    ss = [_scales(x) for x in xs]
    got = p_ops.quantize_rows_leaves([torch.from_numpy(x) for x in xs],
                                     [torch.from_numpy(s) for s in ss])
    assert len(got) == len(sizes)
    for x, s, q in zip(xs, ss, got):
        oracle = np.asarray(r_ref.quantize_rows_ref(jnp.asarray(x), jnp.asarray(s)))
        pallas = np.asarray(r_ops.quantize_rows(jnp.asarray(x), jnp.asarray(s), interpret=True))
        assert q.dtype == torch.int8 and q.shape == x.shape
        assert np.array_equal(q.numpy(), oracle) and np.array_equal(q.numpy(), pallas)


def test_cpu_calls_do_not_count_as_launches():
    before = dict(p_q.launches)
    x = torch.ones(2, 8)
    p_q.quantize_rows_flat(x, torch.ones(2))
    p_q.quantize_rows_leaves([x, torch.ones(3, 5)], [torch.ones(2), torch.ones(3)])
    p_q.downcast_bf16_rows_flat(x)
    p_q.quantize_stochastic_flat(x[0], torch.zeros(8), 1.0)
    assert p_q.launches == before


@pytest.mark.parametrize("call", [
    lambda x: p_q.quantize_rows_flat(x, torch.empty(2, device="meta")),
    lambda x: p_q.downcast_bf16_rows_flat(x),
    lambda x: p_q.quantize_stochastic_flat(x[0], torch.empty(8, device="meta"), 1.0),
], ids=["rows", "bf16", "stochastic"])
def test_wrappers_refuse_devices_without_a_kernel(call):
    with pytest.raises(ValueError, match="unsupported device"):
        call(torch.empty(2, 8, device="meta"))


def test_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError):
        p_q.quantize_rows_flat(torch.ones(2, 8), torch.ones(3))
    with pytest.raises(ValueError):
        p_q.quantize_rows_leaves([torch.ones(2, 8)], [torch.ones(2), torch.ones(2)])
    with pytest.raises(ValueError):
        p_q.downcast_bf16_rows_flat(torch.ones(8))
    with pytest.raises(ValueError):
        p_q.quantize_stochastic_flat(torch.ones(8), torch.ones(7), 1.0)
