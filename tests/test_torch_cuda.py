"""The hand-written CUDA kernels of ``repro_torch`` against their plain
PyTorch versions, on the card. Every test is marked ``cuda`` and skips
without a CUDA device. The file imports neither jax nor repro, so it runs
where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import fedavg_reduce as fr
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qz
from repro_torch.kernels.ref import (
    downcast_bf16_rows_ref,
    fedavg_reduce_ref,
    quantize_rows_ref,
    quantize_stochastic_ref,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _xw(C, N, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(C, N, generator=g, device=device).to(dtype)
    w = torch.rand(C, generator=g, device=device) + 0.05
    return x, w / w.sum()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "C,N",
    [(3, 1000), (10, 4096), (7, 12345), (3, 1), (3, 100), (3, 2048), (3, 2049),
     (10, 144), (10, 4608), (10, 200704), (10, 1280)],
)
def test_fedavg_reduce_kernel_matches_plain(device, C, N, dtype):
    x, w = _xw(C, N, dtype, device)
    before = fr.launches
    got = fr.fedavg_reduce_flat(x, w)
    torch.cuda.synchronize()
    assert fr.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (N,)
    assert torch.max(torch.abs(got - fedavg_reduce_ref(x, w))).item() <= TOL[dtype]


def test_fedavg_reduce_identity_and_weight_scale(device):
    x, _ = _xw(1, 3000, torch.float32, device)
    out = ops.fedavg_reduce({"x": x}, torch.tensor([17.0], device=device))["x"]
    assert torch.allclose(out, x[0], atol=1e-6)
    x, _ = _xw(4, 512, torch.float32, device)
    w = torch.tensor([1.0, 2.0, 3.0, 4.0], device=device)
    a = ops.fedavg_reduce({"x": x}, w)["x"]
    b = ops.fedavg_reduce({"x": x}, w * 100)["x"]
    assert torch.allclose(a, b, atol=1e-6)


def test_fedavg_reduce_refuses_bad_inputs(device):
    x, w = _xw(4, 64, torch.float32, device)
    with pytest.raises(ValueError):
        fr.fedavg_reduce_flat(x.t(), w)  # not contiguous / wrong shape
    with pytest.raises(TypeError):
        fr.fedavg_reduce_flat(x.half(), w)
    with pytest.raises(ValueError):
        fr.fedavg_reduce_flat(x, w[:3])


# the main path's CNN leaf sizes (conv1.b .. fc2.w) and the reference sweeps
QUANT_N = [1, 10, 16, 32, 100, 128, 144, 1280, 2048, 2049, 2050, 4096, 4608, 9999, 200704]


def _rows(R, N, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(R, N, generator=g, device=device) * 2.5


def _scales(x):
    return torch.clamp(x.abs().amax(dim=-1), min=1e-12) / torch.tensor(127.0, device=x.device)


@pytest.mark.parametrize("R", [1, 3, 10])
@pytest.mark.parametrize("N", QUANT_N)
def test_quantize_rows_kernel_codes_equal_plain(device, R, N):
    x = _rows(R, N, device, seed=N)
    x[0, : min(N, 4)] = 0.0  # exact zeros and, below, exact .5 quotients
    s = _scales(x)
    if N >= 8:
        x[-1, 4:8] = torch.tensor([0.5, 1.5, -0.5, -2.5], device=device) * s[-1]
    before = qz.launches["quantize_rows"]
    got = qz.quantize_rows_flat(x, s)
    torch.cuda.synchronize()
    assert qz.launches["quantize_rows"] == before + 1
    assert got.dtype == torch.int8 and got.shape == (R, N)
    assert torch.equal(got, quantize_rows_ref(x, s))


def test_quantize_rows_kernel_zero_row(device):
    x = torch.stack([torch.zeros(300, device=device), torch.linspace(-1, 1, 300, device=device)])
    s = _scales(x)
    q = qz.quantize_rows_flat(x, s)
    assert not q[0].any() and q[1].any()
    assert torch.equal(q, quantize_rows_ref(x, s))


@pytest.mark.parametrize("R", [1, 2, 10])
@pytest.mark.parametrize("N", QUANT_N)
def test_downcast_bf16_kernel_bits_equal_plain(device, R, N):
    x = _rows(R, N, device, seed=N + 1)
    before = qz.launches["downcast_bf16_rows"]
    got = qz.downcast_bf16_rows_flat(x)
    torch.cuda.synchronize()
    assert qz.launches["downcast_bf16_rows"] == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), downcast_bf16_rows_ref(x).view(torch.int16))


@pytest.mark.parametrize("N", [1, 100, 4096, 9999, 206922])
def test_quantize_stochastic_kernel_codes_equal_plain(device, N):
    g = torch.Generator(device=device).manual_seed(N)
    x = torch.randn(N, generator=g, device=device) * 3.0
    u = torch.rand(N, generator=g, device=device)
    scale = torch.clamp(x.abs().max(), min=1e-12) / torch.tensor(127.0, device=device)
    before = qz.launches["quantize_stochastic"]
    got = qz.quantize_stochastic_flat(x, u, scale)
    torch.cuda.synchronize()
    assert qz.launches["quantize_stochastic"] == before + 1
    assert torch.equal(got, quantize_stochastic_ref(x, u, scale))


def test_quantize_tree_on_the_card(device):
    tree = {"a": torch.randn(4099, device=device), "b": torch.randn(3, 7, device=device)}
    payload = ops.quantize_tree(tree, torch.Generator(device=device).manual_seed(0))
    deq = ops.dequantize_tree(payload, tree)
    for k in tree:
        assert float(torch.max(torch.abs(deq[k] - tree[k]))) <= float(payload["scale"]) * 1.01


def test_quantize_wrappers_refuse_bad_inputs(device):
    x = torch.randn(4, 64, device=device)
    with pytest.raises(ValueError):
        qz.quantize_rows_flat(x.t(), torch.ones(64, device=device))  # not contiguous
    with pytest.raises(TypeError):
        qz.quantize_rows_flat(x.half(), torch.ones(4, device=device))
    with pytest.raises(ValueError):
        qz.quantize_rows_flat(x, torch.ones(4))  # scales on another device
    with pytest.raises(TypeError):
        qz.downcast_bf16_rows_flat(x.double())
