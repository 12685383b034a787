"""The hand-written CUDA kernels of ``repro_torch`` against their plain
PyTorch versions, on the card. Every test is marked ``cuda`` and skips
without a CUDA device. The file imports neither jax nor repro, so it runs
where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import fedavg_reduce as fr
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import quantize as qz
from repro_torch.kernels import swiglu as sw
from repro_torch.kernels.ref import (
    downcast_bf16_rows_ref,
    fedavg_reduce_ref,
    flash_attention_ref,
    quantize_rows_ref,
    quantize_stochastic_ref,
    swiglu_ref,
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


# flash attention: the reference sweep, serving lengths (not tile multiples),
# the serving shape and one long prefill; (B, Sq, Skv, Hq, Hkv, D)
FLASH_SHAPES = [
    (1, 128, 128, 2, 2, 64), (2, 256, 256, 4, 2, 64), (1, 128, 256, 8, 1, 32),
    (2, 128, 128, 4, 4, 128),
    (4, 1, 1, 32, 8, 128), (4, 7, 7, 32, 8, 128), (4, 16, 16, 32, 8, 128),
    (4, 100, 100, 32, 8, 128), (1, 4096, 4096, 32, 8, 128),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


def _attn_inputs(B, Sq, Skv, Hq, Hkv, D, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype)
            for shape in ((B * Hq, Sq, D), (B * Hkv, Skv, D), (B * Hkv, Skv, D))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(device, B, Sq, Skv, Hq, Hkv, D, dtype):
    q, k, v = _attn_inputs(B, Sq, Skv, Hq, Hkv, D, dtype, device)
    before = fa.launches
    got = fa.flash_attention_bhsd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=True)
    assert torch.max(torch.abs(got.float() - want.float())).item() < FLASH_TOL[dtype]


@pytest.mark.parametrize("window", [32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_window_matches_plain(device, window, causal):
    q, k, v = _attn_inputs(1, 256, 256, 2, 2, 32, torch.float32, device, seed=window)
    got = fa.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert torch.max(torch.abs(got - want)).item() < FLASH_TOL[torch.float32]


# the bf16 kernel's edges (wgmma + TMA): D of 32 and 64, lengths that are
# not multiples of the 64-row / 64-key tiles, Sq != Skv both ways, and
# G * Sq on both sides of 64, where the query heads of a kv head are packed
# into one tile; (B, Sq, Skv, Hq, Hkv, D)
FLASH_BF16_EDGES = [
    (2, 128, 128, 4, 2, 32), (1, 100, 100, 4, 2, 32), (2, 128, 128, 4, 2, 64),
    (1, 77, 77, 2, 2, 64), (1, 129, 129, 2, 1, 128), (1, 65, 200, 4, 2, 128),
    (1, 200, 65, 4, 2, 128), (1, 7, 300, 8, 2, 64), (1, 300, 7, 8, 2, 64),
    (1, 16, 16, 4, 1, 128), (1, 13, 13, 5, 1, 128), (2, 8, 8, 8, 1, 64),
    (2, 9, 9, 8, 1, 64), (1, 64, 64, 1, 1, 128), (1, 65, 65, 1, 1, 128),
]
# bf16 rounds each output once: one step is at most 2**-7 of the row's
# largest value, below 1e-2 of it
FLASH_BF16_ROW_TOL = 1e-2


def _row_rel_err(got, want):
    err = torch.abs(got.float() - want.float()).amax(-1)
    return (err / torch.abs(want.float()).amax(-1).clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", FLASH_BF16_EDGES)
def test_flash_attention_bf16_edges_match_plain(device, B, Sq, Skv, Hq, Hkv, D, causal):
    q, k, v = _attn_inputs(B, Sq, Skv, Hq, Hkv, D, torch.bfloat16, device, seed=Sq + Skv)
    before = fa.launches
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = flash_attention_ref(q, k, v, causal=causal)
    assert torch.max(torch.abs(got.float() - want.float())).item() < FLASH_TOL[torch.bfloat16]
    assert _row_rel_err(got, want) < FLASH_BF16_ROW_TOL


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("window", [32, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_window_matches_plain(device, window, causal, D):
    q, k, v = _attn_inputs(1, 256, 256, 4, 2, D, torch.bfloat16, device, seed=window + D)
    got = fa.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert torch.max(torch.abs(got.float() - want.float())).item() < FLASH_TOL[torch.bfloat16]
    assert _row_rel_err(got, want) < FLASH_BF16_ROW_TOL


def test_flash_attention_bf16_refuses_what_the_kernel_does_not_take(device):
    q, k, v = _attn_inputs(1, 16, 16, 2, 1, 64, torch.bfloat16, device)
    with pytest.raises(ValueError):  # no keys
        fa.flash_attention_bhsd(q, k[:, :0].contiguous(), v[:, :0].contiguous())

    def shifted(t):  # contiguous, but 2 bytes off a 16-byte boundary
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)

    for i in range(3):
        args = [q, k, v]
        args[i] = shifted(args[i]).copy_(args[i])
        assert args[i].is_contiguous() and args[i].data_ptr() % 16
        with pytest.raises(ValueError):
            fa.flash_attention_bhsd(*args)


def test_flash_attention_bshd_wrapper_on_the_card(device):
    g = torch.Generator(device=device).manual_seed(3)
    q = torch.randn(2, 16, 8, 64, generator=g, device=device)
    k = torch.randn(2, 16, 2, 64, generator=g, device=device)
    v = torch.randn(2, 16, 2, 64, generator=g, device=device)
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu())  # the plain version
    assert torch.max(torch.abs(got.cpu() - want)).item() < FLASH_TOL[torch.float32]


def test_flash_attention_refuses_bad_inputs(device):
    q, k, v = _attn_inputs(1, 16, 16, 2, 1, 64, torch.float32, device)
    with pytest.raises(TypeError):
        fa.flash_attention_bhsd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                v[..., :48].contiguous())  # D = 48 has no kernel
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q.transpose(1, 2), k, v)


# swiglu: the reference sweep (weights x 0.1), then Qwen3-8B's widths at the
# serving row counts (fan-in scaled weights); tolerance 1e-4 / 5e-2 on the
# sweep, relative to max |plain| at full width: 1e-5 in f32 (only the
# summation order differs), 2e-2 in bf16 (h and the output rounded to bf16)
SWIGLU_SHAPES = [(64, 32, 128), (128, 64, 256), (256, 128, 512),
                 (1, 4096, 12288), (4, 4096, 12288), (7, 4096, 12288), (64, 4096, 12288)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,d,F", SWIGLU_SHAPES)
def test_swiglu_kernel_matches_plain(device, M, d, F, dtype):
    g = torch.Generator(device=device).manual_seed(M + d)
    full = d == 4096
    x = torch.randn(M, d, generator=g, device=device).to(dtype)
    w = [(torch.randn(s, generator=g, device=device) * (s[0] ** -0.5 if full else 0.1)).to(dtype)
         for s in ((d, F), (d, F), (F, d))]
    before = sw.launches
    got = sw.swiglu_fused(x, *w)
    torch.cuda.synchronize()
    assert sw.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, d)
    want = swiglu_ref(x, *w).float()
    err = torch.max(torch.abs(got.float() - want)).item()
    if full:
        rel = 1e-5 if dtype == torch.float32 else 2e-2
        assert err <= rel * torch.max(torch.abs(want)).item()
    else:
        assert err < (1e-4 if dtype == torch.float32 else 5e-2)


# the bf16 kernel at full width over the row counts around its 8-row n-tiles
# and 64-row tiles, and the serve run's prefill rows (44, 56)
@pytest.mark.parametrize("M", [1, 8, 9, 44, 56, 65, 128])
def test_swiglu_bf16_rows_match_plain(device, M):
    d, F = 4096, 12288
    g = torch.Generator(device=device).manual_seed(M)
    x = torch.randn(M, d, generator=g, device=device).to(torch.bfloat16)
    w = [(torch.randn(s, generator=g, device=device) * s[0] ** -0.5).to(torch.bfloat16)
         for s in ((d, F), (d, F), (F, d))]
    want = swiglu_ref(x, *w).float()
    for _ in range(2):  # the second call finds the workspace zeroed again
        before = sw.launches
        got = sw.swiglu_fused(x, *w)
        torch.cuda.synchronize()
        assert sw.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == (M, d)
        err = torch.max(torch.abs(got.float() - want)).item()
        assert err <= 2e-2 * torch.max(torch.abs(want)).item()


def test_swiglu_bf16_workspace_serves_every_row_count(device):
    """One workspace per device and stream, grown to the largest M: a call
    with fewer rows after a larger one, and a larger one after it, both
    find their part of it zeroed."""
    d, F = 4096, 12288
    g = torch.Generator(device=device).manual_seed(3)
    w = [(torch.randn(s, generator=g, device=device) * s[0] ** -0.5).to(torch.bfloat16)
         for s in ((d, F), (d, F), (F, d))]
    for M in (64, 4, 64):
        x = torch.randn(M, d, generator=g, device=device).to(torch.bfloat16)
        got = sw.swiglu_fused(x, *w).float()
        want = swiglu_ref(x, *w).float()
        torch.cuda.synchronize()
        err = torch.max(torch.abs(got - want)).item()
        assert err <= 2e-2 * torch.max(torch.abs(want)).item()


def test_swiglu_bf16_refuses_what_the_kernel_does_not_take(device):
    x = torch.randn(4, 64, device=device).bfloat16()
    w = [torch.randn(64, 128, device=device).bfloat16(), torch.randn(64, 128, device=device).bfloat16(),
         torch.randn(128, 64, device=device).bfloat16()]
    with pytest.raises(ValueError):  # d not a multiple of 8
        sw.swiglu_fused(x[:, :60].contiguous(), w[0][:60].contiguous(), w[1][:60].contiguous(),
                        w[2][:, :60].contiguous())
    with pytest.raises(ValueError):  # F not a multiple of 8
        sw.swiglu_fused(x, w[0][:, :100].contiguous(), w[1][:, :100].contiguous(),
                        w[2][:100].contiguous())
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)[1:].view(x.shape).copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError):  # not 16-byte aligned
        sw.swiglu_fused(shifted, *w)
    # the f32 kernel takes the same widths (weights x 0.1, as the sweep above)
    xf = x.float()[:, :60].contiguous()
    wf = [w[0].float()[:60] * 0.1, w[1].float()[:60] * 0.1, w[2].float()[:, :60].contiguous() * 0.1]
    got = sw.swiglu_fused(xf, *wf)
    assert torch.max(torch.abs(got - swiglu_ref(xf, *wf))).item() < 1e-4


def test_swiglu_refuses_bad_inputs(device):
    x = torch.randn(4, 32, device=device)
    w = [torch.randn(32, 64, device=device), torch.randn(32, 64, device=device),
         torch.randn(64, 32, device=device)]
    with pytest.raises(TypeError):
        sw.swiglu_fused(x.bfloat16(), *w)  # mixed dtypes
    with pytest.raises(ValueError):
        sw.swiglu_fused(x, w[0].t().contiguous().t(), w[1], w[2])  # not contiguous
    with pytest.raises(ValueError):
        sw.swiglu_fused(x, w[0], w[1], w[2].cpu())
