"""The hand-written CUDA kernels of ``repro_torch`` against their plain
PyTorch versions, on the card. Every test is marked ``cuda`` and skips
without a CUDA device. The file imports neither jax nor repro, so it runs
where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.compress import get_compressor
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
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    # other files (test_torch_cuda_history.py) run with PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


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


# ---------------------------------------------------------------------------
# one launch over a table of leaves
# ---------------------------------------------------------------------------

CNN_LEAVES = [16, 144, 32, 4608, 128, 200704, 10, 1280]
RAGGED_LEAVES = [1, 3, 10, 2049, 12345, 200704]


def _unaligned(C, N, device, seed=0):
    """[C, N] f32, contiguous, 4-byte but not 16-byte aligned (an offset
    view of a larger buffer)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(C * N + 1, generator=g, device=device) * 2.5)[1:].view(C, N)
    assert x.data_ptr() % 16 == 4
    return x


def _grouped_fedavg_matches(xs, w, launches):
    before = fr.launches
    out = fr.fedavg_reduce_leaves(xs, w)
    torch.cuda.synchronize()
    assert fr.launches == before + launches
    assert out.dtype == torch.float32 and out.shape == (sum(x.shape[1] for x in xs),)
    off = 0
    for x in xs:
        n = x.shape[1]
        got = out[off:off + n]
        if n:
            assert torch.max(torch.abs(got - fedavg_reduce_ref(x, w))).item() <= TOL[x.dtype]
        # the same leaf alone through a one-leaf table: bitwise equal
        assert torch.equal(got, fr.fedavg_reduce_flat(x, w))
        off += n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes", [CNN_LEAVES, RAGGED_LEAVES], ids=["cnn", "ragged"])
def test_fedavg_reduce_leaves_matches_plain(device, sizes, dtype):
    xs = [_xw(10, n, dtype, device, seed=i)[0] for i, n in enumerate(sizes)]
    _grouped_fedavg_matches(xs, _xw(10, 1, torch.float32, device, seed=99)[1], 1)


def test_fedavg_reduce_leaves_unaligned_zero_size_and_mixed_dtypes(device):
    """A 4-byte-aligned leaf takes the scalar loads; zero-size leaves take
    no blocks; f32 and bf16 leaves go in one launch per dtype."""
    w = _xw(7, 1, torch.float32, device, seed=5)[1]
    xs = [_unaligned(7, 4096, device), _xw(7, 0, torch.float32, device)[0],
          _xw(7, 2048, torch.bfloat16, device, seed=1)[0], _unaligned(7, 12345, device, seed=2),
          _xw(7, 0, torch.bfloat16, device)[0], _xw(7, 999, torch.bfloat16, device, seed=3)[0],
          _xw(7, 64, torch.float32, device, seed=4)[0]]
    _grouped_fedavg_matches(xs, w, 2)
    before = fr.launches
    assert fr.fedavg_reduce_leaves([_xw(7, 0, torch.float32, device)[0]], w).shape == (0,)
    assert fr.launches == before


def test_fedavg_reduce_leaves_splits_a_long_table(device):
    n_leaves = fr.MAX_LEAVES * 2 + 3
    xs = [_xw(4, 1 + 37 * i, torch.float32, device, seed=i)[0] for i in range(n_leaves)]
    _grouped_fedavg_matches(xs, _xw(4, 1, torch.float32, device, seed=7)[1], 3)


def test_ops_fedavg_reduce_is_one_launch_per_tree(device):
    tree = {"a": {"w": _xw(10, 4608, torch.float32, device)[0].view(10, 3, 3, 16, 32),
                  "b": _xw(10, 32, torch.float32, device, seed=1)[0]},
            "c": _xw(10, 10, torch.float32, device, seed=2)[0]}
    w = torch.rand(10, device=device) + 0.1
    before = fr.launches
    out = ops.fedavg_reduce(tree, w)
    torch.cuda.synchronize()
    assert fr.launches == before + 1
    wn = w / w.sum()
    for got, x in ((out["a"]["w"], tree["a"]["w"]), (out["a"]["b"], tree["a"]["b"]),
                   (out["c"], tree["c"])):
        assert got.shape == x.shape[1:]
        want = fedavg_reduce_ref(x.reshape(10, -1), wn).reshape(x.shape[1:])
        assert torch.max(torch.abs(got - want)).item() <= 1e-5


def _grouped_codes_equal(xs, launches):
    scales = [_scales(x) if x.numel() else torch.ones(x.shape[0], device=x.device) for x in xs]
    before = qz.launches["quantize_rows"]
    got = qz.quantize_rows_leaves(xs, scales)
    torch.cuda.synchronize()
    assert qz.launches["quantize_rows"] == before + launches
    for x, s, q in zip(xs, scales, got):
        assert q.dtype == torch.int8 and q.shape == x.shape
        assert torch.equal(q, quantize_rows_ref(x, s))
        assert torch.equal(q, qz.quantize_rows_flat(x, s))  # alone == among others


@pytest.mark.parametrize("sizes", [CNN_LEAVES, RAGGED_LEAVES], ids=["cnn", "ragged"])
def test_quantize_rows_leaves_codes_equal_plain(device, sizes):
    _grouped_codes_equal([_rows(10, n, device, seed=i) for i, n in enumerate(sizes)], 1)


def test_quantize_rows_leaves_unaligned_zero_size_and_long_table(device):
    xs = [_unaligned(3, 4096, device), _rows(3, 0, device), _rows(3, 2048, device, seed=1),
          _unaligned(5, 1000, device, seed=2), _rows(1, 17, device, seed=3)]
    _grouped_codes_equal(xs, 1)
    xs = [_rows(2, 1 + 53 * i, device, seed=i) for i in range(qz.MAX_LEAVES + 5)]
    _grouped_codes_equal(xs, 2)


def _grouped_bits_equal(xs, launches):
    before = qz.launches["downcast_bf16_rows"]
    got = qz.downcast_bf16_rows_leaves(xs)
    torch.cuda.synchronize()
    assert qz.launches["downcast_bf16_rows"] == before + launches
    for x, b in zip(xs, got):
        assert b.dtype == torch.bfloat16 and b.shape == x.shape
        assert torch.equal(b.view(torch.int16), downcast_bf16_rows_ref(x).view(torch.int16))
        alone = qz.downcast_bf16_rows_flat(x)  # alone == among others
        assert torch.equal(b.view(torch.int16), alone.view(torch.int16))


@pytest.mark.parametrize("sizes", [CNN_LEAVES, RAGGED_LEAVES], ids=["cnn", "ragged"])
def test_downcast_bf16_rows_leaves_bits_equal_plain(device, sizes):
    _grouped_bits_equal([_rows(10, n, device, seed=i) for i, n in enumerate(sizes)], 1)


def test_downcast_bf16_rows_leaves_unaligned_zero_size_and_long_table(device):
    xs = [_unaligned(3, 4096, device), _rows(3, 0, device), _rows(3, 2048, device, seed=1),
          _unaligned(5, 1000, device, seed=2), _rows(1, 17, device, seed=3),
          _unaligned(10, 10, device, seed=4)]
    _grouped_bits_equal(xs, 1)
    xs = [_rows(2, 1 + 53 * i, device, seed=i) for i in range(qz.MAX_LEAVES + 1)]
    _grouped_bits_equal(xs, 2)
    before = qz.launches["downcast_bf16_rows"]
    assert qz.downcast_bf16_rows_leaves([_rows(4, 0, device)])[0].shape == (4, 0)
    assert qz.launches["downcast_bf16_rows"] == before


def test_bf16_compressor_is_one_launch_per_call(device):
    tree = {"a": {"w": _rows(1, 4608, device).view(3, 3, 16, 32), "b": _rows(1, 32, device)[0]},
            "c": _rows(1, 10, device, seed=2)[0]}
    comp = get_compressor("bf16")
    before = qz.launches["downcast_bf16_rows"]
    payload, res = comp.compress(tree, None)
    torch.cuda.synchronize()
    assert qz.launches["downcast_bf16_rows"] == before + 1
    for path in (("a", "w"), ("a", "b"), ("c",)):
        x, p, r = tree, payload, res
        for k in path:
            x, p, r = x[k], p[k], r[k]
        want = downcast_bf16_rows_ref(x.reshape(1, -1)).reshape(x.shape)
        assert torch.equal(p["bf16"].view(torch.int16), want.view(torch.int16))
        assert torch.equal(r, x - want.float())


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("N", [1, 3, 4, 5, 4111, 206922])
def test_quantize_stochastic_kernel_ragged_and_unaligned(device, N, offset):
    g = torch.Generator(device=device).manual_seed(N)
    x = (torch.randn(N + 1, generator=g, device=device) * 3.0)[int(offset):][:N]
    u = torch.rand(N + 1, generator=g, device=device)[int(offset):][:N]
    assert (x.data_ptr() % 16 == 0) != offset
    scale = torch.clamp(x.abs().max(), min=1e-12) / torch.tensor(127.0, device=device)
    before = qz.launches["quantize_stochastic"]
    got = qz.quantize_stochastic_flat(x, u, scale)
    torch.cuda.synchronize()
    assert qz.launches["quantize_stochastic"] == before + 1
    assert got.dtype == torch.int8 and got.shape == (N,)
    assert torch.equal(got, quantize_stochastic_ref(x, u, scale))


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


# every (D, Dv) the kernels take (csrc/flash_attention.cu's FLASH_PAIRS)
FLASH_HEAD_PAIRS = [(16, 16), (24, 16), (32, 32), (64, 32), (64, 64), (96, 32), (96, 64),
                    (96, 96), (112, 112), (128, 32), (128, 64), (128, 96), (128, 128), (192, 32),
                    (192, 64), (192, 96), (192, 128)]
# MLA's prefill (D 192, Dv 128; 128 heads, no GQA): serving, past one tile,
# packed; Phi-3-vision's (D = Dv = 96, 32 heads): 256 patches + 16 tokens;
# Zamba2's shared attention (D = Dv = 112, 32 heads): serving, past one
# tile, packed; (B, Sq, Skv, Hq, Hkv, D, Dv)
FLASH_DV_SHAPES = [(4, 16, 16, 128, 128, 192, 128), (1, 300, 300, 8, 8, 192, 128),
                   (1, 13, 13, 4, 1, 192, 128), (1, 65, 200, 4, 2, 192, 128),
                   (4, 272, 272, 32, 32, 96, 96), (1, 100, 100, 4, 2, 96, 96),
                   (2, 9, 9, 8, 1, 96, 96), (4, 16, 16, 32, 32, 112, 112),
                   (1, 300, 300, 4, 4, 112, 112), (2, 9, 9, 8, 1, 112, 112)]


def _attn_inputs_dv(B, Sq, Skv, Hq, Hkv, D, Dv, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=device).to(dtype)
            for shape in ((B * Hq, Sq, D), (B * Hkv, Skv, D), (B * Hkv, Skv, Dv))]


def _check_flash(q, k, v, dtype, **kw):
    before = fa.launches
    got = fa.flash_attention_bhsd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == (q.shape[0], q.shape[1], v.shape[2])
    want = flash_attention_ref(q, k, v, **kw)
    assert torch.max(torch.abs(got.float() - want.float())).item() < FLASH_TOL[dtype]
    if dtype == torch.bfloat16:
        assert _row_rel_err(got, want) < FLASH_BF16_ROW_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Dv", FLASH_HEAD_PAIRS)
def test_flash_attention_every_head_dim_pair_matches_plain(device, D, Dv, dtype):
    q, k, v = _attn_inputs_dv(1, 70, 70, 4, 2, D, Dv, dtype, device, seed=D + Dv)
    _check_flash(q, k, v, dtype, causal=True)
    _check_flash(q, k, v, dtype, causal=False, window=32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,Dv", FLASH_DV_SHAPES)
def test_flash_attention_mla_and_vision_shapes_match_plain(device, B, Sq, Skv, Hq, Hkv, D, Dv,
                                                          dtype):
    q, k, v = _attn_inputs_dv(B, Sq, Skv, Hq, Hkv, D, Dv, dtype, device, seed=Sq)
    _check_flash(q, k, v, dtype, causal=True)


# Whisper-base's flash shapes, all without a mask (8 heads of 64): the
# encoder over 1,536 frames, the cross attention of a 16-token prompt and of
# one decode token over them; (B, Sq, Skv, Hq, Hkv, D)
WHISPER_SHAPES = [(4, 1536, 1536, 8, 8, 64), (4, 16, 1536, 8, 8, 64), (4, 1, 1536, 8, 8, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", WHISPER_SHAPES,
                         ids=["encoder", "cross_prefill", "cross_decode"])
def test_flash_attention_whisper_shapes_match_plain(device, B, Sq, Skv, Hq, Hkv, D, dtype):
    q, k, v = _attn_inputs(B, Sq, Skv, Hq, Hkv, D, dtype, device, seed=Sq + 1)
    _check_flash(q, k, v, dtype, causal=False)


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
    q, k, v = _attn_inputs_dv(1, 16, 16, 2, 1, 96, 128, torch.bfloat16, device)
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, k, v)  # Dv > D
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, k, v[..., :48].contiguous())  # Dv = 48 has no kernel
    q, k, v = _attn_inputs_dv(1, 16, 16, 2, 1, 112, 96, torch.bfloat16, device)
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, k, v)  # (112, 96) is no pair of the kernels


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


# ---------------------------------------------------------------------------
# the grid engine on the card: row independence and grid == per-point
# ---------------------------------------------------------------------------


def _cnn_rows(device, n_clients=10, examples=200, steps=4):
    import numpy as np

    from repro_torch.core import EdgeClient, mnist_cnn_task
    from repro_torch.data import make_federated_mnist

    task = mnist_cnn_task(device=device)
    shards = make_federated_mnist(n_clients, examples, seed=0)
    clients = [EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    plans = task.plan_fit(clients, steps, np.random.default_rng(3))
    return task, list(zip(clients, plans))


@pytest.mark.parametrize("mu", [0.0, 0.01])
@pytest.mark.parametrize("width", [1, 3, 12, 24, 64])
def test_plane_rows_width_and_position_independent_on_the_card(device, width, mu):
    """A row's delta and metrics are the same bits at every dispatch width
    and position (cuBLAS batched GEMMs and the per-row reductions of the
    clip and prox term see one chunk shape whatever the width)."""
    from repro_torch.utils import tree_leaves

    task, rows = _cnn_rows(device)
    anchors = [task.init_fn(torch.Generator().manual_seed(s)) for s in (0, 1)]
    target = rows[3]
    want, _, want_m = task.fit_rows(anchors, [target], 4, [mu], mu > 0, anchor_idx=[1])
    for pos in sorted({0, width // 2, width - 1}):
        rs = [rows[(k * 7) % len(rows)] for k in range(width)]
        aidx = [k % 2 for k in range(width)]
        rs[pos], aidx[pos] = target, 1
        plane, _, mets = task.fit_rows(anchors, rs, 4, [mu] * width, mu > 0, anchor_idx=aidx)
        for a, b in zip(tree_leaves(plane), tree_leaves(want)):
            assert torch.equal(a[pos], b[0]), (width, pos)
        assert mets[pos] == want_m[0]


@pytest.mark.parametrize("compressor", [None, "int8", "bf16", "topk:0.05"])
def test_grid_matches_per_point_on_the_card(device, compressor):
    """A small latency grid (coalescing, a dead point, both TCP stacks):
    every History field and the final params equal per-point batched runs
    on the card, bitwise."""
    from repro_torch.chaos import ChaosSchedule
    from repro_torch.compress import get_compressor
    from repro_torch.core import (
        EdgeClient, FederatedServer, GridPoint, ServerConfig, fedavg, run_fl_grid,
    )
    from repro_torch.data import make_federated_mnist, synthetic_mnist
    from repro_torch.transport import DEFAULT, LAB, TUNED_EDGE
    from repro_torch.utils import tree_leaves

    task, _ = _cnn_rows(device, 6, 64, 2)
    shards = make_federated_mnist(6, 64, seed=0)
    eval_data = synthetic_mnist(300, seed=77)
    comp = None
    if compressor is not None:
        name, _, arg = compressor.partition(":")
        comp = get_compressor(name, **({"ratio": float(arg)} if arg else {}))
    specs = [(DEFAULT, 0.0), (TUNED_EDGE, 0.3), (DEFAULT, 8.0), (TUNED_EDGE, 8.0)]

    def point(tcp, delay):
        return GridPoint(
            [EdgeClient(i, dataset=s) for i, s in enumerate(shards)], fedavg(min_fit=0.5), tcp,
            ChaosSchedule(LAB.replace(delay=delay)),
            ServerConfig(rounds=3, local_steps=2, seed=0, batched=True), compressor=comp,
        )

    res = run_fl_grid(task, [point(*s) for s in specs], eval_data=eval_data)
    assert res.stats.fit_rows_unique < res.stats.fit_rows_total
    for spec, grid_srv in zip(specs, res.servers):
        p = point(*spec)
        srv = FederatedServer(task, p.clients, p.strategy, tcp=p.tcp, chaos=p.chaos,
                              config=p.config, compressor=comp, eval_data=eval_data)
        srv.run()
        assert grid_srv.history.rounds == srv.history.rounds
        assert grid_srv.history.eval_metrics == srv.history.eval_metrics
        assert (grid_srv.history.status, grid_srv.history.cause) == (
            srv.history.status, srv.history.cause)
        for a, b in zip(tree_leaves(grid_srv.global_params), tree_leaves(srv.global_params)):
            assert torch.equal(a, b)


def _fl_server(device, *, n_clients=4, compressor=None, slow=(), strategy="fedavg", **cfg):
    from repro_torch.chaos import ChaosSchedule
    from repro_torch.core import STRATEGIES, EdgeClient, FederatedServer, ServerConfig
    from repro_torch.data import make_federated_mnist, synthetic_mnist
    from repro_torch.transport import DEFAULT, LAB

    task, _ = _cnn_rows(device, n_clients, 64, 2)
    clients = [EdgeClient(i, dataset=s)
               for i, s in enumerate(make_federated_mnist(n_clients, 64, seed=0))]
    for i in slow:
        clients[i].compute_rate = 0.2
    kw = dict(rounds=4, local_steps=2, seed=0, batched=True)
    kw.update(cfg)
    return FederatedServer(
        task, clients, STRATEGIES[strategy](min_fit=0.5), tcp=DEFAULT,
        chaos=ChaosSchedule(LAB.replace(loss=0.05)), config=ServerConfig(**kw),
        compressor=None if compressor is None else get_compressor(compressor),
        eval_data=synthetic_mnist(150, seed=7),
    )


def _same_run(a, b):
    from repro_torch.utils import tree_leaves

    assert a.history.rounds == b.history.rounds
    assert a.history.eval_metrics == b.history.eval_metrics
    assert a.sim_time == b.sim_time and a.model_version == b.model_version
    for x, y in zip(tree_leaves(a.global_params), tree_leaves(b.global_params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", [
    dict(),
    dict(compressor="int8", state_plane="sparse"),
    dict(compressor="bf16"),
    dict(async_mode=True, async_buffer_k=2, slow=(0, 1)),
])
def test_kill_and_resume_bitwise_on_the_card(device, tmp_path, case):
    """A point killed after round 2 and resumed from its checkpoint equals
    the uninterrupted run on the card, bitwise (the residual plane and the
    async queue and buffer come back onto the card)."""
    ref = _fl_server(device, **case)
    ref.run()
    d = str(tmp_path / "ckpt")
    _fl_server(device, **case).run(checkpoint_dir=d, stop_after_round=2)
    res = _fl_server(device, **case)
    res.run(checkpoint_dir=d)
    _same_run(ref, res)
    from repro_torch.utils import tree_leaves

    assert all(leaf.device.type == "cuda" for leaf in tree_leaves(res.checkpoint_arrays()))


@pytest.mark.parametrize("batched", [True, False])
def test_fedadam_kill_and_resume_on_the_card(device, tmp_path, batched):
    """A fedadam point killed after round 2 and resumed equals the
    uninterrupted run on the card, bitwise, server state included: the
    state comes back onto the card, and the resumed half launches
    fedavg_reduce once per completed round (batched)."""
    from repro_torch.utils import tree_leaves

    ref = _fl_server(device, strategy="fedadam", batched=batched)
    ref.run()
    d = str(tmp_path / "ckpt")
    _fl_server(device, strategy="fedadam", batched=batched).run(
        checkpoint_dir=d, stop_after_round=2)
    res = _fl_server(device, strategy="fedadam", batched=batched)
    before = fr.launches
    res.run(checkpoint_dir=d)
    resumed = sum(0 if r.failed_round else 1 for r in res.history.rounds[2:])
    assert fr.launches - before == (resumed if batched else 0) and resumed > 0
    _same_run(ref, res)
    state = tree_leaves(res.strategy.server_state)
    assert len(state) == 2 * len(tree_leaves(res.global_params))
    for x, y in zip(tree_leaves(ref.strategy.server_state), state):
        assert y.device.type == "cuda" and torch.equal(x, y)


@pytest.mark.parametrize("batched", [False, True])
def test_degenerate_async_equals_sync_on_the_card(device, batched):
    """One client, a clean link, a buffer of one: async == sync bitwise
    (params, clock, eval trace), on the sequential engine (cuDNN convs, held
    to deterministic algorithms by the task's guard) and the batched one,
    whose flushes launch fedavg_reduce once each."""
    from repro_torch.utils import tree_leaves

    sync = _fl_server(device, n_clients=1, rounds=3, batched=batched)
    sync.run()
    asy = _fl_server(device, n_clients=1, rounds=3, batched=batched, async_mode=True,
                     async_buffer_k=1)
    before = fr.launches
    asy.run()
    assert asy.model_version == 3
    assert fr.launches - before == (3 if batched else 0)  # one launch per flush
    # async records also carry their flush size, so the History's metrics differ
    assert sync.sim_time == asy.sim_time
    assert sync.history.eval_metrics == asy.history.eval_metrics
    assert [r.t_end for r in sync.history.rounds] == [r.t_end for r in asy.history.rounds]
    for x, y in zip(tree_leaves(sync.global_params), tree_leaves(asy.global_params)):
        assert torch.equal(x, y)


def test_sequential_engine_is_reproducible_on_the_card(device):
    """Two identical sequential runs give the same bits (before the task's
    guard held cuDNN to deterministic algorithms they differed by ~6e-8)."""
    a, b = _fl_server(device, batched=False), _fl_server(device, batched=False)
    a.run()
    b.run()
    _same_run(a, b)


# --------------------------------------------------------------------------
# the device transport plane on the card
# --------------------------------------------------------------------------


def _plane_grid(device, *, loss=0.0, jitter=0.0, retry=None, rnd=0, C=12):
    """One grid round through the device plane: a clean or lossy ladder of
    four scenarios (the last one dead at 8 s one-way delay when clean)."""
    import numpy as np

    from repro_torch.transport import BIG_BUFFER, DEFAULT, LAB, TUNED_EDGE
    from repro_torch.transport.plane import sim_grid_round_device, transport_plane_key

    base = LAB.replace(loss=loss, jitter=jitter)
    links = [[base] * C, [base.replace(delay=0.3)] * C, [base.replace(rate_mbps=1.0)] * C,
             [base.replace(delay=8.0 if loss == 0.0 else 0.05)] * C]
    return sim_grid_round_device(
        [DEFAULT, BIG_BUFFER, TUNED_EDGE, DEFAULT], links,
        update_bytes=np.full(4, 300_000, np.int64), download_bytes=np.full(4, 300_000, np.int64),
        local_train_times=np.full((4, C), 30.0), connected=np.zeros((4, C), bool),
        key=transport_plane_key(0, 2, rnd), trace=True, retry=retry, device=device)


def _outcomes(out):
    fields = {f: getattr(out, f).cpu() for f in ("success", "time", "reconnects", "bytes_acked")}
    fields.update({f: v.cpu() for f, v in out.trace.items()})
    fields["scenario_bytes"] = out.scenario_bytes.cpu()
    return fields


@pytest.mark.parametrize("retry", [None, "resume"])
def test_degenerate_plane_on_the_card_equals_the_cpu(device, retry):
    """No draw decides a clean grid: the card's plane gives the CPU's bits,
    every field, with and without a resuming retry ladder."""
    from repro_torch.transport import RetryPolicy

    rp = None if retry is None else RetryPolicy(max_retries=2, resume=True)
    got, want = _outcomes(_plane_grid(device, retry=rp)), _outcomes(_plane_grid("cpu", retry=rp))
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_plane_on_the_card_is_deterministic_and_keyed(device):
    a = _outcomes(_plane_grid(device, loss=0.2, jitter=0.01, rnd=3))
    b = _outcomes(_plane_grid(device, loss=0.2, jitter=0.01, rnd=3))
    c = _outcomes(_plane_grid(device, loss=0.2, jitter=0.01, rnd=4))
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert not (torch.equal(a["success"], c["success"]) and torch.equal(a["time"], c["time"]))


def test_transfer_graph_blocks_equal_the_loop_on_the_card(device):
    """The CUDA graph blocks of the transfer loop give the bits of the loop
    run one iteration at a time on the card, on a lossy jittered plane."""
    import numpy as np

    from repro_torch.transport import DEFAULT, LAB
    from repro_torch.transport import plane as P
    from repro_torch.transport.des import _LinkArrays, _TcpArrays

    k = 300
    rng = np.random.default_rng(0)
    la = _LinkArrays.from_links([LAB.replace(loss=float(x), jitter=0.01)
                                 for x in rng.choice([0.0, 0.1, 0.3, 0.5], k)])
    tp = P.TcpPlane.from_arrays(_TcpArrays.broadcast(DEFAULT, k), device)
    lp = P.LinkPlane.from_arrays(la, device)
    nbytes = torch.full((k,), 300_000.0, device=device)
    need = torch.ones(k, dtype=torch.bool, device=device)
    outs, stats = [], []
    for run in (P._transfer_iters, P._transfer_blocks):
        orig = P._transfer_blocks
        P._transfer_blocks = run  # the same call path, one loop or the other
        try:
            st = P.new_plane_stats()
            outs.append(P._plane_transfer(tp, lp, nbytes, P._stage_generator(7, 0, 1, device),
                                          need, st))
            stats.append(st)
        finally:
            P._transfer_blocks = orig
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    assert stats[1]["syncs"] < stats[0]["syncs"]
    assert 0 <= stats[1]["transfer_iters"] - stats[0]["transfer_iters"] < P._BLOCK


def test_device_backend_kill_and_resume_on_the_card(device, tmp_path):
    """A device-backend point killed after round 2 and resumed equals the
    uninterrupted run on the card, bitwise (the plane runs on the card)."""
    case = dict(stochastic=True, transport_backend="device")
    ref = _fl_server(device, **case)
    ref.run()
    d = str(tmp_path / "ckpt")
    _fl_server(device, **case).run(checkpoint_dir=d, stop_after_round=2)
    res = _fl_server(device, **case)
    res.run(checkpoint_dir=d)
    _same_run(ref, res)
    assert ref.history.completed_rounds == 4


# --------------------------------------------------------------------------
# the kernels under autograd: FlashAttention / SwiGLU against autograd
# through their plain versions, forward and every input gradient, relative
# to the largest |value|; bf16 rounds P (flash) or h (swiglu) once more
# than the plain version does, and the backward's products run in bf16
# --------------------------------------------------------------------------

GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _grad_gaps(fn, plain, inputs, seed):
    """Largest |kernel - plain| / max |plain| over the output and each
    input's gradient, for one random cotangent."""
    g = torch.Generator(device=inputs[0].device).manual_seed(seed)
    xs = [t.detach().requires_grad_(True) for t in inputs]
    ys = [t.detach().requires_grad_(True) for t in inputs]
    out, ref = fn(*xs), plain(*ys)
    cot = torch.randn(ref.shape, generator=g, device=ref.device).to(ref.dtype)
    got = torch.autograd.grad(out, xs, cot)
    want = torch.autograd.grad(ref, ys, cot)
    return [(a.float() - b.float()).abs().max().item() / b.float().abs().max().item()
            for a, b in zip((out.detach(), *got), (ref.detach(), *want))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,window", [(2, 256, 32, 8, 128, 0), (1, 100, 4, 2, 64, 0),
                                                 (1, 256, 4, 2, 128, 64)])
def test_flash_attention_grad_matches_plain_autograd(device, B, S, Hq, Hkv, D, window, dtype):
    q, k, v = _attn_inputs(B, S, S, Hq, Hkv, D, dtype, device, seed=S)
    launches, backs = fa.launches, fa.backward_calls
    gaps = _grad_gaps(lambda *t: fa.flash_attention_grad(*t, causal=True, window=window),
                      lambda *t: flash_attention_ref(*t, causal=True, window=window), [q, k, v], 1)
    torch.cuda.synchronize()
    assert (fa.launches, fa.backward_calls) == (launches + 1, backs + 1)
    assert max(gaps) < GRAD_RTOL[dtype], gaps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv", [(2, 64, 16, 16, 192, 128), (1, 100, 8, 2, 192, 128),
                                             (2, 272, 8, 8, 96, 96)])
def test_flash_attention_grad_head_dims_match_plain_autograd(device, B, S, Hq, Hkv, D, Dv, dtype):
    """MLA's (D 192, Dv 128) and Phi-3-vision's (D 96) heads through the
    custom op: dq and dk in D, dv in Dv."""
    q, k, v = _attn_inputs_dv(B, S, S, Hq, Hkv, D, Dv, dtype, device, seed=S)
    launches, backs = fa.launches, fa.backward_calls
    gaps = _grad_gaps(lambda *t: fa.flash_attention_grad(*t, causal=True),
                      lambda *t: flash_attention_ref(*t, causal=True), [q, k, v], 1)
    torch.cuda.synchronize()
    assert (fa.launches, fa.backward_calls) == (launches + 1, backs + 1)
    assert max(gaps) < GRAD_RTOL[dtype], gaps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv", [(2, 256, 1536), (2, 1536, 1536)],
                         ids=["cross", "encoder"])
def test_flash_attention_grad_without_a_mask_matches_plain_autograd(device, B, Sq, Skv, dtype):
    """Whisper under training: the cross attention's dk / dv at 1,536 keys
    from 256 queries, and the encoder's, through the custom op."""
    q, k, v = _attn_inputs(B, Sq, Skv, 8, 8, 64, dtype, device, seed=Sq)
    launches, backs = fa.launches, fa.backward_calls
    gaps = _grad_gaps(lambda *t: fa.flash_attention_grad(*t, causal=False),
                      lambda *t: flash_attention_ref(*t, causal=False), [q, k, v], 1)
    torch.cuda.synchronize()
    assert (fa.launches, fa.backward_calls) == (launches + 1, backs + 1)
    assert max(gaps) < GRAD_RTOL[dtype], gaps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,d,F", [(64, 128, 256), (512, 4096, 12288)])
def test_swiglu_grad_matches_plain_autograd(device, M, d, F, dtype):
    g = torch.Generator(device=device).manual_seed(M)
    x = torch.randn(M, d, generator=g, device=device).to(dtype)
    w = [(torch.randn(s, generator=g, device=device) * s[0] ** -0.5).to(dtype)
         for s in ((d, F), (d, F), (F, d))]
    launches, backs = sw.launches, sw.backward_calls
    gaps = _grad_gaps(sw.swiglu_grad, swiglu_ref, [x, *w], 2)
    torch.cuda.synchronize()
    assert (sw.launches, sw.backward_calls) == (launches + 1, backs + 1)
    assert max(gaps) < GRAD_RTOL[dtype], gaps


def test_reduced_lm_train_steps_on_the_card(device):
    """Four train steps of reduced Qwen3 in bf16 on the card through both
    kernels: finite losses, flash_attention launched per layer in the
    forward and again in the checkpointed recompute, swiglu once per layer
    (``remat="block"`` keeps its output), one backward per layer. (That
    the loss falls is held on the CPU by
    ``test_torch_trainer.py::test_trainer_loss_decreases_and_resumes`` and on
    the card by ``chip_smoke.py``'s ``lm_train_starcoder2`` phase, at full
    width through flash_attention.)"""
    from repro_torch.configs import TrainConfig, get_reduced
    from repro_torch.data.tokens import token_batch_for
    from repro_torch.launch.steps import build_train_step, make_optimizer
    from repro_torch.models import Model

    cfg = get_reduced("qwen3-8b")
    tcfg = TrainConfig(optimizer="adafactor", learning_rate=1e-2, total_steps=4, warmup_steps=1)
    params = Model(cfg).init(torch.Generator(device=device).manual_seed(0))
    state = {"params": params, "opt": make_optimizer(tcfg).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = build_train_step(cfg, tcfg)
    counts = (fa.launches, sw.launches, fa.backward_calls, sw.backward_calls)
    losses = []
    for i in range(4):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in token_batch_for(cfg, batch=2, seq=64, seed=i).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    L = cfg.n_layers
    assert (fa.launches - counts[0], sw.launches - counts[1]) == (4 * 2 * L, 4 * L)
    assert (fa.backward_calls - counts[2], sw.backward_calls - counts[3]) == (4 * L, 4 * L)
    assert all(torch.isfinite(torch.tensor(losses)))


def test_reduced_whisper_on_the_card_matches_the_cpu(device):
    """Reduced Whisper in f32, with 2 heads of 32 (its 4 heads of 16 are
    not a head width the kernel is built for): a prefill and two decode
    steps on the card (flash 3 a layer a prefill, 1 a layer a step: the
    encoder, the decoder's self and cross attention) against the same
    params on the CPU (the plain versions), within 1e-4 of max |logit|."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import Model
    from repro_torch.utils import tree_map

    cfg = get_reduced("whisper-base").replace(dtype="float32", param_dtype="float32", n_heads=2,
                                              n_kv_heads=2)
    model = Model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    g = torch.Generator(device=device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 9), generator=g, device=device,
                                     dtype=torch.int32),
             "frames": torch.randn(2, cfg.enc_seq_len, cfg.d_model, generator=g, device=device)}
    results = {}
    for where, ps, b in (("cuda", params, batch),
                         ("cpu", tree_map(lambda t: t.cpu(), params),
                          {k: v.cpu() for k, v in batch.items()})):
        before = fa.launches
        logits, cache = model.prefill(ps, {**b, "tokens": b["tokens"][:, :7]}, 16)
        out = [logits]
        for j in (7, 8):
            logits, cache = model.decode_step(ps, cache, b["tokens"][:, j:j + 1])
            out.append(logits)
        results[where] = (torch.stack(out).cpu(), fa.launches - before)
    L = cfg.n_layers
    assert results["cuda"][1] == 3 * L + 2 * L and results["cpu"][1] == 0
    got, want = results["cuda"][0], results["cpu"][0]
    assert torch.max(torch.abs(got - want)).item() <= 1e-4 * torch.max(torch.abs(want)).item()


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "starcoder2-3b", "phi-3-vision-4.2b",
                                  "whisper-base", "deepseek-v2-236b"])
def test_reduced_small_head_configs_on_the_card_match_the_cpu(device, arch):
    """The reduced configs whose heads the flash kernel took only from
    (D, Dv) = (16, 16) and (24, 16) on (heads of 16; reduced DeepSeek-V2's
    MLA prefill at 16 + 8 = 24, v 16), in f32: a prefill and two decode
    steps and one loss and gradient on the card (the kernel, launched)
    against the same weights on the CPU (the plain versions), logits within
    1e-4 of max |logit|, loss and gradient norm within 1e-4."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.tokens import token_batch_for
    from repro_torch.models import Model
    from repro_torch.utils import tree_leaves, tree_map

    cfg = get_reduced(arch).replace(dtype="float32", param_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = token_batch_for(cfg, batch=2, seq=18, seed=3)
    results = {}
    for where in ("cuda", "cpu"):
        ps = tree_map(lambda t: t.to(where), params)
        b = {k: torch.as_tensor(v, device=where) for k, v in batch.items()}
        prompt = {k: v for k, v in b.items() if k not in ("targets", "loss_mask")}
        S = b["tokens"].shape[1] - 2  # the vision stub's patches take 4 of the 18 positions
        before = (fa.launches, fa.backward_calls)
        with torch.no_grad():
            logits, cache = model.prefill(ps, dict(prompt, tokens=b["tokens"][:, :S]), 24)
            out = [logits]
            for j in (S, S + 1):
                logits, cache = model.decode_step(ps, cache, b["tokens"][:, j:j + 1])
                out.append(logits)
        ps = tree_map(lambda p: p.detach().requires_grad_(True), ps)
        loss, _ = model.loss(ps, b)
        grads = torch.autograd.grad(loss, tree_leaves(ps))
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        results[where] = (torch.stack(out).cpu(), float(loss.detach()), float(gnorm),
                          fa.launches - before[0], fa.backward_calls - before[1])
    got, want = results["cuda"], results["cpu"]
    assert got[3] > 0 and got[4] > 0 and want[3] == 0
    assert torch.max(torch.abs(got[0] - want[0])).item() <= 1e-4 * torch.max(torch.abs(want[0])).item()
    assert abs(got[1] - want[1]) <= 1e-4 * abs(want[1])
    assert abs(got[2] - want[2]) <= 1e-4 * abs(want[2])


# --------------------------------------------------------------------------
# the two LM kernels on DTensors: ``ops.flash_attention`` / ``ops.swiglu``
# run each rank's shard through the kernel under ``local_map`` (a 1 x 1
# nccl mesh here), against autograd through their plain versions
# --------------------------------------------------------------------------


@pytest.fixture
def card_mesh(device):
    from repro_torch.launch.mesh import MeshShape, make_device_mesh

    return make_device_mesh(MeshShape(("data", "model"), (1, 1)), device="cuda")


def _sharded(fn, specs, mesh):
    """``fn`` on DTensors laid out by ``specs`` over a mesh of one rank
    (whose local part is the whole tensor), differentiable in the inputs,
    returning the whole output."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.rules import placements_on

    assert mesh.size() == 1

    def run(*ts):
        return fn(*[DTensor.from_local(t, mesh, placements_on(s, mesh))
                    for t, s in zip(ts, specs)]).full_tensor()

    return run


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_under_local_map_matches_plain_autograd(card_mesh, dtype):
    B, S, Hq, Hkv, D = 2, 256, 8, 2, 128
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = [torch.randn(s, generator=g, device="cuda").to(dtype)
               for s in ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    spec = ("data", None, "model", None)
    launches, backs = fa.launches, fa.backward_calls
    gaps = _grad_gaps(_sharded(lambda *t: ops.flash_attention(*t, causal=True), [spec] * 3,
                               card_mesh), _plain_bshd, [q, k, v], 4)
    torch.cuda.synchronize()
    assert (fa.launches, fa.backward_calls) == (launches + 1, backs + 1)
    assert max(gaps) < GRAD_RTOL[dtype], gaps


def _plain_bshd(q, k, v):
    """``flash_attention_ref`` on [B, S, H, D] tensors (head-major flattening)."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    flat = lambda t, H: t.transpose(1, 2).reshape(B * H, S, t.shape[-1])  # noqa: E731
    out = flash_attention_ref(flat(q, Hq), flat(k, Hkv), flat(v, Hkv), causal=True)
    return out.reshape(B, Hq, S, -1).transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_under_local_map_matches_plain_autograd(card_mesh, dtype):
    B, S, d, F = 2, 64, 512, 1536
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(B, S, d, generator=g, device="cuda").to(dtype)
    w = [(torch.randn(s, generator=g, device="cuda") * s[0] ** -0.5).to(dtype)
         for s in ((d, F), (d, F), (F, d))]
    specs = [("data", "model", None), ("data", "model"), ("data", "model"), ("model", "data")]
    launches, backs = sw.launches, sw.backward_calls
    gaps = _grad_gaps(_sharded(ops.swiglu, specs, card_mesh),
                      lambda x, *w: swiglu_ref(x.reshape(-1, d), *w).reshape(B, S, d), [x, *w], 6)
    torch.cuda.synchronize()
    assert (sw.launches, sw.backward_calls) == (launches + 1, backs + 1)
    assert max(gaps) < GRAD_RTOL[dtype], gaps
