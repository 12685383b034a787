"""Port parity for the LM kernels on the CPU: the plain versions
``flash_attention_ref`` / ``swiglu_ref`` and the port's ``ops.flash_attention``
/ ``ops.swiglu`` (which run the plain versions for CPU tensors) against the
reference's jnp oracles and its Pallas kernels in interpret mode, on the
same numpy inputs. Shapes and tolerances are the reference's
(``tests/test_kernels.py``): f32 2e-5 for attention and 1e-4 for SwiGLU,
bf16 5e-2. The hand-written CUDA kernels are held to the plain versions on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.kernels import flash_attention as p_fa
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels import swiglu as p_sw

FLASH_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
SWIGLU_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
SWEEP = [
    (1, 128, 128, 2, 2, 64),   # MHA
    (2, 256, 256, 4, 2, 64),   # GQA 2:1
    (1, 128, 256, 8, 1, 32),   # MQA, uneven seq
    (2, 128, 128, 4, 4, 128),  # wide head
]


def _pair(x_np, dtype):
    """The same values as a jax and a torch array (bf16 rounding is
    round-to-nearest-even in both)."""
    return jnp.asarray(x_np, getattr(jnp, dtype)), torch.from_numpy(x_np).to(getattr(torch, dtype))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _err(a, b) -> float:
    return float(np.max(np.abs(_f32(a) - _f32(b))))


def _qkv(B, Sq, Skv, Hq, Hkv, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))
    return [_pair(rng.standard_normal(s).astype(np.float32), dtype) for s in shapes]


def _bhsd(t):
    """[B, S, H, D] -> [B*H, S, D], the kernels' layout, in either package."""
    B, S, H, D = t.shape
    if isinstance(t, torch.Tensor):
        return t.transpose(1, 2).reshape(B * H, S, D)
    return t.transpose(0, 2, 1, 3).reshape(B * H, S, D)


@functools.partial(jax.jit, static_argnames=("window",))
def _oracle(q, k, v, window=0):
    """The reference's jnp oracle on BSHD inputs (causal), back in BSHD."""
    B, Sq, Hq, D = q.shape
    out = r_ref.flash_attention_ref(_bhsd(q), _bhsd(k), _bhsd(v), causal=True, window=window)
    return out.reshape(B, Hq, Sq, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", SWEEP)
def test_flash_attention_sweep_matches_reference_oracle(B, Sq, Skv, Hq, Hkv, D, dtype):
    (rq, pq), (rk, pk), (rv, pv) = _qkv(B, Sq, Skv, Hq, Hkv, D, dtype)
    got = p_ops.flash_attention(pq, pk, pv, causal=True)
    oracle = _oracle(rq, rk, rv)
    plain = p_ref.flash_attention_ref(_bhsd(pq), _bhsd(pk), _bhsd(pv), causal=True)
    plain = plain.reshape(B, Hq, Sq, D).transpose(1, 2)
    assert got.dtype == pq.dtype and got.shape == (B, Sq, Hq, D)
    assert _err(got, oracle) < FLASH_TOL[dtype]
    assert _err(plain, oracle) < FLASH_TOL[dtype]


# interpret mode is slow on the CPU: one MHA, one MQA/uneven case per dtype
@pytest.mark.parametrize(
    "B,Sq,Skv,Hq,Hkv,D,dtype",
    [(1, 128, 128, 2, 2, 64, "float32"), (1, 128, 128, 2, 2, 64, "bfloat16"),
     (1, 128, 256, 8, 1, 32, "float32")],
)
def test_flash_attention_matches_pallas_interpret(B, Sq, Skv, Hq, Hkv, D, dtype):
    (rq, pq), (rk, pk), (rv, pv) = _qkv(B, Sq, Skv, Hq, Hkv, D, dtype, seed=1)
    got = p_ops.flash_attention(pq, pk, pv, causal=True)
    pallas = r_ops.flash_attention(rq, rk, rv, causal=True, interpret=True)
    assert _err(got, pallas) < FLASH_TOL[dtype]


@pytest.mark.parametrize("window", [32, 64])
def test_flash_attention_sliding_window(window):
    B, S, H, D = 1, 256, 2, 32
    (rq, pq), (rk, pk), (rv, pv) = _qkv(B, S, S, H, H, D, "float32", seed=2)
    got = p_ops.flash_attention(pq, pk, pv, causal=True, window=window)
    oracle = _oracle(rq, rk, rv, window=window)
    assert _err(got, oracle) < FLASH_TOL["float32"]
    if window == 64:  # one window through the Pallas kernel itself
        pallas = r_ops.flash_attention(rq, rk, rv, causal=True, window=window,
                                       block_q=64, block_kv=64, interpret=True)
        assert _err(got, pallas) < FLASH_TOL["float32"]


@pytest.mark.parametrize("S,dtype", [(1, "float32"), (7, "float32"), (16, "bfloat16"),
                                     (100, "float32")])
def test_flash_attention_any_length_matches_oracle(S, dtype):
    """Lengths that are not a tile multiple (the serving prompts are 8-16
    tokens); serving's GQA grouping, 4:1, at a small head count."""
    B, Hq, Hkv, D = 2, 8, 2, 32
    (rq, pq), (rk, pk), (rv, pv) = _qkv(B, S, S, Hq, Hkv, D, dtype, seed=S)
    got = p_ops.flash_attention(pq, pk, pv, causal=True)
    assert _err(got, _oracle(rq, rk, rv)) < FLASH_TOL[dtype]


def _swiglu_inputs(M, d, F, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, d)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in ((d, F), (d, F), (F, d))]
    return [_pair(a, dtype) for a in (x, *ws)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,d,F", [(64, 32, 128), (128, 64, 256), (256, 128, 512)])
def test_swiglu_sweep_matches_reference_oracle(M, d, F, dtype):
    pairs = _swiglu_inputs(M, d, F, dtype)
    r_in, p_in = [p[0] for p in pairs], [p[1] for p in pairs]
    got = p_ops.swiglu(*p_in)
    oracle = jax.jit(r_ref.swiglu_ref)(*r_in)
    assert got.dtype == p_in[0].dtype and got.shape == (M, d)
    assert _err(got, oracle) < SWIGLU_TOL[dtype]
    assert _err(p_ref.swiglu_ref(*p_in), oracle) < SWIGLU_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_pallas_interpret(dtype):
    pairs = _swiglu_inputs(64, 32, 128, dtype, seed=3)
    r_in, p_in = [p[0] for p in pairs], [p[1] for p in pairs]
    pallas = r_ops.swiglu(*r_in, block_m=64, block_f=64, interpret=True)
    assert _err(p_ops.swiglu(*p_in), pallas) < SWIGLU_TOL[dtype]


def test_swiglu_flattens_leading_dims():
    pairs = _swiglu_inputs(12, 32, 64, "float32", seed=4)
    x, wg, wu, wd = [p[1] for p in pairs]
    got = p_ops.swiglu(x.reshape(3, 4, 32), wg, wu, wd)
    assert got.shape == (3, 4, 32)
    assert torch.equal(got.reshape(12, 32), p_ops.swiglu(x, wg, wu, wd))


def test_cpu_calls_do_not_count_as_launches():
    (_, pq), (_, pk), (_, pv) = _qkv(1, 8, 8, 2, 1, 32, "float32")
    x, wg, wu, wd = [p[1] for p in _swiglu_inputs(4, 32, 64, "float32")]
    before = (p_fa.launches, p_sw.launches)
    p_ops.flash_attention(pq, pk, pv)
    p_ops.swiglu(x, wg, wu, wd)
    assert (p_fa.launches, p_sw.launches) == before


def test_wrappers_refuse_bad_inputs():
    q = torch.zeros(4, 8, 32)
    with pytest.raises(ValueError):
        p_fa.flash_attention_bhsd(q, torch.zeros(3, 8, 32), torch.zeros(3, 8, 32))  # 4 % 3
    with pytest.raises(ValueError):
        p_fa.flash_attention_bhsd(q, torch.zeros(2, 8, 16), torch.zeros(2, 8, 16))  # D differs
    with pytest.raises(ValueError):
        p_sw.swiglu_fused(torch.zeros(4, 32), torch.zeros(32, 64), torch.zeros(32, 64),
                          torch.zeros(32, 64))  # w_down not [F, d]
