"""Flash attention, causal / sliding-window / GQA (the port of
``repro/kernels/flash_attention.py``).

``flash_attention_bhsd`` takes the reference kernel's layout: q [BH, Sq, D],
k [BKV, Skv, D], v [BKV, Skv, Dv], query head bh reading kv head bh // G;
the output is [BH, Sq, Dv]. On a CUDA tensor it launches a hand-written
sm_90a kernel in ``csrc/flash_attention.cu`` (online softmax, m / l /
accumulator in f32, fully masked kv tiles skipped; any Sq; D of 16, 24, 32,
64, 96, 112, 128 or 192 and Dv of 16, 32, 64, 96, 112 or 128 with Dv <= D,
each pair of ``csrc/flash_attention.cu``'s FLASH_PAIRS: MLA's prefill takes
D = 192 with Dv = 128 (reduced: 24 with 16), Phi-3-vision's D = Dv = 96,
Zamba2's D = Dv = 112, the GQA models Dv = D of 32 to 128, the reduced
configs' heads of 16 D = Dv = 16): bfloat16 runs on the tensor cores
(``flash_kernel_wgmma``: wgmma, TMA loads of K / V, P rounded to bf16
before P V, GQA rows packed into one tile when G * Sq <= 64) and needs
Skv >= 1 and 16-byte aligned tensors; float32 runs on the CUDA cores
(``flash_kernel_simt``, P kept in f32). On a CPU tensor it runs the plain
version ``ref.flash_attention_ref``. There is no fallback between the
two: any other device, or an input the kernel does not take, raises.

``launches`` counts kernel launches (CPU calls do not count), so a run can
show that it went through the kernel.

``flash_attention_grad`` is the same function under autograd, as the
custom op ``repro_torch::flash_attention`` (an op, so that a
selective-checkpoint policy sees it whole): its forward is
``flash_attention_bhsd`` (the kernel on a CUDA tensor, the plain version
on a CPU tensor) and its backward is
written out in plain torch from the saved q, k, v and output. The
reference has no backward kernel (its flash kernel is forward only), so
this is the port of its gradient; a hand-written backward kernel is
performance work. The backward recomputes the scores S = q k^T * scale and
P = softmax(S) under the masks in f32, then dV = P^T dO,
dS = P * (dO V^T - rowsum(dO * O)), dQ = dS K * scale and
dK = dS^T Q * scale (dQ and dK in D, dV and rowsum(dO * O) in Dv), each
query head's contributions to dK and dV summed over the group of its kv
head (GQA). It materializes P, [BH, Sq, Skv] in
f32, which bounds the lengths it suits. ``backward_calls`` counts backward
passes on CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.ref import NEG_INF, flash_attention_ref

launches = 0
backward_calls = 0

# the (D, Dv) pairs the kernels are built for (FLASH_PAIRS in the source):
# D of q and k, Dv of v and the output
HEAD_PAIRS = ((16, 16), (24, 16), (32, 32), (64, 32), (64, 64), (96, 32), (96, 64), (96, 96),
              (112, 112), (128, 32), (128, 64), (128, 96), (128, 128), (192, 32), (192, 64),
              (192, 96), (192, 128))
MAX_HEADS = 65535  # BH indexes the grid's y dimension
_DTYPES = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
_entries: Dict[torch.dtype, Callable] = {}


def _entry(dtype: torch.dtype):
    fn = _entries.get(dtype)
    if fn is None:
        fn = getattr(load_library("flash_attention"), _DTYPES[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entries[dtype] = fn
    return fn


def _check_shapes(q, k, v):
    if (q.ndim != 3 or k.ndim != 3 or v.ndim != 3 or v.shape[:2] != k.shape[:2]
            or q.shape[2] != k.shape[2]):
        raise ValueError(
            f"flash_attention_bhsd: need q [BH, Sq, D], k [BKV, Skv, D] and v [BKV, Skv, Dv], "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )


def flash_attention_bhsd(q, k, v, *, causal=True, window=0, scale=None):
    """q [BH, Sq, D]; k [BKV, Skv, D]; v [BKV, Skv, Dv]; BH = G * BKV
    (grouped heads).

    Returns [BH, Sq, Dv] in q's dtype."""
    global launches
    _check_shapes(q, k, v)
    BH, Sq, D = q.shape
    BKV, Skv, Dv = v.shape
    if BKV == 0 or BH % BKV:
        raise ValueError(f"flash_attention_bhsd: BH={BH} is not a multiple of BKV={BKV}")
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bhsd: unsupported device {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention_bhsd: need one dtype of float32/bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not all(t.device == dev and t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention_bhsd: q, k, v must be contiguous on one device")
    if ((D, Dv) not in HEAD_PAIRS or BH > MAX_HEADS
            or max(Sq, Skv) * D >= 2**31):
        raise ValueError(f"flash_attention_bhsd: D={D}, Dv={Dv}, BH={BH}, Sq={Sq}, Skv={Skv} "
                         f"out of range")
    if q.dtype == torch.bfloat16 and q.numel() and (
            Skv == 0 or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("flash_attention_bhsd: the bf16 kernel needs Skv >= 1 and 16-byte "
                         "aligned q, k, v")
    out = q.new_empty((BH, Sq, Dv))
    if out.numel() == 0:
        return out
    fn = _entry(q.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, BKV, Sq, Skv, D,
                 Dv, int(bool(causal)), int(window or 0), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out


def _flash_backward(q, k, v, out, dout, causal, window, scale):
    """Gradients of ``flash_attention_bhsd`` in plain torch, in f32: the
    scores and probabilities recomputed from q and k, the kv-head sums of
    GQA taken over a [BKV, G, ...] view (no repeated copy of k and v)."""
    BH, Sq, D = q.shape
    BKV, Skv, Dv = v.shape
    G = BH // BKV
    qf = q.float().reshape(BKV, G, Sq, D)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(BKV, G, Sq, Dv)
    s = torch.einsum("kgqd,ksd->kgqs", qf, kf) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window and window > 0:
        mask &= qpos - kpos < window
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, NEG_INF)), dim=-1)
    dv = torch.einsum("kgqs,kgqd->ksd", p, do)
    dp = torch.einsum("kgqd,ksd->kgqs", do, vf)
    delta = torch.sum(do * out.float().reshape(BKV, G, Sq, Dv), dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("kgqs,ksd->kgqd", ds, kf) * scale
    dk = torch.einsum("kgqs,kgqd->ksd", ds, qf) * scale
    return dq.reshape(BH, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       window: int, scale: float) -> torch.Tensor:
    """``flash_attention_bhsd`` as an op with its gradient (see the module
    docstring)."""
    return flash_attention_bhsd(q, k, v, causal=causal, window=window, scale=scale)


@flash_attention_op.register_fake
def _(q, k, v, causal, window, scale):
    _check_shapes(q, k, v)
    return q.new_empty((q.shape[0], q.shape[1], v.shape[2]))


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window, scale = inputs
    ctx.save_for_backward(q, k, v, output)
    ctx.args = (causal, window, scale)


def _backward(ctx, dout):
    global backward_calls
    q, k, v, out = ctx.saved_tensors
    if q.is_cuda:
        backward_calls += 1
    return (*_flash_backward(q, k, v, out, dout, *ctx.args), None, None, None)


flash_attention_op.register_autograd(_backward, setup_context=_setup_context)


def flash_attention_grad(q, k, v, *, causal=True, window=0, scale=None):
    """``flash_attention_bhsd`` under autograd: q [BH, Sq, D]; k [BKV, Skv, D];
    v [BKV, Skv, Dv] -> [BH, Sq, Dv] in q's dtype, differentiable in q, k, v."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return flash_attention_op(q, k, v, bool(causal), int(window or 0), float(scale))
