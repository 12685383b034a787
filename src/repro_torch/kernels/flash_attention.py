"""Flash attention, causal / sliding-window / GQA (the port of
``repro/kernels/flash_attention.py``).

``flash_attention_bhsd`` takes the reference kernel's layout: q [BH, Sq, D],
k/v [BKV, Skv, D], query head bh reading kv head bh // G. On a CUDA tensor
it launches a hand-written sm_90a kernel in ``csrc/flash_attention.cu``
(online softmax, m / l / accumulator in f32, fully masked kv tiles
skipped; any Sq; D of 32, 64 or 128): bfloat16 runs on the tensor cores
(``flash_kernel_wgmma``: wgmma, TMA loads of K / V, P rounded to bf16
before P V, GQA rows packed into one tile when G * Sq <= 64) and needs
Skv >= 1 and 16-byte aligned tensors; float32 runs on the CUDA cores
(``flash_kernel_simt``, P kept in f32). On a CPU tensor it runs the plain
version ``ref.flash_attention_ref``. There is no fallback between the
two: any other device, or an input the kernel does not take, raises.

``launches`` counts kernel launches (CPU calls do not count), so a run can
show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.ref import flash_attention_ref

launches = 0

HEAD_DIMS = (32, 64, 128)
MAX_HEADS = 65535  # BH indexes the grid's y dimension
_DTYPES = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
_entries: Dict[torch.dtype, Callable] = {}


def _entry(dtype: torch.dtype):
    fn = _entries.get(dtype)
    if fn is None:
        fn = getattr(load_library("flash_attention"), _DTYPES[dtype])
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _entries[dtype] = fn
    return fn


def flash_attention_bhsd(q, k, v, *, causal=True, window=0, scale=None):
    """q [BH, Sq, D]; k/v [BKV, Skv, D]; BH = G * BKV (grouped heads).

    Returns [BH, Sq, D] in q's dtype."""
    global launches
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape or q.shape[2] != k.shape[2]:
        raise ValueError(
            f"flash_attention_bhsd: need q [BH, Sq, D] and k, v [BKV, Skv, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    BH, Sq, D = q.shape
    BKV, Skv, _ = k.shape
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
    if D not in HEAD_DIMS or BH > MAX_HEADS or max(Sq, Skv) * D >= 2**31:
        raise ValueError(f"flash_attention_bhsd: D={D}, BH={BH}, Sq={Sq}, Skv={Skv} out of range")
    if q.dtype == torch.bfloat16 and q.numel() and (
            Skv == 0 or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("flash_attention_bhsd: the bf16 kernel needs Skv >= 1 and 16-byte "
                         "aligned q, k, v")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _entry(q.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, BKV, Sq, Skv, D,
                 int(bool(causal)), int(window or 0), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
