"""Fused SwiGLU MLP: out = (silu(x @ Wg) * (x @ Wu)) @ Wd (the port of
``repro/kernels/swiglu.py``).

On a CUDA tensor ``swiglu_fused`` launches the hand-written sm_90a kernel
in ``csrc/swiglu.cu``: g and u summed in f32, h rounded to x's dtype as the
Pallas body rounds it, the [M, F] hidden kept on chip, the down product
added into an f32 workspace with atomics (so the summation order, and the
last bits, may vary between runs), then cast to x's dtype. Any M, d and F.
On a CPU tensor it runs the plain version ``ref.swiglu_ref``. There is no
fallback between the two: any other device, or an input the kernel does
not take, raises.

``launches`` counts kernel launches (CPU calls do not count), so a run can
show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.ref import swiglu_ref

launches = 0

_DTYPES = {torch.float32: "swiglu_f32", torch.bfloat16: "swiglu_bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
# f32: x, wg, wu, wd, out, M, d, F, stream; bf16 adds the f32 workspace before out
_ARGTYPES = {
    torch.float32: [_P] * 5 + [_I] * 3 + [_P],
    torch.bfloat16: [_P] * 6 + [_I] * 3 + [_P],
}
_entries: Dict[torch.dtype, Callable] = {}


def _entry(dtype: torch.dtype):
    fn = _entries.get(dtype)
    if fn is None:
        fn = getattr(load_library("swiglu"), _DTYPES[dtype])
        fn.argtypes = _ARGTYPES[dtype]
        fn.restype = ctypes.c_int
        _entries[dtype] = fn
    return fn


def swiglu_fused(x, w_gate, w_up, w_down):
    """x [M, d], w_gate/w_up [d, F], w_down [F, d] -> [M, d] in x's dtype."""
    global launches
    if x.ndim != 2 or w_gate.ndim != 2 or w_up.shape != w_gate.shape or w_gate.shape[0] != x.shape[1] \
            or w_down.shape != (w_gate.shape[1], x.shape[1]):
        raise ValueError(
            f"swiglu_fused: need x [M, d], w_gate/w_up [d, F], w_down [F, d], got "
            f"{tuple(x.shape)}, {tuple(w_gate.shape)}, {tuple(w_up.shape)}, {tuple(w_down.shape)}"
        )
    dev = x.device
    if dev.type == "cpu":
        return swiglu_ref(x, w_gate, w_up, w_down)
    if dev.type != "cuda":
        raise ValueError(f"swiglu_fused: unsupported device {dev}")
    ts = (x, w_gate, w_up, w_down)
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in ts):
        raise TypeError(f"swiglu_fused: need one dtype of float32/bfloat16, got {[t.dtype for t in ts]}")
    if not all(t.device == dev and t.is_contiguous() for t in ts):
        raise ValueError("swiglu_fused: inputs must be contiguous on one device")
    M, d = x.shape
    F = w_gate.shape[1]
    if max(M, d, F) >= 2**31 or F > 65535 * 64:
        raise ValueError(f"swiglu_fused: M={M}, d={d}, F={F} out of range")
    if M * d == 0 or F == 0:
        return torch.zeros((M, d), dtype=x.dtype, device=dev)
    # f32 sums straight into its output; bf16 sums into an f32 workspace
    bufs = [torch.empty((M, d), dtype=torch.float32, device=dev)]
    if x.dtype == torch.bfloat16:
        bufs.append(torch.empty((M, d), dtype=x.dtype, device=dev))
    fn = _entry(x.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                 *(b.data_ptr() for b in bufs), M, d, F, stream)
    if err != 0:
        raise RuntimeError(f"swiglu kernel launch failed: cudaError {err}")
    launches += 1
    return bufs[-1]
