"""Fused weighted FedAvg reduction: out = sum_c w[c] * X[c, :].

The server-side aggregation hot spot over C stacked client deltas. On a
CUDA tensor this launches the hand-written sm_90a kernel in
``csrc/fedavg_reduce.cu`` (one pass over X, f32 accumulator); on a CPU
tensor it runs the plain version ``ref.fedavg_reduce_ref``. There is no
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
from repro_torch.kernels.ref import fedavg_reduce_ref

launches = 0

# dynamic shared memory holds the C weights; 48 KB needs no opt-in
MAX_CLIENTS = 48 * 1024 // 4
_DTYPES = {torch.float32: "fedavg_reduce_f32", torch.bfloat16: "fedavg_reduce_bf16"}
_entries: Dict[torch.dtype, Callable] = {}


def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, with its ctypes signature declared
    (pointers and the stream as c_void_p, so no pointer is cut to 32 bits)."""
    fn = _entries.get(dtype)
    if fn is None:
        fn = getattr(load_library("fedavg_reduce"), _DTYPES[dtype])
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[dtype] = fn
    return fn


def fedavg_reduce_flat(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [C, N] f32/bf16, w [C] f32 (already normalized) -> [N] f32."""
    global launches
    if x.device.type == "cpu":
        return fedavg_reduce_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"fedavg_reduce_flat: unsupported device {x.device}")
    if x.ndim != 2 or w.ndim != 1 or w.shape[0] != x.shape[0]:
        raise ValueError(
            f"fedavg_reduce_flat: need x [C, N] and w [C], got {tuple(x.shape)} "
            f"and {tuple(w.shape)}"
        )
    if x.dtype not in _DTYPES or w.dtype != torch.float32:
        raise TypeError(
            f"fedavg_reduce_flat: need x float32/bfloat16 and w float32, got "
            f"{x.dtype} and {w.dtype}"
        )
    if w.device != x.device or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fedavg_reduce_flat: x and w must be contiguous on one device")
    C, N = x.shape
    if not 1 <= C <= MAX_CLIENTS or N >= 2**31:
        raise ValueError(f"fedavg_reduce_flat: C={C}, N={N} out of range")
    out = torch.empty(N, dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    fn = _entry(x.dtype)
    with torch.cuda.device(x.device):  # the launch goes to x's device
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), C, N, stream)
    if err != 0:
        raise RuntimeError(f"fedavg_reduce kernel launch failed: cudaError {err}")
    launches += 1
    return out
