"""int8 / bf16 quantization for the compression front-end (the port of
``repro/kernels/quantize.py``).

- ``quantize_rows_flat`` / ``downcast_bf16_rows_flat``: row-stacked int8
  (per-row scales, deterministic round-half-up) and bf16 for the plane
  compressors, bitwise equal to sequential per-client compression;
- ``quantize_stochastic_flat``: per-tensor int8 with stochastic rounding,
  the uniform bits supplied by the caller.

On a CUDA tensor each wrapper launches its hand-written sm_90a kernel in
``csrc/quantize.cu``; on a CPU tensor it runs the plain version in
``ref``. There is no fallback between the two: any other device, or an
input the kernel does not take, raises.

``launches`` counts kernel launches per kernel (CPU calls do not count),
so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.ref import (
    downcast_bf16_rows_ref,
    quantize_rows_ref,
    quantize_stochastic_ref,
)

launches: Dict[str, int] = {"quantize_rows": 0, "downcast_bf16_rows": 0, "quantize_stochastic": 0}

MAX_ROWS = 65535  # rows index the grid's y dimension
_P = ctypes.c_void_p
_ARGTYPES = {
    "quantize_rows": [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P],
    "downcast_bf16_rows": [_P, _P, ctypes.c_longlong, _P],
    "quantize_stochastic": [_P, _P, _P, _P, ctypes.c_longlong, _P],
}
_entries: Dict[str, Callable] = {}


def _launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` on ``device``'s current stream (pointers and
    the stream as c_void_p, so no pointer is cut to 32 bits); raise on a
    refused launch and count the launch otherwise."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load_library("quantize"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU inputs (the plain version runs); True for CUDA inputs
    the kernel takes (f32, contiguous, one device); raises otherwise."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: needs float32 inputs, got {t.dtype}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous on one device")
    return True


def quantize_rows_flat(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [R, N] f32, scales [R] (per-row quantum) -> int8 [R, N]:
    clip(floor(x / scale_r + 0.5), -127, 127)."""
    if x.ndim != 2 or scales.shape != (x.shape[0],):
        raise ValueError(
            f"quantize_rows_flat: need x [R, N] and scales [R], got "
            f"{tuple(x.shape)} and {tuple(scales.shape)}"
        )
    if not _on_cuda("quantize_rows_flat", x, scales):
        return quantize_rows_ref(x, scales)
    R, N = x.shape
    if R > MAX_ROWS:
        raise ValueError(f"quantize_rows_flat: R={R} > {MAX_ROWS}")
    q = torch.empty((R, N), dtype=torch.int8, device=x.device)
    if q.numel():
        _launch("quantize_rows", x.device, x.data_ptr(), scales.data_ptr(), q.data_ptr(), R, N)
    return q


def downcast_bf16_rows_flat(x: torch.Tensor) -> torch.Tensor:
    """x [R, N] f32 -> bf16 [R, N] (round to nearest even)."""
    if x.ndim != 2:
        raise ValueError(f"downcast_bf16_rows_flat: need x [R, N], got {tuple(x.shape)}")
    if not _on_cuda("downcast_bf16_rows_flat", x):
        return downcast_bf16_rows_ref(x)
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    if out.numel():
        _launch("downcast_bf16_rows", x.device, x.data_ptr(), out.data_ptr(), x.numel())
    return out


def quantize_stochastic_flat(x: torch.Tensor, uniform: torch.Tensor, scale) -> torch.Tensor:
    """x [N] f32, uniform [N] in [0, 1), scale scalar -> int8 [N]:
    clip(floor(x / scale + u), -127, 127)."""
    if x.ndim != 1 or uniform.shape != x.shape:
        raise ValueError(
            f"quantize_stochastic_flat: need x [N] and uniform [N], got "
            f"{tuple(x.shape)} and {tuple(uniform.shape)}"
        )
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device).reshape(())
    if not _on_cuda("quantize_stochastic_flat", x, uniform, scale):
        return quantize_stochastic_ref(x, uniform, scale)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if q.numel():
        _launch(
            "quantize_stochastic", x.device,
            x.data_ptr(), uniform.data_ptr(), scale.data_ptr(), q.data_ptr(), x.numel(),
        )
    return q


def dequantize_flat(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.float() * scales[:, None]
