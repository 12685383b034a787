"""int8 / bf16 quantization for the compression front-end (the port of
``repro/kernels/quantize.py``).

- ``quantize_rows_leaves`` / ``quantize_rows_flat`` and
  ``downcast_bf16_rows_leaves`` / ``downcast_bf16_rows_flat``: row-stacked
  int8 (per-row scales, deterministic round-half-up) and bf16 for the plane
  compressors, every leaf of a tree in one launch, bitwise equal to
  sequential per-client compression;
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
from typing import Callable, Dict, List, Sequence

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.ref import (
    downcast_bf16_rows_ref,
    quantize_rows_ref,
    quantize_stochastic_ref,
)

launches: Dict[str, int] = {"quantize_rows": 0, "downcast_bf16_rows": 0, "quantize_stochastic": 0}

MAX_LEAVES = 64  # csrc/quantize.cu: kMaxLeaves
_P = ctypes.c_void_p
_ARGTYPES = {
    "quantize_rows": [_P, _P],
    "downcast_bf16_rows": [_P, _P],
    "quantize_stochastic": [_P, _P, _P, _P, ctypes.c_longlong, _P],
}
_entries: Dict[str, Callable] = {}


class _RowsLeaf(ctypes.Structure):  # csrc/quantize.cu: RowsLeaf
    _fields_ = [("x", _P), ("scales", _P), ("q", _P), ("n", ctypes.c_longlong),
                ("rows", ctypes.c_int), ("first_block", ctypes.c_int), ("vec", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _RowsTable(ctypes.Structure):  # csrc/quantize.cu: RowsTable
    _fields_ = [("leaf", _RowsLeaf * MAX_LEAVES), ("count", ctypes.c_int)]


class _CastLeaf(ctypes.Structure):  # csrc/quantize.cu: CastLeaf
    _fields_ = [("x", _P), ("out", _P), ("n", ctypes.c_longlong), ("first_block", ctypes.c_int),
                ("vec", ctypes.c_int)]


class _CastTable(ctypes.Structure):  # csrc/quantize.cu: CastTable
    _fields_ = [("leaf", _CastLeaf * MAX_LEAVES), ("count", ctypes.c_int)]


def _launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` on ``device``'s current stream (pointers and
    the stream as c_void_p, so no pointer is cut to 32 bits); raise on a
    refused launch and count the launch otherwise."""
    fn = _entries.get(name)
    if fn is None:
        lib = load_library("quantize")
        if lib.quantize_rows_max_leaves() != MAX_LEAVES:
            raise RuntimeError("quantize: MAX_LEAVES disagrees with csrc/quantize.cu")
        fn = getattr(lib, name)
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


def quantize_rows_leaves(xs: Sequence[torch.Tensor],
                         scales: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """xs: leaves [R_l, n_l] f32, scales: [R_l] per leaf (per-row quantum) ->
    int8 [R_l, n_l] per leaf: clip(floor(x / scale_r + 0.5), -127, 127).

    One launch per ``MAX_LEAVES`` leaves with elements; the codes share one
    int8 buffer, each leaf starting 16-byte aligned."""
    if len(xs) != len(scales) or any(
        x.ndim != 2 or s.shape != (x.shape[0],) for x, s in zip(xs, scales)
    ):
        raise ValueError(
            f"quantize_rows: need each x [R, n] with scales [R], got "
            f"{[tuple(x.shape) for x in xs]} and {[tuple(s.shape) for s in scales]}"
        )
    if not xs or not _on_cuda("quantize_rows", *xs, *scales):
        return [quantize_rows_ref(x, s) for x, s in zip(xs, scales)]
    qs = _packed_outputs(xs, torch.int8)
    work = [(x, s, q) for x, s, q in zip(xs, scales, qs) if q.numel()]
    for start in range(0, len(work), MAX_LEAVES):
        chunk = work[start:start + MAX_LEAVES]
        table = _RowsTable(count=len(chunk))
        for slot, (x, s, q) in zip(table.leaf, chunk):
            slot.x, slot.scales, slot.q = x.data_ptr(), s.data_ptr(), q.data_ptr()
            slot.n, slot.rows = x.shape[1], x.shape[0]
        _launch("quantize_rows", xs[0].device, ctypes.addressof(table))
    return qs


def _packed_outputs(xs: Sequence[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    """One output buffer of ``dtype`` for all leaves, returned as a view per
    leaf shaped like it, each starting 16-byte aligned."""
    step = 16 // torch.empty((), dtype=dtype).element_size()
    offsets, total = [], 0
    for x in xs:
        offsets.append(total)
        total += -(-x.numel() // step) * step
    buf = torch.empty(total, dtype=dtype, device=xs[0].device)
    return [buf[o:o + x.numel()].view(x.shape) for o, x in zip(offsets, xs)]


def quantize_rows_flat(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """x [R, N] f32, scales [R] (per-row quantum) -> int8 [R, N]:
    clip(floor(x / scale_r + 0.5), -127, 127). A one-leaf table through the
    same kernel."""
    return quantize_rows_leaves([x], [scales])[0]


def downcast_bf16_rows_leaves(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """xs: leaves [R_l, n_l] f32 -> bf16 [R_l, n_l] per leaf (round to
    nearest even).

    One launch per ``MAX_LEAVES`` leaves with elements; the values share
    one bf16 buffer, each leaf starting 16-byte aligned."""
    if any(x.ndim != 2 for x in xs):
        raise ValueError(
            f"downcast_bf16_rows: need each x [R, n], got {[tuple(x.shape) for x in xs]}"
        )
    if not xs or not _on_cuda("downcast_bf16_rows", *xs):
        return [downcast_bf16_rows_ref(x) for x in xs]
    outs = _packed_outputs(xs, torch.bfloat16)
    work = [(x, o) for x, o in zip(xs, outs) if o.numel()]
    for start in range(0, len(work), MAX_LEAVES):
        chunk = work[start:start + MAX_LEAVES]
        table = _CastTable(count=len(chunk))
        for slot, (x, o) in zip(table.leaf, chunk):
            slot.x, slot.out, slot.n = x.data_ptr(), o.data_ptr(), x.numel()
        _launch("downcast_bf16_rows", xs[0].device, ctypes.addressof(table))
    return outs


def downcast_bf16_rows_flat(x: torch.Tensor) -> torch.Tensor:
    """x [R, N] f32 -> bf16 [R, N] (round to nearest even). A one-leaf
    table through the same kernel."""
    if x.ndim != 2:
        raise ValueError(f"downcast_bf16_rows_flat: need x [R, N], got {tuple(x.shape)}")
    return downcast_bf16_rows_leaves([x])[0]


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
