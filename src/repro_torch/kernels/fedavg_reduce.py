"""Fused weighted FedAvg reduction: out = sum_c w[c] * X[c, :], over every
leaf of a tree in one launch.

The server-side aggregation hot spot over C stacked client deltas. On CUDA
tensors this launches the hand-written sm_90a kernel in
``csrc/fedavg_reduce.cu``: one launch covers up to ``MAX_LEAVES`` leaves of
one dtype, their table passed as a kernel parameter. On CPU tensors it runs
the plain version ``ref.fedavg_reduce_ref``, per leaf. There is no fallback
between the two: any other device, or an input the kernel does not take,
raises.

``launches`` counts kernel launches (CPU calls do not count), so a run can
show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Sequence

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.ref import fedavg_reduce_ref

launches = 0

# dynamic shared memory holds the C weights; 48 KB needs no opt-in
MAX_CLIENTS = 48 * 1024 // 4
MAX_LEAVES = 64  # csrc/fedavg_reduce.cu: kMaxLeaves
_DTYPES = {torch.float32: "fedavg_reduce_leaves_f32", torch.bfloat16: "fedavg_reduce_leaves_bf16"}
_entries: Dict[torch.dtype, Callable] = {}


class _Leaf(ctypes.Structure):  # csrc/fedavg_reduce.cu: Leaf
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("first_block", ctypes.c_int), ("mode", ctypes.c_int)]


class _Table(ctypes.Structure):  # csrc/fedavg_reduce.cu: LeafTable
    _fields_ = [("leaf", _Leaf * MAX_LEAVES), ("count", ctypes.c_int)]


def _entry(dtype: torch.dtype):
    """The C entry point for ``dtype``, with its ctypes signature declared
    (pointers and the stream as c_void_p, so no pointer is cut to 32 bits)."""
    fn = _entries.get(dtype)
    if fn is None:
        lib = load_library("fedavg_reduce")
        if lib.fedavg_reduce_max_leaves() != MAX_LEAVES:
            raise RuntimeError("fedavg_reduce: MAX_LEAVES disagrees with csrc/fedavg_reduce.cu")
        fn = getattr(lib, _DTYPES[dtype])
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[dtype] = fn
    return fn


def _on_cuda(xs: Sequence[torch.Tensor], w: torch.Tensor) -> bool:
    """False for CPU inputs (the plain version runs); True for CUDA inputs
    the kernel takes; raises otherwise."""
    if w.ndim != 1 or any(x.ndim != 2 or x.shape[0] != w.shape[0] for x in xs):
        raise ValueError(
            f"fedavg_reduce: need each x [C, n] and w [C], got "
            f"{[tuple(x.shape) for x in xs]} and {tuple(w.shape)}"
        )
    if any(x.device != w.device for x in xs):
        raise ValueError("fedavg_reduce: x and w must be contiguous on one device")
    if w.device.type == "cpu":
        return False
    if w.device.type != "cuda":
        raise ValueError(f"fedavg_reduce: unsupported device {w.device}")
    if any(x.dtype not in _DTYPES for x in xs) or w.dtype != torch.float32:
        raise TypeError(
            f"fedavg_reduce: need x float32/bfloat16 and w float32, got "
            f"{sorted({str(x.dtype) for x in xs})} and {w.dtype}"
        )
    if not (w.is_contiguous() and all(x.is_contiguous() for x in xs)):
        raise ValueError("fedavg_reduce: x and w must be contiguous on one device")
    C = w.shape[0]
    if not 1 <= C <= MAX_CLIENTS or any(x.shape[1] >= 2**31 for x in xs):
        raise ValueError(f"fedavg_reduce: C={C} or a leaf width out of range")
    return True


def fedavg_reduce_leaves(xs: Sequence[torch.Tensor], w: torch.Tensor) -> torch.Tensor:
    """xs: leaves [C, n_l] f32/bf16, w [C] f32 (already normalized) ->
    [sum n_l] f32, leaf l at offset sum of n_k for k < l.

    One launch per dtype group of at most ``MAX_LEAVES`` leaves with n_l > 0."""
    global launches
    out = torch.empty(sum(x.shape[1] for x in xs), dtype=torch.float32, device=w.device)
    if not _on_cuda(xs, w):
        off = 0
        for x in xs:
            out[off:off + x.shape[1]] = fedavg_reduce_ref(x, w)
            off += x.shape[1]
        return out
    groups: Dict[torch.dtype, List] = {}
    off = 0
    for x in xs:
        n = x.shape[1]
        if n:
            groups.setdefault(x.dtype, []).append((x, out[off:off + n]))
        off += n
    with torch.cuda.device(w.device):  # the launches go to w's device
        stream = torch.cuda.current_stream(w.device).cuda_stream
        for dtype, leaves in groups.items():
            fn = _entry(dtype)
            for start in range(0, len(leaves), MAX_LEAVES):
                chunk = leaves[start:start + MAX_LEAVES]
                table = _Table(count=len(chunk))
                for slot, (x, o) in zip(table.leaf, chunk):
                    slot.x, slot.out, slot.n = x.data_ptr(), o.data_ptr(), x.shape[1]
                err = fn(ctypes.byref(table), w.data_ptr(), w.shape[0], stream)
                if err != 0:
                    raise RuntimeError(f"fedavg_reduce kernel launch failed: cudaError {err}")
                launches += 1
    return out


def fedavg_reduce_flat(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [C, N] f32/bf16, w [C] f32 (already normalized) -> [N] f32: a
    one-leaf table through the same kernel."""
    return fedavg_reduce_leaves([x], w)
