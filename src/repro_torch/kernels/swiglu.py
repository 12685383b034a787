"""Fused SwiGLU MLP: out = (silu(x @ Wg) * (x @ Wu)) @ Wd (the port of
``repro/kernels/swiglu.py``).

On a CUDA tensor ``swiglu_fused`` launches a hand-written sm_90a kernel in
``csrc/swiglu.cu``: g and u summed in f32, h rounded to x's dtype as the
Pallas body rounds it, the [M, F] hidden kept on chip, the down product
added into an f32 workspace with atomics (so the summation order, and the
last bits, may vary between runs), then cast to x's dtype. bfloat16 runs
on the tensor cores (``swiglu_kernel_mma``: weights streamed by 16-byte
``cp.async``, ``mma.sync``), then ``swiglu_cast_kernel`` casts the f32
workspace and zeroes it again; it takes any M with d and F multiples of 8
and 16-byte aligned tensors, and keeps one zeroed f32 workspace per device
and stream, grown to the largest M * d it has seen, of which a call uses
the first M * d elements. float32 runs on the CUDA cores (``swiglu_kernel_simt``) and takes
any M, d and F. On a CPU tensor it runs the plain version
``ref.swiglu_ref``. There is no fallback between the two: any other
device, or an input the kernel does not take, raises.

``launches`` counts kernel launches (CPU calls do not count), so a run can
show that it went through the kernel.

``swiglu_grad`` is the same function under autograd, as the custom op
``repro_torch::swiglu`` (an op, so that a selective-checkpoint policy can
keep its output): its forward is ``swiglu_fused`` (the kernel on a CUDA
tensor, the plain version on a CPU tensor) and its backward is written
out in plain torch from the saved inputs. The reference has no backward kernel, so this is
the port of its gradient; a hand-written backward kernel is performance
work. The backward recomputes g = x Wg and u = x Wu, then with
a = silu(g) and h = a u: dh = dOut Wd^T, dWd = h^T dOut,
du = dh a, dg = dh u sigmoid(g) (1 + g (1 - sigmoid(g))),
dx = dg Wg^T + du Wu^T, dWg = x^T dg and dWu = x^T du. Its products run
in the inputs' dtype (on the card a bf16 product sums in f32 and rounds
once), the elementwise chain in f32. ``backward_calls`` counts backward
passes on CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels.build import load_library
from repro_torch.kernels.ref import swiglu_ref

launches = 0
backward_calls = 0

_DTYPES = {torch.float32: "swiglu_f32", torch.bfloat16: "swiglu_bf16"}
_P = ctypes.c_void_p
_I = ctypes.c_int
# f32: x, wg, wu, wd, out, M, d, F, stream; bf16 adds the f32 workspace before out
_ARGTYPES = {
    torch.float32: [_P] * 5 + [_I] * 3 + [_P],
    torch.bfloat16: [_P] * 6 + [_I] * 3 + [_P],
}
_entries: Dict[torch.dtype, Callable] = {}
# (device index, stream) -> flat f32 workspace, zero between calls: the
# cast launch zeroes the M * d elements that a call used; dropped when a
# launch fails, since the kernel may have added into it
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


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
    if max(M, d, F) >= 2**31 or F > 65535 * 64 or M * d >= 2**31:
        raise ValueError(f"swiglu_fused: M={M}, d={d}, F={F} out of range")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (d % 8 or F % 8 or any(t.data_ptr() % 16 for t in ts)):
        raise ValueError(
            f"swiglu_fused: the bf16 kernel needs d and F multiples of 8 and 16-byte aligned "
            f"tensors, got d={d}, F={F}"
        )
    if M * d == 0 or F == 0:
        return torch.zeros((M, d), dtype=x.dtype, device=dev)
    fn = _entry(x.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if bf16:
            key = (dev.index if dev.index is not None else torch.cuda.current_device(), stream)
            ws = _workspaces.get(key)
            if ws is None or ws.numel() < M * d:
                ws = _workspaces[key] = torch.zeros(M * d, dtype=torch.float32, device=dev)
            bufs = [ws[: M * d], torch.empty((M, d), dtype=x.dtype, device=dev)]
        else:  # f32 sums straight into its output
            bufs = [torch.empty((M, d), dtype=torch.float32, device=dev)]
        err = fn(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                 *(b.data_ptr() for b in bufs), M, d, F, stream)
    if err != 0:
        if bf16:
            _workspaces.pop(key, None)
        raise RuntimeError(f"swiglu kernel launch failed: cudaError {err}")
    launches += 1
    return bufs[-1]


def _swiglu_backward(x, w_gate, w_up, w_down, dout):
    """Gradients of ``swiglu_fused`` in plain torch: products in the
    inputs' dtype, the elementwise chain in f32."""
    dt = x.dtype
    g = (x @ w_gate).float()
    u = (x @ w_up).float()
    sg = torch.sigmoid(g)
    a = g * sg
    dout = dout.to(dt)
    dh = (dout @ w_down.T).float()
    dw_down = (a * u).to(dt).T @ dout
    du = (dh * a).to(dt)
    dg = (dh * u * (sg * (1.0 + g * (1.0 - sg)))).to(dt)
    dx = dg @ w_gate.T + du @ w_up.T
    return dx, x.T @ dg, x.T @ du, dw_down


@torch.library.custom_op("repro_torch::swiglu", mutates_args=())
def swiglu_op(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor) -> torch.Tensor:
    """``swiglu_fused`` as an op with its gradient (see the module
    docstring)."""
    return swiglu_fused(x, w_gate, w_up, w_down)


@swiglu_op.register_fake
def _(x, w_gate, w_up, w_down):
    return x.new_empty((x.shape[0], w_down.shape[1]))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dout):
    global backward_calls
    x, w_gate, w_up, w_down = ctx.saved_tensors
    if x.is_cuda:
        backward_calls += 1
    return _swiglu_backward(x, w_gate, w_up, w_down, dout)


swiglu_op.register_autograd(_backward, setup_context=_setup_context)


def swiglu_grad(x, w_gate, w_up, w_down):
    """``swiglu_fused`` under autograd: x [M, d], w_gate/w_up [d, F],
    w_down [F, d] -> [M, d], differentiable in all four."""
    return swiglu_op(x, w_gate, w_up, w_down)
