"""Plain PyTorch versions of the port's hand-written kernels.

Each is the kernel's target: the tests hold the kernel to it on the card
(allclose for the reduction, bitwise for the quantize family), and the
kernel's wrapper runs it for tensors on the CPU.
"""

from __future__ import annotations

import torch


def fedavg_reduce_ref(x, w):
    """x [C, N], w [C] -> [N] float32."""
    return torch.einsum("c,cn->n", w.float(), x.float())


def _codes(v):
    return torch.clamp(v, -127.0, 127.0).to(torch.int8)


def quantize_stochastic_ref(x, uniform, scale):
    """x [N], uniform [N] in [0, 1), scale scalar -> int8 [N]:
    clip(floor(x / scale + u), -127, 127).

    ``scale`` becomes a tensor on x's device: on CUDA, PyTorch divides by a
    Python number as a multiply by its reciprocal, which is not the
    correctly rounded quotient the codes are defined by."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return _codes(torch.floor(x.float() / scale + uniform.float()))


def quantize_rows_ref(x, scales):
    """x [R, N], scales [R] -> int8 [R, N]; deterministic round-half-up."""
    return _codes(torch.floor(x.float() / scales.float()[:, None] + 0.5))


def downcast_bf16_rows_ref(x):
    """f32 -> bf16, round to nearest even."""
    return x.float().to(torch.bfloat16)
