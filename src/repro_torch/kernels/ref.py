"""Plain PyTorch versions of the port's hand-written kernels.

Each is the kernel's allclose target: the tests hold the kernel to it on
the card, and the kernel's wrapper runs it for tensors on the CPU.
"""

from __future__ import annotations

import torch


def fedavg_reduce_ref(x, w):
    """x [C, N], w [C] -> [N] float32."""
    return torch.einsum("c,cn->n", w.float(), x.float())
