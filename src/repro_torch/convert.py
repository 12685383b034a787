"""Carry parameter trees between the port and numpy (and through numpy,
the JAX reference). Layouts are shared, so nothing is transposed."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.utils import resolve_device, tree_map


def params_from_numpy(tree: Any, device=None):
    """Nested dict of array-likes -> nested dict of tensors on ``device``
    (default CUDA; raises without it)."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def params_to_numpy(tree: Any):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
