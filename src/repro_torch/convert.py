"""Carry parameter trees between the port and numpy (and through numpy,
the JAX reference). Layouts are shared, so nothing is transposed."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.stateplane import StatePlane
from repro_torch.utils import resolve_device, tree_map


def params_from_numpy(tree: Any, device=None):
    """Nested dict of array-likes -> nested dict of tensors on ``device``
    (default CUDA; raises without it)."""
    device = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def params_to_numpy(tree: Any):
    """Nested dict of tensors -> nested dict of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def state_plane_from_numpy(
    template: Any,
    n_slots: int,
    arrays: Any,
    slots,
    *,
    meta=None,
    storage: str = "dense",
    device=None,
):
    """A reference ``StatePlane`` carried across: its ``state_arrays()``
    and ``slot_list()`` (as numpy) and ``state_meta()`` -> a port
    ``StatePlane`` of the requested storage on ``device`` (default CUDA;
    raises without it), so that both packages start from the same
    residuals."""
    arrays = tree_map(np.asarray, arrays)
    return StatePlane.from_checkpoint(
        template, n_slots, meta, arrays,
        storage=storage, slots=list(slots), device=resolve_device(device),
    )
