"""Carry parameter trees between the port and numpy (and through numpy,
the JAX reference). Layouts are shared, so nothing is transposed: a
reference LM tree (nested dicts, layers stacked on a leading axis as
``lm_params`` builds them) comes across leaf for leaf, and the port indexes
the stacked leaves per layer.

bfloat16 crosses as its bits. numpy has no bf16 of its own: a JAX bf16
array taken through ``np.asarray`` has the ``ml_dtypes`` dtype named
"bfloat16", which ``torch.tensor`` refuses, so its uint16 view is carried
and viewed as ``torch.bfloat16`` again (no rounding)."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.stateplane import StatePlane
from repro_torch.utils import resolve_device, tree_map


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16, detected by name
        bits = np.array(a.view(np.uint16))  # a copy: the tensor owns its memory
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def params_from_numpy(tree: Any, device=None):
    """Nested dict of array-likes -> nested dict of tensors on ``device``
    (default CUDA; raises without it). bf16 leaves keep their bits."""
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(a, device), tree)


def params_to_numpy(tree: Any):
    """Nested dict of tensors -> nested dict of numpy arrays. A bf16 leaf
    comes back upcast to float32, which is exact (numpy has no bf16)."""

    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)


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
