"""Tree-level wrappers around the port's kernels (the port of the slice's
part of ``repro/kernels/ops.py``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.fedavg_reduce import fedavg_reduce_flat
from repro_torch.utils.pytree import tree_map


def fedavg_reduce(stacked_deltas, weights: torch.Tensor):
    """Weighted mean over stacked client deltas.

    stacked_deltas: tree whose leaves have leading client dim C.
    weights: [C]; cast to f32 and normalized in f32 (FedAvg semantics).
    One kernel launch per leaf; each result is cast to its leaf's dtype."""
    w = weights.float()
    w = (w / torch.clamp(w.sum(), min=1e-20)).contiguous()

    def one(leaf):
        flat = leaf.reshape(leaf.shape[0], -1).contiguous()
        return fedavg_reduce_flat(flat, w).reshape(leaf.shape[1:]).to(leaf.dtype)

    return tree_map(one, stacked_deltas)
