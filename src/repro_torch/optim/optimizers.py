"""Functional optimizers over nested dicts of tensors (the port of the
slice's part of ``repro/optim/optimizers.py``).

(init, update) pairs; ``update`` returns *updates* to be added to params
(the optax convention), so optimizers compose with clipping. Over stacked
trees (leading client axis C) every update is leaf-wise, so one call
advances C independent trajectories. This is not ``torch.optim``: the FL
engines need the state as a value they can stack and slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def clip_by_global_norm(grads, max_norm: float):
    """Clip by the global L2 norm; leaves summed in sorted-key order."""
    gn = torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


def clip_by_global_norm_stacked(grads, max_norm: float):
    """Per-client clip over a stacked cohort tree (leading axis C on every
    leaf): each client's slice is clipped by ITS OWN global norm, matching
    ``clip_by_global_norm`` applied client-by-client."""
    gn = torch.sqrt(
        sum(
            torch.sum(torch.square(l.float()), dim=tuple(range(1, l.ndim)))
            for l in tree_leaves(grads)
        )
    )  # [C]
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)

    def one(g):
        return g * scale.reshape((-1,) + (1,) * (g.ndim - 1)).to(g.dtype)

    return tree_map(one, grads), gn


def sgd(lr: Callable | float, momentum: float = 0.0, nesterov: bool = False,
        state_dtype=torch.float32) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        if momentum == 0.0:
            return {}
        return {"m": tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype), params)}

    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        if momentum == 0.0:
            return tree_map(lambda g: -lr_t * g.float(), grads), state
        m = tree_map(lambda mm, g: momentum * mm + g.to(state_dtype), state["m"], grads)
        if nesterov:
            upd = tree_map(
                lambda mm, g: -(lr_t * (momentum * mm + g.to(state_dtype))), m, grads
            )
        else:
            upd = tree_map(lambda mm: -lr_t * mm, m)
        return upd, {"m": m}

    return Optimizer(init, update)
