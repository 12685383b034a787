"""Functional optimizers over nested dicts of tensors (the port of the
slice's part of ``repro/optim/optimizers.py``): ``sgd`` for the clients'
local steps, and the server-side (outer) optimizers ``nesterov_outer``
(DiLoCo-style outer momentum, FedAvg when lr=1, momentum=0) and
``fedopt_server`` (FedAdam / FedYogi / FedAdagrad, Reddi et al.).

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


# ---------------------------------------------------------------------------
# Server-side (outer) optimizers for FedAvg / local-update training: the
# reference's expressions in its operation order, f32 state
# ---------------------------------------------------------------------------


def _f32_zeros(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's and CUDA's: torch's
    vectorised CPU sqrt is off by an ulp on ~0.7 % of inputs, and the f64
    root rounds to the correctly rounded f32 one (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(x.double()).float()


def nesterov_outer(lr: float = 0.7, momentum: float = 0.9) -> Optimizer:
    """DiLoCo outer optimizer. lr=1, momentum=0 reduces to plain FedAvg."""

    def init(params):
        return {"m": _f32_zeros(params)}

    def update(avg_delta, state, params, step):
        m = tree_map(lambda mm, d: momentum * mm + d.float(), state["m"], avg_delta)
        upd = tree_map(lambda mm, d: lr * (momentum * mm + d.float()), m, avg_delta)
        return upd, {"m": m}

    return Optimizer(init, update)


def fedopt_server(kind: str = "adam", lr: float = 0.1, b1: float = 0.9,
                  b2: float = 0.99, tau: float = 1e-3) -> Optimizer:
    """FedAdam / FedYogi / FedAdagrad (Reddi et al. 2021). ``v`` starts at
    ``tau * tau`` rounded to f32; yogi's ``sign(0)`` is 0, as ``jnp.sign``'s."""
    if kind not in ("adam", "yogi", "adagrad"):
        raise ValueError(f"unknown fedopt kind {kind!r}; expected adam, yogi or adagrad")

    def init(params):
        return {
            "m": _f32_zeros(params),
            "v": tree_map(
                lambda p: torch.full(p.shape, tau * tau, dtype=torch.float32, device=p.device),
                params,
            ),
        }

    def update(avg_delta, state, params, step):
        m = tree_map(lambda mm, d: b1 * mm + (1 - b1) * d.float(), state["m"], avg_delta)

        def new_v(vv, d):
            d2 = torch.square(d.float())
            if kind == "adam":
                return b2 * vv + (1 - b2) * d2
            if kind == "yogi":
                return vv - (1 - b2) * d2 * torch.sign(vv - d2)
            return vv + d2  # adagrad

        v = tree_map(new_v, state["v"], avg_delta)
        upd = tree_map(lambda mm, vv: lr * mm / (_sqrt_f32(vv) + tau), m, v)
        return upd, {"m": m, "v": v}

    return Optimizer(init, update)
