"""Functional optimizers over nested dicts of tensors (the port of
``repro/optim/optimizers.py``): ``sgd`` for the clients' local steps,
``adamw`` and ``adafactor`` for LM training, and the server-side (outer)
optimizers ``nesterov_outer`` (DiLoCo-style outer momentum, FedAvg when
lr=1, momentum=0) and ``fedopt_server`` (FedAdam / FedYogi / FedAdagrad,
Reddi et al.).

(init, update) pairs; ``update`` returns *updates* to be added to params
(the optax convention), so optimizers compose with clipping. Over stacked
trees (leading client axis C) every update is leaf-wise, so one call
advances C independent trajectories. This is not ``torch.optim``: the FL
engines need the state as a value they can stack and slice.

A sharded train step (``launch.steps``) runs ``adamw`` and ``adafactor``
on each rank's local shards. AdamW is elementwise; Adafactor's row and
column means and its two rms terms span the leaf, so its ``update`` takes
``spans``, a tree of ``ShardSpan`` (or None) that sums those over the
process groups that split the leaf. Unsplit dims take the one-device
expressions, so a mesh of one rank computes the one-device bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.utils.pytree import tree_leaves, tree_map

_F = np.float32


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step) -> (updates, state)


class ShardSpan:
    """Where a local shard sits in its leaf: ``groups[d]`` are the process
    groups that split dim ``d`` of the whole leaf (of shape ``shape``)."""

    def __init__(self, groups, shape):
        self.groups = tuple(tuple(g) for g in groups)
        self.shape = tuple(shape)

    def sum(self, x: torch.Tensor, dims) -> torch.Tensor:
        """``x``, a sum over this shard's part of ``dims``, summed over the
        groups that split those dims (in place)."""
        done = set()
        for d in dims:
            for g in self.groups[d]:
                if id(g) not in done:
                    done.add(id(g))
                    dist.all_reduce(x, group=g)
        return x

    def mean(self, x: torch.Tensor, dim: int, leaf_dim: int, keepdim=False) -> torch.Tensor:
        """The mean of the whole leaf along ``leaf_dim`` (``dim`` of ``x``)."""
        if not self.groups[leaf_dim]:
            return torch.mean(x, dim=dim, keepdim=keepdim)
        total = self.sum(torch.sum(x, dim=dim, keepdim=keepdim), (leaf_dim,))
        return total / self.shape[leaf_dim]


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


# A leaf of more elements than this is squared and summed slab by slab of
# its flat view, so that the f32 temporaries of the global norm are 64 MiB:
# Zamba2's stacked Mamba2 in_proj gradient (4.1 G elements) would otherwise
# take two 15 GiB f32 copies beside the params and the gradients.
_NORM_SLAB = 1 << 24


def _square_sum(l: torch.Tensor) -> torch.Tensor:
    if l.numel() <= _NORM_SLAB:
        return torch.sum(torch.square(l.float()))
    return sum(torch.sum(torch.square(s.float())) for s in l.reshape(-1).split(_NORM_SLAB))


def global_norm(grads) -> torch.Tensor:
    """The L2 norm over every leaf, in f32; leaves summed in sorted-key order."""
    return torch.sqrt(sum(_square_sum(l) for l in tree_leaves(grads)))


def clip_by_global_norm(grads, max_norm: float):
    """Clip by the global L2 norm; leaves summed in sorted-key order."""
    gn = global_norm(grads)
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


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as XLA's: CUDA's ``sqrt`` is
    correctly rounded; torch's vectorised CPU sqrt is off by an ulp on
    ~0.7 % of inputs, so on the CPU the root is taken in f64 and rounded
    to f32, which is the correctly rounded f32 root (53 >= 2 * 24 + 2
    bits). (On the card an f64 copy of a large leaf would cost memory the
    optimizers of a full-width model do not have; a ``meta`` tensor, the
    dry-run's, takes the card's path.)"""
    return torch.sqrt(x.double()).float() if x.device.type == "cpu" else torch.sqrt(x)


def _slabs(t: torch.Tensor):
    """Index expressions covering ``t``: one per entry of the leading axis
    of a layer-stacked leaf (3+ dims), else the whole tensor. AdamW and
    Adafactor compute such a leaf slab by slab, so that their f32
    temporaries are one layer's size: a Qwen3-8B MLP leaf is 7.2 GB in
    f32, and a handful of whole-leaf temporaries beside the params and
    gradients does not fit in 80 GB."""
    return range(t.shape[0]) if t.ndim >= 3 else (slice(None),)


def adamw(
    lr: Callable | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    state_dtype=torch.float32,
    master_dtype: Optional[torch.dtype] = None,
) -> Optimizer:
    """AdamW with optional master copy (``master_dtype``) when params are
    bf16: the update then moves the master copy, and params follow it. The
    reference's expressions in its operation order; the bias corrections in
    f32, the moments' coefficients in the state dtype (the reference's
    weakly typed Python scalars: bf16 moments take bf16(0.9))."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        st = {
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device), params),
        }
        if master_dtype is not None:
            st["master"] = tree_map(lambda p: p.to(master_dtype, copy=True), params)
        return st

    def update(grads, state, params, step, spans=None):  # elementwise: spans unused
        lr_t = lr_fn(step)
        t = _F(int(step) + 1)
        c1 = float(_F(1.0) - _F(b1) ** t)
        c2 = float(_F(1.0) - _F(b2) ** t)
        c = {k: torch.tensor(x, dtype=state_dtype) for k, x in
             (("b1", b1), ("1-b1", 1 - b1), ("b2", b2), ("1-b2", 1 - b2))}

        def leaf(mm, vv, g, p):
            m, v = torch.empty_like(mm), torch.empty_like(vv)
            u = torch.empty(mm.shape, dtype=torch.float32, device=mm.device)
            for s in _slabs(mm):
                gs = g[s].to(state_dtype)
                m[s] = c["b1"] * mm[s] + c["1-b1"] * gs
                v[s] = c["b2"] * vv[s] + c["1-b2"] * torch.square(gs)
                mhat = m[s].float() / c1
                vhat = v[s].float() / c2
                u[s] = -lr_t * (mhat / (_sqrt_f32(vhat) + eps) + weight_decay * p[s].float())
            return m, v, u

        out = tree_map(leaf, state["m"], state["v"], grads, state.get("master", params))
        pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
        updates = pick(2)
        new_state = {"m": pick(0), "v": pick(1)}
        if "master" in state:
            new_master = tree_map(lambda mp, u: mp + u.to(mp.dtype), state["master"], updates)
            new_state["master"] = new_master
            # params follow the master copy
            updates = tree_map(lambda nm, p: nm.float() - p.float(), new_master, params)
        return updates, new_state

    return Optimizer(init, update)


def adafactor(lr: Callable | float, eps: float = 1e-30, decay: float = 0.8,
              clip_threshold: float = 1.0, eps_scale: float = 1e-3) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern), with the
    parameter-scale term: the update is multiplied by
    max(rms(param), eps_scale). A leaf of two or more dims keeps row and
    column moments ``vr`` [..., rows] and ``vc`` [..., cols]; a vector keeps
    ``v``. No first moment and no master copy. A layer-stacked leaf is
    computed slab by slab (``_slabs``); its update's rms and the param's
    rms, which span the whole leaf, are summed over the slabs."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        def factored(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + (p.shape[-1],))}
            return {"v": z(p.shape)}

        return {"v": tree_map(factored, params)}

    def update(grads, state, params, step, spans=None):
        lr_t = lr_fn(step)
        beta = float(_F(1.0) - (_F(int(step)) + _F(1.0)) ** _F(-decay))

        def mean(x, dim, leaf_dim, span, keepdim=False):
            if span is None:
                return torch.mean(x, dim=dim, keepdim=keepdim)
            return span.mean(x, dim, leaf_dim, keepdim=keepdim)

        def upd(g, v, p, span):
            u = torch.empty(g.shape, dtype=torch.float32, device=g.device)
            new_v = {k: torch.empty_like(x) for k, x in v.items()}
            u_sq = p_sq = 0.0
            for s in _slabs(g):
                gs = g[s].float()
                g2 = torch.square(gs) + eps
                if "v" in v:
                    nv = new_v["v"][s] = beta * v["v"][s] + (1 - beta) * g2
                    u[s] = gs / torch.clamp(_sqrt_f32(nv), min=1e-30)
                else:
                    nd = g.ndim
                    vr = new_v["vr"][s] = beta * v["vr"][s] + (1 - beta) * mean(g2, -1, nd - 1, span)
                    vc = new_v["vc"][s] = beta * v["vc"][s] + (1 - beta) * mean(g2, -2, nd - 2, span)
                    del g2
                    r = vr / torch.clamp(mean(vr, -1, nd - 2, span, keepdim=True), min=1e-30)
                    denom = _sqrt_f32(r)[..., None] * _sqrt_f32(vc)[..., None, :]
                    u[s] = gs / torch.clamp(denom, min=1e-30)
                u_sq = u_sq + torch.sum(torch.square(u[s]))
                p_sq = p_sq + torch.sum(torch.square(p[s].float()))
            n = g.numel()
            if span is not None:  # the rms terms span the whole leaf
                every = range(len(span.shape))
                u_sq, p_sq = span.sum(u_sq, every), span.sum(p_sq, every)
                n = math.prod(span.shape)
            scale = torch.clamp(_sqrt_f32(u_sq / n) / clip_threshold, min=1.0)
            # parameter-scale: relative step sizes (Shazeer & Stern)
            p_rms = _sqrt_f32(p_sq / n)
            return u.mul_(-lr_t * torch.clamp(p_rms, min=eps_scale)).div_(scale), new_v

        def walk(g, v, p, sp):
            if isinstance(g, dict):
                pairs = {k: walk(g[k], v[k], p[k], None if sp is None else sp[k]) for k in g}
                return {k: u for k, (u, _) in pairs.items()}, {k: nv for k, (_, nv) in pairs.items()}
            return upd(g, v, p, sp)

        updates, new_v = walk(grads, state["v"], params, spans)
        return updates, {"v": new_v}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Server-side (outer) optimizers for FedAvg / local-update training: the
# reference's expressions in its operation order, f32 state
# ---------------------------------------------------------------------------


def _f32_zeros(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


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
