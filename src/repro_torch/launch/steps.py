"""Step builders (the port of the single-device part of
``repro/launch/steps.py``): ``make_optimizer`` and the train step.

``build_train_step(cfg, tcfg)`` returns ``train_step(state, batch) ->
(state, metrics)`` over ``state = {"params", "opt", "step"}`` on the
params' device: the loss and its gradients (microbatches accumulated in
f32 when ``tcfg.microbatches > 1``), ``clip_by_global_norm``, then the
optimizer's update and ``apply_updates``, as the reference's step computes
them. The reference donates the state to its step; the port updates it in
place, one parameter leaf at a time (that leaf's update computed, added
into the param, and dropped before the next), so a step never holds a
second copy of the params or a whole tree of f32 updates: for Qwen3-8B in
bf16 that is 16.4 GB of params and 32.8 GB of updates. Every optimizer
here is leaf-wise, so the values are those of the whole-tree update.

The sharded steps (the local-SGD ``vmap`` over pods, the outer sync, the
prefill / decode step builders on a mesh) are not ported (ROADMAP Queue 1,
item 16) and raise; the mesh shapes and the sharding rules they will
consume are ``launch.mesh`` and ``repro_torch.sharding``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import Model
from repro_torch.models.base import dtype_of
from repro_torch.optim import adafactor, adamw, clip_by_global_norm, cosine_warmup
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, item 16)")


def make_optimizer(tcfg: TrainConfig):
    lr = cosine_warmup(tcfg.learning_rate, tcfg.warmup_steps, tcfg.total_steps)
    if tcfg.optimizer == "adafactor":
        # factored second moments, no first moment, no master copy
        return adafactor(lr)
    state_dtype = dtype_of(tcfg.opt_state_dtype)
    master = torch.float32 if tcfg.opt_state_dtype != "float32" else None
    return adamw(
        lr, tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay,
        state_dtype=state_dtype, master_dtype=master,
    )


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def update_in_place(opt, grads: Dict[str, Any], opt_state: Dict[str, Any], params, step: int):
    """``opt.update`` then ``apply_updates``, one parameter leaf at a time:
    each param is added into in place and each optimizer-state entry (a
    tree mirroring the params, e.g. ``m`` / ``v`` / ``master``, or
    adafactor's per-leaf ``{vr, vc}``) replaced; ``grads`` is emptied as it
    is consumed. The optimizer must be leaf-wise (every one here is)."""
    for path in list(_paths(params)):
        g = _at(grads, path)
        _set(grads, path, None)
        p = _at(params, path)
        sub = {k: {"x": _at(tree, path)} for k, tree in opt_state.items()}
        upd, new = opt.update({"x": g}, sub, {"x": p}, step)
        del g
        with torch.no_grad():
            p.add_(upd["x"].to(p.dtype))
        del upd
        for k in opt_state:
            _set(opt_state[k], path, new[k]["x"])


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, *, mode: str = "sync"):
    """The train step on one device (see the module docstring)."""
    if mode != "sync":
        raise _not_ported(f"the '{mode}' train step (a mesh of pods)")
    model = Model(cfg)
    opt = make_optimizer(tcfg)
    n_micro = max(tcfg.microbatches, 1)

    def loss_and_grads(params, b):
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = model.loss(ps, b)
        grads = tree_unflatten(ps, torch.autograd.grad(loss, tree_leaves(ps)))
        return {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(train_state, batch):
        params, opt_state, step = (
            train_state["params"], train_state["opt"], train_state["step"]
        )
        if n_micro == 1:
            metrics, grads = loss_and_grads(params, batch)
        else:
            # gradient accumulation in f32: the first microbatch, then the
            # remaining n - 1 added in order, both sums divided at the end
            mb = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
                  for k, v in batch.items()}
            msum, gsum = loss_and_grads(params, {k: v[0] for k, v in mb.items()})
            gsum = tree_map(lambda g: g.float(), gsum)
            msum = {k: m.float() for k, m in msum.items()}
            for i in range(1, n_micro):
                metrics, grads = loss_and_grads(params, {k: v[i] for k, v in mb.items()})
                gsum = tree_map(lambda a, g: a + g.float(), gsum, grads)
                msum = {k: a + metrics[k].float() for k, a in msum.items()}
                del grads
            grads = tree_map(lambda g: g / n_micro, gsum)
            metrics = {k: m / n_micro for k, m in msum.items()}
            del gsum
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        update_in_place(opt, grads, opt_state, params, int(step))
        metrics = dict(metrics, grad_norm=gnorm)
        return {"params": params, "opt": opt_state, "step": step + 1}, metrics

    return train_step


def build_outer_sync(*args, **kwargs):
    raise _not_ported("the cross-pod outer sync")


def build_prefill_step(*args, **kwargs):
    raise _not_ported("the sharded prefill step")


def build_decode_step(*args, **kwargs):
    raise _not_ported("the sharded decode step")


def build_step(*args, **kwargs):
    raise _not_ported("the shape-dispatching step builder")
