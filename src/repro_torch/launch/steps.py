"""Step builders (the port of ``repro/launch/steps.py``): the train step
on one device, and the sharded steps (train, outer sync, prefill, decode)
on a torch ``DeviceMesh``.

One device. ``build_train_step(cfg, tcfg)`` returns ``train_step(state,
batch) -> (state, metrics)`` over ``state = {"params", "opt", "step"}`` on
the params' device: the loss and its gradients (microbatches accumulated in
f32 when ``tcfg.microbatches > 1``), ``clip_by_global_norm``, then the
optimizer's update and ``apply_updates``, as the reference's step computes
them. The reference donates the state to its step; the port updates it in
place, one parameter leaf at a time (that leaf's update computed, added
into the param, and dropped before the next), so a step never holds a
second copy of the params or a whole tree of f32 updates: for Qwen3-8B in
bf16 that is 16.4 GB of params and 32.8 GB of updates. Every optimizer
here is leaf-wise, so the values are those of the whole-tree update.

On a mesh. ``build_train_step(cfg, tcfg, shape, mesh, mode=)``,
``build_outer_sync``, ``build_prefill_step``, ``build_decode_step`` and
``build_step`` take the reference's arguments and return a ``BuiltStep``:
the step function over DTensor trees, its abstract args (``meta``
tensors), its in / out specs (the reference's ``PartitionSpec``s as
tuples, ``repro_torch.sharding``) and the args it updates in place (the
reference donates them). ``run_built(built, mesh, *args)`` distributes
whole tensors (or redistributes DTensors) by the in specs, runs the step
and lays the outputs out by the out specs: the counterpart of
``jax.jit(fn, in_shardings, out_shardings)``. Inside, the params are
DTensors (``distribute_tree``), the model runs on them with the
activation constraints on (``cfg.act_shard_*`` from the mesh), the two
hand kernels run on each rank's shard under ``local_map``
(``kernels.ops``), and the MoE takes ``models.moe_sharded``'s paths.

- ``sync``: one step over the whole mesh; the gradients are laid out as
  their params (summed over the batch's axes), the global norm summed
  over the shards, and the optimizer runs on each rank's shards
  (``update_in_place``), with Adafactor's means and rms terms summed over
  the groups that split a leaf (``optim.ShardSpan``).
- ``local_sgd`` on a mesh with a "pod" axis: every state leaf and input
  carries a leading pod dim split over "pod"; each rank trains its own
  pods, one after the other, as a sync step on its (data, model) sub-mesh,
  so nothing in the step crosses "pod" (the reference's
  ``vmap(spmd_axis_name="pod")``: ``torch.func.vmap`` batches neither the
  custom ops nor DTensors). Any other mode runs as ``sync``, as the
  reference's does.
- ``build_outer_sync``: the FedAvg burst across pods: each pod's delta from
  the anchor, int8 per pod on the wire (scale over every dim but the pod,
  ``torch.round``, half to even) when ``compression="int8"``: the codes and
  scales, not f32, are gathered over "pod", dequantized and averaged in pod
  order; then ``nesterov_outer`` on the anchor and every pod reset to it.
- Prefill and decode: FSDP over "data" for models past 1e10 params, caches
  with the batch over ("pod", "data"); decode writes the cache in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, ShapeSpec, TrainConfig
from repro_torch.launch.mesh import mesh_context
from repro_torch.models import Model
from repro_torch.models.base import dtype_of
from repro_torch.optim import adafactor, adamw, clip_by_global_norm, cosine_warmup, nesterov_outer
from repro_torch.optim.optimizers import ShardSpan, _square_sum
from repro_torch.sharding.rules import (
    batch_spec,
    cache_shardings,
    distribute_tree,
    input_shardings,
    mesh_sizes,
    param_shardings,
    placements_on,
)
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


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


def _shard_span(t: DTensor) -> Optional[ShardSpan]:
    """The groups that split each dim of a DTensor leaf (None if whole)."""
    groups = [[] for _ in range(t.ndim)]
    for i, pl in enumerate(t.placements):
        if pl.is_shard() and t.device_mesh.size(i) > 1:
            groups[pl.dim].append(t.device_mesh.get_group(i))
    return ShardSpan(groups, t.shape) if any(groups) else None


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _like(local, ref):
    """``local`` as a DTensor laid out as ``ref`` (a plain tensor if ``ref`` is)."""
    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


def update_in_place(opt, grads: Dict[str, Any], opt_state: Dict[str, Any], params, step: int):
    """``opt.update`` then ``apply_updates``, one parameter leaf at a time:
    each param is added into in place and each optimizer-state entry (a
    tree mirroring the params, e.g. ``m`` / ``v`` / ``master``, or
    adafactor's per-leaf ``{vr, vc}``) replaced; ``grads`` is emptied as it
    is consumed. The optimizer must be leaf-wise (every one here is). A
    DTensor leaf is updated on this rank's shard (its gradient laid out as
    the param), what spans the leaf summed over its groups."""
    for path in list(_paths(params)):
        g = _at(grads, path)
        _set(grads, path, None)
        p = _at(params, path)
        sub = {k: _at(tree, path) for k, tree in opt_state.items()}
        kw = {}
        if isinstance(p, DTensor):
            kw["spans"] = {"x": _shard_span(p)}
            refs = sub
            sub = tree_map(_local, sub)
            g = _local(g)
        upd, new = opt.update({"x": g}, {k: {"x": v} for k, v in sub.items()}, {"x": _local(p)},
                              step, **kw)
        del g
        with torch.no_grad():
            _local(p).add_(upd["x"].to(p.dtype))
        del upd
        for k in opt_state:
            val = new[k]["x"]
            if isinstance(p, DTensor):
                val = tree_map(_like, val, refs[k])
            _set(opt_state[k], path, val)


def _microbatches(batch, n_micro: int):
    return [{k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n_micro)]


def _train_step_fn(model, opt, tcfg, *, mesh=None, mb_spec=None):
    """``train_step(state, batch) -> (state, metrics)`` on one device, or on
    ``mesh`` over DTensors (see the module docstring)."""
    n_micro = max(tcfg.microbatches, 1)

    def loss_and_grads(params, b):
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = model.loss(ps, b)
        if isinstance(loss, DTensor):  # one loss, not a sum of per-rank parts
            loss = loss.redistribute(mesh, [Replicate()] * mesh.ndim)
        grads = tree_unflatten(ps, torch.autograd.grad(loss, tree_leaves(ps)))
        if mesh is not None:  # each gradient laid out as its param
            grads = tree_map(lambda g, p: g.redistribute(mesh, p.placements), grads, params)
        return {k: v.detach() for k, v in metrics.items()}, grads

    def split(batch):
        if mesh is None:
            return _microbatches(batch, n_micro)
        # the microbatch dim whole, each microbatch's rows over mb_spec
        whole = {k: v.full_tensor() for k, v in batch.items()}
        return [distribute_tree(mb, {k: (mb_spec,) + (None,) * (v.ndim - 1) for k, v in mb.items()},
                                mesh) for mb in _microbatches(whole, n_micro)]

    def train_step(train_state, batch):
        params, opt_state, step = (
            train_state["params"], train_state["opt"], train_state["step"]
        )
        if n_micro == 1:
            metrics, grads = loss_and_grads(params, batch)
        else:
            # gradient accumulation in f32: the first microbatch, then the
            # remaining n - 1 added in order, both sums divided at the end
            mbs = split(batch)
            msum, gsum = loss_and_grads(params, mbs[0])
            gsum = tree_map(lambda g: g.float(), gsum)
            msum = {k: m.float() for k, m in msum.items()}
            for mb in mbs[1:]:
                metrics, grads = loss_and_grads(params, mb)
                gsum = tree_map(lambda a, g: a + g.float(), gsum, grads)
                msum = {k: a + metrics[k].float() for k, a in msum.items()}
                del grads
            grads = tree_map(lambda g: g / n_micro, gsum)
            metrics = {k: m / n_micro for k, m in msum.items()}
            del gsum
        if mesh is None:
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        else:
            grads, gnorm = _clip_sharded(grads, tcfg.grad_clip)
        update_in_place(opt, grads, opt_state, params, int(_local(step)))
        metrics = dict(metrics, grad_norm=gnorm)
        return {"params": params, "opt": opt_state, "step": step + 1}, metrics

    return train_step


def _clip_sharded(grads, max_norm: float):
    """``clip_by_global_norm`` over DTensor gradients: each leaf's squares
    summed on its shard, then over the groups that split it; leaves added
    in sorted-key order."""
    leaves = tree_leaves(grads)
    sq = []
    for g in leaves:
        s = _square_sum(_local(g))
        span = _shard_span(g)
        sq.append(s if span is None else span.sum(s.clone(), range(g.ndim)))
    gn = torch.sqrt(sum(sq))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    with torch.no_grad():
        for g in leaves:
            _local(g).mul_(scale.to(g.dtype))
    return grads, gn


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, shape: Optional[ShapeSpec] = None,
                     mesh=None, *, mode: str = "sync"):
    """Without a mesh: the train step on one device (see the module
    docstring); every mode is ``sync`` there, as the reference's is on a
    mesh without pods. With ``shape`` and ``mesh``: a ``BuiltStep``."""
    if mesh is None:
        assert shape is None, "a shape needs a mesh"
        return _train_step_fn(Model(cfg), make_optimizer(tcfg), tcfg)
    cfg = _with_act_sharding(cfg, mesh)
    model = Model(cfg)
    opt = make_optimizer(tcfg)
    sizes = mesh_sizes(mesh)
    multi_pod = "pod" in sizes
    local_sgd = multi_pod and mode == "local_sgd"

    abstract_params = model.abstract_params()
    p_shard = param_shardings(abstract_params, model.param_axes(), mesh)
    state_abs = opt.init(abstract_params)
    s_shard = _mirror_state_shardings(state_abs, abstract_params, p_shard)
    inputs_abs = model.input_specs(shape)
    in_shard = input_shardings(inputs_abs, mesh, include_pod=not local_sgd)
    n_micro = max(tcfg.microbatches, 1)
    mb_spec = batch_spec(mesh, shape.global_batch // n_micro, include_pod=not local_sgd)
    state_abs_full = {"params": abstract_params, "opt": state_abs,
                      "step": torch.empty((), dtype=torch.int32, device="meta")}
    state_shardings = {"params": p_shard, "opt": s_shard, "step": ()}
    metrics_shard = {k: () for k in ("loss", "accuracy", "aux", "grad_norm")}

    if not local_sgd:
        step = _train_step_fn(model, opt, tcfg, mesh=mesh, mb_spec=mb_spec)

        def fn(state, batch):
            with mesh_context(mesh), implicit_replication():
                state, metrics = step(state, batch)
                return state, {k: _replicated(v, mesh) for k, v in metrics.items()}
    else:
        assert mesh.mesh_dim_names[0] == "pod", "the pod axis leads the mesh"
        n_pod = sizes["pod"]
        sub = mesh["data", "model"]
        step = _train_step_fn(model, opt, tcfg, mesh=sub, mb_spec=mb_spec)

        def stack(tree):
            return tree_map(lambda a: torch.empty((n_pod,) + tuple(a.shape), dtype=a.dtype,
                                                  device="meta"), tree)

        def shard_stack(specs):
            return tree_map(lambda s: ("pod",) + tuple(s), specs)

        state_abs_full = stack(state_abs_full)
        state_shardings = shard_stack(state_shardings)
        inputs_abs = {k: torch.empty((n_pod, v.shape[0] // n_pod) + tuple(v.shape[1:]),
                                     dtype=v.dtype, device="meta") for k, v in inputs_abs.items()}
        in_shard = shard_stack(in_shard)
        metrics_shard = shard_stack(metrics_shard)

        def fn(state, batch):
            return _per_pod(step, sub, state, batch)

    return BuiltStep(
        name=f"train:{cfg.name}:{shape.name}:{mode}",
        fn=fn,
        abstract_args=(state_abs_full, inputs_abs),
        in_shardings=(state_shardings, in_shard),
        out_shardings=(state_shardings, metrics_shard),
        donate_argnums=(0,),
    )


def _replicated(t, mesh):
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(mesh, [Replicate()] * mesh.ndim)


def _pod_slice(t: DTensor, j: int, sub):
    """Local pod ``j`` of a pod-stacked DTensor, as a DTensor on the
    (data, model) sub-mesh (a view of the stacked storage); any other leaf
    (the dry-run's step, a Python int) as it is."""
    if not isinstance(t, DTensor):
        return t
    pl = tuple(Shard(p.dim - 1) if p.is_shard() else p for p in t.placements[1:])
    return DTensor.from_local(t._local_tensor[j], sub, pl, run_check=False)


def _per_pod(step, sub, state, batch):
    """Each of this rank's pods trained by ``step`` on the sub-mesh; the
    pods' state written back into the stacked leaves, their metrics
    stacked. Nothing crosses "pod"."""
    some = tree_leaves(state["params"])[0]
    n_local = some._local_tensor.shape[0]
    pod_mesh = some.device_mesh
    out_metrics = []
    for j in range(n_local):
        st = tree_map(lambda t: _pod_slice(t, j, sub), state)
        bt = {k: _pod_slice(v, j, sub) for k, v in batch.items()}
        with mesh_context(sub), implicit_replication():
            st, metrics = step(st, bt)
            metrics = {k: _replicated(v, sub) for k, v in metrics.items()}
        with torch.no_grad():  # the new optimizer state (and step) into pod j's slot
            for path in _paths(state):
                new, old = _at(st, path), _at(state, path)
                if not isinstance(old, DTensor):
                    continue
                dst = old._local_tensor[j]
                src = _local(new)
                if src.data_ptr() != dst.data_ptr():
                    dst.copy_(src)
        out_metrics.append({k: _local(v) for k, v in metrics.items()})
    metrics = {}
    for k in out_metrics[0]:
        local = torch.stack([m[k] for m in out_metrics])
        pl = (Shard(0),) + tuple(Replicate() for _ in range(pod_mesh.ndim - 1))
        metrics[k] = DTensor.from_local(local, pod_mesh, pl, run_check=False,
                                        shape=(n_local * pod_mesh.size(0),), stride=(1,))
    return state, metrics


# ---------------------------------------------------------------------------
# The built step and its runner
# ---------------------------------------------------------------------------


@dataclass
class BuiltStep:
    """A step over DTensor trees with its abstract args (``meta`` tensors)
    and its in / out specs; ``donate_argnums`` are the args it updates in
    place."""

    name: str
    fn: Callable
    abstract_args: Tuple
    in_shardings: Tuple
    out_shardings: Any
    donate_argnums: Tuple[int, ...] = ()


def _lay_out(tree, specs, mesh):
    if isinstance(specs, dict):
        return {k: _lay_out(tree[k], specs[k], mesh) for k in tree}
    if isinstance(tree, DTensor):
        return tree.redistribute(mesh, placements_on(specs, mesh))
    return distribute_tree(tree, specs, mesh)


def run_built(built: BuiltStep, mesh, *args):
    """``built.fn`` on ``args`` laid out by its in specs (whole tensors,
    the same on every rank, are split; DTensors redistributed), its
    outputs laid out by its out specs."""
    args = [_lay_out(a, s, mesh) for a, s in zip(args, built.in_shardings)]
    out = built.fn(*args)
    return tuple(_lay_out(o, s, mesh) for o, s in zip(out, built.out_shardings))


def _with_act_sharding(cfg: ModelConfig, mesh) -> ModelConfig:
    sizes = mesh_sizes(mesh)
    return cfg.replace(act_shard_data=sizes.get("data", 0), act_shard_model=sizes.get("model", 0))


def _same_structure(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_structure(a[k], b[k]) for k in a))
    return True


def _is_factored(sub, ap) -> bool:
    """``sub`` holds a ``{vr, vc}`` or ``{v}`` dict where ``ap`` holds a leaf."""
    if isinstance(ap, dict):
        return (isinstance(sub, dict) and sub.keys() == ap.keys()
                and all(_is_factored(sub[k], ap[k]) for k in ap))
    return isinstance(sub, dict) and ("vr" in sub or "v" in sub)


def _mirror_state_shardings(state_abs, abstract_params, p_shardings):
    """Optimizer-state specs: trees mirroring the params take the params'
    specs; Adafactor's factored moments the matching reduced specs (``vr``
    drops the last param dim, ``vc`` the second-to-last); anything else is
    replicated."""

    def factored(ap, spec, vd):
        if isinstance(ap, dict):
            return {k: factored(ap[k], spec[k], vd[k]) for k in ap}
        spec = list(spec) + [None] * (len(ap.shape) - len(spec))
        if "v" in vd:
            return {"v": tuple(spec)}
        return {"vr": tuple(spec[:-1]), "vc": tuple(spec[:-2] + [spec[-1]])}

    def build(sub):
        if _same_structure(sub, abstract_params):
            return p_shardings
        if _is_factored(sub, abstract_params):
            return factored(abstract_params, p_shardings, sub)
        return tree_map(lambda _: (), sub)

    return {k: build(v) for k, v in state_abs.items()}


# ---------------------------------------------------------------------------
# Outer sync (FedAvg across pods over the constrained link)
# ---------------------------------------------------------------------------


def build_outer_sync(cfg: ModelConfig, tcfg: TrainConfig, mesh, *,
                     compression: Optional[str] = None) -> BuiltStep:
    """The cross-pod FedAvg burst on pod-stacked replicas (see the module
    docstring): args (stacked params, anchor, outer state, step); the
    stacked params, anchor and outer state are updated in place."""
    sizes = mesh_sizes(mesh)
    if "pod" not in sizes:
        raise ValueError(f"the outer sync needs the multi-pod mesh; {tuple(sizes)} has no 'pod'")
    compression = compression or tcfg.compression
    model = Model(cfg)
    abstract_params = model.abstract_params()
    p_shard = param_shardings(abstract_params, model.param_axes(), mesh)
    n_pod = sizes["pod"]
    stacked_abs = tree_map(lambda a: torch.empty((n_pod,) + tuple(a.shape), dtype=a.dtype,
                                                 device="meta"), abstract_params)
    stacked_shard = tree_map(lambda s: ("pod",) + tuple(s), p_shard)
    outer = nesterov_outer(tcfg.outer_lr, tcfg.outer_momentum)
    outer_abs = outer.init(abstract_params)
    o_shard = _mirror_state_shardings(outer_abs, abstract_params, p_shard)
    pod_group = mesh.get_group("pod")

    def avg_delta(ps, a):
        """The mean over pods of each pod's delta from the anchor, on this
        rank's shard; only the (int8) payload crosses "pod"."""
        d = _local(ps).float() - _local(a).float()[None]
        if compression == "int8":
            amax = torch.amax(torch.abs(d), dim=tuple(range(1, d.ndim)), keepdim=True)
            span = _shard_span(a)
            if span is not None:  # the max over the whole leaf, not this shard
                for g in {id(g): g for gs in span.groups for g in gs}.values():
                    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=g)
            scale = torch.clamp(amax, min=1e-12) / 127.0
            q = torch.clamp(torch.round(d / scale), -127, 127).to(torch.int8)
            q, scale = _gather_pods(q, pod_group), _gather_pods(scale, pod_group)
            d = q.float() * scale
        else:
            d = _gather_pods(d, pod_group)
        return torch.mean(d, dim=0)

    def sync(params_stacked, anchor, outer_state, step):
        delta = tree_map(avg_delta, params_stacked, anchor)
        local_state = tree_map(_local, outer_state)
        upd, new_state = outer.update(delta, local_state, tree_map(_local, anchor), int(_local(step)))
        with torch.no_grad():
            for path in _paths(anchor):
                a = _local(_at(anchor, path))
                a.copy_((a.float() + _at(upd, path)).to(a.dtype))
                _local(_at(params_stacked, path)).copy_(a[None].expand_as(
                    _local(_at(params_stacked, path))))
            for k in outer_state:
                for path in _paths(outer_state[k]):
                    _local(_at(outer_state[k], path)).copy_(_at(new_state[k], path))
        return params_stacked, anchor, outer_state

    return BuiltStep(
        name=f"outer_sync:{cfg.name}:{compression}",
        fn=sync,
        abstract_args=(stacked_abs, abstract_params, outer_abs,
                       torch.empty((), dtype=torch.int32, device="meta")),
        in_shardings=(stacked_shard, p_shard, o_shard, ()),
        out_shardings=(stacked_shard, p_shard, o_shard),
        donate_argnums=(0, 1, 2),
    )


def _gather_pods(t: torch.Tensor, group) -> torch.Tensor:
    """Every pod's ``t`` (leading dim: this rank's pods) stacked in pod order."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------


def _serving_layout(cfg, shape: ShapeSpec, mesh):
    cfg = _with_act_sharding(cfg, mesh)
    model = Model(cfg)
    abstract_params = model.abstract_params()
    # past 10B params: the weights over "data" at serve time too (per-layer
    # gathers beat not fitting: deepseek's 472 GB, phi3-medium's replicated
    # non-divisible-head attention weights)
    fsdp = cfg.param_count() > 1e10
    p_shard = param_shardings(abstract_params, model.param_axes(), mesh, fsdp=fsdp)
    b_axes = ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)
    cache_abs = model.cache_spec(shape.global_batch, shape.seq_len)
    c_axes = model.cache_axes(shape.global_batch, shape.seq_len)
    c_shard = cache_shardings(cache_abs, c_axes, mesh, batch_axes=b_axes)
    return cfg, model, abstract_params, p_shard, cache_abs, c_shard


def build_prefill_step(cfg: ModelConfig, shape: ShapeSpec, mesh) -> BuiltStep:
    """``prefill(params, batch) -> (last logits [B, V] f32, cache)``; the
    cache is made empty on the mesh and filled in place."""
    cfg, model, abstract_params, p_shard, cache_abs, c_shard = _serving_layout(cfg, shape, mesh)
    inputs_abs = model.input_specs(shape)
    in_shard = input_shardings(inputs_abs, mesh)

    def prefill(params, batch):
        with mesh_context(mesh), implicit_replication():
            device = _local(tree_leaves(params)[0]).device  # meta in the dry-run
            cache = distribute_tree(model.init_cache(shape.global_batch, shape.seq_len,
                                                     device=device), c_shard, mesh)
            with torch.no_grad():
                logits, cache = model.prefill(params, batch, shape.seq_len, cache=cache)
            return _replicated(logits, mesh), cache

    return BuiltStep(
        name=f"prefill:{cfg.name}:{shape.name}",
        fn=prefill,
        abstract_args=(abstract_params, inputs_abs),
        in_shardings=(p_shard, in_shard),
        out_shardings=((), c_shard),
    )


def build_decode_step(cfg: ModelConfig, shape: ShapeSpec, mesh) -> BuiltStep:
    """``decode(params, cache, tokens [B, 1]) -> (logits [B, V] f32,
    cache)``, the cache written in place (the reference donates it)."""
    cfg, model, abstract_params, p_shard, cache_abs, c_shard = _serving_layout(cfg, shape, mesh)
    tok_abs = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")
    tok_shard = (batch_spec(mesh, shape.global_batch, include_pod=True), None)

    def decode(params, cache, tokens):
        with mesh_context(mesh), implicit_replication(), torch.no_grad():
            logits, cache = model.decode_step(params, cache, tokens)
            return _replicated(logits, mesh), cache

    return BuiltStep(
        name=f"decode:{cfg.name}:{shape.name}",
        fn=decode,
        abstract_args=(abstract_params, cache_abs, tok_abs),
        in_shardings=(p_shard, c_shard, tok_shard),
        out_shardings=((), c_shard),
        donate_argnums=(1,),
    )


def build_step(cfg: ModelConfig, tcfg: TrainConfig, shape: ShapeSpec, mesh, *,
               mode: str = "sync") -> BuiltStep:
    """Dispatch on the shape kind (train / prefill / decode)."""
    if shape.kind == "train":
        return build_train_step(cfg, tcfg, shape, mesh, mode=mode)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh)
    return build_decode_step(cfg, shape, mesh)
