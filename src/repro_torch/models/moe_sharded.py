"""Distribution-aware MoE dispatch on a mesh (the port of
``repro/models/moe_sharded.py``).

On a mesh the dispatch is LOCAL and only the expert-parallel payload
crosses ranks, as in the reference:

- ``ep_a2a`` (experts divisible by "model", tokens shardable over data x
  model: training and prefill): each rank scatters its own tokens into an
  [E, C_loc, d] buffer, an all-to-all over "model" hands each rank its
  E/model experts' tokens from every peer, the batched expert FFN runs on
  weights gathered over "data" (FSDP), and a second all-to-all brings the
  outputs home.
- ``ep_local`` (decode: tokens replicated over "model"): each model rank
  dispatches only the experts it owns, and the combined outputs are summed
  over "model" in f32.
- ``local`` (experts not divisible by "model": Mixtral's 8 on 16): dispatch
  is local per data shard; the expert FFN runs with its ffn dim split over
  "model" and the partial outputs are summed over "model" in f32.

Each runs under ``local_map`` over the ambient mesh with the reference's
in and out specs (its ``shard_map``), and its collectives are autograd
aware: the all-to-alls (their gradient the inverse exchange), the
all-gathers of the expert weights over "data" (in f32, cast after; their
gradient reduce-scattered), and a sum over "model" whose gradient passes
through unchanged (its output is the same on every rank). Gloo has no
all-to-all and no reduce-scatter; there both go through an all-gather or
an all-reduce, with the same values. The capacity
is computed from each rank's own token count, as the reference's is.

Routing (router product, softmax, top-k, the load-balance loss) runs
outside the local region on the DTensors, as the reference keeps it under
plain GSPMD. Without a mesh, or with a batch the mesh cannot split
(``pick_moe_path`` -> "gather"), ``models.mlp``'s no-mesh paths run; on
DTensors they run whole on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import mlp
from repro_torch.models.base import dtype_of
from repro_torch.models.mlp import _dispatch_local
from repro_torch.sharding.rules import ambient_mesh


def _route(cfg, p, x):
    """Top-k routing and the load-balance loss on x [..., d]
    (``mlp._router``, the reference's name for it here)."""
    return mlp._router(cfg, p, x)


def _combine_local(yb, dest, token_idx, flat_gates, keep, T, d, dtype):
    """Each token's gated expert outputs summed (the dropped ones read the
    zero row): [T, d] in ``dtype``."""
    yb_flat = torch.cat([yb.reshape(-1, d), torch.zeros((1, d), dtype=yb.dtype, device=yb.device)])
    contrib = yb_flat[dest] * (flat_gates * keep)[:, None].to(yb.dtype)
    out = torch.zeros((T, d), dtype=yb.dtype, device=yb.device).index_add(0, token_idx, contrib)
    return out.to(dtype)


def _expert_ffn(w_gate, w_up, w_down, xb):
    """Batched per-expert SwiGLU: xb [E, C, d] -> [E, C, d]."""
    return mlp._expert_ffn(None, w_gate, w_up, w_down, xb)


class _SumOver(torch.autograd.Function):
    """Sum over a process group; the gradient passes through unchanged
    (the sum is the same on every rank, and so is its gradient)."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sum_over(t, group):
    return t if dist.get_world_size(group) == 1 else _SumOver.apply(t, group)


def _gather_raw(t, group):
    """[n * t.shape[0], ...]: every rank's ``t`` in group-rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def _a2a_raw(t, group):
    """Chunk i of ``t``'s leading dim to group rank i; chunk i of the result
    from group rank i. Gloo has no all-to-all: there every rank's ``t`` is
    gathered and each keeps its chunk of each."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    if dist.get_backend(group) != "gloo":
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out
    me = dist.get_rank(group)
    every = _gather_raw(t, group).reshape((n, n, t.shape[0] // n) + tuple(t.shape[1:]))
    return every[:, me].reshape(t.shape)


class _AllToAll(torch.autograd.Function):
    """``_a2a_raw`` under autograd: the gradient takes the inverse exchange,
    which for equal chunks is the same exchange."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _a2a_raw(t, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a_raw(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    """The whole of ``t`` along ``dim`` from its shards over ``group``; the
    gradient is summed over the group and this rank's shard kept (a
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        whole = _gather_raw(t.movedim(dim, 0), group)
        return whole.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n, me = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        g = g.movedim(ctx.dim, 0).contiguous()
        if dist.get_backend(ctx.group) != "gloo":
            out = torch.empty((g.shape[0] // n,) + tuple(g.shape[1:]), dtype=g.dtype, device=g.device)
            dist.reduce_scatter_tensor(out, g, group=ctx.group)
        else:
            dist.all_reduce(g, group=ctx.group)
            out = g.reshape((n, g.shape[0] // n) + tuple(g.shape[1:]))[me]
        return out.movedim(0, ctx.dim), None, None


def _gather(w, dim: int, group, dtype):
    """The whole of ``w`` along ``dim`` from its shards over ``group``, in
    f32, cast to ``dtype`` after; its backward sums the gradients over the
    group and keeps this rank's shard."""
    if dist.get_world_size(group) > 1:
        w = _AllGather.apply(w.float(), dim, group)
    return w.to(dtype)


def _all_to_all(t, group):
    """Chunk i of ``t``'s leading dim to rank i; chunk i of the result
    from rank i (its gradient is the inverse exchange)."""
    return t if dist.get_world_size(group) == 1 else _AllToAll.apply(t, group)


def _local_weights(p):
    return (p["w_gate"].float(), p["w_up"].float(), p["w_down"].float())


def moe_forward_ep_a2a(cfg, p, x):
    """x [B, S, d] with B % data == 0, S % model == 0, E % model == 0.
    Returns (y [B, S, d], aux)."""
    m = cfg.moe
    _, _, d = x.shape
    E = m.num_experts
    mesh = ambient_mesh()
    g_data, g_model = mesh.get_group("data"), mesh.get_group("model")
    nm = mesh.size(mesh.mesh_dim_names.index("model"))
    wdt = dtype_of(cfg.dtype)
    gates, ids, aux = _route(cfg, p, x)

    def local(wg, wu, wd, x_loc, gates_loc, ids_loc):
        Bl, Sl, _ = x_loc.shape
        T = Bl * Sl
        C = mlp.capacity(cfg, T)
        buf, dest, token_idx, fg, keep = _dispatch_local(
            cfg, x_loc.reshape(T, d), gates_loc.reshape(T, -1), ids_loc.reshape(T, -1), C)
        # EP exchange: [E, C, d] -> [E/nm, nm*C, d], my experts' tokens from every peer
        buf = _all_to_all(buf, g_model)
        buf = buf.reshape(nm, E // nm, C, d).transpose(0, 1).reshape(E // nm, nm * C, d)
        yb = _expert_ffn(_gather(wg, 1, g_data, wdt), _gather(wu, 1, g_data, wdt),
                         _gather(wd, 2, g_data, wdt), buf)
        yb = yb.reshape(E // nm, nm, C, d).transpose(0, 1).reshape(E, C, d)
        yb = _all_to_all(yb, g_model)
        out = _combine_local(yb, dest, token_idx, fg, keep, T, d, x_loc.dtype)
        return out.reshape(Bl, Sl, d)

    w_in = [("model", 0, "data", 1), ("model", 0, "data", 1), ("model", 0, "data", 2)]
    tok = {"data": 0, "model": 1}
    y = _run_local(mesh, local, p, x, gates, ids, w_in, tok, x_grad=tok, gate_grad=tok)
    return y, aux


def moe_forward_local(cfg, p, x):
    """Manual over data only: experts not divisible by "model" (Mixtral's 8
    on 16). The ffn dim of the expert weights stays split over "model"
    where it divides, and the partial outputs are summed over it in f32."""
    m = cfg.moe
    _, S, d = x.shape
    mesh = ambient_mesh()
    g_data, g_model = mesh.get_group("data"), mesh.get_group("model")
    wdt = dtype_of(cfg.dtype)
    gates, ids, aux = _route(cfg, p, x)
    nm = mesh.size(mesh.mesh_dim_names.index("model"))
    ffn_split = m.expert_d_ff % nm == 0 and nm > 1

    def local(wg, wu, wd, x_loc, gates_loc, ids_loc):
        Bl = x_loc.shape[0]
        T = Bl * S
        C = mlp.capacity(cfg, T)
        buf, dest, token_idx, fg, keep = _dispatch_local(
            cfg, x_loc.reshape(T, d), gates_loc.reshape(T, -1), ids_loc.reshape(T, -1), C)
        yb = _expert_ffn(_gather(wg, 1, g_data, wdt), _gather(wu, 1, g_data, wdt),
                         _gather(wd, 2, g_data, wdt), buf)
        if ffn_split:  # partial sums over the ffn shards
            yb = _sum_over(yb.float(), g_model).to(yb.dtype)
        out = _combine_local(yb, dest, token_idx, fg, keep, T, d, x_loc.dtype)
        return out.reshape(Bl, S, d)

    if ffn_split:
        w_in = [("model", 2, "data", 1), ("model", 2, "data", 1), ("model", 1, "data", 2)]
    else:
        w_in = [("data", 1), ("data", 1), ("data", 2)]
    tok = {"data": 0}
    x_grad = {"data": 0, "model": "partial"} if ffn_split else tok
    y = _run_local(mesh, local, p, x, gates, ids, w_in, tok, x_grad=x_grad, gate_grad=tok)
    return y, aux


def moe_forward_ep_local(cfg, p, x):
    """Expert parallelism for short sequences (decode): tokens replicated
    over "model", each model rank dispatches only its own E/model experts,
    and the combined outputs are summed over "model" in f32."""
    m = cfg.moe
    _, S, d = x.shape
    mesh = ambient_mesh()
    g_data, g_model = mesh.get_group("data"), mesh.get_group("model")
    nm = mesh.size(mesh.mesh_dim_names.index("model"))
    E_loc = m.num_experts // nm
    e0 = mesh.get_local_rank("model") * E_loc
    wdt = dtype_of(cfg.dtype)
    gates, ids, aux = _route(cfg, p, x)

    def local(wg, wu, wd, x_loc, gates_loc, ids_loc):
        Bl = x_loc.shape[0]
        T = Bl * S
        xl = x_loc.reshape(T, d)
        C = mlp.capacity(cfg, T)
        # dispatch only my experts; the others' tokens go to the waste row
        flat_ids = ids_loc.reshape(-1) - e0
        flat_gates = gates_loc.reshape(-1)
        token_idx = torch.arange(T, device=xl.device).repeat_interleave(m.top_k)
        mine = (flat_ids >= 0) & (flat_ids < E_loc)
        safe = torch.clamp(flat_ids, 0, E_loc - 1)
        onehot = F.one_hot(safe, E_loc) * mine[:, None]
        pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=1)
        keep = mine & (pos < C)
        dest = torch.where(keep, safe * C + pos, E_loc * C)
        buf = torch.zeros((E_loc * C + 1, d), dtype=xl.dtype, device=xl.device)
        buf = buf.index_add(0, dest, xl[token_idx])[: E_loc * C].reshape(E_loc, C, d)
        yb = _expert_ffn(_gather(wg, 1, g_data, wdt), _gather(wu, 1, g_data, wdt),
                         _gather(wd, 2, g_data, wdt), buf)
        out = _combine_local(yb, dest, token_idx, flat_gates, keep, T, d, torch.float32)
        out = _sum_over(out, g_model)  # in f32, as the reference's psum
        return out.to(x_loc.dtype).reshape(Bl, S, d)

    w_in = [("model", 0, "data", 1), ("model", 0, "data", 1), ("model", 0, "data", 2)]
    tok = {"data": 0}
    part = {"data": 0, "model": "partial"}
    y = _run_local(mesh, local, p, x, gates, ids, w_in, tok, x_grad=part, gate_grad=part)
    return y, aux


def _placements(mesh, dims):
    """Placements from {axis: tensor dim, or "partial"}; other axes, and
    axes of one rank, replicate."""
    out = []
    for i, name in enumerate(mesh.mesh_dim_names):
        d = None if mesh.size(i) == 1 else dims.get(name)
        out.append(Partial() if d == "partial" else Replicate() if d is None else Shard(d))
    return tuple(out)


def _run_local(mesh, fn, p, x, gates, ids, w_in, tok, *, x_grad, gate_grad):
    """``fn(wg, wu, wd, x, gates, ids)`` under ``local_map`` over ``mesh``:
    the f32 expert weights laid out as ``w_in`` says ((axis, dim, ...)
    pairs; their gradients come back the same way), the tokens, gates, ids
    and the output as ``tok``; ``x_grad`` / ``gate_grad``
    are the placements of the tokens' and gates' gradients ("partial" where
    a rank's gradient is its share of a sum)."""
    if not isinstance(x, DTensor):  # plain tensors on a mesh of one rank
        return fn(*_local_weights(p), x, gates, ids)
    w_pl = [_placements(mesh, dict(zip(spec[::2], spec[1::2]))) for spec in w_in]
    t_pl = _placements(mesh, tok)
    args = [w.redistribute(mesh, pl) for w, pl in zip(_local_weights(p), w_pl)]
    args += [t.redistribute(mesh, t_pl) for t in (x, gates, ids)]
    grads = (*w_pl, _placements(mesh, x_grad), _placements(mesh, gate_grad), t_pl)
    wrapped = local_map(fn, out_placements=(t_pl,),
                        in_placements=(*w_pl, t_pl, t_pl, t_pl), in_grad_placements=grads,
                        device_mesh=mesh)
    return wrapped(*args)


def moe_forward_replicated(cfg, p, x, path_fn):
    """A no-mesh dispatch path (``mlp.moe_forward_gather`` / ``_einsum``)
    on DTensors: run whole on every rank (the batch the mesh cannot split),
    the output replicated."""
    mesh = x.device_mesh
    rep = tuple(Replicate() for _ in mesh.mesh_dim_names)
    keys = ("router", "w_gate", "w_up", "w_down")
    args = [p[k].redistribute(mesh, rep) for k in keys] + [x.redistribute(mesh, rep)]

    def local(router, wg, wu, wd, x_loc):
        B, S, d = x_loc.shape
        y, aux = path_fn(cfg, dict(zip(keys, (router, wg, wu, wd))), x_loc.reshape(B * S, d))
        return y.reshape(B, S, d), aux

    return local_map(local, out_placements=(rep, rep), in_placements=(rep,) * 5,
                     in_grad_placements=(rep,) * 5, device_mesh=mesh)(*args)


def pick_moe_path(cfg, B: int, S: int) -> str:
    """Select the dispatch implementation for this shape and mesh."""
    m = cfg.moe
    nd, nm = cfg.act_shard_data, cfg.act_shard_model
    if m.impl in ("gather", "einsum"):
        return m.impl
    if not nd or B % nd != 0 or cfg.d_model % nd != 0:
        return "gather"  # no mesh (CPU tests) or an unshardable batch (B = 1)
    if nm and m.num_experts % nm == 0:
        if S % nm == 0:
            return "ep_a2a"  # train / prefill: tokens shard over model too
        return "ep_local"  # decode: tokens replicated over model, owned experts
    return "local"  # experts do not divide model (mixtral): ffn split over model
