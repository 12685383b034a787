"""Parameter construction context + elementary ops shared by the LM blocks
(the port of ``repro/models/base.py``).

Models are plain functions ``apply(cfg, params, ...)`` over nested dicts of
tensors. The tree structure is defined once, in the init code, through a
:class:`Ctx`, in one of the reference's three modes: ``init`` (draws),
abstract (leaves are tensors on the ``meta`` device: shapes and dtypes, no
storage) and ``axes`` (each leaf is its tuple of logical axis names, which
``repro_torch.sharding`` maps onto a mesh). Draws come from a
``torch.Generator`` on its own device, in f32, then cast to the parameter
dtype; the kinds and the fan-in rule are the reference's. The reference's
threefry draws have no torch counterpart, so tests carry its parameters
across with ``repro_torch.convert`` instead.

Logical axis names used across the zoo (the reference's):
  batch, seq, kvseq, embed, vocab, heads, kv_heads, head_dim, qk_dim,
  ffn, experts, layers, state, conv, lora

The ops compute in f32 and return the activation dtype, as the
reference's do.

On a mesh (a sharded step of ``launch.steps``) the params and activations
are ``torch.distributed.tensor`` DTensors and the ops above run on them
unchanged. ``heads_constraint`` and ``seq_constraint`` are the reference's
sharding constraints: each redistributes an activation to the layout the
reference pins (batch over "data", heads or the sequence over "model"),
and each is the identity when ``cfg.act_shard_*`` is 0 or the tensor is
not a DTensor. ``shard_view`` gives a DTensor's local shard and where it
sits in the whole, for the in-place cache writes.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

Axes = Tuple[Optional[str], ...]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WHOLE_DRAW_MAX = 2**31  # elements of a leaf drawn in one call (see Ctx._scaled_randn)


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype string ("bfloat16", "float32") as a torch dtype."""
    return DTYPES[name]


class Ctx:
    """Parameter materialization context: draws from ``generator`` on its
    device, or shapes only (``meta`` tensors) when ``generator`` is None,
    or, with ``axes=True``, each leaf's logical axes (no generator)."""

    def __init__(self, generator: Optional[torch.Generator], param_dtype=torch.bfloat16, *,
                 axes: bool = False):
        assert not (axes and generator is not None), "the axes mode draws nothing"
        self.generator = generator
        self.device = generator.device if generator is not None else torch.device("meta")
        self.param_dtype = param_dtype
        self.axes = axes

    def _randn(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.device,
                           dtype=torch.float32)

    def _scaled_randn(self, shape, s: float, dtype):
        """``randn * s`` cast to ``dtype``. A leaf of more than
        ``WHOLE_DRAW_MAX`` elements is drawn one leading slice at a time into
        its output, so that its f32 draws never stand beside it whole (two
        f32 copies of Mixtral's stacked experts at 16 layers are 60 GB)."""
        if math.prod(shape) <= WHOLE_DRAW_MAX or len(shape) < 2:
            return (self._randn(shape) * s).to(dtype)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        for i in range(shape[0]):
            out[i] = self._randn(shape[1:]) * s
        return out

    def param(
        self,
        shape: Sequence[int],
        axes: Axes,
        init: str = "fan_in",
        scale: Optional[float] = None,
        dtype=None,
    ):
        shape = tuple(int(s) for s in shape)
        assert len(shape) == len(axes), f"shape {shape} vs axes {axes}"
        if self.axes:
            return tuple(axes)
        dtype = dtype or self.param_dtype
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init == "normal":
            s = 0.02 if scale is None else scale
            return self._scaled_randn(shape, s, dtype)
        if init == "fan_in":
            # fan_in = product of all dims except the last (stacked-layer dim
            # excluded by convention when axes[0] == "layers").
            dims = shape[1:] if axes and axes[0] == "layers" else shape
            fan_in = math.prod(dims[:-1]) if len(dims) > 1 else dims[0]
            s = (scale if scale is not None else 1.0) / max(math.sqrt(fan_in), 1.0)
            return self._scaled_randn(shape, s, dtype)
        if init == "uniform":
            s = 1.0 if scale is None else scale
            u = torch.rand(shape, generator=self.generator, device=self.device,
                           dtype=torch.float32)
            return (u * (2 * s) - s).to(dtype)  # jax.random.uniform(-s, s)
        raise ValueError(f"unknown init {init}")


# ---------------------------------------------------------------------------
# Elementary ops (compute in float32, return activation dtype)
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-5):
    if isinstance(x, DTensor):
        return _rowwise_sharded(lambda x, w: rms_norm(x, w, eps), x, (weight,))
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    if isinstance(x, DTensor):
        return _rowwise_sharded(lambda x, w, b: layer_norm(x, w, b, eps), x, (weight, bias))
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)  # jnp.var: biased
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def _rowwise_sharded(fn, x, params):
    """``fn(x, *params)``, a function of each row of x's last dim (a norm)
    with params over that dim, on each rank's shard under ``local_map``: x
    keeps its splits but one of the last dim, the params are whole and
    their gradients partial sums over the axes that split x. Under
    DTensor's rules (torch 2.11) a norm of the residual stream, split over
    both batch and sequence, ran on tensors of its global shape in f32."""
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    x_pl = tuple(p if p.is_shard() and p.dim != x.ndim - 1 else Replicate() for p in x.placements)
    g_pl = tuple(Partial() if p.is_shard() else Replicate() for p in x_pl)
    params = [(t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, rep)).redistribute(
        mesh, rep) for t in params]
    return local_map(fn, out_placements=(x_pl,), in_placements=(x_pl,) + (rep,) * len(params),
                     in_grad_placements=(x_pl,) + (g_pl,) * len(params), device_mesh=mesh)(
        x.redistribute(mesh, x_pl), *params)


def apply_norm(cfg, x, w):
    if cfg.norm_kind == "layernorm":
        return layer_norm(x, w["scale"], w["bias"], cfg.norm_eps)
    return rms_norm(x, w["scale"], cfg.norm_eps)


def norm_params(ctx: Ctx, cfg, d: int, stacked: Optional[int] = None):
    lead = () if stacked is None else (stacked,)
    lead_ax = () if stacked is None else ("layers",)
    p = {"scale": ctx.param(lead + (d,), lead_ax + ("embed",), init="ones")}
    if cfg.norm_kind == "layernorm":
        p["bias"] = ctx.param(lead + (d,), lead_ax + ("embed",), init="zeros")
    return p


def embed_lookup(table, ids):
    """table[ids]: the rows of ``ids``. On a DTensor table each rank looks
    its ids up in its own shard under ``local_map``: a vocab split keeps
    the table's rows where they are (an id outside this rank's rows reads
    zeros, so the output is a partial sum over that axis), a split of the
    ids' batch keeps theirs (the table whole there, its gradient a partial
    sum)."""
    if not isinstance(table, DTensor):
        return table[ids.long()]
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    rep = [Replicate()] * mesh.ndim
    ids = ids if isinstance(ids, DTensor) else DTensor.from_local(ids, mesh, rep)
    t_pl, i_pl, o_pl, tg, vocab_axes = [], [], [], [], []
    for i, (tp, ip) in enumerate(zip(table.placements, ids.placements)):
        if tp.is_shard(0):
            t_pl.append(Shard(0)), i_pl.append(Replicate()), o_pl.append(Partial())
            tg.append(Shard(0))
            vocab_axes.append(i)
        elif ip.is_shard():
            t_pl.append(Replicate()), i_pl.append(ip), o_pl.append(ip), tg.append(Partial())
        else:
            t_pl.append(Replicate()), i_pl.append(Replicate()), o_pl.append(Replicate())
            tg.append(Replicate())
    assert len(vocab_axes) <= 1, table.placements
    rows = table.shape[0] // (mesh.size(vocab_axes[0]) if vocab_axes else 1)
    first = mesh.get_local_rank(vocab_axes[0]) * rows if vocab_axes else 0

    def local(t, i):
        i = i.long() - first
        mine = (i >= 0) & (i < rows)
        out = t[torch.where(mine, i, 0)]
        return out * mine[..., None].to(out.dtype) if vocab_axes else out

    table, ids = table.redistribute(mesh, t_pl), ids.redistribute(mesh, i_pl)
    return local_map(local, out_placements=(tuple(o_pl),), in_placements=(tuple(t_pl), tuple(i_pl)),
                     in_grad_placements=(tuple(tg), tuple(i_pl)), device_mesh=mesh)(table, ids)


def linear(x, w):
    """x @ w in x's dtype (on the card a bf16 product sums in f32 and
    rounds once, as the reference's preferred_element_type=f32 does)."""
    return matmul(x, w.to(x.dtype))


def matmul(x, w):
    """x [..., K] @ w [K, N]; on DTensors each rank multiplies its shards
    (``_matmul_sharded``): DTensor cannot flatten x's leading dims when more
    than one of them is split (the sequence-parallel [B, S, d])."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return _matmul_sharded(x, w)
    return torch.matmul(x, w)


def _matmul_sharded(x, w, local=torch.matmul):
    """``local(x, w)`` (a product) under ``local_map``, per mesh axis: a column split of w
    keeps it (x whole there, the output split on its last dim, x's
    gradient a partial sum); a split of the contracted dim in both keeps
    both (the output a partial sum); a split of one of x's leading dims
    keeps it (w whole there, w's gradient a partial sum); anything else is
    gathered whole."""
    from torch.distributed.tensor.experimental import local_map

    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    rep = [Replicate()] * mesh.ndim
    x, w = (t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, rep) for t in (x, w))
    last = x.ndim - 1
    x_pl, w_pl, o_pl, xg, wg = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if wp.is_shard(1):
            x_pl.append(Replicate()), w_pl.append(Shard(1)), o_pl.append(Shard(last))
            xg.append(Partial()), wg.append(Shard(1))
        elif wp.is_shard(0) and xp.is_shard(last):
            x_pl.append(Shard(last)), w_pl.append(Shard(0)), o_pl.append(Partial())
            xg.append(Shard(last)), wg.append(Shard(0))
        elif xp.is_shard() and xp.dim < last:
            x_pl.append(xp), w_pl.append(Replicate()), o_pl.append(xp)
            xg.append(xp), wg.append(Partial())
        else:
            for lst in (x_pl, w_pl, o_pl, xg, wg):
                lst.append(Replicate())
    x, w = x.redistribute(mesh, x_pl), w.redistribute(mesh, w_pl)
    return local_map(local, out_placements=(tuple(o_pl),),
                     in_placements=(tuple(x_pl), tuple(w_pl)),
                     in_grad_placements=(tuple(xg), tuple(wg)), device_mesh=mesh)(x, w)


def silu(x):
    return x * torch.sigmoid(x.float()).to(x.dtype)


def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]. Rotates the
    two halves of D (not interleaved pairs), as the reference does. On a
    DTensor each rank rotates its shard (``_rope_sharded``)."""
    if isinstance(x, DTensor):
        return _rope_sharded(x, positions, theta)
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, device=x.device)  # [D/2]
    ang = positions[..., None].float() * inv  # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope_sharded(x, positions, theta: float):
    """``apply_rope`` on each rank's shard under ``local_map``: x keeps its
    splits of the leading (batch) dims and of the heads, and is whole in S
    and D (neither is split where the blocks rotate); positions with x's
    batch dim take its split there, other positions are whole. Under
    DTensor's rules (torch 2.11) the halves' backward made a zero gradient
    of x's global shape, in f32, for each half."""
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    pos = positions if isinstance(positions, DTensor) else DTensor.from_local(positions, mesh, rep)
    per_row = pos.ndim >= 2 and pos.shape[0] == x.shape[0] > 1
    x_pl, p_pl = [], []
    for p in x.placements:
        if p.is_shard() and (p.dim < x.ndim - 3 or p.dim == x.ndim - 2):
            x_pl.append(p), p_pl.append(p if per_row and p.dim == 0 else Replicate())
        else:
            x_pl.append(Replicate()), p_pl.append(Replicate())
    x_pl, p_pl = tuple(x_pl), tuple(p_pl)
    x, pos = x.redistribute(mesh, x_pl), pos.redistribute(mesh, p_pl)
    return local_map(lambda x, pos: apply_rope(x, pos, theta), out_placements=(x_pl,),
                     in_placements=(x_pl, p_pl), in_grad_placements=(x_pl, p_pl),
                     device_mesh=mesh)(x, pos)


def constrain(t, dims):
    """``t`` redistributed so that mesh axis ``name`` shards tensor dim
    ``dims[name]`` (None, or an axis of size 1: whole); the "pod" axis
    keeps a batch shard it has. The identity on a plain tensor."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    placements = []
    for i, (name, cur) in enumerate(zip(mesh.mesh_dim_names, t.placements)):
        if name == "pod" and name not in dims:
            placements.append(Shard(0) if cur.is_shard(0) else Replicate())
            continue
        d = dims.get(name)
        # an axis of one rank splits nothing: whole, so views never trip on it
        placements.append(Replicate() if d is None or mesh.size(i) == 1 else Shard(d))
    placements = tuple(placements)
    return t if t.placements == placements else t.redistribute(mesh, placements)


def heads_constraint(cfg, t):
    """[B, S, H, D] attention tensors: batch over "data", heads over
    "model" where each divides, S replicated: the Megatron-SP layout inside
    the attention block (``seq_constraint`` outside). Heads that "model"
    does not divide stay whole (q heads are padded to divisibility
    upstream, ``attention._pad_heads_for_tp``)."""
    if not (cfg.act_shard_data and cfg.act_shard_model) or t.ndim != 4:
        return t
    B, _, H, _ = t.shape
    b = 0 if B % cfg.act_shard_data == 0 else None
    h = 2 if H % cfg.act_shard_model == 0 else None
    if b is None and h is None:
        return t
    return constrain(t, {"data": b, "model": h})


def seq_constraint(cfg, x):
    """Sequence parallelism on the residual stream: x [B, S, d] with batch
    over "data" and S over "model" where each divides; the identity when
    activation sharding is off (no mesh, the CPU tests)."""
    if not (cfg.act_shard_data and cfg.act_shard_model) or x.ndim != 3:
        return x
    B, S, _ = x.shape
    b = 0 if B % cfg.act_shard_data == 0 else None
    s = 1 if S % cfg.act_shard_model == 0 else None
    if b is None and s is None:
        return x
    return constrain(x, {"data": b, "model": s})


def shard_view(t):
    """(local tensor, global offset of each of its dims) of a DTensor's
    shard; (t, zeros) for a plain tensor. The local tensor shares the
    DTensor's storage, so writing into it writes the shard in place."""
    if not isinstance(t, DTensor):
        return t, (0,) * t.ndim
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing

    # host arithmetic on small index tensors: kept out of a traced step (the dry-run's)
    with disable_proxy_modes_tracing():
        _, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return t._local_tensor, tuple(int(o) for o in offset)


def like_shards(vals, dst, dims):
    """``vals`` (a DTensor or a plain tensor) laid out so that its local
    shard lines up with ``dst``'s along ``dims``: each of those dims that a
    mesh axis shards in ``dst`` is sharded the same way in ``vals``, and
    everything else is whole. Returns the local tensor."""
    if not isinstance(dst, DTensor):
        return vals
    mesh = dst.device_mesh
    pl = tuple(p if p.is_shard() and p.dim in dims else Replicate() for p in dst.placements)
    if not isinstance(vals, DTensor):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(vals, mesh, pl)._local_tensor
    return vals.redistribute(mesh, pl).to_local()


def per_batch_shard(fn, batched, shared=(), n_out: int = 1):
    """``fn(*batched, *shared)`` on each rank's shard of the batch: every
    tensor in ``batched`` (and every output) has the batch as dim 0, which
    keeps the shards of the first DTensor among them and is whole on its
    other axes; ``shared`` tensors are whole on every rank (their gradients
    are partial sums over the batch's axes). For a computation independent
    per batch row (the recurrences), which DTensor cannot always trace (a
    cumsum's backward takes ``aten.flip``, which it has no rule for).
    ``fn`` itself on plain tensors."""
    lead = next((t for t in batched if isinstance(t, DTensor)), None)
    if lead is None:
        return fn(*batched, *shared)
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    mesh = lead.device_mesh
    b_pl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in lead.placements)
    rep = tuple(Replicate() for _ in b_pl)
    part = tuple(Partial() if p.is_shard(0) else Replicate() for p in b_pl)

    def lay(t, pl):
        if t is None:
            return None
        if isinstance(t, DTensor):
            return t.redistribute(mesh, pl)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    args = [lay(t, b_pl) for t in batched] + [lay(t, rep) for t in shared]
    in_pl = [None if t is None else b_pl for t in batched] + [rep for _ in shared]
    grads = [None if t is None else b_pl for t in batched] + [part for _ in shared]
    outs = tuple(b_pl for _ in range(n_out))
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(in_pl), in_grad_placements=tuple(grads),
                     device_mesh=mesh)(*args)


def sinusoidal_positions(n: int, d: int, device=None):
    """[n, d] f32 table: sin at the even columns, cos at the odd, built in
    numpy exactly as the reference builds it (bit for bit the same)."""
    pos = np.arange(n)[:, None]
    div = np.exp(-np.log(10000.0) * np.arange(0, d, 2) / d)
    table = np.zeros((n, d), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(table).to(device)
