"""Public wrappers around the port's kernels (the port of
``repro/kernels/ops.py``): tree-level aggregation and quantization, and
the layout side of attention and SwiGLU. The port's kernels take any
sequence length and row count, so the reference's padding and
power-of-two block search have no counterpart here."""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import quantize as _quantize
from repro_torch.kernels.fedavg_reduce import fedavg_reduce_leaves
from repro_torch.kernels.flash_attention import flash_attention_grad
from repro_torch.kernels.quantize import (
    dequantize_flat,
    downcast_bf16_rows_flat,
    quantize_rows_flat,
    quantize_stochastic_flat,
)
from repro_torch.kernels.swiglu import swiglu_grad
from repro_torch.utils.pytree import (
    flatten_to_vector,
    tree_leaves,
    tree_unflatten,
    unflatten_from_vector,
)


def fedavg_reduce(stacked_deltas, weights: torch.Tensor):
    """Weighted mean over stacked client deltas.

    stacked_deltas: tree whose leaves have leading client dim C.
    weights: [C]; cast to f32 and normalized in f32 (FedAvg semantics).
    One kernel launch for the whole tree (per dtype, per ``MAX_LEAVES``
    leaves); each result is a view of the one f32 output, cast to its
    leaf's dtype."""
    w = weights.float()
    w = (w / torch.clamp(w.sum(), min=1e-20)).contiguous()
    leaves = tree_leaves(stacked_deltas)
    out = fedavg_reduce_leaves([l.reshape(l.shape[0], -1).contiguous() for l in leaves], w)
    views, off = [], 0
    for l in leaves:
        n = math.prod(l.shape[1:])
        views.append(out[off:off + n].reshape(l.shape[1:]).to(l.dtype))
        off += n
    return tree_unflatten(stacked_deltas, views)


def quantize_tree(tree, generator: torch.Generator):
    """Per-tensor int8 stochastic quantization of a tree: one scale for the
    whole flattened tree, uniform bits drawn from ``generator`` (the
    counterpart of the reference's ``jax.random`` key).

    Returns the payload {q, scale}; ``dequantize_tree`` inverts it."""
    vec, _ = flatten_to_vector(tree)
    amax = torch.clamp(vec.abs().max(), min=1e-12)
    scale = amax / torch.full_like(amax, 127.0)  # the quotient, not x * (1/127)
    uniform = torch.rand(vec.shape, generator=generator, device=generator.device)
    q = quantize_stochastic_flat(vec.contiguous(), uniform.to(vec.device), scale)
    return {"q": q, "scale": scale}


def quantize_rows(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Row-stacked int8 quantization: x [R, N] f32, scales [R] -> int8 [R, N].

    Deterministic round-half-up: the plane compressors' parity contract
    (stacked == sequential per-client, bitwise) rules out stochastic bits."""
    return quantize_rows_flat(x.float().contiguous(), scales.float().contiguous())


def quantize_rows_leaves(xs, scales):
    """``quantize_rows`` over every leaf of a tree at once: xs [R, n_l] and
    scales [R] per leaf, in ``tree_leaves`` order -> int8 [R, n_l] per leaf.
    One kernel launch for all of them (per ``MAX_LEAVES`` leaves)."""
    return _quantize.quantize_rows_leaves([x.float().contiguous() for x in xs],
                                          [s.float().contiguous() for s in scales])


def downcast_bf16_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-stacked f32 -> bf16 downcast (the bf16 wire compressor)."""
    return downcast_bf16_rows_flat(x.float().contiguous())


def downcast_bf16_rows_leaves(xs):
    """``downcast_bf16_rows`` over every leaf of a tree at once: xs [R, n_l]
    per leaf, in ``tree_leaves`` order -> bf16 [R, n_l] per leaf. One kernel
    launch for all of them (per ``MAX_LEAVES`` leaves)."""
    return _quantize.downcast_bf16_rows_leaves([x.float().contiguous() for x in xs])


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor, *, num_segments: int):
    """Per-segment reduction: sum ``values[i]`` into ``segment_ids[i]``.

    The device transport plane's byte accounting: per-scenario delivered
    wire bytes from flat [S*C] row outcomes without leaving the device.
    Oracle: ``repro_torch.kernels.ref.segment_sum_ref``."""
    out = torch.zeros((num_segments,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_add_(0, segment_ids, values)


def dequantize_tree(payload, template):
    _, meta = flatten_to_vector(template)
    return unflatten_from_vector(dequantize_flat(payload["q"], payload["scale"]), meta)


def _flash_local(q, k, v, causal, window):
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    qf = q.transpose(1, 2).reshape(B * Hq, Sq, D).contiguous()
    kf = k.transpose(1, 2).reshape(B * Hkv, Skv, D).contiguous()
    vf = v.transpose(1, 2).reshape(B * Hkv, Skv, Dv).contiguous()
    out = flash_attention_grad(qf, kf, vf, causal=causal, window=window)
    return out.reshape(B, Hq, Sq, Dv).transpose(1, 2)


def flash_attention(q, k, v, *, causal=True, window=0):
    """q [B, Sq, Hq, D]; k [B, Skv, Hkv, D]; v [B, Skv, Hkv, Dv] ->
    [B, Sq, Hq, Dv], scores scaled by D^-0.5.

    GQA by head-major flattening: [B, S, H, D] -> [B*H, S, D], the kernel
    reading kv head bh // G (no repeated copy of k and v). Differentiable
    in q, k and v (``flash_attention.flash_attention_op``). On DTensors
    (a sharded step) each rank runs the kernel on its own shard under
    ``local_map`` (``_flash_sharded``)."""
    if isinstance(q, DTensor):
        return _flash_sharded(q, k, v, causal, window)
    return _flash_local(q, k, v, causal, window)


def _flash_sharded(q, k, v, causal, window):
    """Attention is independent per (batch, head): batch stays on the mesh
    axes that shard it, heads on the axis that shards q's heads, and a
    sharded sequence or head dim is gathered first. The flattening to
    [B*H, S, D] runs inside ``local_map`` with the kernel, so it never
    merges two sharded dims of a DTensor. Where k / v hold too few heads
    for q's head split, they stay whole on that axis and each rank takes
    the kv heads its q heads read (their gradients are then partial sums
    over the axis)."""
    mesh = q.device_mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    G = Hq // Hkv
    q_pl, kv_pl, kv_grad, head_axes = [], [], [], []
    for i, pl in enumerate(q.placements):
        if pl.is_shard(0):
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
            kv_grad.append(Shard(0))
        elif pl.is_shard(2):
            q_pl.append(Shard(2))
            head_axes.append(i)
            if Hkv % mesh.size(i) == 0 and (Hq // mesh.size(i)) % G == 0:
                kv_pl.append(Shard(2))
                kv_grad.append(Shard(2))
            else:
                kv_pl.append(Replicate())
                kv_grad.append(Partial())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            kv_grad.append(Replicate())
    assert len(head_axes) <= 1, q.placements
    pick = None
    if head_axes and isinstance(kv_pl[head_axes[0]], Replicate):
        ax = head_axes[0]
        Hl = Hq // mesh.size(ax)
        first = mesh.get_local_rank(ax) * Hl
        pick = torch.div(first + torch.arange(Hl, device=q.device), G, rounding_mode="floor")

    def local(ql, kl, vl):
        if pick is not None:  # the kv heads this rank's q heads read
            kl, vl = kl.index_select(2, pick), vl.index_select(2, pick)
        return _flash_local(ql, kl, vl, causal, window)

    q = q.redistribute(mesh, q_pl)
    k, v = k.redistribute(mesh, kv_pl), v.redistribute(mesh, kv_pl)
    fn = local_map(local, out_placements=(tuple(q_pl),),
                   in_placements=(tuple(q_pl), tuple(kv_pl), tuple(kv_pl)),
                   in_grad_placements=(tuple(q_pl), tuple(kv_grad), tuple(kv_grad)),
                   device_mesh=mesh)
    return fn(q, k, v)


def _swiglu_local(x, w_gate, w_up, w_down):
    lead = x.shape[:-1]
    d = x.shape[-1]
    out = swiglu_grad(x.reshape(-1, d).contiguous(), w_gate.contiguous(), w_up.contiguous(),
                      w_down.contiguous())
    return out.reshape(*lead, d)


def swiglu(x, w_gate, w_up, w_down):
    """Fused SwiGLU over [..., d] inputs, differentiable in x and the three
    weights (``swiglu.swiglu_op``). On DTensors each rank runs the kernel
    on its own shard under ``local_map`` (``_swiglu_sharded``)."""
    if isinstance(x, DTensor):
        return _swiglu_sharded(x, w_gate, w_up, w_down)
    return _swiglu_local(x, w_gate, w_up, w_down)


def _swiglu_sharded(x, w_gate, w_up, w_down):
    """Rows stay on the axes that shard x's leading dim; the ffn dim stays
    on the axis that shards it in the weights (w_gate / w_up by column,
    w_down by row), so each rank's output is a partial sum over that axis
    (``Partial``). Any other shard is gathered first: the sequence of a
    sequence-parallel x, and the embed (FSDP) shard of the weights, whose
    gradients come back reduce-scattered."""
    mesh = x.device_mesh
    x_pl, x_grad, g_pl, d_pl, w_grad_g, w_grad_d, out_pl = [], [], [], [], [], [], []
    for i, (xp, wp) in enumerate(zip(x.placements, w_gate.placements)):
        rows = xp.is_shard(0) and x.ndim > 1
        ffn = wp.is_shard(1) and not rows
        x_pl.append(Shard(0) if rows else Replicate())
        x_grad.append(Shard(0) if rows else (Partial() if ffn else Replicate()))
        g_pl.append(Shard(1) if ffn else Replicate())
        d_pl.append(Shard(0) if ffn else Replicate())
        w_grad_g.append(Shard(1) if ffn else (Partial() if rows else Replicate()))
        w_grad_d.append(Shard(0) if ffn else (Partial() if rows else Replicate()))
        out_pl.append(Shard(0) if rows else (Partial() if ffn else Replicate()))
    x = x.redistribute(mesh, x_pl)
    w_gate, w_up = w_gate.redistribute(mesh, g_pl), w_up.redistribute(mesh, g_pl)
    w_down = w_down.redistribute(mesh, d_pl)
    fn = local_map(_swiglu_local, out_placements=(tuple(out_pl),),
                   in_placements=(tuple(x_pl), tuple(g_pl), tuple(g_pl), tuple(d_pl)),
                   in_grad_placements=(tuple(x_grad), tuple(w_grad_g), tuple(w_grad_g),
                                       tuple(w_grad_d)),
                   device_mesh=mesh)
    return fn(x, w_gate, w_up, w_down)
