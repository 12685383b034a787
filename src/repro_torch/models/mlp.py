"""MLP and mixture-of-experts blocks (the port of ``repro/models/mlp.py``).

Dense: ``swiglu`` runs ``kernels.ops.swiglu``: the hand-written fused
kernel on the card, its plain version on the CPU. It computes the
reference's ``mlp_forward`` for ``mlp_kind == "swiglu"`` (asserted in
``tests/test_kernels.py``). ``gelu`` stays plain torch.

Mixture of experts: ``moe_forward`` dispatches on
``moe_sharded.pick_moe_path`` as the reference does; on a mesh that is one
of ``moe_sharded``'s expert-parallel paths. The two implementations
without a mesh:

- ``gather``: each (token, slot) gets its place in its expert from a
  cumsum over the flat [T*k] order (token-major, slot-minor); places past
  the capacity go to an overflow row and are dropped. The tokens are
  scattered into an [E, C, d] buffer, the experts run as batched products,
  and each token's k contributions are gathered back, scaled by its gates
  and summed (one reshape-and-sum over k: for k = 2 one rounding of
  c0 + c1, what the reference's scatter-add from zero gives in any order).
- ``einsum``: GShard's one-hot dispatch and combine tensors [T, E, C],
  places counted per slot as the reference counts them; the dispatch and
  the combine are plain 2-D products, as the reference's einsums have no
  batch dimension.

The expert products are plain ``torch.bmm`` in the activation dtype,
rounding g, u and their product as the reference's ``_expert_ffn`` does
(the SwiGLU kernel would round only the hidden). The router works in f32;
ties in top-k go to the lower expert index, as ``jax.lax.top_k`` does.
Both paths return the Switch load-balance loss over the top-1 choices.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.models.base import Ctx, gelu, linear, matmul, silu


def mlp_params(ctx: Ctx, cfg, d_ff: Optional[int] = None, stacked: Optional[int] = None):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    lead = () if stacked is None else (stacked,)
    la = () if stacked is None else ("layers",)
    if cfg.mlp_kind == "swiglu":
        return {
            "w_gate": ctx.param(lead + (d, ff), la + ("embed", "ffn")),
            "w_up": ctx.param(lead + (d, ff), la + ("embed", "ffn")),
            "w_down": ctx.param(lead + (ff, d), la + ("ffn", "embed")),
        }
    return {
        "w_up": ctx.param(lead + (d, ff), la + ("embed", "ffn")),
        "b_up": ctx.param(lead + (ff,), la + ("ffn",), init="zeros"),
        "w_down": ctx.param(lead + (ff, d), la + ("ffn", "embed")),
        "b_down": ctx.param(lead + (d,), la + ("embed",), init="zeros"),
    }


def mlp_forward(cfg, p, x):
    if cfg.mlp_kind == "swiglu":
        dt = x.dtype
        return ops.swiglu(x, p["w_gate"].to(dt), p["w_up"].to(dt), p["w_down"].to(dt))
    h = gelu(linear(x, p["w_up"]) + p["b_up"].to(x.dtype))
    return linear(h, p["w_down"]) + p["b_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------


def moe_params(ctx: Ctx, cfg, stacked: Optional[int] = None):
    m = cfg.moe
    d, E, ff = cfg.d_model, m.num_experts, m.expert_d_ff
    lead = () if stacked is None else (stacked,)
    la = () if stacked is None else ("layers",)
    p = {
        "router": ctx.param(lead + (d, E), la + ("embed", "experts"), scale=0.02, init="normal"),
        "w_gate": ctx.param(lead + (E, d, ff), la + ("experts", "embed", "ffn")),
        "w_up": ctx.param(lead + (E, d, ff), la + ("experts", "embed", "ffn")),
        "w_down": ctx.param(lead + (E, ff, d), la + ("experts", "ffn", "embed")),
    }
    if m.num_shared:
        sff = m.expert_d_ff * m.num_shared
        p["shared"] = {
            "w_gate": ctx.param(lead + (d, sff), la + ("embed", "ffn")),
            "w_up": ctx.param(lead + (d, sff), la + ("embed", "ffn")),
            "w_down": ctx.param(lead + (sff, d), la + ("ffn", "embed")),
        }
    return p


def capacity(cfg, T: int) -> int:
    """Tokens each expert takes from a call of T tokens (the reference's
    float expression)."""
    m = cfg.moe
    return max(int(m.capacity_factor * m.top_k * T / m.num_experts), 1)


def _router(cfg, p, x):
    """Top-k routing. x [..., d] (on a mesh, any sharding) -> (gates
    [..., k], ids [..., k], aux_loss)."""
    m = cfg.moe
    E = m.num_experts
    logits = matmul(x.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: equal probabilities keep the lower index first
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., : m.top_k], ids[..., : m.top_k]
    gates = gates / torch.clamp(torch.sum(gates, dim=-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * sum_e (fraction_tokens_e * mean_prob_e)
    tokens = tuple(range(x.ndim - 1))
    frac = torch.mean(F.one_hot(ids[..., 0], E).float(), dim=tokens)  # top-1 counts
    mean_prob = torch.mean(probs, dim=tokens)
    aux = E * torch.sum(frac * mean_prob)
    return gates, ids, aux


def _expert_ffn(cfg, w_gate, w_up, w_down, xb):
    """Batched per-expert SwiGLU. xb [E, C, d] -> [E, C, d]."""
    dt = xb.dtype
    h = torch.bmm(xb, w_gate.to(dt))
    u = torch.bmm(xb, w_up.to(dt))
    return torch.bmm(silu(h) * u, w_down.to(dt))


def _places(ids, E: int):
    """Each entry's place among the earlier entries routed to the same
    expert (a one-hot cumsum down the rows)."""
    onehot = F.one_hot(ids, E)
    return torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=1)


def _dispatch_local(cfg, x2d, gates, ids, C):
    """Scatter the tokens into an [E, C, d] buffer: each (token, slot) at
    its place in its expert (a cumsum over the flat [T*k] order,
    token-major), places past C to an overflow row that is dropped.
    Returns (buf, dest, token_idx, flat_gates, keep) for the combine."""
    m = cfg.moe
    T, d = x2d.shape
    E, k = m.num_experts, m.top_k
    flat_ids = ids.reshape(-1)  # [T*k], token-major
    token_idx = torch.arange(T, device=x2d.device).repeat_interleave(k)
    pos = _places(flat_ids, E)
    keep = pos < C
    dest = torch.where(keep, flat_ids * C + pos, E * C)  # dropped -> overflow row
    buf = torch.zeros((E * C + 1, d), dtype=x2d.dtype, device=x2d.device)
    buf = buf.index_add(0, dest, x2d[token_idx])
    return buf[: E * C].reshape(E, C, d), dest, token_idx, gates.reshape(-1), keep


def moe_forward_gather(cfg, p, x2d):
    """Sorted scatter/gather dispatch. x2d [T, d] -> ([T, d], aux)."""
    m = cfg.moe
    T, d = x2d.shape
    E, k = m.num_experts, m.top_k
    C = capacity(cfg, T)

    gates, ids, aux = _router(cfg, p, x2d)
    buf, dest, _, flat_gates, keep = _dispatch_local(cfg, x2d, gates, ids, C)
    yb = _expert_ffn(cfg, p["w_gate"], p["w_up"], p["w_down"], buf)
    yb = torch.cat([yb.reshape(E * C, d), torch.zeros((1, d), dtype=x2d.dtype, device=x2d.device)])

    contrib = yb[dest] * (flat_gates * keep)[:, None].to(x2d.dtype)
    return torch.sum(contrib.reshape(T, k, d), dim=1), aux


def moe_forward_einsum(cfg, p, x2d):
    """GShard one-hot dispatch/combine. x2d [T, d] -> ([T, d], aux)."""
    m = cfg.moe
    T, d = x2d.shape
    E, k = m.num_experts, m.top_k
    C = capacity(cfg, T)

    gates, ids, aux = _router(cfg, p, x2d)
    dispatch = torch.zeros((T, E, C), dtype=torch.float32, device=x2d.device)
    combine = torch.zeros((T, E, C), dtype=torch.float32, device=x2d.device)
    for slot in range(k):  # places counted per slot, as the reference counts them
        within = _places(ids[:, slot], E)
        keep = within < C
        oh_c = F.one_hot(torch.clamp(within, max=C - 1), C).float() * keep[:, None]
        d_slot = F.one_hot(ids[:, slot], E).float()[:, :, None] * oh_c[:, None, :]
        dispatch = dispatch + d_slot
        combine = combine + d_slot * gates[:, slot][:, None, None]

    dt = x2d.dtype
    xb = torch.mm(dispatch.to(dt).reshape(T, E * C).T, x2d).reshape(E, C, d)
    yb = _expert_ffn(cfg, p["w_gate"], p["w_up"], p["w_down"], xb)
    out = torch.mm(combine.to(dt).reshape(T, E * C), yb.reshape(E * C, d))
    return out, aux


def moe_forward(cfg, p, x):
    """x [B, S, d] -> (y [B, S, d], aux_loss scalar), on the path
    ``moe_sharded.pick_moe_path`` picks, as the reference dispatches. Without
    a mesh that is ``cfg.moe.impl`` when it names a path, else gather."""
    from repro_torch.models import moe_sharded

    m = cfg.moe
    B, S, d = x.shape
    path = moe_sharded.pick_moe_path(cfg, B, S)
    if path in ("ep_a2a", "ep_local", "local"):
        fn = {"ep_a2a": moe_sharded.moe_forward_ep_a2a, "ep_local": moe_sharded.moe_forward_ep_local,
              "local": moe_sharded.moe_forward_local}[path]
        y, aux = fn(cfg, p, x)
    else:
        fn = moe_forward_einsum if path == "einsum" else moe_forward_gather
        if isinstance(x, DTensor):
            y, aux = moe_sharded.moe_forward_replicated(cfg, p, x, fn)
        else:
            y, aux = fn(cfg, p, x.reshape(B * S, d))
            y = y.reshape(B, S, d)
    if m.num_shared:
        sp = p["shared"]
        y = y + linear(silu(linear(x, sp["w_gate"])) * linear(x, sp["w_up"]), sp["w_down"])
    return y, aux
