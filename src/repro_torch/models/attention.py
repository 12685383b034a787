"""GQA, cross and MLA attention for serving and training (the port of
``repro/models/attention.py``).

- Prefill runs ``kernels.ops.flash_attention``: the hand-written flash
  kernel on the card, its plain version on the CPU. It computes exactly the
  reference's ``full_attention`` for a prefill (causal, windowed, or
  non-causal when the caller says so, as Whisper's encoder does; no query
  offset).
- Cross attention (``gqa_forward(cross_kv=(k, v))``, the encoder-decoder's)
  projects q with no rope and no norm and runs the flash kernel with
  ``causal=False`` against the precomputed k and v, in prefill, training
  and decode alike: with no mask, a one-token query over the encoder's
  keys is exactly the kernel's function.
- ``decode_attention`` (self attention against a cache) stays plain torch
  (einsum + softmax), as the reference computes it outside any Pallas
  kernel: the flash kernel's causal mask is top-left aligned with no query
  offset, so a one-token query at position ``pos`` is not its case.
- ``full_attention`` is the materialized form, kept as the oracle.

Caches are dicts of tensors; the per-layer views of the stacked cache are
written IN PLACE (the reference returns updated copies), which keeps one
cache in device memory. A sliding-window model's cache is a ring of
``Smax = min(max_len, window)`` slots with a ``kv_pos`` leaf (the absolute
position in each slot, -1 when empty): position ``p`` lives at slot
``p % Smax``. A prompt longer than the ring keeps its last ``Smax`` tokens
at those slots. The reference puts them at slots ``0..Smax-1`` instead,
which agrees with its own decode only when ``S % Smax == 0``, so its decode
then overwrites a token still inside the window; the port keeps the ring's
rule (ROADMAP Queue 3, C5). A cache without a ring that is shorter than
the prompt keeps the last ``Smax`` tokens at slots ``0..Smax-1``, as the
reference does.

MLA (DeepSeek-V2) keeps the reference's two paths. Prefill and training
run the naive form: the compressed ``c_kv`` is expanded to per-head k_nope
and v, k_pe (one rope head shared by all heads) is broadcast beside it,
and the flash kernel runs at D = qk_nope + qk_rope (192) with Dv =
v_head_dim (128), scale D^-0.5. Every MLA projection is one 2-D product
(``aten.mm``), so remat "block" keeps them all. Its cache holds the normed
``c_kv`` and the roped ``k_pe`` per position, written in place. Decode is
the absorbed form in plain torch, in the reference's rounding order:
``q_abs = q_nope W_uk`` in the activation dtype, the scores against
``c_kv`` and ``k_pe`` in f32, the probabilities cast to the activation
dtype before the product with ``c_kv``, then ``W_uv`` and ``wo``.

On a mesh (DTensors, ``launch.steps``) the prefill pads q, k and v heads
to a multiple of the "model" axis (``_pad_heads_for_tp``, the reference's)
and pins them with ``heads_constraint`` at the reference's sites; the
padded q heads are sliced off the output. The cache writes go to each
rank's own shard (``_write_prefix``, ``_write_slots``): a sharded cache
is written in place as a plain one is.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import ops
from repro_torch.models.base import (
    Ctx, apply_rope, dtype_of, heads_constraint, like_shards, linear, matmul, per_batch_shard,
    rms_norm, shard_view,
)

NEG_INF = -1e30


def repeat_kv(k, n_heads: int):
    """[B,S,Hkv,D] -> [B,S,H,D]: kv head j serves query heads j*G .. j*G+G-1."""
    Hkv = k.shape[2]
    if Hkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // Hkv, dim=2)


def _pad_heads_for_tp(cfg, q, k, v):
    """Zero-pad q (and kv) heads up to a multiple of the "model" axis so
    attention stays head-sharded where the head count does not divide it
    (phi3-medium's 40, starcoder2's 24, whisper's 8 on a 16-way axis).
    The caller slices the padded q heads' outputs away; real q heads keep
    reading their kv heads because H_pad / Hkv_pad keeps the group order.
    Returns (q, k, v, real q head count)."""
    nm = cfg.act_shard_model
    H, Hkv = q.shape[2], k.shape[2]
    if not nm or H % nm == 0:
        return q, k, v, H
    H_pad = ((H + nm - 1) // nm) * nm
    Hkv_pad = next(h for h in range(Hkv, H_pad + 1) if H_pad % h == 0)
    return _pad_dim2(q, H_pad - H), _pad_dim2(k, Hkv_pad - Hkv), _pad_dim2(v, Hkv_pad - Hkv), H


def _pad_dim2(t, n: int):
    """``n`` zero heads after t's heads (dim 2), on each rank's shard of a
    DTensor whose heads are whole."""
    if not n:
        return t
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, n))  # noqa: E731
    if not isinstance(t, DTensor):
        return pad(t)
    assert not any(p.is_shard(2) for p in t.placements), t.placements
    pl = tuple(t.placements)
    return local_map(pad, out_placements=(pl,), in_placements=(pl,), device_mesh=t.device_mesh)(t)


def full_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Materialized attention. q [B,Sq,H,D], k/v [B,Skv,Hkv,D] (GQA kv
    repeated internally); query i sits at absolute position q_offset + i."""
    B, Sq, Hq, D = q.shape
    scale = D ** -0.5
    k = repeat_kv(k, Hq)
    v = repeat_kv(v, Hq)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    Skv = k.shape[1]
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window and window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    scores = torch.where(mask[None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def decode_attention(q, k_cache, v_cache, *, pos, window=0, kv_positions=None):
    """One-token attention against a cache. q [B,1,Hq,D]; k_cache/v_cache
    [B,Smax,Hkv,D]; pos [B] the query's absolute position. ``kv_positions``
    [B,Smax] holds each slot's absolute position (-1 empty) for a ring;
    when None the slot index is the absolute position."""
    B, _, Hq, D = q.shape
    Smax = k_cache.shape[1]
    scale = D ** -0.5
    k = repeat_kv(k_cache, Hq)
    v = repeat_kv(v_cache, Hq)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale  # [B,Hq,1,Smax]
    if kv_positions is None:
        kv_positions = torch.arange(Smax, device=q.device)[None].expand(B, Smax)
    valid = (kv_positions <= pos[:, None]) & (kv_positions >= 0)
    if window and window > 0:
        valid &= pos[:, None] - kv_positions < window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


# ---------------------------------------------------------------------------
# GQA block (params + forward for prefill / decode)
# ---------------------------------------------------------------------------


def gqa_params(ctx: Ctx, cfg, stacked: Optional[int] = None):
    d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    lead = () if stacked is None else (stacked,)
    la = () if stacked is None else ("layers",)
    p = {
        "wq": ctx.param(lead + (d, H, hd), la + ("embed", "heads", "head_dim")),
        "wk": ctx.param(lead + (d, Hkv, hd), la + ("embed", "kv_heads", "head_dim")),
        "wv": ctx.param(lead + (d, Hkv, hd), la + ("embed", "kv_heads", "head_dim")),
        "wo": ctx.param(lead + (H, hd, d), la + ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = ctx.param(lead + (hd,), la + ("head_dim",), init="ones")
        p["k_norm"] = ctx.param(lead + (hd,), la + ("head_dim",), init="ones")
    return p


def _heads(x, w):
    """x [B,S,d] @ w [d,H,k] -> [B,S,H,k] (one matmul over the flattened heads)."""
    d, H, k = w.shape
    return matmul(x, w.to(x.dtype).reshape(d, H * k)).reshape(*x.shape[:-1], H, k)


def _project_qkv(cfg, p, x, positions):
    q = _heads(x, p["wq"])
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(out, wo):
    """out [B,S,H,k] @ wo [H,k,d] -> [B,S,d]."""
    H, k, d = wo.shape
    return matmul(out.reshape(*out.shape[:-2], H * k), wo.to(out.dtype).reshape(H * k, d))


def gqa_forward(cfg, p, x, *, positions=None, cache=None, decode=False, cross_kv=None,
                causal=None):
    """Returns (out [B,S,d], cache_or_None).

    - prefill: cache is None or an empty cache dict, whose k/v (and a
      ring's kv_pos) are filled in place: slots 0..S-1 when the prompt
      fits, else its last Smax tokens (see the module docstring).
      ``causal`` overrides ``cfg.causal`` (the encoder's ``False``).
    - decode: x is [B,1,d]; cache holds k/v [B,Smax,Hkv,D], pos [B] and a
      ring's kv_pos [B,Smax]; the new k/v are written in place at slot
      ``pos % Smax`` on a ring, else ``min(pos, Smax-1)``, and pos advances.
    - cross_kv: the precomputed (k, v) [B,Se,Hkv,D] of an encoder's states;
      x attends to all of them, with no mask, in prefill and decode alike.
    """
    B, S, d = x.shape
    causal = cfg.causal if causal is None else causal
    if cross_kv is not None:
        k, v = cross_kv
        out = ops.flash_attention(_heads(x, p["wq"]), k, v, causal=False)
        return _out_proj(out, p["wo"]), None
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]

    if not decode:
        q, k, v = _project_qkv(cfg, p, x, positions)
        new_cache = None
        if cache is not None:
            _prefill_cache(cache, k, v, positions)
            new_cache = cache
        qp, kp, vp, H = _pad_heads_for_tp(cfg, q, k, v)
        qp, kp, vp = (heads_constraint(cfg, t) for t in (qp, kp, vp))
        out = ops.flash_attention(qp, kp, vp, causal=causal, window=cfg.sliding_window)
        out = heads_constraint(cfg, out)
        if out.shape[2] != H:
            out = out[:, :, :H]
        return _out_proj(out, p["wo"]), new_cache

    # ---- decode ----
    pos = cache["pos"]  # [B] absolute position of this query token
    q, k, v = _project_qkv(cfg, p, x, positions=pos[:, None])
    Smax = cache["k"].shape[1]
    ring = bool(cfg.sliding_window) and Smax <= cfg.sliding_window
    slot = (pos % Smax if ring else torch.clamp(pos, max=Smax - 1)).long()
    _write_slots(cache["k"], slot, k[:, 0])
    _write_slots(cache["v"], slot, v[:, 0])
    kv_pos = cache.get("kv_pos")
    if kv_pos is not None:
        _write_slots(kv_pos, slot, pos)
    # one query row against its own cache row: on a mesh each rank runs its rows
    out = per_batch_shard(
        lambda q, k, v, pos, kvp: decode_attention(q, k, v, pos=pos, window=cfg.sliding_window,
                                                   kv_positions=kvp),
        (q, cache["k"], cache["v"], pos, kv_pos))
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return _out_proj(out, p["wo"]), new_cache


def _prefill_cache(cache, k, v, positions):
    """Write a prompt's k / v (and positions, on a ring) into an empty
    cache in place."""
    B, S = k.shape[:2]
    Smax = cache["k"].shape[1]
    pw = positions.to(torch.int32).expand(B, S)
    if S > Smax:
        # the last Smax tokens; on a ring each at slot p % Smax, which rolls
        # them by S % Smax (the reference's layout when that is 0)
        shift = S % Smax if "kv_pos" in cache else 0
        k, v, pw = (torch.roll(t[:, -Smax:], shift, dims=1) for t in (k, v, pw))
    _write_prefix(cache["k"], k)
    _write_prefix(cache["v"], v)
    if "kv_pos" in cache:
        _write_prefix(cache["kv_pos"], pw)


def _write_prefix(dst, vals):
    """dst[:, :S] = vals (S = vals.shape[1]) in place, each rank writing
    the part of the slots its shard of a DTensor ``dst`` holds."""
    local, off = shard_view(dst)
    vals = like_shards(vals, dst, [d for d in range(dst.ndim) if d != 1])
    lo, hi = off[1], off[1] + local.shape[1]
    a, b = max(lo, 0), min(hi, vals.shape[1])
    if a < b:
        with torch.no_grad():
            local[:, a - lo:b - lo] = vals[:, a:b].to(local.dtype)


def _write_slots(dst, slot, vals):
    """dst[b, slot[b]] = vals[b] for every row b, in place, each rank
    writing the rows and slots its shard of a DTensor ``dst`` holds."""
    local, off = shard_view(dst)
    vals = like_shards(vals[:, None], dst, [d for d in range(dst.ndim) if d != 1])[:, 0]
    slot = like_shards(slot, dst, (0,))
    rel = slot - off[1]
    mine = (rel >= 0) & (rel < local.shape[1])
    rows = torch.arange(local.shape[0], device=local.device)[mine]
    with torch.no_grad():
        local[rows, rel[mine]] = vals[mine].to(local.dtype)


def gqa_cache_spec(cfg, batch: int, max_len: int, stacked: int):
    """{name: (shape, dtype)} of the stacked-by-layer GQA cache: a ring of
    ``min(max_len, window)`` slots with ``kv_pos`` for a sliding window."""
    hd = cfg.resolved_head_dim
    Smax = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    dt = dtype_of(cfg.dtype)
    spec = {
        "k": ((stacked, batch, Smax, cfg.n_kv_heads, hd), dt),
        "v": ((stacked, batch, Smax, cfg.n_kv_heads, hd), dt),
        "pos": ((stacked, batch), torch.int32),
    }
    if cfg.sliding_window and Smax <= cfg.sliding_window:
        spec["kv_pos"] = ((stacked, batch, Smax), torch.int32)
    return spec


def gqa_cache_init(cfg, batch: int, max_len: int, stacked: int, device=None):
    spec = gqa_cache_spec(cfg, batch, max_len, stacked)
    out = {k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, dt) in spec.items()}
    if "kv_pos" in out:
        out["kv_pos"].fill_(-1)  # -1 = empty slot
    return out


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V2): naive prefill / training path + absorbed decode
# ---------------------------------------------------------------------------


def mla_params(ctx: Ctx, cfg, stacked: Optional[int] = None):
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    lead = () if stacked is None else (stacked,)
    la = () if stacked is None else ("layers",)
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "w_dq": ctx.param(lead + (d, m.q_lora_rank), la + ("embed", "lora")),
        "q_norm": ctx.param(lead + (m.q_lora_rank,), la + ("lora",), init="ones"),
        "w_uq": ctx.param(lead + (m.q_lora_rank, H, qk), la + ("lora", "heads", "qk_dim")),
        "w_dkv": ctx.param(lead + (d, m.kv_lora_rank + m.qk_rope_dim), la + ("embed", "lora")),
        "kv_norm": ctx.param(lead + (m.kv_lora_rank,), la + ("lora",), init="ones"),
        "w_uk": ctx.param(lead + (m.kv_lora_rank, H, m.qk_nope_dim),
                          la + ("lora", "heads", "qk_dim")),
        "w_uv": ctx.param(lead + (m.kv_lora_rank, H, m.v_head_dim),
                          la + ("lora", "heads", "head_dim")),
        "wo": ctx.param(lead + (H, m.v_head_dim, d), la + ("heads", "head_dim", "embed")),
    }


def mla_forward(cfg, p, x, *, positions=None, cache=None, decode=False):
    """Returns (out [B,S,d], cache_or_None).

    - prefill: the naive form through the flash kernel; an empty cache's
      ``c_kv`` [B,Smax,kv_lora] and ``k_pe`` [B,Smax,rope] get slots
      0..S-1 in place.
    - decode: x is [B,1,d]; the new ``c_kv`` and roped ``k_pe`` are written
      in place at slot ``min(pos, Smax-1)``, the absorbed form attends to
      slots 0..pos, and pos advances.
    """
    m = cfg.mla
    B, S, d = x.shape
    H = cfg.n_heads
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]

    cq = rms_norm(linear(x, p["w_dq"]), p["q_norm"], cfg.norm_eps)
    q = _heads(cq, p["w_uq"])
    q_nope, q_pe = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    kv_a = linear(x, p["w_dkv"])  # [B,S,kv_lora+rope]
    c_kv = rms_norm(kv_a[..., : m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_pe = kv_a[..., m.kv_lora_rank:][:, :, None, :]  # [B,S,1,rope], shared by the heads

    if not decode:
        q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
        k_pe = apply_rope(k_pe, positions, cfg.rope_theta)
        k_nope = _heads(c_kv, p["w_uk"])
        v = _heads(c_kv, p["w_uv"])
        k_full = torch.cat([k_nope, k_pe.expand(B, S, H, m.qk_rope_dim)], dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        q_full, k_full, v = (heads_constraint(cfg, t) for t in (q_full, k_full, v))
        out = ops.flash_attention(q_full, k_full, v, causal=True)  # scale: D^-0.5 of q_full
        out = heads_constraint(cfg, out)
        if cache is not None:
            _write_prefix(cache["c_kv"], c_kv)
            _write_prefix(cache["k_pe"], k_pe[:, :, 0])
        return _out_proj(out, p["wo"]), cache

    # ---- absorbed decode
    pos = cache["pos"]  # [B] absolute position of this query token
    q_pe = apply_rope(q_pe, pos[:, None], cfg.rope_theta)
    k_pe = apply_rope(k_pe, pos[:, None], cfg.rope_theta)
    Smax = cache["c_kv"].shape[1]
    slot = torch.clamp(pos, max=Smax - 1).long()
    _write_slots(cache["c_kv"], slot, c_kv[:, 0])
    _write_slots(cache["k_pe"], slot, k_pe[:, 0, 0])
    dt = x.dtype
    c_all = cache["c_kv"].to(dt)
    q_abs = torch.einsum("bshk,lhk->bshl", q_nope, p["w_uk"].to(dt))  # [B,1,H,kv_lora]
    s_nope = torch.einsum("bshl,bkl->bhsk", q_abs.float(), c_all.float())
    s_pe = torch.einsum("bshr,bkr->bhsk", q_pe.float(), cache["k_pe"].float())
    s = (s_nope + s_pe) * scale  # [B,H,1,Smax]
    valid = torch.arange(Smax, device=x.device)[None] <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    prob = torch.softmax(s, dim=-1)
    ctx_l = torch.einsum("bhsk,bkl->bshl", prob.to(dt), c_all)
    out = torch.einsum("bshl,lhk->bshk", ctx_l, p["w_uv"].to(dt))
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return _out_proj(out, p["wo"]), new_cache


def mla_cache_spec(cfg, batch: int, max_len: int, stacked: int):
    """{name: (shape, dtype)} of the stacked-by-layer MLA cache."""
    m = cfg.mla
    dt = dtype_of(cfg.dtype)
    return {
        "c_kv": ((stacked, batch, max_len, m.kv_lora_rank), dt),
        "k_pe": ((stacked, batch, max_len, m.qk_rope_dim), dt),
        "pos": ((stacked, batch), torch.int32),
    }


def mla_cache_init(cfg, batch: int, max_len: int, stacked: int, device=None):
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in mla_cache_spec(cfg, batch, max_len, stacked).items()}
