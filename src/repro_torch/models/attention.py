"""GQA attention for serving (the port of the GQA half of
``repro/models/attention.py``).

- Prefill runs ``kernels.ops.flash_attention``: the hand-written flash
  kernel on the card, its plain version on the CPU. It computes exactly the
  reference's ``full_attention`` for a prefill (causal or windowed, no
  query offset).
- ``decode_attention`` stays plain torch (einsum + softmax), as the
  reference computes it outside any Pallas kernel: the flash kernel's
  causal mask is top-left aligned with no query offset, so a one-token
  query at position ``pos`` is not its case.
- ``full_attention`` is the materialized form, kept as the oracle.

Caches are dicts of tensors; the per-layer views of the stacked cache are
written IN PLACE (the reference returns updated copies), which keeps one
cache in device memory. MLA, cross attention, the cache of a
sliding-window model (the reference's ring of ``min(max_len, window)``
slots; ``gqa_cache_spec`` refuses it) and the prefill branch for a cache
shorter than the prompt are not ported (ROADMAP Queue 1, item 15) and
raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.base import Ctx, apply_rope, dtype_of, rms_norm

NEG_INF = -1e30


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, item 15)")


def repeat_kv(k, n_heads: int):
    """[B,S,Hkv,D] -> [B,S,H,D]: kv head j serves query heads j*G .. j*G+G-1."""
    Hkv = k.shape[2]
    if Hkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // Hkv, dim=2)


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


def decode_attention(q, k_cache, v_cache, *, pos, window=0):
    """One-token attention against a cache. q [B,1,Hq,D]; k_cache/v_cache
    [B,Smax,Hkv,D]; pos [B] the query's absolute position, slot index =
    absolute position (no ring buffer)."""
    B, _, Hq, D = q.shape
    Smax = k_cache.shape[1]
    scale = D ** -0.5
    k = repeat_kv(k_cache, Hq)
    v = repeat_kv(v_cache, Hq)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale  # [B,Hq,1,Smax]
    kv_positions = torch.arange(Smax, device=q.device)[None].expand(B, Smax)
    valid = kv_positions <= pos[:, None]
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
    return torch.matmul(x, w.to(x.dtype).reshape(d, H * k)).reshape(*x.shape[:-1], H, k)


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
    return torch.matmul(out.reshape(*out.shape[:-2], H * k), wo.to(out.dtype).reshape(H * k, d))


def gqa_forward(cfg, p, x, *, positions=None, cache=None, decode=False, cross_kv=None):
    """Returns (out [B,S,d], cache_or_None).

    - prefill: cache is None or an empty cache dict, whose k/v are filled in
      place at slots 0..S-1.
    - decode: x is [B,1,d]; cache holds k/v [B,Smax,Hkv,D] and pos [B]; the
      new k/v are written in place at slot pos and pos advances by one.
    """
    if cross_kv is not None:
        raise _not_ported("cross attention (encoder-decoder)")
    B, S, d = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]

    if not decode:
        q, k, v = _project_qkv(cfg, p, x, positions)
        new_cache = None
        if cache is not None:
            Smax = cache["k"].shape[1]
            if Smax < S:
                raise _not_ported("prefill into a cache shorter than the prompt")
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
            new_cache = cache
        out = ops.flash_attention(q, k, v, causal=cfg.causal, window=cfg.sliding_window)
        return _out_proj(out, p["wo"]), new_cache

    # ---- decode ----
    pos = cache["pos"]  # [B] absolute position of this query token
    q, k, v = _project_qkv(cfg, p, x, positions=pos[:, None])
    Smax = cache["k"].shape[1]
    slot = torch.clamp(pos, max=Smax - 1).long()
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"], pos=pos, window=cfg.sliding_window)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return _out_proj(out, p["wo"]), new_cache


def gqa_cache_spec(cfg, batch: int, max_len: int, stacked: int):
    """{name: (shape, dtype)} of the stacked-by-layer GQA cache."""
    if cfg.sliding_window:  # the reference's cache is then a ring of min(max_len, window)
        raise _not_ported("the sliding-window ring cache")
    hd = cfg.resolved_head_dim
    dt = dtype_of(cfg.dtype)
    return {
        "k": ((stacked, batch, max_len, cfg.n_kv_heads, hd), dt),
        "v": ((stacked, batch, max_len, cfg.n_kv_heads, hd), dt),
        "pos": ((stacked, batch), torch.int32),
    }


def gqa_cache_init(cfg, batch: int, max_len: int, stacked: int, device=None):
    spec = gqa_cache_spec(cfg, batch, max_len, stacked)
    return {k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, dt) in spec.items()}
