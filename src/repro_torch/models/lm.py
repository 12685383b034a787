"""Decoder-LM assembly for serving (the port of the dense part of
``repro/models/lm.py``).

The layer stack is organized as *segments*, runs of structurally identical
blocks whose params are stacked on a leading layer axis, as in the
reference; the port runs a segment as a Python loop over layers and
indexes the stacked leaves per layer. Only the dense GQA block with
RMSNorm is ported: MoE, MLA, RWKV, LayerNorm and the vision stub raise
(ROADMAP Queue 1, item 15), and ``lm_loss`` / ``loss_from_hidden`` come
with training.

Caches are updated IN PLACE: ``lm_prefill`` and ``lm_decode_step`` return
the cache they were given (or built), written through, where the
reference returns an updated copy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.base import Ctx, apply_norm, dtype_of, norm_params


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1, item 15)")


# ---------------------------------------------------------------------------
# Segment layout
# ---------------------------------------------------------------------------


def segments(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Return [(block_kind, count), ...] covering cfg.n_layers."""
    if cfg.ssm is not None:
        raise _not_ported(f"the {cfg.ssm.kind} block")
    if cfg.moe is not None and cfg.moe.num_experts > 0:
        raise _not_ported("mixture of experts")
    if cfg.attn_kind != "gqa":
        raise _not_ported(f"attention kind '{cfg.attn_kind}'")
    if cfg.frontend != "none":
        raise _not_ported(f"the '{cfg.frontend}' frontend")
    if cfg.norm_kind != "rmsnorm":
        raise _not_ported(f"norm kind '{cfg.norm_kind}'")
    return [("dense", cfg.n_layers)]


def _block_params(ctx: Ctx, cfg: ModelConfig, kind: str, count: int):
    return {
        "ln1": norm_params(ctx, cfg, cfg.d_model, stacked=count),
        "ln2": norm_params(ctx, cfg, cfg.d_model, stacked=count),
        "attn": attn.gqa_params(ctx, cfg, stacked=count),
        "mlp": mlp_mod.mlp_params(ctx, cfg, d_ff=cfg.d_ff, stacked=count),
    }


def _block_apply(cfg, kind, p, x, cache, *, decode, positions):
    """One dense block. Returns (x, new_cache)."""
    h = apply_norm(cfg, x, p["ln1"])
    y, new_cache = attn.gqa_forward(cfg, p["attn"], h, positions=positions, cache=cache,
                                    decode=decode)
    x = x + y
    h = apply_norm(cfg, x, p["ln2"])
    x = x + mlp_mod.mlp_forward(cfg, p["mlp"], h)
    return x, new_cache


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _run_segment(cfg, kind, params, x, caches, *, decode, positions):
    """Run one segment layer by layer. ``caches`` (stacked by layer, or
    None) is written in place: each layer's view is filled by the block,
    and a leaf the block replaces (decode's ``pos``) is copied back."""
    count = params["ln1"]["scale"].shape[0]
    for i in range(count):
        layer_cache = _index(caches, i) if caches is not None else None
        x, new_cache = _block_apply(cfg, kind, _index(params, i), x, layer_cache,
                                    decode=decode, positions=positions)
        if caches is not None:
            for key, val in new_cache.items():
                if val is not layer_cache[key]:
                    caches[key][i] = val
    return x, caches


# ---------------------------------------------------------------------------
# Whole-model params / forward
# ---------------------------------------------------------------------------


def lm_params(ctx: Ctx, cfg: ModelConfig):
    V, d = cfg.padded_vocab, cfg.d_model
    p: Dict[str, Any] = {
        "embed": ctx.param((V, d), ("vocab", "embed"), init="normal", scale=0.02),
        "final_norm": norm_params(ctx, cfg, d),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = ctx.param((d, V), ("embed", "vocab"))
    for i, (kind, count) in enumerate(segments(cfg)):
        p[f"seg{i}"] = _block_params(ctx, cfg, kind, count)
    return p


def _embed_inputs(cfg, params, batch):
    """Token embedding. Returns x [B,S,d] in the activation dtype."""
    if "patch_embed" in batch:
        raise _not_ported("the vision stub's patch embeddings")
    tokens = batch["tokens"].long()
    return params["embed"][tokens].to(dtype_of(cfg.dtype))


def lm_forward(cfg, params, batch, *, caches=None, decode=False):
    """Returns (hidden [B,S,d], caches); caches are written in place."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = None if decode else torch.arange(S, device=x.device)[None, :]
    for i, (kind, count) in enumerate(segments(cfg)):
        seg_cache = caches.get(f"seg{i}") if caches is not None else None
        x, _ = _run_segment(cfg, kind, params[f"seg{i}"], x, seg_cache, decode=decode,
                            positions=positions)
    x = apply_norm(cfg, x, params["final_norm"])
    return x, caches


def unembed(cfg, params, h):
    """h [..., d] -> f32 logits [..., V], summed in f32.

    A bf16 product on the card takes ``torch.mm(..., out_dtype=float32)``,
    so the logits are not rounded to bf16 and the unembedding is never
    copied to f32; PyTorch has no CPU kernel for that call, so on the CPU
    both operands are upcast per call (exact: bf16 products are exact in
    f32)."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    w = w.to(h.dtype)
    h2 = h.reshape(-1, h.shape[-1])
    if h.dtype == torch.float32:
        out = torch.mm(h2, w)
    elif h.is_cuda:
        out = torch.mm(h2, w, out_dtype=torch.float32)
    else:
        out = torch.mm(h2.float(), w.float())
    return out.reshape(*h.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def lm_cache(cfg, batch: int, max_len: int, device=None):
    return {
        f"seg{i}": attn.gqa_cache_init(cfg, batch, max_len, count, device=device)
        for i, (kind, count) in enumerate(segments(cfg))
    }


def lm_prefill(cfg, params, batch, max_len: int):
    """Run the prompt, fill caches, return (last_logits [B,V] f32, caches)."""
    B, S = batch["tokens"].shape
    caches = lm_cache(cfg, B, max_len, device=params["embed"].device)
    h, caches = lm_forward(cfg, params, batch, caches=caches)
    for c in caches.values():
        c["pos"].fill_(S)
    logits = unembed(cfg, params, h[:, -1:])[:, 0]
    return logits, caches


def lm_decode_step(cfg, params, caches, tokens):
    """tokens [B,1] -> (logits [B,V] f32, caches updated in place)."""
    h, caches = lm_forward(cfg, params, {"tokens": tokens}, caches=caches, decode=True)
    logits = unembed(cfg, params, h)[:, 0]
    return logits, caches
