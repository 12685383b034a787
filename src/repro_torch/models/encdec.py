"""Whisper-style encoder-decoder backbone (the port of
``repro/models/encdec.py``).

The audio frontend (log-mel + conv downsampling) is a stub, as in the
reference: the caller supplies precomputed frame embeddings
[B, enc_seq, d_model]. The transformer backbone is real: an encoder of
non-causal self-attention blocks over the frames plus a sinusoidal table,
and a decoder of causal self-attention, cross attention to the encoder's
states and a GELU MLP, each after a LayerNorm. Rope is applied in both
self-attentions, as the reference's ``_project_qkv`` always applies it;
the cross attention's q takes none.

Every attention runs ``kernels.ops.flash_attention`` (the hand-written
kernel on the card, its plain version on the CPU): the encoder's with
``causal=False``, the decoder's self-attention causal in prefill and
training (its decode step attends to the cache in plain torch, as every
GQA decode does), and the cross attention with ``causal=False`` in
prefill, training and decode.

The cache keeps the reference's layout: ``self`` {k, v [L,B,max_len,Hkv,
hd], pos [L,B]} and ``cross_k`` / ``cross_v`` [L,B,Se,Hkv,hd], the
encoder's k / v per decoder layer, computed once at prefill. The self
cache is written in place, as the port's other caches are. Training runs
each encoder and decoder block under ``models.lm``'s remat policy
(``cfg.remat``); the cross k / v are computed outside the blocks, as the
reference computes them outside its scan.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.attention import _heads
from repro_torch.models.base import (
    Ctx, apply_norm, dtype_of, embed_lookup, like_shards, norm_params, seq_constraint,
    shard_view, sinusoidal_positions,
)
from repro_torch.models.lm import _index, _remat_kwargs, _write_back
from repro_torch.utils import tree_unstack

MAX_DEC_POSITIONS = 32768  # sized to the largest non-skipped decode shape


def encdec_params(ctx: Ctx, cfg: ModelConfig):
    V, d = cfg.padded_vocab, cfg.d_model
    Le, Ld = cfg.n_enc_layers, cfg.n_layers

    def enc_stack():
        return {
            "ln1": norm_params(ctx, cfg, d, stacked=Le),
            "attn": attn.gqa_params(ctx, cfg, stacked=Le),
            "ln2": norm_params(ctx, cfg, d, stacked=Le),
            "mlp": mlp_mod.mlp_params(ctx, cfg, stacked=Le),
        }

    def dec_stack():
        return {
            "ln1": norm_params(ctx, cfg, d, stacked=Ld),
            "self_attn": attn.gqa_params(ctx, cfg, stacked=Ld),
            "ln_x": norm_params(ctx, cfg, d, stacked=Ld),
            "cross_attn": attn.gqa_params(ctx, cfg, stacked=Ld),
            "ln2": norm_params(ctx, cfg, d, stacked=Ld),
            "mlp": mlp_mod.mlp_params(ctx, cfg, stacked=Ld),
        }

    return {
        "embed": ctx.param((V, d), ("vocab", "embed"), init="normal", scale=0.02),
        "dec_pos": ctx.param((MAX_DEC_POSITIONS, d), ("seq", "embed"), init="normal", scale=0.01),
        "encoder": enc_stack(),
        "decoder": dec_stack(),
        "enc_norm": norm_params(ctx, cfg, d),
        "final_norm": norm_params(ctx, cfg, d),
    }


def _remat(cfg) -> bool:
    return cfg.remat != "none" and torch.is_grad_enabled()


def _enc_block(cfg, lp, x):
    h = apply_norm(cfg, x, lp["ln1"])
    y, _ = attn.gqa_forward(cfg, lp["attn"], h, causal=False)
    x = x + y
    h = apply_norm(cfg, x, lp["ln2"])
    return x + mlp_mod.mlp_forward(cfg, lp["mlp"], h)


def encode(cfg, params, frames):
    """frames [B, enc_seq, d] (the stub's output) -> encoder states
    [B, enc_seq, d] in the activation dtype."""
    x = frames.to(dtype_of(cfg.dtype))
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device)[None].to(x.dtype)
    for lp in tree_unstack(params["encoder"]):
        if _remat(cfg):
            x = checkpoint(_enc_block, cfg, lp, x, use_reentrant=False, **_remat_kwargs(cfg))
        else:
            x = _enc_block(cfg, lp, x)
    return apply_norm(cfg, x, params["enc_norm"])


def _cross_kv(cfg, dec_params, enc_states):
    """Cross-attention k / v of every decoder layer: ([L,B,Se,Hkv,hd],) * 2."""
    ca = dec_params["cross_attn"]
    k = torch.stack([_heads(enc_states, w) for w in ca["wk"].unbind(0)])
    v = torch.stack([_heads(enc_states, w) for w in ca["wv"].unbind(0)])
    return k, v


def _dec_block(cfg, lp, x, self_cache, cross_k, cross_v, *, decode, positions):
    h = apply_norm(cfg, x, lp["ln1"])
    y, new_cache = attn.gqa_forward(cfg, lp["self_attn"], h, positions=positions,
                                    cache=self_cache, decode=decode)
    x = x + y
    h = apply_norm(cfg, x, lp["ln_x"])
    y, _ = attn.gqa_forward(cfg, lp["cross_attn"], h, cross_kv=(cross_k, cross_v))
    x = x + y
    h = apply_norm(cfg, x, lp["ln2"])
    return x + mlp_mod.mlp_forward(cfg, lp["mlp"], h), new_cache


def _dec_block_train(cfg, lp, x, cross_k, cross_v, positions):
    return _dec_block(cfg, lp, x, None, cross_k, cross_v, decode=False, positions=positions)[0]


def decoder_forward(cfg, params, tokens, cross_kv, *, caches=None, decode=False, pos0=None):
    """tokens [B,S]; cross_kv (k, v) stacked [L,...]; returns (h, caches).
    ``caches`` (the ``self`` cache, or None) is written in place; a decode
    step adds ``dec_pos[pos0]`` ([B] absolute positions), a prefill
    ``dec_pos[:S]``."""
    S = tokens.shape[1]
    x = embed_lookup(params["embed"], tokens).to(dtype_of(cfg.dtype))
    if decode:
        x = x + embed_lookup(params["dec_pos"], pos0)[:, None].to(x.dtype)
        positions = None
    else:
        x = x + params["dec_pos"][:S][None].to(x.dtype)
        positions = torch.arange(S, device=x.device)[None, :]
    ck, cv = cross_kv
    remat = caches is None and _remat(cfg)
    for i, lp in enumerate(tree_unstack(params["decoder"])):
        x = seq_constraint(cfg, x)  # the residual stream entering each block
        if remat:
            x = checkpoint(_dec_block_train, cfg, lp, x, ck[i], cv[i], positions,
                           use_reentrant=False, **_remat_kwargs(cfg))
            continue
        layer_cache = _index(caches, i) if caches is not None else None
        x, new_cache = _dec_block(cfg, lp, x, layer_cache, ck[i], cv[i], decode=decode,
                                  positions=positions)
        if caches is not None:
            _write_back(caches, i, layer_cache, new_cache)
    return apply_norm(cfg, x, params["final_norm"]), caches


def encdec_loss_forward(cfg, params, batch):
    """Training path: encode the stub frames, teacher-forced decoder.
    Returns (h, None, aux = 0)."""
    enc_states = encode(cfg, params, batch["frames"])
    h, _ = decoder_forward(cfg, params, batch["tokens"], _cross_kv(cfg, params["decoder"],
                                                                   enc_states))
    return h, None, torch.zeros((), dtype=torch.float32, device=h.device)


def _self_cache_spec(cfg, batch: int, max_len: int):
    L, hd, dt = cfg.n_layers, cfg.resolved_head_dim, dtype_of(cfg.dtype)
    return {
        "k": ((L, batch, max_len, cfg.n_kv_heads, hd), dt),
        "v": ((L, batch, max_len, cfg.n_kv_heads, hd), dt),
        "pos": ((L, batch), torch.int32),
    }


def encdec_cache(cfg, batch: int, max_len: int, device=None):
    """The reference's cache layout, all zeros (on ``meta``: the spec)."""
    L, hd, dt = cfg.n_layers, cfg.resolved_head_dim, dtype_of(cfg.dtype)
    cross = (L, batch, cfg.enc_seq_len, cfg.n_kv_heads, hd)
    return {
        "self": {k: torch.zeros(shape, dtype=d, device=device)
                 for k, (shape, d) in _self_cache_spec(cfg, batch, max_len).items()},
        "cross_k": torch.zeros(cross, dtype=dt, device=device),
        "cross_v": torch.zeros(cross, dtype=dt, device=device),
    }


def _logits(params, h):
    """h [B,d] @ embed^T in the activation dtype (the embeddings are tied),
    then f32, as the reference rounds them."""
    return (h @ params["embed"].T.to(h.dtype)).float()


def encdec_prefill(cfg, params, batch, max_len: int, cache=None):
    """Encode the frames, run the prompt, fill the self cache (``pos``
    becomes S) and keep the cross k / v. Returns (last logits [B,V] f32,
    cache). ``cache`` (empty, e.g. sharded over a mesh) is filled in place;
    by default a new one is made."""
    enc_states = encode(cfg, params, batch["frames"])
    ck, cv = _cross_kv(cfg, params["decoder"], enc_states)
    B, S = batch["tokens"].shape
    if cache is None:
        self_cache = {k: torch.zeros(shape, dtype=d, device=enc_states.device)
                      for k, (shape, d) in _self_cache_spec(cfg, B, max_len).items()}
    else:
        self_cache = cache["self"]
        with torch.no_grad():
            for key, val in (("cross_k", ck), ("cross_v", cv)):
                shard_view(cache[key])[0].copy_(like_shards(val, cache[key], range(val.ndim)))
        ck, cv = cache["cross_k"], cache["cross_v"]
    h, self_cache = decoder_forward(cfg, params, batch["tokens"], (ck, cv), caches=self_cache)
    with torch.no_grad():
        shard_view(self_cache["pos"])[0].fill_(S)
    return _logits(params, h[:, -1]), {"self": self_cache, "cross_k": ck, "cross_v": cv}


def encdec_decode_step(cfg, params, caches, tokens):
    """tokens [B,1] -> (logits [B,V] f32, caches, the self cache updated in
    place)."""
    pos0 = caches["self"]["pos"][0]  # all layers share pos
    h, _ = decoder_forward(cfg, params, tokens, (caches["cross_k"], caches["cross_v"]),
                           caches=caches["self"], decode=True, pos0=pos0)
    return _logits(params, h[:, 0]), caches
