"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block
(the port of ``repro/models/hybrid.py``).

``n_layers`` Mamba2 blocks; after every ``hybrid.attn_every``-th of them
the shared transformer block (GQA attention and a SwiGLU MLP, each after a
norm) is applied. Its params are one set, applied ``n_super = n_layers //
attn_every`` times (the Zamba2 trick); the ``n_layers % attn_every`` Mamba2
layers after the last application are the tail. The Mamba2 params are
stacked [n_super * every, ...] and the tail's [tail, ...], as in the
reference.

The reference scans over super-blocks (``every`` Mamba2 layers and one
application of the shared block); the port runs them as a Python loop.
Under autograd and ``cfg.remat != "none"`` each super-block is
checkpointed, with the LM's policies (``lm._remat_kwargs``): the remat unit
is the super-block, as in the reference, and the tail's layers stay
outside remat. On the card the shared block's attention runs the flash
kernel (D = 112 at Zamba2's widths) and its MLP the SwiGLU kernel, so a
prefill launches each ``n_super`` times and a decode step the SwiGLU
kernel ``n_super`` times.

The cache is the reference's ``hybrid_cache`` layout: ``mamba`` ({ssm
[n_super, every, B, H, N, hd] f32, conv [n_super, every, B, K-1, C]}),
``attn`` (one GQA cache per application, stacked [n_super, ...]: a ring of
``min(max_len, window)`` slots with ``kv_pos`` for a sliding window, see
``models.attention``) and ``tail`` ({ssm, conv} [tail, ...]). It is
written IN PLACE, as the LM's caches are.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.base import (
    Ctx, apply_norm, dtype_of, embed_lookup, norm_params, seq_constraint,
)
from repro_torch.models.lm import _index, _remat_kwargs, _write_back
from repro_torch.utils import tree_unstack


def _layout(cfg: ModelConfig):
    every = cfg.hybrid.attn_every
    return every, cfg.n_layers // every, cfg.n_layers % every


def hybrid_params(ctx: Ctx, cfg: ModelConfig):
    every, n_super, tail = _layout(cfg)
    V, d = cfg.padded_vocab, cfg.d_model

    def mamba_stack(count):
        return {
            "ln": norm_params(ctx, cfg, d, stacked=count),
            "body": ssm_mod.mamba2_params(ctx, cfg, stacked=count),
        }

    p: Dict[str, Any] = {
        "embed": ctx.param((V, d), ("vocab", "embed"), init="normal", scale=0.02),
        "final_norm": norm_params(ctx, cfg, d),
        "unembed": ctx.param((d, V), ("embed", "vocab")),
        "mamba": mamba_stack(n_super * every),
        "shared_attn": {
            "ln1": norm_params(ctx, cfg, d),
            "attn": attn.gqa_params(ctx, cfg),
            "ln2": norm_params(ctx, cfg, d),
            "mlp": mlp_mod.mlp_params(ctx, cfg),
        },
    }
    if tail:
        p["tail"] = mamba_stack(tail)
    return p


def _mamba_block(cfg, p, x, state):
    """One Mamba2 layer after a norm, with its residual. ``state`` ({ssm,
    conv}) or None; a one-token x takes the decode step. Returns (x, new
    state or None)."""
    h = apply_norm(cfg, x, p["ln"])
    if state is None:
        y, _ = ssm_mod.mamba2_forward(cfg, p["body"], h)
        return x + y, None
    if h.shape[1] == 1:
        y, (ssm_state, conv_state) = ssm_mod.mamba2_decode(cfg, p["body"], h, state["ssm"],
                                                           state["conv"])
    else:
        y, (ssm_state, conv_state) = ssm_mod.mamba2_forward(
            cfg, p["body"], h, state=state["ssm"], conv_state=state["conv"])
    return x + y, {"ssm": ssm_state, "conv": conv_state}


def _shared_attn_block(cfg, p, x, cache, *, decode, positions):
    h = apply_norm(cfg, x, p["ln1"])
    y, new_cache = attn.gqa_forward(cfg, p["attn"], h, positions=positions, cache=cache,
                                    decode=decode)
    x = x + y
    h = apply_norm(cfg, x, p["ln2"])
    return x + mlp_mod.mlp_forward(cfg, p["mlp"], h), new_cache


def _super_block_train(cfg, layers, shared_p, x, positions):
    for lp in layers:
        x, _ = _mamba_block(cfg, lp, x, None)
    x, _ = _shared_attn_block(cfg, shared_p, x, None, decode=False, positions=positions)
    return x


def hybrid_forward(cfg, params, batch, *, caches=None, decode=False):
    """Returns (hidden [B,S,d], caches written in place, aux f32 zero)."""
    every, n_super, tail = _layout(cfg)
    x = embed_lookup(params["embed"], batch["tokens"]).to(dtype_of(cfg.dtype))
    S = x.shape[1]
    positions = None if decode else torch.arange(S, device=x.device)[None, :]
    shared_p = params["shared_attn"]
    layers = tree_unstack(params["mamba"])
    remat = caches is None and cfg.remat != "none" and torch.is_grad_enabled()

    for i in range(n_super):
        group = layers[i * every:(i + 1) * every]
        x = seq_constraint(cfg, x)  # the residual stream entering each super-block
        if remat:
            x = checkpoint(_super_block_train, cfg, group, shared_p, x, positions,
                           use_reentrant=False, **_remat_kwargs(cfg))
            continue
        for j, lp in enumerate(group):
            st = None if caches is None else _index(caches["mamba"], (i, j))
            x, new = _mamba_block(cfg, lp, x, st)
            if caches is not None:
                _write_back(caches["mamba"], (i, j), st, new)
        ac = None if caches is None else _index(caches["attn"], i)
        x, new = _shared_attn_block(cfg, shared_p, x, ac, decode=decode, positions=positions)
        if caches is not None:
            _write_back(caches["attn"], i, ac, new)

    if tail:
        for j, lp in enumerate(tree_unstack(params["tail"])):
            st = None if caches is None else _index(caches["tail"], j)
            x, new = _mamba_block(cfg, lp, x, st)
            if caches is not None:
                _write_back(caches["tail"], j, st, new)

    x = apply_norm(cfg, x, params["final_norm"])
    return x, caches, torch.zeros((), dtype=torch.float32, device=x.device)


def hybrid_cache(cfg, batch: int, max_len: int, device=None):
    """The empty cache (the reference's ``hybrid_cache`` layout, see the
    module docstring)."""
    every, n_super, tail = _layout(cfg)
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    dt = dtype_of(cfg.dtype)

    def mamba_state(lead):
        return {
            "ssm": torch.zeros(lead + (batch, H, s.d_state, s.head_dim), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros(lead + (batch, s.conv_kernel - 1, conv_dim), dtype=dt,
                                device=device),
        }

    out = {"mamba": mamba_state((n_super, every)),
           "attn": attn.gqa_cache_init(cfg, batch, max_len, n_super, device=device)}
    if tail:
        out["tail"] = mamba_state((tail,))
    return out
