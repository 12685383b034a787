"""Uniform model API over all families (the port of ``repro/models/api.py``).

``Model(cfg)`` exposes:
  init(generator) / abstract_params() / param_axes()
  loss(params, batch) -> (loss, metrics)               [train]
  prefill(params, batch, max_len) -> (logits, cache)   [prefill]
  decode_step(params, cache, tokens) -> (logits, cache) [decode]
  init_cache(batch, max_len, device) / cache_spec(batch, max_len)
  input_specs(shape) -> dict of ``meta`` tensors        [dry-run stand-ins]
  cache_axes(batch, max_len)                            [logical sharding axes]
Params are drawn on the generator's device. The ``lm`` family
(``models.lm``) holds the dense, MoE, MLA, vision-stub and RWKV6 models,
the ``hybrid`` family (``models.hybrid``) Zamba2's Mamba2 backbone with a
shared attention block, the ``encdec`` family (``models.encdec``)
Whisper's encoder-decoder; each returns its loss metrics with ``aux``.
``abstract_params``, ``cache_spec`` and ``input_specs`` give ``meta``
tensors (shapes and dtypes, no storage), where the reference gives
``jax.ShapeDtypeStruct``s; ``param_axes`` and ``cache_axes`` give the
trees of logical-axis tuples that ``repro_torch.sharding`` maps onto a
mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models.base import Ctx, dtype_of, shard_view
from repro_torch.utils import resolve_device, tree_map

VLM_PATCH_TOKENS = 256  # vision-stub prefix length
META = torch.device("meta")


def _family(cfg: ModelConfig) -> str:
    if cfg.enc_dec:
        return "encdec"
    if cfg.hybrid is not None:
        return "hybrid"
    return "lm"


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.family = _family(cfg)

    def _params(self, ctx: Ctx):
        if self.family == "encdec":
            return encdec_mod.encdec_params(ctx, self.cfg)
        if self.family == "hybrid":
            return hybrid_mod.hybrid_params(ctx, self.cfg)
        return lm_mod.lm_params(ctx, self.cfg)

    def init(self, generator: torch.Generator):
        return self._params(Ctx(generator, dtype_of(self.cfg.param_dtype)))

    def abstract_params(self):
        """The params' shapes and dtypes as ``meta`` tensors (no storage)."""
        return self._params(Ctx(None, dtype_of(self.cfg.param_dtype)))

    def param_axes(self):
        """The params' tree with each leaf's logical axes, a tuple of names."""
        return self._params(Ctx(None, axes=True))

    def loss(self, params, batch):
        cfg = self.cfg
        if self.family == "lm":
            return lm_mod.lm_loss(cfg, params, batch)
        forward = (encdec_mod.encdec_loss_forward if self.family == "encdec"
                   else hybrid_mod.hybrid_forward)
        h, _, aux = forward(cfg, params, batch)
        loss, metrics = lm_mod.loss_from_hidden(cfg, params, h, batch)
        return loss, dict(metrics, aux=aux)

    def prefill(self, params, batch, max_len: int, cache=None):
        """(last logits [B,V] f32, cache); a hybrid's attention caches'
        ``pos`` becomes the prompt length (reference ``api.py:75-83``).
        ``cache``, an empty one (a sharded step's), is filled in place; by
        default a new one is made."""
        cfg = self.cfg
        if self.family == "encdec":
            return encdec_mod.encdec_prefill(cfg, params, batch, max_len, cache=cache)
        if self.family == "hybrid":
            if cache is None:
                cache = self.init_cache(batch["tokens"].shape[0], max_len,
                                        device=params["embed"].device)
            h, cache, _ = hybrid_mod.hybrid_forward(cfg, params, batch, caches=cache)
            with torch.no_grad():
                shard_view(cache["attn"]["pos"])[0].fill_(batch["tokens"].shape[1])
            return lm_mod.unembed(cfg, params, h[:, -1:])[:, 0], cache
        return lm_mod.lm_prefill(cfg, params, batch, max_len, caches=cache)

    def decode_step(self, params, cache, tokens):
        cfg = self.cfg
        if self.family == "encdec":
            return encdec_mod.encdec_decode_step(cfg, params, cache, tokens)
        if self.family == "hybrid":
            h, cache, _ = hybrid_mod.hybrid_forward(cfg, params, {"tokens": tokens}, caches=cache,
                                                    decode=True)
            return lm_mod.unembed(cfg, params, h)[:, 0], cache
        return lm_mod.lm_decode_step(cfg, params, cache, tokens)

    def init_cache(self, batch: int, max_len: int, device=None):
        if device is None or torch.device(device) != META:
            device = resolve_device(device)
        if self.family == "encdec":
            return encdec_mod.encdec_cache(self.cfg, batch, max_len, device=device)
        if self.family == "hybrid":
            return hybrid_mod.hybrid_cache(self.cfg, batch, max_len, device=device)
        return lm_mod.lm_cache(self.cfg, batch, max_len, device=device)

    def cache_spec(self, batch: int, max_len: int):
        """The cache's shapes and dtypes as ``meta`` tensors."""
        return self.init_cache(batch, max_len, device=META)

    def input_specs(self, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
        """``meta`` stand-ins for every model input of this shape, with the
        reference's keys, shapes and dtypes."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        f = dtype_of(cfg.dtype)

        def spec(shape, dtype):
            return torch.empty(shape, dtype=dtype, device=META)

        def tok(n):
            return spec((B, n), torch.int32)

        if shape.kind == "train":
            if cfg.frontend == "vision_stub":
                st = S - VLM_PATCH_TOKENS
                return {"tokens": tok(st),
                        "patch_embed": spec((B, VLM_PATCH_TOKENS, cfg.d_model), f),
                        "targets": tok(st), "loss_mask": spec((B, st), torch.float32)}
            out = {"tokens": tok(S), "targets": tok(S),
                   "loss_mask": spec((B, S), torch.float32)}
            if cfg.enc_dec:
                out = {"frames": spec((B, cfg.enc_seq_len, cfg.d_model), f), **out}
            return out
        if shape.kind == "prefill":
            out = {"tokens": tok(S if cfg.frontend != "vision_stub" else S - VLM_PATCH_TOKENS)}
            if cfg.frontend == "vision_stub":
                out["patch_embed"] = spec((B, VLM_PATCH_TOKENS, cfg.d_model), f)
            if cfg.enc_dec:
                out["frames"] = spec((B, cfg.enc_seq_len, cfg.d_model), f)
            return out
        return {"tokens": tok(1)}  # decode: one token against a cache of seq_len

    def cache_axes(self, batch: int, max_len: int):
        """Each cache leaf's logical axes, by the reference's rank rules."""
        return tree_map(lambda leaf: axes_for_cache_leaf(tuple(leaf.shape)),
                        self.cache_spec(batch, max_len))


def axes_for_cache_leaf(shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    """Logical axes of a cache leaf by its rank (the reference's
    ``_axes_for_cache_leaf``); every rank is unambiguous within one cache:
      k/v            [L, B, Skv, Hkv, hd] -> (layers, batch, kvseq, kv_heads, head_dim)
      c_kv/k_pe      [L, B, Skv, r]       -> (layers, batch, kvseq, lora)
      pos            [L, B]               -> (layers, batch)
      kv_pos         [L, B, Skv]          -> (layers, batch, kvseq)
      rwkv S         [L, B, H, hd, hd]    -> (layers, batch, heads, head_dim, head_dim2)
      tm_x/cm_x      [L, B, 1, d]         -> (layers, batch, None, embed)
      mamba ssm      [Ls, e, B, H, N, hd] -> (layers, layers2, batch, heads, state, head_dim)
      cross_k/v      [L, B, Se, Hkv, hd]  -> (layers, batch, kvseq, kv_heads, head_dim)
    """
    r = len(shape)
    if r == 2:
        return ("layers", "batch")
    if r == 3:
        return ("layers", "batch", "kvseq")
    if r == 4:
        if shape[2] == 1:
            return ("layers", "batch", None, "embed")
        return ("layers", "batch", "kvseq", "lora")
    if r == 5:
        if shape[3] == shape[4]:
            return ("layers", "batch", "heads", "head_dim", "head_dim2")
        return ("layers", "batch", "kvseq", "kv_heads", "head_dim")
    if r == 6:
        return ("layers", "layers2", "batch", "heads", "state", "head_dim")
    return tuple([None] * r)
