"""Uniform model API (the port of ``repro/models/api.py`` for the ``lm``
and ``hybrid`` families).

``Model(cfg)`` exposes:
  init(generator)                                      -> params
  abstract_params()                                    -> params on ``meta``
  loss(params, batch) -> (loss, metrics)               [train]
  prefill(params, batch, max_len) -> (logits, cache)   [prefill]
  decode_step(params, cache, tokens) -> (logits, cache) [decode]
  init_cache(batch, max_len, device)                   -> empty cache
Params are drawn on the generator's device. The ``lm`` family
(``models.lm``) holds the dense, MoE, MLA, vision-stub and RWKV6 models,
the ``hybrid`` family (``models.hybrid``) Zamba2's Mamba2 backbone with a
shared attention block; both return their loss metrics with ``aux``. The
encoder-decoder family is not ported (ROADMAP Queue 1, item 15), nor the
dry-run's input stand-ins and sharding axes (item 16).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid as hybrid_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models.base import Ctx, dtype_of
from repro_torch.utils import resolve_device

VLM_PATCH_TOKENS = 256  # vision-stub prefix length


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
        if self.family == "encdec":
            raise NotImplementedError(
                "model family 'encdec' is not ported yet (ROADMAP Queue 1, item 15)")

    def _params(self, ctx: Ctx):
        if self.family == "hybrid":
            return hybrid_mod.hybrid_params(ctx, self.cfg)
        return lm_mod.lm_params(ctx, self.cfg)

    def init(self, generator: torch.Generator):
        return self._params(Ctx(generator, dtype_of(self.cfg.param_dtype)))

    def abstract_params(self):
        """The params' shapes and dtypes as ``meta`` tensors (no storage)."""
        return self._params(Ctx(None, dtype_of(self.cfg.param_dtype)))

    def loss(self, params, batch):
        if self.family == "hybrid":
            h, _, aux = hybrid_mod.hybrid_forward(self.cfg, params, batch)
            loss, metrics = lm_mod.loss_from_hidden(self.cfg, params, h, batch)
            return loss, dict(metrics, aux=aux)
        return lm_mod.lm_loss(self.cfg, params, batch)

    def prefill(self, params, batch, max_len: int):
        """(last logits [B,V] f32, cache); a hybrid's attention caches'
        ``pos`` becomes the prompt length (reference ``api.py:75-83``)."""
        cfg = self.cfg
        if self.family == "hybrid":
            cache = self.init_cache(batch["tokens"].shape[0], max_len,
                                    device=params["embed"].device)
            h, cache, _ = hybrid_mod.hybrid_forward(cfg, params, batch, caches=cache)
            cache["attn"]["pos"].fill_(batch["tokens"].shape[1])
            return lm_mod.unembed(cfg, params, h[:, -1:])[:, 0], cache
        return lm_mod.lm_prefill(cfg, params, batch, max_len)

    def decode_step(self, params, cache, tokens):
        cfg = self.cfg
        if self.family == "hybrid":
            h, cache, _ = hybrid_mod.hybrid_forward(cfg, params, {"tokens": tokens}, caches=cache,
                                                    decode=True)
            return lm_mod.unembed(cfg, params, h)[:, 0], cache
        return lm_mod.lm_decode_step(cfg, params, cache, tokens)

    def init_cache(self, batch: int, max_len: int, device=None):
        device = resolve_device(device)
        if self.family == "hybrid":
            return hybrid_mod.hybrid_cache(self.cfg, batch, max_len, device=device)
        return lm_mod.lm_cache(self.cfg, batch, max_len, device=device)
