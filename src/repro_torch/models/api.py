"""Uniform model API (the port of the serving part of
``repro/models/api.py``).

``Model(cfg)`` exposes, for family ``"lm"``:
  init(generator)                                      -> params
  prefill(params, batch, max_len) -> (logits, cache)   [prefill]
  decode_step(params, cache, tokens) -> (logits, cache) [decode]
  init_cache(batch, max_len, device)                   -> empty cache
Params are drawn on the generator's device. The encoder-decoder and hybrid
families, the loss and the dry-run stand-ins are not ported (ROADMAP
Queue 1, items 15 and 16).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as lm_mod
from repro_torch.models.base import Ctx, dtype_of
from repro_torch.utils import resolve_device


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
        if self.family != "lm":
            raise NotImplementedError(
                f"model family '{self.family}' is not ported yet (ROADMAP Queue 1, item 15)"
            )

    def init(self, generator: torch.Generator):
        return lm_mod.lm_params(Ctx(generator, dtype_of(self.cfg.param_dtype)), self.cfg)

    def prefill(self, params, batch, max_len: int):
        return lm_mod.lm_prefill(self.cfg, params, batch, max_len)

    def decode_step(self, params, cache, tokens):
        return lm_mod.lm_decode_step(self.cfg, params, cache, tokens)

    def init_cache(self, batch: int, max_len: int, device=None):
        return lm_mod.lm_cache(self.cfg, batch, max_len, device=resolve_device(device))
