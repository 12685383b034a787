"""Synthetic token streams for the LM architectures (the port of
``repro/data/tokens.py``; numpy, so its draws are the reference's exactly).

Markov-chain token generator: deterministic per (seed, client), with
enough sequential structure that a small LM's loss visibly drops within a
few hundred steps (used by the trainer and the LM federated task).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def _markov_tokens(rng: np.random.Generator, n: int, vocab: int, order_bias: float = 0.85):
    """Tokens where t_{i+1} is usually (t_i * 7 + 3) % vocab — learnable."""
    toks = np.empty(n, dtype=np.int32)
    toks[0] = rng.integers(0, vocab)
    jumps = rng.random(n) > order_bias
    rand = rng.integers(0, vocab, size=n)
    for i in range(1, n):
        toks[i] = rand[i] if jumps[i] else (toks[i - 1] * 7 + 3) % vocab
    return toks


def synthetic_token_batches(
    *,
    batch: int,
    seq: int,
    vocab: int,
    seed: int = 0,
    client_id: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed * 100003 + client_id)
    while True:
        stream = _markov_tokens(rng, batch * (seq + 1), vocab).reshape(batch, seq + 1)
        yield {
            "tokens": stream[:, :-1],
            "targets": stream[:, 1:],
            "loss_mask": np.ones((batch, seq), np.float32),
        }


def token_batch_for(cfg, *, batch: int, seq: int, seed: int = 0, client_id: int = 0):
    """One batch shaped for a ModelConfig (handles vlm/enc-dec stubs)."""
    rng = np.random.default_rng(seed * 100003 + client_id)
    out = next(
        synthetic_token_batches(batch=batch, seq=seq, vocab=cfg.vocab_size, seed=seed, client_id=client_id)
    )
    if cfg.frontend == "vision_stub":
        n_patch = min(8, seq // 4)
        out = {
            "tokens": out["tokens"][:, n_patch:],
            "targets": out["targets"][:, n_patch:],
            "loss_mask": out["loss_mask"][:, n_patch:],
            "patch_embed": rng.normal(0, 1, (batch, n_patch, cfg.d_model)).astype(np.float32),
        }
    if cfg.enc_dec:
        out["frames"] = rng.normal(0, 1, (batch, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
    return out
