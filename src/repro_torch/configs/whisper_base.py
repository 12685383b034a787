"""Whisper-base — encoder-decoder with conv audio frontend (STUB).

[arXiv:2212.04356] 6L(enc)+6L(dec) d_model=512 8H d_ff=2048 vocab=51865.
``input_specs`` provides precomputed frame embeddings [B,1500,512] (the
conv frontend is a stub per the assignment). Enc-dec (not encoder-only):
decode shapes RUN with a cross-attention cache. long_500k skipped (full
attention; 500k also far exceeds any audio context).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        attn_kind="gqa",
        enc_dec=True,
        n_enc_layers=6,
        enc_seq_len=1536,  # 1500 mel frames padded to a tile multiple so the
        # encoder takes the memory-bounded blockwise-attention path

        frontend="audio_stub",
        mlp_kind="gelu",
        norm_kind="layernorm",
        tie_embeddings=True,
        skip_shapes=("long_500k",),
        skip_reason="full attention enc-dec; 500k decode inapplicable to the "
        "audio family (30 s context)",
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="whisper-smoke",
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        enc_seq_len=16,
        loss_chunk=0,
    )
