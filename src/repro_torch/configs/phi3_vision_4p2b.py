"""Phi-3-vision 4.2B — phi3-mini backbone + CLIP frontend (STUB).

[hf:microsoft/Phi-3-vision-128k-instruct] 32L d_model=3072 32H (kv=32)
d_ff=8192 vocab=32064. The CLIP vision tower is stubbed: ``input_specs``
provides precomputed patch embeddings. Full attention => long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        attn_kind="gqa",
        frontend="vision_stub",
        mlp_kind="swiglu",
        skip_shapes=("long_500k",),
        skip_reason="pure full attention: 500k decode KV is quadratic-history; "
        "sub-quadratic attention not part of this architecture",
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="phi3v-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        loss_chunk=0,
    )
