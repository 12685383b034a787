"""Qwen3-8B — dense, GQA (kv=8) with qk_norm.

[hf:Qwen/Qwen3-8B] 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
Full attention => long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12288,
        vocab_size=151936,
        attn_kind="gqa",
        qk_norm=True,
        rope_theta=1000000.0,
        mlp_kind="swiglu",
        skip_shapes=("long_500k",),
        skip_reason="pure full attention",
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="qwen3-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        loss_chunk=0,
    )
