"""StarCoder2-3B — dense, extreme GQA (kv=2), RoPE.

[arXiv:2402.19173] 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
Full attention => long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        attn_kind="gqa",
        mlp_kind="gelu",  # starcoder2 uses gelu MLP
        norm_kind="layernorm",
        skip_shapes=("long_500k",),
        skip_reason="pure full attention",
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="starcoder2-smoke",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        loss_chunk=0,
    )
