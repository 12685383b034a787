"""Phi-3-medium 14B — dense, RoPE + SwiGLU + GQA (kv=10).

[arXiv:2404.14219] 40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
Full attention => long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17920,
        vocab_size=100352,
        attn_kind="gqa",
        mlp_kind="swiglu",
        skip_shapes=("long_500k",),
        skip_reason="pure full attention",
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="phi3-medium-smoke",
        n_layers=2,
        d_model=80,
        n_heads=5,
        n_kv_heads=5,  # keeps the 40:10 q:kv ratio structure divisible small
        d_ff=160,
        vocab_size=512,
        loss_chunk=0,
    )
