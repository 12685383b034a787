"""Mixtral 8x7B — MoE (8 experts, top-2) with sliding-window attention.

[arXiv:2401.04088] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
SWA window 4096 => sub-quadratic => long_500k RUNS (ring KV cache).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        attn_kind="gqa",
        sliding_window=4096,
        moe=MoEConfig(num_experts=8, top_k=2, expert_d_ff=14336, capacity_factor=1.25),
        mlp_kind="swiglu",
        skip_shapes=(),
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="mixtral-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        sliding_window=32,
        moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=64, capacity_factor=1.5),
        loss_chunk=0,
    )
