"""Zamba2-7B — hybrid: Mamba2 backbone + shared attention block.

[arXiv:2411.15242] 81L d_model=3584 32H d_ff=14336 vocab=32000 ssm_state=64.
One shared attention+MLP block applied every 6 Mamba2 layers (weights
shared across applications — the Zamba2 trick). long_500k RUNS: Mamba2
state is O(1); the shared attention runs a 4096 sliding window at 500k
(documented deviation for sub-quadratic serving).
"""

from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        attn_kind="gqa",
        sliding_window=4096,
        ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2, chunk_len=128),
        hybrid=HybridConfig(attn_every=6, shared_attn=True),
        mlp_kind="swiglu",
        skip_shapes=(),
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="zamba2-smoke",
        n_layers=7,  # 1 super-block of 3 + tail of... 7 = 2*3 + 1 with every=3
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        sliding_window=32,
        ssm=SSMConfig(kind="mamba2", d_state=16, head_dim=32, expand=2, chunk_len=16),
        hybrid=HybridConfig(attn_every=3, shared_attn=True),
        loss_chunk=0,
    )
