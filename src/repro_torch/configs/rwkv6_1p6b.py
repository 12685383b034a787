"""RWKV6 'Finch' 1.6B — attention-free, data-dependent decay.

[arXiv:2404.05892] 24L d_model=2048 d_ff=7168 vocab=65536, head_size 64.
Attention-free => ``long_500k`` RUNS (O(1) recurrent state decode).
"""

from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,  # d_model / head_size(64)
        n_kv_heads=32,
        d_ff=7168,
        vocab_size=65536,
        attn_kind="none",
        # chunked-WKV6 (the §Perf fix for the sequential scan's memory term);
        # chunk 128 measured -42% memory term vs 64 on prefill_32k while the
        # [B,H,L,L,hd] intra-chunk tensors stay within budget
        ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk_len=128),
        mlp_kind="swiglu",  # channel-mix uses its own relu^2 form internally
        skip_shapes=(),
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="rwkv6-smoke",
        n_layers=2,
        d_model=128,
        n_heads=2,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk_len=16),
        loss_chunk=0,
    )
