"""Minitron-8B — width-pruned Nemotron-4, huge 256k vocab.

[arXiv:2407.14679] 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
The 256k vocab stresses embedding sharding + the chunked-vocab loss.
Full attention => long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=256000,
        attn_kind="gqa",
        mlp_kind="swiglu",
        skip_shapes=("long_500k",),
        skip_reason="pure full attention",
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="minitron-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=1024,
        loss_chunk=0,
    )
