"""The paper's own workload configuration (MNIST CNN over 10 FL clients).

Not part of the 40-cell LM grid — this is the faithful-reproduction
payload used by the paper-figure benchmarks. The FL core consumes the CNN
via repro_torch.models.cnn directly; the ModelConfig here records metadata only.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paper-mnist-cnn",
        family="cnn",
        n_layers=4,
        d_model=128,
        n_heads=1,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=10,
        attn_kind="none",
        skip_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        skip_reason="paper workload: 28x28 MNIST images, not an LM",
    )


def reduced() -> ModelConfig:
    return config()
