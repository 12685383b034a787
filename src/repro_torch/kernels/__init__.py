"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version in ``ref``. Sources live in ``csrc/`` and are built on
first use by ``build``.

- fedavg_reduce: fused weighted reduction over stacked client deltas
- quantize: int8 rows, bf16 rows and stochastic int8 for the compressors
- flash_attention: causal / windowed GQA online-softmax attention (prefill)
- swiglu: the fused SwiGLU MLP, its [M, F] hidden kept on chip
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
