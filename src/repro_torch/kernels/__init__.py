"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version in ``ref``. Sources live in ``csrc/`` and are built on
first use by ``build``.

- fedavg_reduce: fused weighted reduction over stacked client deltas
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
