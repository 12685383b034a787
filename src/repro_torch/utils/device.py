"""Device selection shared by the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Without CUDA and without an explicit device this raises instead of
    carrying on quietly on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def f32_math(device: Union[str, torch.device]) -> Iterator[None]:
    """Full-f32, reproducible library math inside the block on a CUDA
    ``device``: TF32 off for cuDNN convolutions and cuBLAS matmuls (PyTorch
    turns it on for cuDNN by default, which keeps ~3 digits where the
    reference computes in f32), and cuDNN held to deterministic algorithms
    without autotuning (its default conv backward sums with atomics, so two
    identical runs of the sequential engine differed in the last bit). The
    flags are restored on exit, also after an exception. On the CPU this
    does nothing."""
    if torch.device(device).type != "cuda":
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved
