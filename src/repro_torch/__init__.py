"""PyTorch/CUDA port of ``repro``: the synchronous FL round on the MNIST CNN.

The package mirrors ``repro``'s module layout and public names so every
module has a namesake in the JAX reference to be checked against. It
imports ``torch`` and numpy only. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without CUDA and without an explicit
device they raise. The one hand-written kernel of this slice is
``kernels/csrc/fedavg_reduce.cu`` (CUDA C++ for sm_90a, bound with ctypes).
"""
