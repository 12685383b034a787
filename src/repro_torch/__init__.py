"""PyTorch/CUDA port of ``repro``: the synchronous and compressed FL rounds
on the MNIST CNN, and serving the dense GQA LM (Qwen3-8B).

The package mirrors ``repro``'s module layout and public names so every
module has a namesake in the JAX reference to be checked against. It
imports ``torch`` and numpy only. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without CUDA and without an explicit
device they raise. Every Pallas kernel of the reference has a hand-written
counterpart in ``kernels/csrc/`` (CUDA C++ for sm_90a, bound with ctypes).
"""
