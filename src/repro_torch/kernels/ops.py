"""Public wrappers around the port's kernels (the port of
``repro/kernels/ops.py``): tree-level aggregation and quantization, and
the layout side of attention and SwiGLU. The port's kernels take any
sequence length and row count, so the reference's padding and
power-of-two block search have no counterpart here."""

from __future__ import annotations

import torch

from repro_torch.kernels.fedavg_reduce import fedavg_reduce_flat
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.quantize import (
    dequantize_flat,
    downcast_bf16_rows_flat,
    quantize_rows_flat,
    quantize_stochastic_flat,
)
from repro_torch.kernels.swiglu import swiglu_fused
from repro_torch.utils.pytree import flatten_to_vector, tree_map, unflatten_from_vector


def fedavg_reduce(stacked_deltas, weights: torch.Tensor):
    """Weighted mean over stacked client deltas.

    stacked_deltas: tree whose leaves have leading client dim C.
    weights: [C]; cast to f32 and normalized in f32 (FedAvg semantics).
    One kernel launch per leaf; each result is cast to its leaf's dtype."""
    w = weights.float()
    w = (w / torch.clamp(w.sum(), min=1e-20)).contiguous()

    def one(leaf):
        flat = leaf.reshape(leaf.shape[0], -1).contiguous()
        return fedavg_reduce_flat(flat, w).reshape(leaf.shape[1:]).to(leaf.dtype)

    return tree_map(one, stacked_deltas)


def quantize_tree(tree, generator: torch.Generator):
    """Per-tensor int8 stochastic quantization of a tree: one scale for the
    whole flattened tree, uniform bits drawn from ``generator`` (the
    counterpart of the reference's ``jax.random`` key).

    Returns the payload {q, scale}; ``dequantize_tree`` inverts it."""
    vec, _ = flatten_to_vector(tree)
    amax = torch.clamp(vec.abs().max(), min=1e-12)
    scale = amax / torch.full_like(amax, 127.0)  # the quotient, not x * (1/127)
    uniform = torch.rand(vec.shape, generator=generator, device=generator.device)
    q = quantize_stochastic_flat(vec.contiguous(), uniform.to(vec.device), scale)
    return {"q": q, "scale": scale}


def quantize_rows(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Row-stacked int8 quantization: x [R, N] f32, scales [R] -> int8 [R, N].

    Deterministic round-half-up: the plane compressors' parity contract
    (stacked == sequential per-client, bitwise) rules out stochastic bits."""
    return quantize_rows_flat(x.float().contiguous(), scales.float().contiguous())


def downcast_bf16_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-stacked f32 -> bf16 downcast (the bf16 wire compressor)."""
    return downcast_bf16_rows_flat(x.float().contiguous())


def dequantize_tree(payload, template):
    _, meta = flatten_to_vector(template)
    return unflatten_from_vector(dequantize_flat(payload["q"], payload["scale"]), meta)


def flash_attention(q, k, v, *, causal=True, window=0):
    """q [B, Sq, Hq, D]; k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D].

    GQA by head-major flattening: [B, S, H, D] -> [B*H, S, D], the kernel
    reading kv head bh // G (no repeated copy of k and v)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    qf = q.transpose(1, 2).reshape(B * Hq, Sq, D).contiguous()
    kf = k.transpose(1, 2).reshape(B * Hkv, Skv, D).contiguous()
    vf = v.transpose(1, 2).reshape(B * Hkv, Skv, Dv).contiguous()
    out = flash_attention_bhsd(qf, kf, vf, causal=causal, window=window)
    return out.reshape(B, Hq, Sq, Dv).transpose(1, 2)


def swiglu(x, w_gate, w_up, w_down):
    """Fused SwiGLU over [..., d] inputs."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    out = swiglu_fused(x.reshape(-1, d).contiguous(), w_gate.contiguous(), w_up.contiguous(),
                       w_down.contiguous())
    return out.reshape(*lead, d)
