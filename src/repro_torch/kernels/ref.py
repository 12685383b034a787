"""Plain PyTorch versions of the port's hand-written kernels.

Each is the kernel's target: the tests hold the kernel to it on the card
(allclose for the reduction, attention and SwiGLU, bitwise for the
quantize family), and the kernel's wrapper runs it for tensors on the CPU.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, window=0, scale=None):
    """q [BH, Sq, D]; k/v [BKV, Skv, D]; GQA via BH = G * BKV (query head
    bh reads kv head bh // G). Scores, softmax and the product in f32; the
    causal mask is top-left aligned (query i sees keys j <= i)."""
    BH, Sq, D = q.shape
    BKV, Skv, _ = v.shape
    G = BH // BKV
    scale = scale if scale is not None else D ** -0.5
    kr = torch.repeat_interleave(k, G, dim=0)
    vr = torch.repeat_interleave(v, G, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), kr.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window and window > 0:
        mask &= qpos - kpos < window
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, vr.float()).to(q.dtype)


def swiglu_ref(x, w_gate, w_up, w_down):
    """x [M, d], w_gate/w_up [d, F], w_down [F, d] -> [M, d] in x's dtype:
    (silu(x @ Wg) * (x @ Wu)) @ Wd, all in f32."""
    xf = x.float()
    g = xf @ w_gate.float()
    u = xf @ w_up.float()
    h = g * torch.sigmoid(g) * u
    return (h @ w_down.float()).to(x.dtype)


def fedavg_reduce_ref(x, w):
    """x [C, N], w [C] -> [N] float32."""
    return torch.einsum("c,cn->n", w.float(), x.float())


def _codes(v):
    return torch.clamp(v, -127.0, 127.0).to(torch.int8)


def quantize_stochastic_ref(x, uniform, scale):
    """x [N], uniform [N] in [0, 1), scale scalar -> int8 [N]:
    clip(floor(x / scale + u), -127, 127).

    ``scale`` becomes a tensor on x's device: on CUDA, PyTorch divides by a
    Python number as a multiply by its reciprocal, which is not the
    correctly rounded quotient the codes are defined by."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return _codes(torch.floor(x.float() / scale + uniform.float()))


def quantize_rows_ref(x, scales):
    """x [R, N], scales [R] -> int8 [R, N]; deterministic round-half-up."""
    return _codes(torch.floor(x.float() / scales.float()[:, None] + 0.5))


def downcast_bf16_rows_ref(x):
    """f32 -> bf16, round to nearest even."""
    return x.float().to(torch.bfloat16)


def segment_sum_ref(values, segment_ids, num_segments):
    """values [K], segment_ids [K] int -> [num_segments] scatter-add."""
    out = torch.zeros((num_segments,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_put_((segment_ids,), values, accumulate=True)
