"""Parameter construction context + elementary ops shared by the LM blocks
(the port of ``repro/models/base.py``).

Models are plain functions ``apply(cfg, params, ...)`` over nested dicts of
tensors. The tree structure is defined once, in the init code, through a
:class:`Ctx`, in one of the reference's three modes: ``init`` (draws),
abstract (leaves are tensors on the ``meta`` device: shapes and dtypes, no
storage) and ``axes`` (each leaf is its tuple of logical axis names, which
``repro_torch.sharding`` maps onto a mesh). Draws come from a
``torch.Generator`` on its own device, in f32, then cast to the parameter
dtype; the kinds and the fan-in rule are the reference's. The reference's
threefry draws have no torch counterpart, so tests carry its parameters
across with ``repro_torch.convert`` instead.

Logical axis names used across the zoo (the reference's):
  batch, seq, kvseq, embed, vocab, heads, kv_heads, head_dim, qk_dim,
  ffn, experts, layers, state, conv, lora

The ops compute in f32 and return the activation dtype, as the
reference's do.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Axes = Tuple[Optional[str], ...]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WHOLE_DRAW_MAX = 2**31  # elements of a leaf drawn in one call (see Ctx._scaled_randn)


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype string ("bfloat16", "float32") as a torch dtype."""
    return DTYPES[name]


class Ctx:
    """Parameter materialization context: draws from ``generator`` on its
    device, or shapes only (``meta`` tensors) when ``generator`` is None,
    or, with ``axes=True``, each leaf's logical axes (no generator)."""

    def __init__(self, generator: Optional[torch.Generator], param_dtype=torch.bfloat16, *,
                 axes: bool = False):
        assert not (axes and generator is not None), "the axes mode draws nothing"
        self.generator = generator
        self.device = generator.device if generator is not None else torch.device("meta")
        self.param_dtype = param_dtype
        self.axes = axes

    def _randn(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.device,
                           dtype=torch.float32)

    def _scaled_randn(self, shape, s: float, dtype):
        """``randn * s`` cast to ``dtype``. A leaf of more than
        ``WHOLE_DRAW_MAX`` elements is drawn one leading slice at a time into
        its output, so that its f32 draws never stand beside it whole (two
        f32 copies of Mixtral's stacked experts at 16 layers are 60 GB)."""
        if math.prod(shape) <= WHOLE_DRAW_MAX or len(shape) < 2:
            return (self._randn(shape) * s).to(dtype)
        out = torch.empty(shape, dtype=dtype, device=self.device)
        for i in range(shape[0]):
            out[i] = self._randn(shape[1:]) * s
        return out

    def param(
        self,
        shape: Sequence[int],
        axes: Axes,
        init: str = "fan_in",
        scale: Optional[float] = None,
        dtype=None,
    ):
        shape = tuple(int(s) for s in shape)
        assert len(shape) == len(axes), f"shape {shape} vs axes {axes}"
        if self.axes:
            return tuple(axes)
        dtype = dtype or self.param_dtype
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init == "normal":
            s = 0.02 if scale is None else scale
            return self._scaled_randn(shape, s, dtype)
        if init == "fan_in":
            # fan_in = product of all dims except the last (stacked-layer dim
            # excluded by convention when axes[0] == "layers").
            dims = shape[1:] if axes and axes[0] == "layers" else shape
            fan_in = math.prod(dims[:-1]) if len(dims) > 1 else dims[0]
            s = (scale if scale is not None else 1.0) / max(math.sqrt(fan_in), 1.0)
            return self._scaled_randn(shape, s, dtype)
        if init == "uniform":
            s = 1.0 if scale is None else scale
            u = torch.rand(shape, generator=self.generator, device=self.device,
                           dtype=torch.float32)
            return (u * (2 * s) - s).to(dtype)  # jax.random.uniform(-s, s)
        raise ValueError(f"unknown init {init}")


# ---------------------------------------------------------------------------
# Elementary ops (compute in float32, return activation dtype)
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)  # jnp.var: biased
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def apply_norm(cfg, x, w):
    if cfg.norm_kind == "layernorm":
        return layer_norm(x, w["scale"], w["bias"], cfg.norm_eps)
    return rms_norm(x, w["scale"], cfg.norm_eps)


def norm_params(ctx: Ctx, cfg, d: int, stacked: Optional[int] = None):
    lead = () if stacked is None else (stacked,)
    lead_ax = () if stacked is None else ("layers",)
    p = {"scale": ctx.param(lead + (d,), lead_ax + ("embed",), init="ones")}
    if cfg.norm_kind == "layernorm":
        p["bias"] = ctx.param(lead + (d,), lead_ax + ("embed",), init="zeros")
    return p


def linear(x, w):
    """x @ w in x's dtype (on the card a bf16 product sums in f32 and
    rounds once, as the reference's preferred_element_type=f32 does)."""
    return torch.matmul(x, w.to(x.dtype))


def silu(x):
    return x * torch.sigmoid(x.float()).to(x.dtype)


def gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]. Rotates the
    two halves of D (not interleaved pairs), as the reference does."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, device=x.device)  # [D/2]
    ang = positions[..., None].float() * inv  # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None):
    """[n, d] f32 table: sin at the even columns, cos at the odd, built in
    numpy exactly as the reference builds it (bit for bit the same)."""
    pos = np.arange(n)[:, None]
    div = np.exp(-np.log(10000.0) * np.arange(0, d, 2) / d)
    table = np.zeros((n, d), np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return torch.from_numpy(table).to(device)
