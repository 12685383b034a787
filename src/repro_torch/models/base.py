"""Parameter construction context + elementary ops shared by the LM blocks
(the port of ``repro/models/base.py``).

Models are plain functions ``apply(cfg, params, ...)`` over nested dicts of
tensors. The tree structure is defined once, in the init code, through a
:class:`Ctx`. The port keeps the ``init`` mode only: the reference's
``abstract`` and ``axes`` modes serve the dry-run and sharding, which are
not ported (ROADMAP Queue 1, item 16). Draws come from a
``torch.Generator`` on its own device, in f32, then cast to the parameter
dtype; the kinds and the fan-in rule are the reference's. The reference's
threefry draws have no torch counterpart, so tests carry its parameters
across with ``repro_torch.convert`` instead.

The ops compute in f32 and return the activation dtype, as the
reference's do. LayerNorm and the ``uniform`` init come with the families
that use them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Axes = Tuple[Optional[str], ...]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype string ("bfloat16", "float32") as a torch dtype."""
    return DTYPES[name]


class Ctx:
    """Parameter materialization context (init mode)."""

    def __init__(self, generator: torch.Generator, param_dtype=torch.bfloat16):
        self.generator = generator
        self.device = generator.device
        self.param_dtype = param_dtype

    def _randn(self, shape):
        return torch.randn(shape, generator=self.generator, device=self.device,
                           dtype=torch.float32)

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
        dtype = dtype or self.param_dtype
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init == "normal":
            s = 0.02 if scale is None else scale
            return (self._randn(shape) * s).to(dtype)
        if init == "fan_in":
            # fan_in = product of all dims except the last (stacked-layer dim
            # excluded by convention when axes[0] == "layers").
            dims = shape[1:] if axes and axes[0] == "layers" else shape
            fan_in = math.prod(dims[:-1]) if len(dims) > 1 else dims[0]
            s = (scale if scale is not None else 1.0) / max(math.sqrt(fan_in), 1.0)
            return (self._randn(shape) * s).to(dtype)
        raise ValueError(f"unknown init {init}")


# ---------------------------------------------------------------------------
# Elementary ops (compute in float32, return activation dtype)
# ---------------------------------------------------------------------------


def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def apply_norm(cfg, x, w):
    """The block's norm: RMSNorm (``segments`` refuses LayerNorm models)."""
    return rms_norm(x, w["scale"], cfg.norm_eps)


def norm_params(ctx: Ctx, cfg, d: int, stacked: Optional[int] = None):
    lead = () if stacked is None else (stacked,)
    lead_ax = () if stacked is None else ("layers",)
    return {"scale": ctx.param(lead + (d,), lead_ax + ("embed",), init="ones")}


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
