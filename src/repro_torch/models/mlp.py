"""Dense MLP blocks (the port of the dense half of ``repro/models/mlp.py``).

``swiglu`` runs ``kernels.ops.swiglu``: the hand-written fused kernel on
the card, its plain version on the CPU. It computes the reference's
``mlp_forward`` for ``mlp_kind == "swiglu"`` (asserted in
``tests/test_kernels.py``). ``gelu`` stays plain torch. Mixture of experts
is not ported (ROADMAP Queue 1, item 15).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.kernels import ops
from repro_torch.models.base import Ctx, gelu, linear


def mlp_params(ctx: Ctx, cfg, d_ff: Optional[int] = None, stacked: Optional[int] = None):
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    lead = () if stacked is None else (stacked,)
    la = () if stacked is None else ("layers",)
    if cfg.mlp_kind == "swiglu":
        return {
            "w_gate": ctx.param(lead + (d, ff), la + ("embed", "ffn")),
            "w_up": ctx.param(lead + (d, ff), la + ("embed", "ffn")),
            "w_down": ctx.param(lead + (ff, d), la + ("ffn", "embed")),
        }
    return {
        "w_up": ctx.param(lead + (d, ff), la + ("embed", "ffn")),
        "b_up": ctx.param(lead + (ff,), la + ("ffn",), init="zeros"),
        "w_down": ctx.param(lead + (ff, d), la + ("ffn", "embed")),
        "b_down": ctx.param(lead + (d,), la + ("embed",), init="zeros"),
    }


def mlp_forward(cfg, p, x):
    if cfg.mlp_kind == "swiglu":
        dt = x.dtype
        return ops.swiglu(x, p["w_gate"].to(dt), p["w_up"].to(dt), p["w_down"].to(dt))
    h = gelu(linear(x, p["w_up"]) + p["b_up"].to(x.dtype))
    return linear(h, p["w_down"]) + p["b_down"].to(x.dtype)
