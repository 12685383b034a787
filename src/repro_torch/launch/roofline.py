"""Roofline terms of a dry-run cell on the H100 (the port of
``repro/launch/roofline.py``).

The dry-run (``launch.dryrun``) counts ONE rank's work from its traced
step (``launch.hlo_analysis``), so every count is per card:

    compute term    = flops_per_chip / peak_flops
    memory term     = bytes_per_chip / hbm_bw
    collective term = collective_bytes_per_chip / link_bw

``link_bw`` is the slowest link the mesh's collectives cross. The meshes
are laid out rank-major over nodes of ``cards_per_node`` cards (8 on a DGX
H100), so an axis of size n whose ranks sit ``stride`` apart (the product
of the sizes after it) spans n * stride consecutive ranks. If every axis
of more than one rank spans at most one node's cards, its collectives stay
on NVLink (``nvlink_bw``); otherwise some cross nodes, over each card's
InfiniBand port (``ib_bw``). On the production meshes (16 x 16 and 2 x
16 x 16) every 16-wide axis spans at least two nodes, so the term is
InfiniBand's. The constants are ``launch.mesh.H100_SXM``'s, each with its
source there.

MODEL_FLOPS (the "useful" flops) = 6*N*D for training (N params, active
params for MoE, and D processed tokens), 2*N*D for inference steps. The
ratio MODEL_FLOPS / (flops_per_chip * chips) exposes remat / dispatch /
masking waste.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import H100_SXM


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / (flops_per_chip * chips)
    step_s: float  # max of the three terms (no-overlap bound)
    roofline_fraction: float  # compute_s / step_s (how compute-bound we are)
    collective_breakdown: Dict[str, float] = field(default_factory=dict)
    notes: str = ""
    link: str = ""  # the hw key the collective term divides by

    def as_dict(self) -> Dict:
        return dict(self.__dict__)


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6*N_active*D for train, 2*N_active*D per processed token set.

    For inference the embedding table does no matmul work and the unembed
    matmul runs only on emitted positions (prefill computes last-position
    logits only): N excludes them accordingly.
    """
    n = cfg.param_count(active_only=True)
    vd = cfg.padded_vocab * cfg.d_model
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * (n - vd) * tokens  # embed lookup is a gather, not flops
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        body = 2.0 * (n - 2 * vd) * tokens
        return body + 2.0 * vd * shape.global_batch  # last-position logits
    # decode: one token per sequence, logits on every emitted token
    return (2.0 * (n - 2 * vd) + 2.0 * vd) * shape.global_batch


def mesh_sizes_of(mesh_name: str) -> Sequence[int]:
    """"2x16x16" -> (2, 16, 16)."""
    return tuple(int(n) for n in mesh_name.split("x"))


def collective_link(sizes: Sequence[int], cards_per_node: int) -> str:
    """"nvlink_bw" if every axis of a rank-major mesh of ``sizes`` stays
    within one node, else "ib_bw" (see the module docstring)."""
    for i, n in enumerate(sizes):
        stride = math.prod(sizes[i + 1:])
        if n > 1 and n * stride > cards_per_node:
            return "ib_bw"
    return "nvlink_bw"


def derive(
    cfg: ModelConfig,
    shape: ShapeSpec,
    *,
    mesh_name: str,
    chips: int,
    flops_per_chip: float,
    bytes_per_chip: float,
    collective_bytes: Dict[str, float],
    hw: Optional[Dict] = None,
    notes: str = "",
) -> RooflineTerms:
    hw = hw or H100_SXM
    link = collective_link(mesh_sizes_of(mesh_name), hw["cards_per_node"])
    coll_total = sum(collective_bytes.values())
    compute_s = flops_per_chip / hw["peak_flops_bf16"]
    memory_s = bytes_per_chip / hw["hbm_bw"]
    collective_s = coll_total / hw[link]
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    total_flops = flops_per_chip * chips
    step = max(compute_s, memory_s, collective_s)
    return RooflineTerms(
        arch=cfg.name,
        shape=shape.name,
        mesh=mesh_name,
        chips=chips,
        flops_per_chip=flops_per_chip,
        bytes_per_chip=bytes_per_chip,
        collective_bytes_per_chip=coll_total,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant,
        model_flops=mf,
        useful_ratio=mf / total_flops if total_flops else 0.0,
        step_s=step,
        roofline_fraction=compute_s / step if step > 0 else 0.0,
        collective_breakdown=dict(collective_bytes),
        notes=notes,
        link=link,
    )
