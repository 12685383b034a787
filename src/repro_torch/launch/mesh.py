"""Meshes as shapes, and the card's constants (the port of
``repro/launch/mesh.py``).

A mesh here is what the sharding rules read: named axes and their sizes
(``MeshShape``). ``make_production_mesh`` gives the reference's production
layouts, 16 x 16 ("data", "model") or 2 x 16 x 16 ("pod", "data",
"model"), as shapes only: no device stands behind them, so the rules can
be held to the reference's on any host. ``make_host_mesh`` lays the CUDA
devices present (1 x 1 on the CPU) out as data x model, as the
reference's does with its host devices. ``H100_SXM`` replaces the
reference's TPU constants in the roofline (``launch.roofline``).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.sharding.rules import _AMBIENT, ambient_mesh  # noqa: F401


@dataclass(frozen=True)
class MeshShape:
    """Named mesh axes and their sizes (no devices)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        assert len(self.axis_names) == len(self.shape), (self.axis_names, self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 = 256 devices per pod; ``multi_pod`` adds a leading 2-pod axis."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(*, data: int = 1, model: int = 1) -> MeshShape:
    """data x model over the CUDA devices present (one device, the CPU,
    without CUDA), each cut to what the devices allow, as the reference's
    is cut to its host devices."""
    n = max(torch.cuda.device_count(), 1)
    data = min(data, n)
    model = max(min(model, n // max(data, 1)), 1)
    return MeshShape(("data", "model"), (data, model))


def make_device_mesh(shape: MeshShape, device=None):
    """A ``DeviceMesh`` of ``shape`` (its axis names as ``mesh_dim_names``)
    over the ranks of the default process group, rank-major. ``device``
    ("cuda" or "cpu"; default "cuda") picks the backend, ``nccl`` or
    ``gloo``. Without a group (one process) it starts one of world size 1
    from a ``HashStore``; under ``torchrun`` or ``mp.spawn`` it uses the
    group the caller started, whose world must equal the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    kind = torch.device(device or "cuda").type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda mesh needs CUDA; pass device='cpu' for a gloo mesh")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    if world != shape.size:
        raise ValueError(f"mesh {shape.axis_names} x {shape.shape} needs {shape.size} ranks; "
                         f"the process group has {world}")
    if kind == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    ranks = torch.arange(world).reshape(shape.shape)
    return DeviceMesh(kind, ranks, mesh_dim_names=shape.axis_names)


@contextlib.contextmanager
def mesh_context(mesh):
    """The ambient mesh within the block (see the module docstring)."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


# Roofline constants of one card (NVIDIA H100 SXM5 data sheet): dense bf16
# tensor-core rate, HBM3 bandwidth and size, NVLink 4 (900 GB/s both ways
# in all, 450 GB/s each way), at the card's 700 W power limit. Between
# nodes (NVIDIA DGX H100 data sheet: 8 cards a node, one ConnectX-7
# InfiniBand NDR port of 400 Gb/s per card) a card sends 50e9 bytes/s each
# way; ``launch.roofline`` says which link a mesh's collectives cross.
H100_SXM = {
    "name": "h100_sxm",
    "peak_flops_bf16": 989e12,  # FLOP/s per card
    "hbm_bw": 3.35e12,  # bytes/s per card
    "hbm_bytes": 80e9,  # per card
    "nvlink_bw": 450e9,  # bytes/s each way per card, within a node
    "ib_bw": 50e9,  # bytes/s each way per card, between nodes (400 Gb/s NDR)
    "cards_per_node": 8,
    "power_limit_w": 700,
}
