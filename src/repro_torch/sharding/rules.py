"""Logical-axis sharding rules: axes trees -> per-leaf specs (the port of
``repro/sharding/rules.py``).

Every parameter and cache leaf carries a tuple of logical axis names
(``models.base.Ctx``'s axes mode, ``Model.cache_axes``). This module maps
them onto mesh axes with the reference's priority and divisibility
fallback:

- Priority: tensor-parallel axes (vocab / ffn / experts / heads) claim
  "model" first; FSDP axes (embed) claim "data"; leftovers (lora /
  embed2) take whatever mesh axis is still free on their candidate list.
- Divisibility fallback: a dimension that the mesh axis does not divide is
  replicated instead (phi3-medium's 40 q heads, starcoder2's 2 kv heads on
  a 16-way model axis).
- Decode caches shard batch over "data" and the kv sequence over "model".

A mesh is any object with ``axis_names`` and sizes: a
``launch.mesh.MeshShape`` (``shape``) or an object whose ``devices``
array has the shape (as the reference's meshes have). A spec is a plain
tuple with one entry per dimension: a mesh axis name, a
tuple of names, or None; it equals the reference's ``PartitionSpec``
entry for entry. ``to_placements`` turns one into the
``torch.distributed.tensor`` placements of a mesh.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch.utils import tree_map

Spec = Tuple[object, ...]

# assignment priority: earlier names claim mesh axes first. experts > ffn:
# expert-parallel beats per-expert TP when the expert count divides (160 on
# deepseek); falls back to ffn TP when it doesn't (mixtral's 8 experts).
# head_dim/qk_dim are LAST: they claim "model" only when heads couldn't.
PRIORITY = [
    "vocab", "experts", "ffn", "heads", "kvseq", "kv_heads",
    "embed", "batch", "embed2", "lora", "state", "head_dim", "qk_dim",
]

# logical axis -> ordered mesh-axis candidates
CANDIDATES = {
    "vocab": ["model"],
    "ffn": ["model"],
    "experts": ["model"],
    "heads": ["model"],
    "kv_heads": ["model"],
    "embed": ["data"],
    "embed2": ["model", "data"],
    "lora": ["model", "data"],
    "batch": ["data"],
    "kvseq": ["model"],
    "state": [],
    "seq": [],
    "encseq": [],
    # head_dim/qk_dim stay unsharded (the reference's choice: a param-level
    # head_dim shard fights the head-padded activation layout)
    "head_dim": [],
    "head_dim2": [],
    "qk_dim": [],
    "conv": [],
    "layers": [],
    "layers2": [],
}


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh (see the module docstring)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a torch DeviceMesh
        return dict(zip(names, (int(s) for s in mesh.mesh.shape)))
    devices = getattr(mesh, "devices", None)
    shape = mesh.shape if devices is None else devices.shape
    return dict(zip(mesh.axis_names, (int(s) for s in shape)))


def _batch_span(size: int, wanted, sizes) -> Optional[object]:
    """The longest prefix of ``wanted`` whose sizes' product divides
    ``size``: one name, a tuple of names, or None."""
    for k in range(len(wanted), 0, -1):
        span = wanted[:k]
        if size % math.prod(sizes[a] for a in span) == 0:
            return tuple(span) if len(span) > 1 else span[0]
    return None


def spec_for_leaf(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...], mesh, *,
                  fsdp: bool = True, batch_axes: Tuple[str, ...] = ("data",)) -> Spec:
    """Assign mesh axes to one leaf's dims by priority + divisibility."""
    assert len(shape) == len(axes), (shape, axes)
    assignment: list = [None] * len(axes)
    used = set()
    order = sorted(range(len(axes)),
                   key=lambda i: PRIORITY.index(axes[i]) if axes[i] in PRIORITY else 999)
    sizes = mesh_sizes(mesh)
    for i in order:
        name = axes[i]
        if name is None or (name == "embed" and not fsdp):
            continue
        if name == "batch":
            # batch may span several mesh axes (pod x data); shorter
            # prefixes when the size does not divide
            span = _batch_span(shape[i], [a for a in batch_axes if a in sizes and a not in used],
                               sizes)
            if span is not None:
                assignment[i] = span
                used.update(span if isinstance(span, tuple) else (span,))
            continue
        for cand in CANDIDATES.get(name, []):
            if cand in used or cand not in sizes:
                continue
            if shape[i] % sizes[cand] == 0:
                assignment[i] = cand
                used.add(cand)
                break
    return tuple(assignment)


def _tree_specs(spec_tree, axes_tree, mesh, **kw):
    # the axes tree's leaves are tuples: tree_map hands each over whole
    return tree_map(lambda leaf, axes: spec_for_leaf(tuple(leaf.shape), tuple(axes), mesh, **kw),
                    spec_tree, axes_tree)


def param_shardings(abstract_params, param_axes, mesh, *, fsdp: bool = True):
    """Specs for the parameter tree (TP over model, FSDP over data)."""
    return _tree_specs(abstract_params, param_axes, mesh, fsdp=fsdp)


def cache_shardings(cache_spec, cache_axes, mesh, *, batch_axes=("data",)):
    """Decode / prefill cache specs (batch -> data, kvseq -> model)."""
    return _tree_specs(cache_spec, cache_axes, mesh, batch_axes=batch_axes)


def batch_spec(mesh, batch_size: int, *, include_pod: bool = True):
    """The spec entry of a batch dim of the given size (divisibility
    checked; fewer axes, then replication: long_500k's B = 1)."""
    sizes = mesh_sizes(mesh)
    wanted = [a for a in (("pod", "data") if include_pod else ("data",)) if a in sizes]
    return _batch_span(batch_size, wanted, sizes)


def state_plane_sharding(mesh, *, axis: str = "data") -> Spec:
    """Row sharding of a per-client state plane's ``[rows, ...]`` buffer:
    the leading row dim over ``axis``, the rest replicated."""
    assert axis in mesh_sizes(mesh), (axis, mesh)
    return (axis,)


def input_shardings(input_specs_dict, mesh, *, include_pod: bool = True):
    """Shard every model input on its leading batch dim."""

    def one(leaf):
        ndim = len(leaf.shape)
        if not ndim:
            return ()
        return (batch_spec(mesh, int(leaf.shape[0]), include_pod=include_pod),
                *([None] * (ndim - 1)))

    return {k: one(v) for k, v in input_specs_dict.items()}


def to_placements(spec: Spec, mesh) -> tuple:
    """The ``torch.distributed.tensor`` placements of ``spec`` on ``mesh``:
    one per mesh axis, in the mesh's order, ``Shard(dim)`` for the axis
    that shards tensor dim ``dim`` (alone or in a tuple of axes) and
    ``Replicate()`` for an axis that shards none. Needs no process group."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {}
    for dim, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                assert name not in owner, f"mesh axis {name!r} shards two dims of {spec}"
                owner[name] = dim
    names = list(mesh_sizes(mesh))
    unknown = set(owner) - set(names)
    assert not unknown, f"{spec} names axes {sorted(unknown)} the mesh {names} lacks"
    return tuple(Shard(owner[n]) if n in owner else Replicate() for n in names)


# ---------------------------------------------------------------------------
# Concrete tensors on a torch DeviceMesh (the counterpart of jit's
# in_shardings / out_shardings on concrete arrays)
# ---------------------------------------------------------------------------

_AMBIENT: list = []


def ambient_mesh():
    """The DeviceMesh set by ``launch.mesh.mesh_context`` (the innermost),
    or None: what the activation constraints and ``models.moe_sharded``
    read, as the reference's read jax's ambient mesh."""
    return _AMBIENT[-1] if _AMBIENT else None


def placements_on(spec: Spec, mesh) -> tuple:
    """``to_placements`` on a DeviceMesh, an axis of one rank whole: it
    splits nothing, and its ``Shard`` would only leave DTensor's views
    (merging or splitting dims) something to refuse."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() if mesh.size(i) == 1 else p
                 for i, p in enumerate(to_placements(spec, mesh)))


def distribute_tree(tree, spec_tree, mesh):
    """Each leaf of ``tree`` (a whole tensor, the same on every rank: each
    rank keeps its own part, nothing is sent) distributed over ``mesh`` by
    its spec: a DTensor holding this rank's shard. A leaf that is already a
    DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, spec):
        placements = placements_on(spec, mesh)
        if isinstance(t, DTensor):
            return t.redistribute(mesh, placements)
        return distribute_tensor(t, mesh, placements, src_data_rank=None)

    return tree_map(one, tree, spec_tree)


def full_tree(tree):
    """Every DTensor leaf of ``tree`` gathered whole onto each rank (a
    plain tensor); other leaves as they are."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)
