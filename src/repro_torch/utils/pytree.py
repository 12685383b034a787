"""Tree arithmetic over nested dicts of tensors (the port of
``repro/utils/pytree.py``).

Params, deltas and optimizer state are plain nested dicts whose leaves are
tensors. Leaves are visited in SORTED-KEY order, the order
``jax.tree.leaves`` gives dicts, so every sum over leaves (the global clip
norms, the prox term) accumulates in the reference's order.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def tree_map(fn: Callable, tree, *rest):
    """Leaf-wise ``fn(leaf, *matching leaves of rest)``; dict structure kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """Leaves in sorted-key order (``jax.tree.leaves`` order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_add(a, b):
    """Leaf-wise a + b."""
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    """Leaf-wise a - b."""
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    """Leaf-wise a * s for scalar s."""
    return tree_map(lambda x: x * s, a)


def tree_size(a) -> int:
    """Total number of elements across all leaves."""
    return int(sum(np.prod(tuple(l.shape), dtype=np.int64) for l in tree_leaves(a)))


def tree_weighted_mean(trees, weights):
    """Weighted mean over a list of trees.

    ``weights`` is a 1-D array-like with one weight per tree, cast to f32
    and normalized in f32 (FedAvg semantics, raw example counts allowed)."""
    first = tree_leaves(trees[0])[0]
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32, device=first.device)
    w = w / torch.clamp(w.sum(), min=1e-20)

    def _avg(*leaves):
        stacked = torch.stack([l.float() for l in leaves])
        out = torch.tensordot(w, stacked, dims=1)
        return out.to(leaves[0].dtype)

    return tree_map(_avg, *trees)


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` filled from ``leaves`` in sorted-key
    (``tree_leaves``) order; the inverse of ``tree_leaves``."""
    it = iter(leaves)

    def _fill(node):
        if isinstance(node, dict):
            return {k: _fill(node[k]) for k in sorted(node)}
        return next(it)

    return _fill(template)


def tree_stack(trees):
    """Stack identically-structured trees along a new leading axis C."""
    return tree_map(lambda *leaves: torch.stack(leaves, dim=0), *trees)


def tree_unstack(tree):
    """Split a stacked tree (leading axis C on every leaf) into C trees."""
    leaves = tree_leaves(tree)
    if not leaves:
        return []
    return [tree_map(lambda l, _i=i: l[_i], tree) for i in range(leaves[0].shape[0])]


def flatten_to_vector(tree):
    """Flatten a tree into one 1-D f32 vector, leaves in sorted-key order.

    Returns (vector, meta) — see :func:`unflatten_from_vector`."""
    leaves = tree_leaves(tree)
    shapes = [tuple(l.shape) for l in leaves]
    dtypes = [l.dtype for l in leaves]
    vec = (
        torch.cat([l.float().reshape(-1) for l in leaves])
        if leaves
        else torch.zeros(0, dtype=torch.float32)
    )
    return vec, (tree, shapes, dtypes)


def unflatten_from_vector(vec, meta):
    template, shapes, dtypes = meta
    leaves = []
    offset = 0
    for shape, dtype in zip(shapes, dtypes):
        n = int(np.prod(shape, dtype=np.int64))
        leaves.append(vec[offset : offset + n].reshape(shape).to(dtype))
        offset += n
    return tree_unflatten(template, leaves)
