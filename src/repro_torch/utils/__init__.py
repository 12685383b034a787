from repro_torch.utils.device import f32_math, resolve_device
from repro_torch.utils.pytree import (
    flatten_to_vector,
    tree_add,
    tree_leaves,
    tree_map,
    tree_scale,
    tree_size,
    tree_stack,
    tree_sub,
    tree_unflatten,
    tree_unstack,
    tree_weighted_mean,
    unflatten_from_vector,
)

__all__ = [
    "f32_math",
    "resolve_device",
    "tree_map",
    "tree_leaves",
    "tree_add",
    "tree_scale",
    "tree_sub",
    "tree_size",
    "tree_weighted_mean",
    "tree_stack",
    "tree_unflatten",
    "tree_unstack",
    "flatten_to_vector",
    "unflatten_from_vector",
]
