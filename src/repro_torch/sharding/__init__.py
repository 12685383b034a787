"""Logical-axis sharding rules (the port of ``repro/sharding``)."""

from repro_torch.sharding.rules import (
    CANDIDATES,
    PRIORITY,
    batch_spec,
    cache_shardings,
    input_shardings,
    param_shardings,
    spec_for_leaf,
    state_plane_sharding,
    to_placements,
)

__all__ = [
    "spec_for_leaf",
    "param_shardings",
    "cache_shardings",
    "input_shardings",
    "batch_spec",
    "state_plane_sharding",
    "to_placements",
    "PRIORITY",
    "CANDIDATES",
]
