"""Round-granular, atomic checkpoints in the reference's on-disk format."""

from repro_torch.checkpoint.store import (
    CheckpointManager,
    load_slot_maps,
    load_tree,
    save_tree,
)

__all__ = ["CheckpointManager", "save_tree", "load_tree", "load_slot_maps"]
