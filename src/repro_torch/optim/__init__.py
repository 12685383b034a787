from repro_torch.optim.optimizers import (
    Optimizer,
    apply_updates,
    clip_by_global_norm,
    clip_by_global_norm_stacked,
    sgd,
)

__all__ = [
    "Optimizer",
    "sgd",
    "clip_by_global_norm",
    "clip_by_global_norm_stacked",
    "apply_updates",
]
