from repro_torch.optim.optimizers import (
    Optimizer,
    apply_updates,
    clip_by_global_norm,
    clip_by_global_norm_stacked,
    fedopt_server,
    nesterov_outer,
    sgd,
)

__all__ = [
    "Optimizer",
    "sgd",
    "nesterov_outer",
    "fedopt_server",
    "clip_by_global_norm",
    "clip_by_global_norm_stacked",
    "apply_updates",
]
