from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor,
    adamw,
    apply_updates,
    clip_by_global_norm,
    clip_by_global_norm_stacked,
    fedopt_server,
    global_norm,
    nesterov_outer,
    sgd,
)
from repro_torch.optim.schedules import constant, cosine_warmup, linear_warmup

__all__ = [
    "Optimizer",
    "sgd",
    "adamw",
    "adafactor",
    "nesterov_outer",
    "fedopt_server",
    "clip_by_global_norm",
    "clip_by_global_norm_stacked",
    "global_norm",
    "apply_updates",
    "constant",
    "cosine_warmup",
    "linear_warmup",
]
