"""Learning-rate schedules (the port of ``repro/optim/schedules.py``):
functions of an int step returning a Python float.

Each computes in f32 (numpy float32 scalars), as the reference's jnp
schedules do, so a rate is the same f32 value in both packages up to the
last bit of the cosine."""

from __future__ import annotations

import numpy as np

_F = np.float32


def constant(lr: float):
    return lambda step: float(_F(lr))


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        frac = np.minimum(_F(step) + _F(1.0), _F(warmup_steps)) / _F(max(warmup_steps, 1))
        return float(_F(lr) * frac)

    return fn


def cosine_warmup(lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        s = _F(step)
        warm = np.minimum(s + _F(1.0), _F(warmup_steps)) / _F(max(warmup_steps, 1))
        prog = np.clip((s - _F(warmup_steps)) / _F(max(total_steps - warmup_steps, 1)),
                       _F(0.0), _F(1.0))
        cos = _F(final_frac) + _F((1 - final_frac) * 0.5) * (_F(1.0) + np.cos(_F(np.pi) * prog))
        return float(_F(lr) * warm * cos)

    return fn
