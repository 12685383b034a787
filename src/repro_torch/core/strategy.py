"""FL aggregation strategies (the port of the slice's part of
``repro/core/strategy.py``).

All strategies speak *deltas*: clients send (new_params - global_params);
the server turns the aggregated delta into the next global model.
``min_fit_fraction`` implements Flower's min_fit_clients semantics, the
paper's Recommendation #3 knob. FedAvg and FedProx are ported; the robust
and server-optimizer strategies are not yet (ROADMAP Queue 1, item 5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.utils import tree_add, tree_leaves, tree_unstack, tree_weighted_mean


@dataclass
class Strategy:
    name: str
    min_fit_fraction: float = 0.5  # Flower default-ish; paper tunes to 0.1
    min_eval_fraction: float = 0.5
    prox_mu: float = 0.0  # >0 => FedProx client regularizer
    # server-side optimizer (FedOpt/DiLoCo): not ported yet, and a server
    # given a strategy that sets it refuses to start
    server_opt: Optional[object] = None
    aggregate_fn: Callable = None  # (deltas, weights) -> delta
    # Stacked twin of aggregate_fn for the batched cohort engine:
    # (stacked_deltas [C,...], weights [C]) -> delta. None => the server
    # unstacks and falls back to the list path.
    stacked_aggregate_fn: Callable = None
    # hashable identity of the aggregation semantics (grid provenance)
    agg_fingerprint: tuple = ()

    def quorum(self, n_total: int) -> int:
        return max(1, int(np.ceil(self.min_fit_fraction * n_total)))

    def aggregate(self, global_params, deltas: Sequence, weights: Sequence[float], step: int):
        """Returns new global params given delivered client deltas."""
        return self._apply(global_params, self.aggregate_fn(deltas, weights), step)

    def aggregate_stacked(self, global_params, stacked_deltas, weights, step: int):
        """Batched-engine entry: deltas arrive stacked along a leading client
        axis; the weighted-mean family reduces them in one kernel pass per
        leaf with no per-client scaled copies."""
        if self.stacked_aggregate_fn is None:
            return self.aggregate(global_params, tree_unstack(stacked_deltas), weights, step)
        return self._apply(global_params, self.stacked_aggregate_fn(stacked_deltas, weights), step)

    def _apply(self, global_params, agg_delta, step: int):
        if self.server_opt is not None:
            raise NotImplementedError(
                "server-side optimizers are not ported yet (ROADMAP Queue 1, item 5)"
            )
        return tree_add(global_params, agg_delta)


def _weighted_mean(deltas, weights):
    return tree_weighted_mean(list(deltas), np.asarray(weights, np.float64))


def _weighted_mean_stacked(stacked, weights):
    """Kernel-backed FedAvg reduction over stacked deltas [C, ...]: on a
    CUDA device the hand-written ``fedavg_reduce`` kernel, one launch for
    the whole tree; on the CPU its plain version."""
    device = tree_leaves(stacked)[0].device
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32, device=device)
    return kernel_ops.fedavg_reduce(stacked, w)


def fedavg(min_fit: float = 0.5, min_eval: float = 0.5) -> Strategy:
    """McMahan et al. FedAvg — the paper's configuration."""
    return Strategy(
        "fedavg", min_fit, min_eval,
        aggregate_fn=_weighted_mean, stacked_aggregate_fn=_weighted_mean_stacked,
        agg_fingerprint=("wmean",),
    )


def fedprox(mu: float = 0.01, min_fit: float = 0.5) -> Strategy:
    return Strategy(
        "fedprox", min_fit, min_fit, prox_mu=mu,
        aggregate_fn=_weighted_mean, stacked_aggregate_fn=_weighted_mean_stacked,
        agg_fingerprint=("wmean",),
    )


STRATEGIES = {
    "fedavg": fedavg,
    "fedprox": fedprox,
}
