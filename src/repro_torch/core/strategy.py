"""FL aggregation strategies (the port of the slice's part of
``repro/core/strategy.py``).

All strategies speak *deltas*: clients send (new_params - global_params);
the server turns the aggregated delta into the next global model.
``min_fit_fraction`` implements Flower's min_fit_clients semantics, the
paper's Recommendation #3 knob. FedAvg is the paper's baseline;
FedProx, the server-optimizer strategies (FedAdam / FedYogi / FedAdagrad,
DiLoCo) and the robust order-statistic strategies (trimmed mean, median,
Krum) are the "advanced reliability techniques" tier the paper's Table III
points practitioners to.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.optim import Optimizer, fedopt_server, nesterov_outer
from repro_torch.utils import tree_add, tree_leaves, tree_map, tree_unstack, tree_weighted_mean


@dataclass
class Strategy:
    name: str
    min_fit_fraction: float = 0.5  # Flower default-ish; paper tunes to 0.1
    min_eval_fraction: float = 0.5
    prox_mu: float = 0.0  # >0 => FedProx client regularizer
    # server-side optimizer (FedOpt/DiLoCo) and its state, made from the
    # global params at the first aggregation (on their device)
    server_opt: Optional[Optimizer] = None
    server_state: Optional[dict] = None
    aggregate_fn: Callable = None  # (deltas, weights) -> delta
    # Stacked twin of aggregate_fn for the batched cohort engine:
    # (stacked_deltas [C,...], weights [C]) -> delta. None => the server
    # unstacks and falls back to the list path.
    stacked_aggregate_fn: Callable = None
    # hashable identity of the aggregation semantics (grid provenance)
    agg_fingerprint: tuple = ()
    # True for order-statistic aggregators (trimmed_mean/median/krum) whose
    # semantics degenerate on a single update: the async engine refuses
    # async_buffer_k < 2 for them
    robust: bool = False

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
        if self.server_opt is None:
            return tree_add(global_params, agg_delta)
        if self.server_state is None:
            self.server_state = self.server_opt.init(global_params)
        upd, self.server_state = self.server_opt.update(
            agg_delta, self.server_state, global_params, step
        )
        return tree_add(global_params, upd)


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


def fedopt(kind: str = "adam", server_lr: float = 0.1, min_fit: float = 0.5) -> Strategy:
    return Strategy(
        f"fed{kind}",
        min_fit,
        min_fit,
        server_opt=fedopt_server(kind, lr=server_lr),
        aggregate_fn=_weighted_mean,
        stacked_aggregate_fn=_weighted_mean_stacked,
        agg_fingerprint=("wmean", "fedopt", kind, float(server_lr)),
    )


def diloco(outer_lr: float = 0.7, outer_momentum: float = 0.9, min_fit: float = 0.5) -> Strategy:
    """Local-SGD outer Nesterov — the cross-pod datacenter configuration."""
    return Strategy(
        "diloco",
        min_fit,
        min_fit,
        server_opt=nesterov_outer(outer_lr, outer_momentum),
        aggregate_fn=_weighted_mean,
        stacked_aggregate_fn=_weighted_mean_stacked,
        agg_fingerprint=("wmean", "nesterov", float(outer_lr), float(outer_momentum)),
    )


# ---------------------------------------------------------------------------
# robust order-statistic strategies: plain torch (no Pallas kernel computes
# them in the reference), each reduction in f32 as the reference's jnp code
# ---------------------------------------------------------------------------


def _trim_one(x: torch.Tensor, k: int) -> torch.Tensor:
    xs = torch.sort(x.float(), dim=0).values
    if xs.shape[0] > 2 * k:
        xs = xs[k : xs.shape[0] - k]
    # jnp.mean's f32 sum times f32(1/n), not a division
    return (xs.sum(dim=0) * (1.0 / xs.shape[0])).to(x.dtype)


def trimmed_mean(trim_fraction: float = 0.1, min_fit: float = 0.5) -> Strategy:
    """Coordinate-wise trimmed mean (robust to corrupt/straggled updates)."""

    def agg(deltas, weights):
        deltas = list(deltas)
        k = int(len(deltas) * trim_fraction)
        return tree_map(lambda *leaves: _trim_one(torch.stack(leaves), k), *deltas)

    def agg_stacked(stacked, weights):
        c = tree_leaves(stacked)[0].shape[0]
        k = int(c * trim_fraction)
        return tree_map(lambda x: _trim_one(x, k), stacked)

    return Strategy(
        "trimmed_mean", min_fit, min_fit,
        aggregate_fn=agg, stacked_aggregate_fn=agg_stacked,
        agg_fingerprint=("trimmed_mean", float(trim_fraction)),
        robust=True,
    )


def _median_one(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over axis 0: the midpoint of the two middle order
    statistics, (lo + hi) * 0.5, and NaN where a column holds a NaN."""
    xf = x.float()
    xs = torch.sort(xf, dim=0).values
    n = xs.shape[0]
    out = (xs[(n - 1) // 2] + xs[n // 2]) * 0.5
    out = torch.where(torch.isnan(xf).any(dim=0), torch.full_like(out, float("nan")), out)
    return out.to(x.dtype)


def median(min_fit: float = 0.5) -> Strategy:
    def agg(deltas, weights):
        return tree_map(lambda *leaves: _median_one(torch.stack(leaves)), *list(deltas))

    def agg_stacked(stacked, weights):
        return tree_map(_median_one, stacked)

    return Strategy(
        "median", min_fit, min_fit,
        aggregate_fn=agg, stacked_aggregate_fn=agg_stacked,
        agg_fingerprint=("median",),
        robust=True,
    )


def krum(n_byzantine: int = 1, min_fit: float = 0.5) -> Strategy:
    """Krum (Blanchard et al.): pick the delta closest to its neighbours."""

    def _krum_pick(V: torch.Tensor, n: int) -> int:
        d2 = torch.sum((V[:, None] - V[None, :]) ** 2, dim=-1)
        m = n - n_byzantine - 2
        scores = torch.sum(torch.sort(d2, dim=1).values[:, 1 : m + 1], dim=1)
        return int(torch.argmin(scores))

    def agg(deltas, weights):
        deltas = list(deltas)
        n = len(deltas)
        if n <= 2 * n_byzantine + 2:
            return _weighted_mean(deltas, weights)
        vecs = [torch.cat([l.float().reshape(-1) for l in tree_leaves(d)]) for d in deltas]
        return deltas[_krum_pick(torch.stack(vecs), n)]

    def agg_stacked(stacked, weights):
        leaves = tree_leaves(stacked)
        n = leaves[0].shape[0]
        if n <= 2 * n_byzantine + 2:
            return _weighted_mean_stacked(stacked, weights)
        V = torch.cat([l.float().reshape(n, -1) for l in leaves], dim=1)
        best = _krum_pick(V, n)
        return tree_map(lambda l: l[best], stacked)

    return Strategy(
        "krum", min_fit, min_fit,
        aggregate_fn=agg, stacked_aggregate_fn=agg_stacked,
        agg_fingerprint=("krum", int(n_byzantine)),
        robust=True,
    )


STRATEGIES = {
    "fedavg": fedavg,
    "fedprox": fedprox,
    "fedadam": lambda **kw: fedopt("adam", **kw),
    "fedyogi": lambda **kw: fedopt("yogi", **kw),
    "fedadagrad": lambda **kw: fedopt("adagrad", **kw),
    "diloco": diloco,
    "trimmed_mean": trimmed_mean,
    "median": median,
    "krum": krum,
}
