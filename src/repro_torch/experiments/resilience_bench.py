"""Resilience benchmark: fault-domain gates and the cost of kill-and-resume
(the port of ``benchmarks/resilience_bench.py``).

Four sections, one BENCH json line:

- ``kill_resume``  a small characterization grid run three ways per
  transport mode: uninterrupted, checkpointed every round (the overhead),
  and killed at the halfway round then resumed from its
  ``checkpoint_dir``. The gate is crash consistency: the resumed sweep's
  histories are BITWISE equal to the uninterrupted run's, every summary
  field and every per-round record;
- ``retry_frontier`` the paper's 5 s handshake cliff as a trade-off: a
  delay ladder on a lossy link x retry budgets through both stochastic
  transport engines (host DES grid and device plane), pooled delivery
  rates as CSV. Gates: delivery non-decreasing in budget (sampling
  tolerance) on both backends, a strict improvement at the cliff, and
  host/device agreement;
- ``quarantine``   a NaN-poisoned point inside a sweep is retired (status
  "diverged") while every other point stays bitwise equal to a sweep
  without it;
- ``retry_degenerate`` loss=0/jitter=0 at 6 s OWD makes the retry ladder's
  clock closed-form (56.0 s with 3 retries); host grid and device plane
  agree on it.

Checkpoint overhead is reported, not gated. Every entry point runs on CUDA
unless given ``device=``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

from repro_torch.core import EdgeClient, run_fl_grid
from repro_torch.core.server import _TRANSPORT_STREAM, derive_rng
from repro_torch.experiments.common import (
    _make_point,
    _shared_eval_data,
    _shared_shards,
    _shared_task,
    emit_csv,
)
from repro_torch.transport import (
    DEFAULT,
    LAB,
    RetryPolicy,
    sim_grid_round,
    sim_grid_round_device,
    transport_plane_key,
)


def _histories_identical(ref, got) -> bool:
    """Bitwise identity of two History lists: summary fields (nan equal to
    nan) and every per-round record tuple."""
    if len(ref) != len(got):
        return False
    for hr, hg in zip(ref, got):
        a, b = hr.summary(), hg.summary()
        for k in a:
            if a[k] != b[k] and not (a[k] != a[k] and b[k] != b[k]):
                return False
        if len(hr.rounds) != len(hg.rounds):
            return False
        for rr, rg in zip(hr.rounds, hg.rounds):
            if (
                rr.round_idx, rr.t_start, rr.t_end, rr.selected_ids,
                rr.delivered, rr.failed_round, rr.reconnects, rr.cause,
            ) != (
                rg.round_idx, rg.t_start, rg.t_end, rg.selected_ids,
                rg.delivered, rg.failed_round, rg.reconnects, rg.cause,
            ):
                return False
    return True


def kill_resume_section(*, fast: bool = False, reps: int = 1, device=None):
    """Per transport mode: the overhead of per-round checkpoints and the
    bitwise kill-and-resume gate."""
    rounds = 4 if fast else 8
    half = rounds // 2
    task, eval_data = _shared_task(device), _shared_eval_data()

    def stochastic_points():
        kw = dict(rounds=rounds, stochastic=True, rng_streams="split")
        return [
            _make_point(**kw),
            _make_point(link=LAB.replace(delay=0.3), **kw),
            # retry state is round-local, so a round-granular restore of a
            # retrying point stays exact
            _make_point(link=LAB.replace(loss=0.1), retry=RetryPolicy(max_retries=2), **kw),
        ]

    def deterministic_points():
        return [
            _make_point(rounds=rounds),
            _make_point(rounds=rounds, link=LAB.replace(delay=0.3)),
            _make_point(rounds=rounds, link=LAB.replace(delay=1.0)),
        ]

    modes = [("fused", stochastic_points)]
    if not fast:
        modes.insert(0, ("per_point", deterministic_points))

    out = []
    for mode, pts in modes:
        run_fl_grid(task, pts(), eval_data=eval_data, transport=mode)  # warm-up
        base_t, ckpt_t = [], []
        ref = None
        with tempfile.TemporaryDirectory() as tmp:
            for rep in range(max(int(reps), 1)):
                t0 = time.perf_counter()
                ref = run_fl_grid(task, pts(), eval_data=eval_data, transport=mode)
                base_t.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                run_fl_grid(task, pts(), eval_data=eval_data, transport=mode,
                            checkpoint_dir=os.path.join(tmp, f"full{rep}"))
                ckpt_t.append(time.perf_counter() - t0)
            d = os.path.join(tmp, "killed")
            part = run_fl_grid(task, pts(), eval_data=eval_data, transport=mode,
                               checkpoint_dir=d, stop_after_round=half)
            res = run_fl_grid(task, pts(), eval_data=eval_data, transport=mode,
                              checkpoint_dir=d)
        base_s = float(np.median(base_t))
        ckpt_s = float(np.median(ckpt_t))
        parity = (
            part.stats.checkpoints_saved == half
            and res.stats.resumed_round == half
            and _histories_identical(ref.histories, res.histories)
        )
        out.append({
            "transport": mode,
            "points": 3,
            "rounds": rounds,
            "kill_at_round": half,
            "baseline_s": base_s,
            "checkpointed_s": ckpt_s,
            "overhead_pct": 100.0 * (ckpt_s - base_s) / base_s,
            "resume_parity": parity,
        })
    return out


def retry_frontier_section(*, fast: bool = False, device=None):
    """Retry-budget frontier on a lossy delay ladder near the 5 s cliff:
    pooled delivery rate per (delay, budget) through the host DES and the
    device plane, with monotonicity, cliff-improvement and host/device
    gates."""
    delays = [4.0] if fast else [3.0, 4.0, 5.0]
    budgets = [0, 1, 3]
    rounds, cohort = 8, 16
    kw = dict(
        update_bytes=np.full(1, 200_000, np.int64),
        download_bytes=np.full(1, 200_000, np.int64),
        local_train_times=np.full((1, cohort), 5.0),
        connected=np.zeros((1, cohort), bool),
    )
    rows, rates = [], {}
    for delay in delays:
        link = LAB.replace(delay=delay, loss=0.15)
        for budget in budgets:
            rp = RetryPolicy(max_retries=budget) if budget else None
            host = np.concatenate([
                sim_grid_round([DEFAULT], [[link] * cohort],
                               rng=derive_rng(0, _TRANSPORT_STREAM, r), retry=rp, **kw
                               ).success.ravel()
                for r in range(rounds)
            ]).mean()
            dev = np.concatenate([
                sim_grid_round_device([DEFAULT], [[link] * cohort],
                                      key=transport_plane_key(0, _TRANSPORT_STREAM, r),
                                      retry=rp, device=device, **kw
                                      ).success.cpu().numpy().ravel()
                for r in range(rounds)
            ]).mean()
            rates[(delay, budget)] = (float(host), float(dev))
            rows.append([delay, budget, round(float(host), 4), round(float(dev), 4)])
    emit_csv(
        "resilience_retry_frontier",
        ["delay_s", "retry_budget", "host_delivery", "device_delivery"],
        rows,
    )
    # monotone in budget per delay, both backends (binomial sampling
    # tolerance at rounds*cohort draws per cell)
    tol = 0.05
    monotone = all(
        rates[(d, hi)][b] >= rates[(d, lo)][b] - tol
        for d in delays
        for lo, hi in zip(budgets, budgets[1:])
        for b in (0, 1)
    )
    # the budget buys a STRICT improvement at the cliff delay
    cliff = all(rates[(4.0, budgets[-1])][b] > rates[(4.0, 0)][b] + 0.05 for b in (0, 1))
    agreement = all(abs(h - d) < 0.15 for h, d in rates.values())
    return {
        "delays_s": delays,
        "budgets": budgets,
        "samples_per_cell": rounds * cohort,
        "rates": [[d, b, h, v] for (d, b), (h, v) in rates.items()],
        "monotone": monotone,
        "cliff_improvement": cliff,
        "host_device_agreement": agreement,
        "parity": monotone and cliff and agreement,
    }


def quarantine_section(*, fast: bool = False, device=None):
    """Isolation gate: one NaN-poisoned point is quarantined and every other
    point's history is bitwise equal to a sweep without it."""
    rounds = 2 if fast else 3
    task, eval_data = _shared_task(device), _shared_eval_data()
    links = [LAB, LAB.replace(delay=0.3), LAB.replace(delay=1.0)]

    shard = _shared_shards(0)[0]
    images = shard.images.copy()
    images.reshape(-1)[0] = np.nan
    poisoned = dataclasses.replace(
        _make_point(rounds=rounds),
        clients=[EdgeClient(i, dataset=dataclasses.replace(shard, images=images))
                 for i in range(len(_shared_shards(0)))],
    )
    ref = run_fl_grid(task, [_make_point(rounds=rounds, link=l) for l in links],
                      eval_data=eval_data)
    got = run_fl_grid(
        task,
        [_make_point(rounds=rounds, link=links[0]), poisoned,
         _make_point(rounds=rounds, link=links[1]), _make_point(rounds=rounds, link=links[2])],
        eval_data=eval_data,
    )
    bad = got.histories[1]
    healthy = [got.histories[0], got.histories[2], got.histories[3]]
    isolated = (bad.status == "diverged" and got.stats.quarantined == 1
                and _histories_identical(ref.histories, healthy))
    return {
        "points": 4,
        "rounds": rounds,
        "poisoned_status": bad.status,
        "poisoned_cause": bad.cause,
        "isolation": isolated,
    }


def retry_degenerate_section(*, device=None):
    """Host/device retry parity on the deterministic path: the 6 s-OWD
    loss-free ladder exhausts every attempt, so the round clock is the
    closed form 10.5 + (2+10.5) + (4+10.5) + (8+10.5) = 56.0 s."""
    link = LAB.replace(delay=6.0)
    rp = RetryPolicy(max_retries=3, base_backoff=2.0, backoff_factor=2.0)
    host = sim_grid_round(
        [DEFAULT], [[link] * 4], update_bytes=100_000,
        local_train_times=np.full((1, 4), 5.0), connected=np.zeros((1, 4), bool),
        rng=derive_rng(0, _TRANSPORT_STREAM, 0), retry=rp,
    )
    dev = sim_grid_round_device(
        [DEFAULT], [[link] * 4], update_bytes=np.full(1, 100_000, np.int64),
        download_bytes=np.full(1, 100_000, np.int64),
        local_train_times=np.full((1, 4), 5.0), connected=np.zeros((1, 4), bool),
        key=transport_plane_key(0, _TRANSPORT_STREAM, 0), retry=rp, device=device,
    )
    host_t = np.asarray(host.time, np.float64)
    dev_t = dev.time.cpu().numpy().astype(np.float64)
    parity = (
        not host.success.any()
        and not bool(dev.success.any())
        and bool(np.allclose(host_t, 56.0, rtol=1e-6))
        and bool(np.allclose(dev_t, 56.0, rtol=1e-4))
    )
    return {
        "expected_s": 56.0,
        "host_s": float(host_t.mean()),
        "device_s": float(dev_t.mean()),
        "parity": parity,
    }


def run_bench(*, fast: bool = False, reps: int = 1, device=None):
    kill_resume = kill_resume_section(fast=fast, reps=reps, device=device)
    frontier = retry_frontier_section(fast=fast, device=device)
    quarantine = quarantine_section(fast=fast, device=device)
    degenerate = retry_degenerate_section(device=device)
    result = {
        "bench": "resilience",
        "config": {"fast": fast, "reps": max(int(reps), 1)},
        "kill_resume": kill_resume,
        "retry_frontier": frontier,
        "quarantine": quarantine,
        "retry_degenerate": degenerate,
        "parity": (
            all(m["resume_parity"] for m in kill_resume)
            and frontier["parity"]
            and quarantine["isolation"]
            and degenerate["parity"]
        ),
    }
    print("BENCH " + json.dumps(result))
    return result


def main(fast: bool = False, reps: int = 1, device=None):
    result = run_bench(fast=fast, reps=reps, device=device)
    if not result["parity"]:
        print("resilience_bench: RESILIENCE GATE FAILURE", file=sys.stderr)
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(fast=args.fast, reps=args.reps, device=args.device)
