"""Resilience benchmark: fault-domain gates and the cost of kill-and-resume
(the port of ``benchmarks/resilience_bench.py``'s host sections).

Sections, one BENCH json line:

- ``kill_resume``  a small characterization grid run three ways per
  transport mode: uninterrupted, checkpointed every round (the overhead),
  and killed at the halfway round then resumed from its
  ``checkpoint_dir``. The gate is crash consistency: the resumed sweep's
  histories are BITWISE equal to the uninterrupted run's, every summary
  field and every per-round record;
- ``quarantine``   a NaN-poisoned point inside a sweep is retired (status
  "diverged") while every other point stays bitwise equal to a sweep
  without it.

The reference's ``retry_frontier`` and ``retry_degenerate`` sections hold
the host DES against the device transport plane, which is not ported yet
(ROADMAP Queue 1, item 13): here they raise ``NotImplementedError``.
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
from repro_torch.experiments.common import (
    _make_point,
    _shared_eval_data,
    _shared_shards,
    _shared_task,
)
from repro_torch.transport import LAB, RetryPolicy


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


def retry_frontier_section(*, fast: bool = False):
    raise NotImplementedError(
        "retry_frontier holds the host DES against the device transport plane, "
        "which is not ported yet (ROADMAP Queue 1, item 13)"
    )


def retry_degenerate_section():
    raise NotImplementedError(
        "retry_degenerate holds the host DES against the device transport plane, "
        "which is not ported yet (ROADMAP Queue 1, item 13)"
    )


def run_bench(*, fast: bool = False, reps: int = 1, device=None):
    kill_resume = kill_resume_section(fast=fast, reps=reps, device=device)
    quarantine = quarantine_section(fast=fast, device=device)
    result = {
        "bench": "resilience",
        "config": {"fast": fast, "reps": max(int(reps), 1)},
        "kill_resume": kill_resume,
        "quarantine": quarantine,
        "parity": all(m["resume_parity"] for m in kill_resume) and quarantine["isolation"],
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
