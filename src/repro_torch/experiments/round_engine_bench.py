"""Round-engine benchmark: the batched cohort engine vs the sequential one
(the port of ``benchmarks/round_engine_bench.py``).

Runs the same 32-client MNIST FL experiment twice — once with the
per-client loop (``batched=False``) and once with the batched cohort engine
(``batched=True``: one fused local-SGD dispatch per round, stacked-delta
aggregation through ``fedavg_reduce``, vectorized transport draws) — at a
fixed seed, and prints a BENCH json line with wall times, the speedup, and
the semantic-parity checks (completed rounds equal; final accuracy within
1e-3).

Methodology: both engines share one task, a throwaway one-round run of each
precedes timing, runs alternate and the median of ``reps`` wall times is
reported (the card is synchronized around each run). Eval runs once at the
end so the comparison isolates the round hot path. Both engines run the CNN
under the task's ``utils.f32_math`` guard, so their Histories are
reproducible on the card.

``SIZES`` holds the two sizes: the default (32 clients x 10 rounds of 10
local steps, 3 reps) and ``fast`` (8 clients x 3 rounds of 4, 1 rep). Every
entry point runs on CUDA unless given ``device=``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.chaos import ChaosSchedule
from repro_torch.core import EdgeClient, FederatedServer, ServerConfig, fedavg, mnist_cnn_task
from repro_torch.data import make_federated_mnist, synthetic_mnist
from repro_torch.experiments.common import wall_s
from repro_torch.transport import DEFAULT, LAB
from repro_torch.utils import resolve_device


def _build_server(task, shards_seed, *, n_clients, rounds, local_steps, seed, batched):
    shards = make_federated_mnist(n_clients, 320, seed=shards_seed)
    clients = [EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    return FederatedServer(
        task,
        clients,
        fedavg(min_fit=0.5),
        tcp=DEFAULT,
        chaos=ChaosSchedule(LAB),
        config=ServerConfig(
            rounds=rounds,
            local_steps=local_steps,
            seed=seed,
            batched=batched,
            eval_every=rounds,  # eval once at the end: time the round hot path
        ),
        eval_data=synthetic_mnist(2000, seed=4242),
    )


SEED = 0
SIZES = {
    False: dict(n_clients=32, rounds=10, local_steps=10, reps=3),
    True: dict(n_clients=8, rounds=3, local_steps=4, reps=1),
}


def run_bench(*, fast: bool = False, device=None):
    size = SIZES[fast]
    n_clients, rounds, local_steps, reps = (
        size["n_clients"], size["rounds"], size["local_steps"], size["reps"])
    seed = SEED
    device = resolve_device(device)
    task = mnist_cnn_task(device=device)  # one task for every server below

    def timed_run(batched):
        srv = _build_server(task, seed, n_clients=n_clients, rounds=rounds,
                            local_steps=local_steps, seed=seed, batched=batched)
        hist, dt = wall_s(device, srv.run)
        return dt, hist

    # warmup: both engines at the bench shapes
    for batched in (False, True):
        _build_server(task, seed, n_clients=n_clients, rounds=1, local_steps=local_steps,
                      seed=seed, batched=batched).run()

    seq_times, bat_times = [], []
    hist_seq = hist_bat = None
    for _ in range(reps):  # interleaved
        dt, hist_bat = timed_run(batched=True)
        bat_times.append(dt)
        dt, hist_seq = timed_run(batched=False)
        seq_times.append(dt)

    seq_s = float(np.median(seq_times))
    bat_s = float(np.median(bat_times))
    s, b = hist_seq.summary(), hist_bat.summary()
    acc_diff = abs(s["final_accuracy"] - b["final_accuracy"])
    result = {
        "bench": "round_engine",
        "config": {
            "n_clients": n_clients, "rounds": rounds,
            "local_steps": local_steps, "seed": seed, "reps": reps,
        },
        "sequential_s": round(seq_s, 3),
        "batched_s": round(bat_s, 3),
        "speedup": round(seq_s / bat_s, 3),
        "sequential_times_s": [round(t, 3) for t in seq_times],
        "batched_times_s": [round(t, 3) for t in bat_times],
        "seq_completed_rounds": s["completed_rounds"],
        "bat_completed_rounds": b["completed_rounds"],
        "seq_final_accuracy": round(s["final_accuracy"], 5),
        "bat_final_accuracy": round(b["final_accuracy"], 5),
        "agree_completed_rounds": s["completed_rounds"] == b["completed_rounds"],
        "agree_total_time": abs(s["total_time_s"] - b["total_time_s"]) < 1e-6,
        "final_accuracy_diff": round(acc_diff, 6),
        "accuracy_within_tol": acc_diff <= 1e-3,
    }
    print("BENCH " + json.dumps(result))
    return result


def main(fast: bool = False, device=None):
    """The bench with its parity gate: ``SystemExit(1)`` when the engines
    disagree on completed rounds or on final accuracy beyond 1e-3."""
    result = run_bench(fast=fast, device=device)
    if not (result["agree_completed_rounds"] and result["accuracy_within_tol"]):
        print("round_engine_bench: PARITY FAILURE", file=sys.stderr)
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="8 clients x 3 rounds")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(fast=args.fast, device=args.device)
