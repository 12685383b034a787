"""Async engine benchmark: the latency and dropout cliffs, sync vs async
(the port of ``benchmarks/async_bench.py``).

The paper's Fig. 3 cliff (no training above 5 s one-way delay, the TCP
handshake budget under the RTT) kills the synchronous round for the whole
cohort: one straggling half past the cliff and the run trips the failure
breaker. The event-driven async engine (``ServerConfig.async_mode``: a
delivery-ordered event queue, a FedBuff-style buffer of ``async_buffer_k``,
staleness weight ``(1+s)^-alpha``) keeps flushing from whoever still lands.

Sections, one BENCH json line:

- ``degenerate``    one client, clean link, ``async_buffer_k=1``: the async
  engine must reproduce the sync engine BITWISE (params, simulated clock,
  eval trace);
- ``latency_cliff`` half the clients on the base link, half at a swept
  one-way delay. Sync (min_fit=0.6) waits on the slow half and, past the
  handshake cliff, never meets quorum; async (buffer_k=3) flushes from the
  fast half;
- ``dropout``       60 % of the clients permanently killed.

Gates (``SystemExit(1)`` from ``main``): degenerate parity is bitwise; at
the cliff delay sync ends "failed" while async trains every tick; async
time-to-target <= sync time-to-target there (a dead run's is +inf);
under dropout async completes every tick while sync completes none. Every
entry point runs on CUDA unless given ``device=``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from repro_torch.chaos import ChaosSchedule, client_failure_schedule
from repro_torch.core import EdgeClient, FederatedServer, ServerConfig, fedavg
from repro_torch.data import make_federated_mnist
from repro_torch.experiments.common import (
    N_CLIENTS,
    _make_point,
    _shared_eval_data,
    _shared_task,
    emit_csv,
)
from repro_torch.transport import DEFAULT, LAB
from repro_torch.utils import tree_leaves

TARGET_LOSS = 2.35  # below the initial ~2.4, reachable within the round budget
CLIFF_DELAY = 6.0  # past the paper's 5 s handshake budget


def _run_point(kw, device=None):
    """One server run through the shared harness: (server, History)."""
    p = _make_point(**kw)
    srv = FederatedServer(
        _shared_task(device), p.clients, p.strategy, tcp=p.tcp, chaos=p.chaos,
        config=p.config, compressor=p.compressor, eval_data=_shared_eval_data(),
    )
    return srv, srv.run()


def _time_to_target(hist, target: float = TARGET_LOSS) -> float:
    """Simulated seconds until eval loss first drops below ``target`` (+inf
    if it never does)."""
    for m in hist.eval_metrics:
        if m.get("loss", math.inf) < target:
            return float(m["t"])
    return math.inf


def degenerate_section(device=None):
    """Bitwise async == sync on one client, a clean link, a buffer of one."""

    def run(async_mode: bool):
        shards = make_federated_mnist(1, 64, seed=0)
        srv = FederatedServer(
            _shared_task(device), [EdgeClient(0, dataset=shards[0])], fedavg(),
            tcp=DEFAULT, chaos=ChaosSchedule(LAB),
            config=ServerConfig(rounds=3, local_steps=2, seed=0,
                                async_mode=async_mode, async_buffer_k=1),
            eval_data=_shared_eval_data(),
        )
        return srv, srv.run()

    s_sync, h_sync = run(False)
    s_asy, h_asy = run(True)
    params_bitwise = all(
        torch.equal(a, b)
        for a, b in zip(tree_leaves(s_sync.global_params), tree_leaves(s_asy.global_params))
    )
    losses = lambda h: [m.get("loss") for m in h.eval_metrics]  # noqa: E731
    parity = (
        params_bitwise
        and s_sync.sim_time == s_asy.sim_time
        and losses(h_sync) == losses(h_asy)
        and [r.t_end for r in h_sync.rounds] == [r.t_end for r in h_asy.rounds]
    )
    return {
        "rounds": 3,
        "params_bitwise": params_bitwise,
        "clock_equal": s_sync.sim_time == s_asy.sim_time,
        "parity": parity,
    }


def latency_cliff_section(*, fast: bool = False, device=None):
    """Sync-vs-async ladder over the slow half's one-way delay."""
    delays = [0.0, CLIFF_DELAY] if fast else [0.0, 1.0, 3.0, CLIFF_DELAY]
    rounds = 4 if fast else 6
    half = N_CLIENTS // 2
    rows, cells = [], {}
    for d in delays:
        links = None
        if d > 0:
            slow = LAB.replace(delay=d, name=f"slow{d}")
            links = [None] * (N_CLIENTS - half) + [slow] * half
        for eng, akw in (("sync", {}), ("async", dict(async_mode=True, async_buffer_k=3))):
            _, hist = _run_point(dict(min_fit=0.6, rounds=rounds, client_links=links,
                                      max_consecutive_failures=3, **akw), device)
            s = hist.summary()
            tta = _time_to_target(hist)
            cells[(d, eng)] = {"status": hist.status, "completed": int(s["completed_rounds"]),
                               "tta": tta}
            rows.append([
                d, eng, int(s["completed_rounds"]), round(s["total_time_s"], 1),
                round(s["final_accuracy"], 4) if not math.isnan(s["final_accuracy"])
                else float("nan"),
                hist.status, round(tta, 1) if math.isfinite(tta) else "inf",
            ])
    emit_csv(
        "async_latency_cliff: sync vs async, slow half at swept OWD",
        ["slow_owd_s", "engine", "completed_rounds", "time_s", "accuracy", "status",
         "time_to_target_s"],
        rows,
    )
    sync_c, asy_c = cells[(CLIFF_DELAY, "sync")], cells[(CLIFF_DELAY, "async")]
    cliff = (sync_c["status"] == "failed" and asy_c["status"] == "healthy"
             and asy_c["completed"] == rounds)
    monotone = asy_c["tta"] <= sync_c["tta"]
    return {
        "delays_s": delays,
        "rounds": rounds,
        "cliff_sync_status": sync_c["status"],
        "cliff_async_completed": asy_c["completed"],
        "cliff_survival": cliff,
        "tta_sync_s": sync_c["tta"] if math.isfinite(sync_c["tta"]) else "inf",
        "tta_async_s": asy_c["tta"] if math.isfinite(asy_c["tta"]) else "inf",
        "tta_monotone": monotone,
        "parity": cliff and monotone,
    }


def dropout_section(*, fast: bool = False, device=None):
    """60 % of the clients permanently dead: sync's quorum (min_fit=0.6) is
    out of reach and the breaker kills the run; async keeps flushing from
    the survivors."""
    rounds = 4 if fast else 6
    mk_chaos = lambda: ChaosSchedule(LAB).add(  # noqa: E731
        client_failure_schedule(N_CLIENTS, 0.6, seed=2))
    _, h_sync = _run_point(dict(min_fit=0.6, rounds=rounds, chaos=mk_chaos(),
                                max_consecutive_failures=3), device)
    _, h_asy = _run_point(dict(min_fit=0.6, rounds=rounds, chaos=mk_chaos(),
                               max_consecutive_failures=3, async_mode=True, async_buffer_k=3),
                          device)
    gate = (h_sync.completed_rounds == 0 and h_asy.status == "healthy"
            and h_asy.completed_rounds == rounds)
    return {
        "failure_rate": 0.6,
        "rounds": rounds,
        "sync_completed": h_sync.completed_rounds,
        "sync_status": h_sync.status,
        "async_completed": h_asy.completed_rounds,
        "async_status": h_asy.status,
        "parity": gate,
    }


def run_bench(*, fast: bool = False, device=None):
    degenerate = degenerate_section(device)
    cliff = latency_cliff_section(fast=fast, device=device)
    dropout = dropout_section(fast=fast, device=device)
    result = {
        "bench": "async",
        "config": {"fast": fast, "target_loss": TARGET_LOSS, "cliff_delay_s": CLIFF_DELAY},
        "degenerate": degenerate,
        "latency_cliff": cliff,
        "dropout": dropout,
        "parity": degenerate["parity"] and cliff["parity"] and dropout["parity"],
    }
    print("BENCH " + json.dumps(result))
    return result


def main(fast: bool = False, device=None):
    result = run_bench(fast=fast, device=device)
    if not result["parity"]:
        print("async_bench: ASYNC ENGINE GATE FAILURE", file=sys.stderr)
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(fast=args.fast, device=args.device)
