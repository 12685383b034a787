"""Population-plane benchmark: million-client rounds in O(cohort) memory
(the port of ``benchmarks/population_bench.py``).

Two sections, one BENCH json line each:

1. **Parity gate**: at N = 8 clients the sparse state plane reproduces the
   dense plane BITWISE (every ``History.summary()`` field, every per-round
   record, the eval trace) across the sequential / batched /
   fused_transport engines and the topk / int8 / bf16 plane compressors,
   and a lazy ``Population`` reproduces the materialized list on
   identical shards.
2. **Scale**: a population of ``population`` clients (1,000,000 by default)
   runs a round loop with cohort ~32: a seeded cohort draw over the whole
   population, local SGD on shards generated on first touch, top-k
   compression with error-feedback residuals in the sparse plane, simulated
   WAN transport. Gates: plane occupancy and capacity stay O(touched
   cohort), the host peak stays under a fixed budget, and clients
   materialized stay O(rounds x cohort). A 10x smaller population runs the
   same loop to show that the peak does not grow with N.

Host peaks come from ``tracemalloc``, which sees numpy and Python objects
but not torch's CPU allocator; on CUDA the device peak is
``torch.cuda.max_memory_allocated`` over the run. Every entry point runs on
CUDA unless given ``device=``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import tracemalloc

import torch

from repro_torch.chaos import ChaosSchedule
from repro_torch.compress import bf16_compressor, int8_compressor, topk_compressor
from repro_torch.core import (
    EdgeClient,
    FederatedServer,
    Population,
    ServerConfig,
    fedavg,
    mnist_cnn_task,
)
from repro_torch.data import (
    federated_mnist_factory,
    make_federated_mnist,
    shard_list_factory,
    synthetic_mnist,
)
from repro_torch.transport import DEFAULT, LAB

# Host-peak budget for the scale section (bytes): a dense plane for 1M
# clients of MNIST-CNN state would be ~800 GB and eager partitioning ~200 GB
# of images; 1 GB is ~3 orders of magnitude under either.
MEM_BUDGET_BYTES = 1024 * 1024 * 1024

_PARITY_ENGINES = {
    "sequential": dict(batched=False),
    "batched": dict(batched=True),
    "fused_transport": dict(batched=True, stochastic=True, engine="fused_transport"),
}
_PARITY_COMPRESSORS = {
    "topk:0.1": lambda: topk_compressor(0.1),
    "int8": int8_compressor,
    "bf16": bf16_compressor,
}


def _histories_bitwise(ha, hb) -> bool:
    sa, sb = ha.summary(), hb.summary()
    for k in sa:
        va, vb = sa[k], sb[k]
        if va != vb and not (va != va and vb != vb):  # nan == nan
            return False
    if len(ha.rounds) != len(hb.rounds):
        return False
    for ra, rb in zip(ha.rounds, hb.rounds):
        if (
            ra.round_idx, ra.t_start, ra.t_end, ra.selected_ids,
            ra.delivered, ra.failed_round, ra.reconnects, ra.cause,
        ) != (
            rb.round_idx, rb.t_start, rb.t_end, rb.selected_ids,
            rb.delivered, rb.failed_round, rb.reconnects, rb.cause,
        ):
            return False
    return ha.eval_metrics == hb.eval_metrics


def run_parity_gate(*, n_clients: int = 8, rounds: int = 3, device=None) -> dict:
    """Dense-vs-sparse bitwise gate over the engine x compressor matrix, and
    Population vs list."""
    task = mnist_cnn_task(device=device)
    shards = make_federated_mnist(n_clients, 64, seed=0)
    eval_data = synthetic_mnist(200, seed=77)

    def run(clients, comp, plane, **kw):
        return FederatedServer(
            task, clients, fedavg(min_fit=0.5), tcp=DEFAULT, chaos=ChaosSchedule(LAB),
            config=ServerConfig(rounds=rounds, local_steps=2, seed=0, clients_per_round=0.5,
                                state_plane=plane, **kw),
            compressor=comp, eval_data=eval_data,
        ).run()

    def mk():
        return [EdgeClient(i, dataset=s) for i, s in enumerate(shards)]

    cells = {}
    for ename, ekw in _PARITY_ENGINES.items():
        for cname, cfac in _PARITY_COMPRESSORS.items():
            h_dense = run(mk(), cfac(), "dense", **ekw)
            h_sparse = run(mk(), cfac(), "sparse", **ekw)
            cells[f"{ename}/{cname}"] = _histories_bitwise(h_dense, h_sparse)
    h_list = run(mk(), topk_compressor(0.1), "dense", batched=True)
    h_pop = run(Population(n_clients, shard_list_factory(shards)), topk_compressor(0.1),
                "sparse", batched=True)
    cells["population/topk:0.1"] = _histories_bitwise(h_list, h_pop)
    return {
        "bench": "population_parity",
        "config": {"n_clients": n_clients, "rounds": rounds},
        "cells": cells,
        "all_bitwise": all(cells.values()),
    }


def _run_population(task, n_clients: int, cohort: int, rounds: int) -> dict:
    pop = Population(n_clients, federated_mnist_factory(64, seed=9),
                     max_cached_shards=4 * cohort)
    srv = FederatedServer(
        task, pop, fedavg(min_fit=cohort / n_clients), tcp=DEFAULT, chaos=ChaosSchedule(LAB),
        config=ServerConfig(rounds=rounds, local_steps=1, seed=0, batched=True,
                            clients_per_round=cohort / n_clients, state_plane="sparse",
                            eval_every=rounds),
        compressor=topk_compressor(0.05),
        eval_data=synthetic_mnist(200, seed=77),
    )
    cuda = srv._device().type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tracemalloc.start()
    t0 = time.perf_counter()
    try:
        hist = srv.run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _, host_peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    plane = srv._residual_plane
    return {
        "n_clients": n_clients,
        "cohort": cohort,
        "rounds": rounds,
        "completed_rounds": hist.completed_rounds,
        "delivered_per_round": [r.delivered for r in hist.rounds],
        "wall_s": wall,
        "round_s": wall / max(rounds, 1),
        "host_peak_bytes": int(host_peak),
        "device_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else None,
        "plane_storage": plane.storage if plane is not None else None,
        "plane_occupancy": plane.occupancy if plane is not None else 0,
        "plane_capacity": plane.capacity if plane is not None else 0,
        "plane_device_bytes": plane.nbytes if plane is not None else 0,
        "clients_materialized": pop.materialized,
        "shards_cached": pop.cached_shards,
        "shards_built": pop.shards_built,
    }


def run_scale(*, population: int = 1_000_000, cohort: int = 32, rounds: int = 3,
              device=None) -> dict:
    task = mnist_cnn_task(device=device)
    # warm-up at a small population: first-touch costs excluded from timing
    _run_population(task, max(4 * cohort, 1024), cohort, 1)
    small = _run_population(task, max(population // 10, 4 * cohort), cohort, rounds)
    big = _run_population(task, population, cohort, rounds)
    touched = rounds * cohort
    gates = {
        "rounds_completed": big["completed_rounds"] == rounds,
        "cohort_delivered": all(d > 0 for d in big["delivered_per_round"]),
        "plane_o_cohort": (
            big["plane_storage"] == "sparse"
            and big["plane_occupancy"] <= touched
            and big["plane_capacity"] <= 4 * touched
        ),
        "host_peak_under_budget": big["host_peak_bytes"] < MEM_BUDGET_BYTES,
        "materialization_o_cohort": (
            big["clients_materialized"] <= touched and big["shards_cached"] <= 4 * cohort
        ),
        # the host peak must not scale with N: 2x for the O(N) cohort-draw
        # transient, against the 10x population ratio
        "peak_independent_of_n": big["host_peak_bytes"] <= 2 * max(small["host_peak_bytes"], 1),
    }
    return {
        "bench": "population_scale",
        "config": {"population": population, "cohort": cohort, "rounds": rounds},
        "small": small,
        "big": big,
        "gates": gates,
        "all_gates": all(gates.values()),
    }


def main(fast: bool = False, population: int = 1_000_000, cohort: int = 32, rounds: int = 3,
         device=None):
    parity = run_parity_gate(device=device)
    print("BENCH " + json.dumps(parity))
    scale = run_scale(population=100_000 if fast else population, cohort=cohort,
                      rounds=rounds, device=device)
    print("BENCH " + json.dumps(scale))
    if not parity["all_bitwise"]:
        bad = [k for k, v in parity["cells"].items() if not v]
        print(f"population_bench: PARITY FAILURE in {bad}", file=sys.stderr)
        raise SystemExit(1)
    if not scale["all_gates"]:
        bad = [k for k, v in scale["gates"].items() if not v]
        print(f"population_bench: SCALE GATE FAILURE in {bad}", file=sys.stderr)
        raise SystemExit(1)
    return {"parity": parity, "scale": scale}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="a 100k-client scale section")
    ap.add_argument("--population", type=int, default=1_000_000)
    ap.add_argument("--cohort", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(fast=args.fast, population=args.population, cohort=args.cohort, rounds=args.rounds,
         device=args.device)
