"""Sweep-engine benchmark: the scenario-parallel grid vs the per-point loop
(the port of ``benchmarks/sweep_bench.py``).

Runs the paper's Fig. 3 characterization grid (delay x tcp-config, the full
DELAYS ladder unless ``fast``) through both execution engines at the same
fixed seed:

- ``per_point``: one FederatedServer per sweep point (each point pays its
  own local-SGD dispatches and evals per round);
- ``grid``: ``run_fl_grid`` — per round, every point's transport on its own
  RNG stream, the union of local-training rows as one fused plane dispatch
  with provenance coalescing, eval memoized.

A second section benchmarks the FUSED TRANSPORT PLANE on a fig4-size
STOCHASTIC (DES) grid with split RNG streams: the per-point transport loop
(every point samples its own ``sim_cohort_round`` per round) against
``transport="fused"`` (ONE shared-rng ``sim_grid_round`` pass per round
for every point's cohort). Its parity flag is the per-scenario-rng
contract: ``transport="parity"`` — the same single ``sim_grid_round`` call
driven by per-point streams — reproduces the per-point loop's rows bitwise.

Prints a BENCH json line with both wall times, the speedup, the grid's
``GridStats`` and EXACT row parity flags (CSV-text equality, nan-aware) for
fig3, fig4 and table3. A parity failure exits 1; the speed targets are
readings (``meets_target``), not gates. Both engines share one task per
device, a thinned fig3 grid through both precedes timing, and each engine
is timed over one pass (the card synchronized around it); the schema's
``reps`` is 1 and each ``*_times_s`` list holds that pass. Every entry point
runs on CUDA unless given ``device=``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from repro_torch.core.server import _TRANSPORT_STREAM, derive_rng
from repro_torch.experiments import common, fig3_latency, fig4_loss, table3_boundaries
from repro_torch.transport import sim_cohort_round, sim_grid_round
from repro_torch.utils import resolve_device


def _csv_rows(rows):
    """Rows as CSV text cells — exact-parity comparison, nan-aware
    (str(nan) == str(nan), while nan != nan as floats)."""
    return [[str(x) for x in r] for r in rows]


def time_transport_plane(tcps, links, up, down, rounds: int):
    """Time EXACTLY the work the grid engine hoists: per round, every
    scenario's stochastic cohort transport — as S per-scenario
    ``sim_cohort_round`` calls (the per-point transport loop) vs ONE fused
    shared-rng ``sim_grid_round``. Streams are derived per (scenario/grid,
    round) as the engines derive them; payload bytes are per scenario.
    Host numpy on both sides. Returns (loop_s, fused_s), one pass each."""
    S = len(links)
    C = len(links[0])
    ltt = np.full(C, 2.0)
    conn = np.zeros(C, bool)

    def loop():
        for r in range(rounds):
            for s in range(S):
                sim_cohort_round(
                    tcps[s], links[s], update_bytes=up[s], local_train_times=ltt,
                    rng=derive_rng(s, _TRANSPORT_STREAM, r), connected=conn,
                    download_bytes=down[s],
                )

    def fused():
        for r in range(rounds):
            sim_grid_round(
                tcps, links, update_bytes=np.asarray(up, np.int64),
                download_bytes=np.asarray(down, np.int64),
                local_train_times=np.broadcast_to(ltt, (S, C)),
                connected=np.broadcast_to(conn, (S, C)),
                rng=derive_rng(0, _TRANSPORT_STREAM, r),
            )

    t0 = time.perf_counter()
    loop()
    t1 = time.perf_counter()
    fused()
    return t1 - t0, time.perf_counter() - t1


def fused_transport_section(pts, grid_label: str, tcps, links, up, down, *, device=None):
    """The fused-transport BENCH sub-dict (sweep_bench and compress_bench
    print the same schema). ``transport_*`` times the hoisted work alone
    (``time_transport_plane``; the 2x target lives here); ``sweep_*`` the
    end-to-end stochastic sweep both ways (informational); ``parity`` is
    the per-scenario-rng contract: one ``sim_grid_round`` per round on the
    points' own streams reproduces the per-point transport loop's rows
    bitwise."""
    device = resolve_device(device)
    loop_s, fused_plane_s = time_transport_plane(tcps, links, up, down, common.ROUNDS)

    def sweep(transport, **kw):
        return common.run_fl_grid_experiments(pts, transport=transport, device=device, **kw)

    sweep("per_point")  # warmup
    sweep("fused")
    rows_pp, sweep_pp_s = common.wall_s(device, lambda: sweep("per_point"))
    (_, stats), sweep_fused_s = common.wall_s(device, lambda: sweep("fused", return_stats=True))
    rows_parity = sweep("parity")
    parity = _csv_rows([list(r.values()) for r in rows_parity]) == _csv_rows(
        [list(r.values()) for r in rows_pp])
    return {
        "grid": grid_label,
        "points": len(pts),
        "transport_loop_s": round(loop_s, 3),
        "transport_fused_s": round(fused_plane_s, 3),
        "speedup": round(loop_s / fused_plane_s, 3),
        "target_speedup": 2.0,
        "meets_target": loop_s / fused_plane_s >= 2.0,
        "sweep_per_point_s": round(sweep_pp_s, 3),
        "sweep_fused_s": round(sweep_fused_s, 3),
        "parity": parity,
        "transport_dispatches": stats.transport_dispatches,
        "transport_rows": stats.transport_rows,
    }


def run_fused_transport_bench(*, fast: bool = False, device=None):
    """The fused transport plane vs the per-point transport loop on the
    stochastic fig4 grid (uncompressed: full-model payloads both ways)."""
    _, raw = fig4_loss.sweep_points(fast)
    up_bytes = common._shared_task(device).update_bytes
    return fused_transport_section(
        common.stochastic_fig4_points(fast),
        "fig4_loss stochastic (DES, split streams)",
        [kw["tcp"] for kw in raw],
        [[kw["link"]] * common.N_CLIENTS for kw in raw],
        [up_bytes] * len(raw),
        [up_bytes] * len(raw),
        device=device,
    )


def run_bench(*, fast: bool = False, device=None):
    device = resolve_device(device)

    # warmup: a thinned fig3 grid through both engines
    fig3_latency.compute_rows(fast=True, engine="grid", device=device)
    fig3_latency.compute_rows(fast=True, engine="per_point", device=device)

    rows_grid, grid_s = common.wall_s(
        device, lambda: fig3_latency.compute_rows(fast=fast, engine="grid", device=device))
    rows_pp, pp_s = common.wall_s(
        device, lambda: fig3_latency.compute_rows(fast=fast, engine="per_point", device=device))
    grid_stats = common.last_grid_stats

    parity_fig3 = _csv_rows(rows_grid) == _csv_rows(rows_pp)
    parity_fig4 = _csv_rows(fig4_loss.compute_rows(fast=fast, engine="grid", device=device)) \
        == _csv_rows(fig4_loss.compute_rows(fast=fast, engine="per_point", device=device))
    # table3 classifies the grid analytically (no FL runs): parity here
    # asserts the sweep artifact is reproducible run to run
    parity_table3 = _csv_rows(table3_boundaries.compute_rows(fast)) == _csv_rows(
        table3_boundaries.compute_rows(fast))

    result = {
        "bench": "sweep_engine",
        "config": {
            "grid": "fig3_latency",
            "points": len(fig3_latency.sweep_points(fast)[1]),
            "fast": fast,
            "reps": 1,
        },
        "per_point_s": round(pp_s, 3),
        "grid_s": round(grid_s, 3),
        "speedup": round(pp_s / grid_s, 3),
        "per_point_times_s": [round(pp_s, 3)],
        "grid_times_s": [round(grid_s, 3)],
        "target_speedup": 2.5,
        "meets_target": pp_s / grid_s >= 2.5,
        "parity_fig3": parity_fig3,
        "parity_fig4": parity_fig4,
        "parity_table3": parity_table3,
        "parity": parity_fig3 and parity_fig4 and parity_table3,
        "grid_stats": dataclasses.asdict(grid_stats) if grid_stats else None,
        "fused_transport": run_fused_transport_bench(fast=fast, device=device),
    }
    result["parity"] = result["parity"] and result["fused_transport"]["parity"]
    print("BENCH " + json.dumps(result))
    return result


def main(fast: bool = False, device=None):
    result = run_bench(fast=fast, device=device)
    if not result["parity"]:
        print("sweep_bench: PARITY FAILURE", file=sys.stderr)
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="thinned grid")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(fast=args.fast, device=args.device)
