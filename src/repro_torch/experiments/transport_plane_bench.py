"""Device transport plane benchmark: host-numpy loops against the device
plane (the port of ``benchmarks/transport_plane_bench.py``).

Times exactly the per-round transport work on a fig4-faithful stochastic
grid — the paper's loss ladder (0..0.6 step 0.05) x {DEFAULT, BIG_BUFFER},
LAB delays, 300 KB payloads — at three plane sizes (S*C ~ 64, 512, 4096
rows), three ways:

- ``host_loop_s``:  S per-scenario ``sim_cohort_round`` calls per round
  (the per-point transport loop — the host-numpy baseline);
- ``host_fused_s``: one vectorized numpy ``sim_grid_round`` per round;
- ``device_s``:     one ``sim_grid_round_device`` call per round (the
  torch plane on the device, one host sync per loop iteration).

The >= 3x gate applies at the LARGEST size against the host loop; the
speedup over the fused numpy plane is reported beside it.

Two parity gates run in the same invocation (failure exits non-zero):

- ``parity_exact``: on the degenerate loss=0 / jitter=0 grid every draw is
  unused, so the device plane reproduces the host oracle exactly —
  success and reconnects bitwise, clocks to float32 tolerance.
- ``parity_distributional``: on the stochastic grid host and device sample
  different streams, so agreement is statistical: per-scenario delivery
  rates within a 4-sigma binomial envelope of the pooled estimate, and
  median delivered clocks within 20 % where both sides mostly deliver.

An end-to-end section sweeps a thinned stochastic fig4 grid through
``run_fl_grid`` with ``transport="fused"`` on both backends and reports
wall times and the device-dispatch telemetry.

Method: per size, each execution runs once untimed (warm-up), then one
timed pass of ``ROUNDS`` rounds each, in turns. Device results are copied to the host inside the timed region,
so the device's work is billed. Runs on CUDA unless given ``device=``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch.core.server import _TRANSPORT_STREAM, derive_rng
from repro_torch.experiments.common import run_fl_grid_experiments, stochastic_fig4_points
from repro_torch.transport import (
    BIG_BUFFER,
    DEFAULT,
    LAB,
    TUNED_EDGE,
    sim_cohort_round,
    sim_grid_round,
    sim_grid_round_device,
    transport_plane_key,
)

ROUNDS = 4
UPDATE_BYTES = 300_000
TRAIN_TIME = 30.0
SIZES = (64, 512, 4096)  # target S*C row counts (actual: S * (target // S))
GATE_SPEEDUP = 3.0
PARITY_ROUNDS = 3  # rounds pooled by the distributional gate


def _grid(target_rows: int):
    """The fig4-faithful scenario list at ~``target_rows`` total rows:
    losses 0..0.6 step 0.05 x {DEFAULT, BIG_BUFFER} (S=26 scenarios),
    cohort width C = target_rows // S. Heavy loss cells are where the host
    pays Python-level per-flow RTO loops — the honest baseline."""
    losses = [round(0.05 * i, 2) for i in range(13)]
    tcps, links = [], []
    for tcp in (DEFAULT, BIG_BUFFER):
        for loss in losses:
            tcps.append(tcp)
            links.append(LAB.replace(loss=loss))
    C = max(target_rows // len(tcps), 1)
    return tcps, [[lk] * C for lk in links], C


def _round_args(links):
    S, C = len(links), len(links[0])
    return dict(
        update_bytes=np.full(S, UPDATE_BYTES, np.int64),
        download_bytes=np.full(S, UPDATE_BYTES, np.int64),
        local_train_times=np.full((S, C), TRAIN_TIME),
        connected=np.zeros((S, C), bool),
    )


def _run_host_loop(tcps, links, kw, rounds):
    outs = []
    for r in range(rounds):
        for s, (tcp, lks) in enumerate(zip(tcps, links)):
            outs.append(sim_cohort_round(
                tcp, lks,
                update_bytes=int(kw["update_bytes"][s]),
                download_bytes=int(kw["download_bytes"][s]),
                local_train_times=kw["local_train_times"][s],
                connected=kw["connected"][s],
                rng=derive_rng(s, _TRANSPORT_STREAM, r),
            ))
    return outs


def _run_host_fused(tcps, links, kw, rounds):
    return [
        sim_grid_round(tcps, links, rng=derive_rng(0, _TRANSPORT_STREAM, r), **kw)
        for r in range(rounds)
    ]


def _run_device(tcps, links, kw, rounds, device=None, stats=None):
    outs = []
    for r in range(rounds):
        out = sim_grid_round_device(
            tcps, links, key=transport_plane_key(0, _TRANSPORT_STREAM, r),
            device=device, stats=stats, **kw,
        )
        # bill the copy: success/time/reconnects is what the grid engine
        # brings to the host every round
        outs.append((out.success.cpu().numpy(), out.time.cpu().numpy(),
                     out.reconnects.cpu().numpy()))
    return outs


def time_plane_size(target_rows: int, device=None):
    """Wall times for ROUNDS rounds of the ~``target_rows``-row grid
    through all three executions (after one untimed warm-up pass)."""
    tcps, links, C = _grid(target_rows)
    kw = _round_args(links)

    _run_host_loop(tcps, links, kw, 1)
    _run_host_fused(tcps, links, kw, 1)
    _run_device(tcps, links, kw, 1, device)

    t0 = time.perf_counter()
    _run_host_loop(tcps, links, kw, ROUNDS)
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _run_host_fused(tcps, links, kw, ROUNDS)
    fused_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _run_device(tcps, links, kw, ROUNDS, device)
    dev_s = time.perf_counter() - t0
    return {
        "target_rows": target_rows,
        "rows": len(tcps) * C,
        "scenarios": len(tcps),
        "cohort": C,
        "rounds": ROUNDS,
        "host_loop_s": loop_s,
        "host_fused_s": fused_s,
        "device_s": dev_s,
        "speedup_vs_loop": loop_s / dev_s,
        "speedup_vs_fused": fused_s / dev_s,
    }


def check_parity_exact(device=None) -> bool:
    """Degenerate loss=0 / jitter=0 grid: the device plane matches the host
    oracle exactly — the flow mechanics are deterministic, so every stream
    draw is unused on both sides."""
    C = 16
    tcps = [DEFAULT, BIG_BUFFER, TUNED_EDGE]
    links = [[LAB] * C, [LAB.replace(delay=0.3)] * C, [LAB.replace(rate_mbps=1.0)] * C]
    kw = _round_args(links)
    host = sim_grid_round(tcps, links, rng=derive_rng(0, _TRANSPORT_STREAM, 0), **kw)
    dev = sim_grid_round_device(
        tcps, links, key=transport_plane_key(0, _TRANSPORT_STREAM, 0), device=device, **kw
    )
    return (
        bool(np.array_equal(host.success, dev.success.cpu().numpy()))
        and bool(np.array_equal(host.reconnects, dev.reconnects.cpu().numpy()))
        and bool(np.allclose(host.time, dev.time.cpu().numpy().astype(np.float64), rtol=1e-4))
    )


def check_parity_distributional(device=None):
    """Stochastic grid, different streams by design: per-scenario delivery
    rates agree within a 4-sigma binomial envelope of the pooled estimate
    (pooled over ``PARITY_ROUNDS`` rounds), and median delivered clocks within
    20 % where both sides deliver a majority of rows."""
    tcps, links, C = _grid(4096)
    kw = _round_args(links)
    S = len(tcps)
    n = C * PARITY_ROUNDS

    host = _run_host_fused(tcps, links, kw, PARITY_ROUNDS)
    dev = _run_device(tcps, links, kw, PARITY_ROUNDS, device)
    h_succ = np.stack([o.success for o in host])  # [R, S, C]
    d_succ = np.stack([o[0] for o in dev])
    h_time = np.stack([o.time for o in host])
    d_time = np.stack([o[1] for o in dev]).astype(np.float64)

    h_rate = h_succ.transpose(1, 0, 2).reshape(S, n).mean(axis=1)
    d_rate = d_succ.transpose(1, 0, 2).reshape(S, n).mean(axis=1)
    pooled = (h_rate + d_rate) / 2.0
    sigma = np.sqrt(np.maximum(pooled * (1.0 - pooled), 1e-4) * 2.0 / n)
    rate_gap = np.abs(h_rate - d_rate)
    rate_ok = bool(np.all(rate_gap <= 4.0 * sigma + 0.01))

    clock_ok = True
    worst_clock = 0.0
    for s in range(S):
        hm = h_succ[:, s, :].reshape(-1)
        dm = d_succ[:, s, :].reshape(-1)
        if hm.mean() < 0.5 or dm.mean() < 0.5:
            continue  # mostly-dead scenarios: clocks are censored
        qh = float(np.median(h_time[:, s, :].reshape(-1)[hm]))
        qd = float(np.median(d_time[:, s, :].reshape(-1)[dm]))
        rel = abs(qh - qd) / max(qh, 1e-9)
        worst_clock = max(worst_clock, rel)
        clock_ok = clock_ok and rel <= 0.20
    return {
        "rate_ok": rate_ok,
        "max_rate_gap": float(rate_gap.max()),
        "clock_ok": clock_ok,
        "max_clock_rel_gap": worst_clock,
        "ok": rate_ok and clock_ok,
    }


def run_end_to_end(device=None):
    """Thinned stochastic fig4 sweep through ``run_fl_grid``
    (transport="fused") on both backends: same grid, same point seeds,
    host plane against device plane end to end."""
    pts_host = stochastic_fig4_points(fast=True)
    pts_dev = [dict(kw, transport_backend="device") for kw in pts_host]

    run_fl_grid_experiments(pts_host, transport="fused", device=device)  # warm-up
    run_fl_grid_experiments(pts_dev, transport="fused", device=device)
    t0 = time.perf_counter()
    run_fl_grid_experiments(pts_host, transport="fused", device=device)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, stats = run_fl_grid_experiments(
        pts_dev, transport="fused", return_stats=True, device=device
    )
    dev_s = time.perf_counter() - t0
    return {
        "grid": "fig4_loss stochastic (DES, split streams)",
        "points": len(pts_host),
        "sweep_host_s": host_s,
        "sweep_device_s": dev_s,
        "transport_device_dispatches": stats.transport_device_dispatches,
        "transport_rows": stats.transport_rows,
    }


def run_bench(*, device=None):
    sizes = [time_plane_size(rows, device=device) for rows in SIZES]
    gate = sizes[-1]
    parity_exact = check_parity_exact(device)
    parity_dist = check_parity_distributional(device=device)
    result = {
        "bench": "transport_plane",
        "config": {
            "grid": "fig4 loss ladder x {DEFAULT, BIG_BUFFER}",
            "rounds": ROUNDS,
            "update_bytes": UPDATE_BYTES,
        },
        "sizes": sizes,
        "speedup": gate["speedup_vs_loop"],
        "target_speedup": GATE_SPEEDUP,
        "meets_target": gate["speedup_vs_loop"] >= GATE_SPEEDUP,
        "parity_exact": parity_exact,
        "parity_distributional": parity_dist,
        "parity": parity_exact and parity_dist["ok"],
        "end_to_end": run_end_to_end(device=device),
    }
    print("BENCH " + json.dumps(result))
    return result


def main(device=None):
    result = run_bench(device=device)
    if not result["parity"]:
        print("transport_plane_bench: PARITY FAILURE", file=sys.stderr)
        raise SystemExit(1)
    if not result["meets_target"]:
        print(
            f"transport_plane_bench: speedup {result['speedup']} < {GATE_SPEEDUP}x target",
            file=sys.stderr,
        )
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(device=args.device)
