"""Plane-resident compression benchmark: the compressed characterization
grid, the stacked plane vs the unstacked per-client baseline (the port of
``benchmarks/compress_bench.py``).

Runs a fig4-style (packet-loss x tcp-config x compressor) grid — top-k and
int8 payloads under default and big-buffer TCP, the first mitigations
practitioners reach for at the paper's breaking points — through two
execution paths at the same fixed seed:

- ``plane``: ``run_fl_grid`` with plane-resident compression (stacked
  top-k / int8 through ``quantize_rows``, error-feedback residuals as a
  device plane, residual-digest provenance so compressed points coalesce
  rows and share eval);
- ``unstacked``: one FederatedServer per sweep point with the compressor's
  plane twin stripped (``compress_plane=None``): the server unstacks the
  cohort and compresses client by client.

Prints a BENCH json line with both wall times, the speedup, the grid's
``GridStats`` and EXACT row parity (CSV-text equality, nan-aware): plane
compression is bitwise identical to per-client compression, so any drift
exits 1. The 5x target is a reading (``meets_target``), not a gate.

A second section benchmarks the FUSED TRANSPORT PLANE on the same
compressed grid with stochastic (DES) transport and split RNG streams, each
plane row billing its point's asymmetric payloads (the compressor's exact
upload wire size, the full-model download); its parity flag is
``sweep_bench.fused_transport_section``'s.

Methodology as sweep_bench: one shared task and shared compressor
instances, a thinned warmup grid through both paths, one timed pass of each
(the card synchronized around it). Every entry point
runs on CUDA unless given ``device=``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from repro_torch.experiments import common
from repro_torch.experiments.sweep_bench import _csv_rows, fused_transport_section
from repro_torch.models.cnn import cnn_init
from repro_torch.transport import BIG_BUFFER, DEFAULT, LAB
from repro_torch.utils import resolve_device

LOSSES = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5]
COMPRESSORS = ["topk:0.05", "int8"]

_STRIPPED = {}  # spec -> plane-less Compressor (shared across points)


def _stripped(spec):
    if spec not in _STRIPPED:
        _STRIPPED[spec] = dataclasses.replace(
            common._shared_compressor(spec), compress_plane=None)
    return _STRIPPED[spec]


def sweep_points(fast: bool = False):
    losses = LOSSES[::2] if fast else LOSSES
    tcps = [("default", DEFAULT), ("bigbuf", BIG_BUFFER)]
    labels, points = [], []
    for comp in COMPRESSORS:
        for tcp_name, tcp in tcps:
            for p in losses:
                link = LAB.replace(loss=p, name=f"loss{p}")
                labels.append((comp, tcp_name, p))
                points.append(dict(tcp=tcp, link=link, compressor=comp))
    return labels, points


def compute_rows(fast: bool = False, engine: str = "plane", device=None):
    labels, points = sweep_points(fast)
    if engine == "plane":
        res = common.run_fl_grid_experiments(points, device=device)
    elif engine == "unstacked":
        res = [
            common.run_fl_experiment(device=device,
                                     **{**kw, "compressor": _stripped(kw["compressor"])})
            for kw in points
        ]
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return [
        [comp, tcp_name, p, r["trained"], r["training_time_s"], r["accuracy"]]
        for (comp, tcp_name, p), r in zip(labels, res)
    ]


def stochastic_points(fast: bool = False):
    """The compressed (loss x tcp x compressor) grid with event-granular DES
    transport on split streams; per-point stream seeds from a SeedSequence
    spawn, one shared shard set via ``data_seed``."""
    _, points = sweep_points(fast)
    seeds = common.spawn_point_seeds(len(points))
    return [
        dict(kw, stochastic=True, rng_streams="split", seed=s, data_seed=0)
        for kw, s in zip(points, seeds)
    ]


def run_fused_transport_bench(*, fast: bool = False, device=None):
    """The fused transport plane vs the per-point transport loop on the
    compressed stochastic grid. Each scenario's upload bills its
    compressor's exact wire size (of a CNN template from a seeded
    generator, on the device), the download the full model."""
    device = resolve_device(device)
    task = common._shared_task(device)
    template = cnn_init(torch.Generator().manual_seed(0), device=device)
    _, raw = sweep_points(fast)
    return fused_transport_section(
        stochastic_points(fast),
        "compressed fig4 stochastic (DES, split streams)",
        [kw["tcp"] for kw in raw],
        [[kw["link"]] * common.N_CLIENTS for kw in raw],
        [common._shared_compressor(kw["compressor"]).wire_bytes(template) for kw in raw],
        [task.update_bytes] * len(raw),
        device=device,
    )


def run_bench(*, fast: bool = False, device=None):
    device = resolve_device(device)

    # warmup: the thinned grid through both paths; the full grid coalesces
    # to wider plane dispatches than the thinned one, so the plane path
    # warms again at the timed shape
    compute_rows(fast=True, engine="plane", device=device)
    compute_rows(fast=True, engine="unstacked", device=device)
    if not fast:
        compute_rows(fast=False, engine="plane", device=device)

    rows_plane, plane_s = common.wall_s(
        device, lambda: compute_rows(fast=fast, engine="plane", device=device))
    rows_unstacked, unstacked_s = common.wall_s(
        device, lambda: compute_rows(fast=fast, engine="unstacked", device=device))
    grid_stats = common.last_grid_stats

    parity = _csv_rows(rows_plane) == _csv_rows(rows_unstacked)
    result = {
        "bench": "compress_plane",
        "config": {
            "grid": "fig4_loss x tcp x compressor",
            "compressors": COMPRESSORS,
            "points": len(sweep_points(fast)[1]),
            "fast": fast,
            "reps": 1,
        },
        "unstacked_s": round(unstacked_s, 3),
        "plane_s": round(plane_s, 3),
        "speedup": round(unstacked_s / plane_s, 3),
        "unstacked_times_s": [round(unstacked_s, 3)],
        "plane_times_s": [round(plane_s, 3)],
        "target_speedup": 5.0,
        "meets_target": unstacked_s / plane_s >= 5.0,
        "parity": parity,
        "grid_stats": dataclasses.asdict(grid_stats) if grid_stats else None,
        "fused_transport": run_fused_transport_bench(fast=fast, device=device),
    }
    result["parity"] = result["parity"] and result["fused_transport"]["parity"]
    print("BENCH " + json.dumps(result))
    return result


def main(fast: bool = False, device=None):
    result = run_bench(fast=fast, device=device)
    if not result["parity"]:
        print("compress_bench: PARITY FAILURE", file=sys.stderr)
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="thinned grid")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(fast=args.fast, device=args.device)
