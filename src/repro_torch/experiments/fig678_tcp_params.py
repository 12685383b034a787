"""Paper Figs. 6-8: per-parameter TCP sweeps across the latency range (the
port of ``benchmarks/fig678_tcp_params.py``).

Fig 6 — tcp_syn_retries:      default 6 suboptimal at ~10/17 points (~60%)
Fig 7 — tcp_keepalive_time:   default 7200 suboptimal at ~11/17 (~65%)
Fig 8 — tcp_keepalive_intvl:  default 75 suboptimal at ~12/17 (>70%)

Swept with the analytic transport model under the paper's stressed-testbed
conditions (loss 8%, jitterless, FL round = connect + download + local
train idle + upload). The CSV carries every (value x latency) cell.
"""

import math

from repro_torch.experiments.common import emit_csv
from repro_torch.tuning.grid import (
    LATENCY_POINTS,
    best_per_latency,
    default_suboptimal_count,
    sweep_parameter,
)

# the paper's stressed-testbed regime: lossy edge link, long local training
CONDITIONS = dict(loss=0.08, local_train_time=900.0, update_bytes=300_000)

FIGS = [
    ("fig6", "tcp_syn_retries", 6),
    ("fig7", "tcp_keepalive_time", 7200.0),
    ("fig8", "tcp_keepalive_intvl", 75.0),
]


def keepalive_cohort_trace(fast: bool = False):
    """Fig 7/8 companion at cohort scale: the vectorized grid MC samples a
    (keepalive_time x latency) grid of whole cohorts in one fused pass and
    reports sparse per-client event counts (probes, probe failures, silent
    middlebox reaps, reconnects) — the connection-pattern analysis the
    paper does per client, at sweep scale."""
    import numpy as np

    from repro_torch.transport import DEFAULT, LAB, sim_grid_round

    ka_times = [60.0, 600.0, 7200.0]
    lats = [0.1, 3.0] if fast else [0.1, 1.0, 3.0]
    cohort = 8 if fast else 32
    grid = [(ka, lat) for ka in ka_times for lat in lats]
    tcps = [DEFAULT.replace(tcp_keepalive_time=ka) for ka, _ in grid]
    links = [
        [LAB.replace(delay=lat, loss=CONDITIONS["loss"])] * cohort
        for _, lat in grid
    ]
    s, c = len(grid), cohort
    out = sim_grid_round(
        tcps,
        links,
        update_bytes=CONDITIONS["update_bytes"],
        local_train_times=np.full((s, c), CONDITIONS["local_train_time"]),
        connected=np.ones((s, c), bool),
        rng=np.random.default_rng(0),
        trace=True,
    )
    rows = []
    for i, (ka, lat) in enumerate(grid):
        tr = {k: v[i] for k, v in out.trace.items()}
        rows.append([
            ka, lat,
            round(float(np.mean(tr["keepalive_probes"])), 1),
            round(float(np.mean(tr["keepalive_failures"])), 1),
            round(float(np.mean(tr["mbox_drops"])), 2),
            round(float(np.mean(out.reconnects[i])), 2),
            round(float(np.mean(out.success[i])), 2),
        ])
    emit_csv(
        "fig78_keepalive_cohort: sparse cohort traces (probes/reaps/reconnects)",
        ["keepalive_time", "owd_s", "mean_probes", "mean_probe_failures",
         "mbox_drop_rate", "mean_reconnects", "success_rate"],
        rows,
    )
    # the paper's burst-idle pathology: the 7200 s default never probes
    # during local training, so the middlebox silently reaps every idle
    # connection; a 60 s keepalive keeps the cohort alive
    by = {(r[0], r[1]): r for r in rows}
    assert all(by[(7200.0, lat)][4] == 1.0 for lat in lats)
    assert all(by[(60.0, lat)][4] == 0.0 for lat in lats)
    return rows


def main(fast: bool = False):
    out = {}
    lat = LATENCY_POINTS[::3] if fast else LATENCY_POINTS
    for fig, param, default in FIGS:
        results = sweep_parameter(param, latencies=lat, **CONDITIONS)
        rows = [
            [r.value, r.latency,
             round(r.round_time, 1) if math.isfinite(r.round_time) else "inf",
             round(r.p_complete, 3)]
            for r in results
        ]
        emit_csv(
            f"{fig}_{param}: value x latency -> expected round time",
            [param, "owd_s", "round_time_s", "p_complete"],
            rows,
        )
        n_sub = default_suboptimal_count(results, default)
        n_pts = len(lat)
        print(f"# {fig}: default {param}={default} suboptimal at {n_sub}/{n_pts} latency points")
        best = best_per_latency(results)
        winners = sorted({str(b.value) for b in best.values()})
        print(f"# {fig}: per-latency winners: {winners}")
        out[fig] = (n_sub, n_pts)
    keepalive_cohort_trace(fast)
    # the paper's qualitative claim: defaults lose at a majority-ish of points
    assert out["fig7"][0] >= out["fig7"][1] * 0.5
    return out


if __name__ == "__main__":
    main()
