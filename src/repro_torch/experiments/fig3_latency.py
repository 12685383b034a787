"""Paper Fig. 3: impact of one-way latency on FL training (the port of
``benchmarks/fig3_latency.py``).

Claim reproduced: below 5 s the key impact is increased training time;
above 5 s one-way delay, no training (TCP handshake budget < RTT).

The whole (delay x tcp-config) grid runs as one scenario-parallel plane
(``engine="grid"``, the default); ``engine="per_point"`` runs the same
points through the per-point loop and produces identical rows.
"""

from repro_torch.experiments.common import emit_csv, run_points
from repro_torch.transport import DEFAULT, LAB, TUNED_EDGE

DELAYS = [0.0, 0.1, 0.3, 1.0, 2.0, 3.0, 5.0, 6.0, 8.0, 10.0]


def sweep_points(fast: bool = False):
    delays = DELAYS[::2] if fast else DELAYS
    points = []
    for d in delays:
        link = LAB.replace(delay=d, name=f"owd{d}")
        points.append(dict(tcp=DEFAULT, link=link))
        points.append(dict(tcp=TUNED_EDGE, link=link))
    return delays, points


def compute_rows(fast: bool = False, engine: str = "grid", device=None):
    delays, points = sweep_points(fast)
    res = run_points(points, engine, device=device)
    rows = []
    for i, d in enumerate(delays):
        r_def, r_tun = res[2 * i], res[2 * i + 1]
        rows.append([
            d, r_def["trained"], r_def["training_time_s"], r_def["accuracy"],
            r_tun["trained"], r_tun["training_time_s"], r_tun["accuracy"],
        ])
    return rows


def main(fast: bool = False, engine: str = "grid", device=None):
    rows = compute_rows(fast, engine, device)
    emit_csv(
        "fig3_latency: training vs one-way delay (default vs tuned TCP)",
        ["owd_s", "default_trains", "default_time_s", "default_acc",
         "tuned_trains", "tuned_time_s", "tuned_acc"],
        rows,
    )
    # the paper's cliff: defaults fail above 5 s OWD, tuned params survive
    cliff = [r for r in rows if r[0] > 5.0]
    assert all(r[1] == 0.0 for r in cliff), "defaults must fail beyond 5s"
    assert all(r[4] == 1.0 for r in cliff), "tuned params must restore training"
    return rows


if __name__ == "__main__":
    main()
