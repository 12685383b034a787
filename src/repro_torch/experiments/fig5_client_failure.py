"""Paper Fig. 5: impact of client (pod) failure rate (the port of
``benchmarks/fig5_client_failure.py``).

Claim reproduced: with min_fit/min_eval at 10% (Rec #3) training tolerates
up to 90% client failure with no significant accuracy impact but longer
convergence; a strict quorum (50%) dies much earlier.

The (failure-rate x quorum) grid runs as one scenario-parallel plane by
default. The relaxed/strict pairs at each rate share their training
trajectory (quorum only gates round failure, not aggregation), so the grid
engine's provenance coalescing computes each trajectory once — this sweep
also exercises chaos-variable cohort sizes through the row-bucket ladder.
"""

from repro_torch.chaos import ChaosSchedule, client_failure_schedule
from repro_torch.experiments.common import emit_csv, run_points
from repro_torch.transport import DEFAULT, LAB

RATES = [0.0, 0.2, 0.4, 0.6, 0.8, 0.9, 0.95]


def sweep_points(fast: bool = False):
    rates = RATES[::2] if fast else RATES
    points = []
    for f in rates:
        chaos = ChaosSchedule(LAB).add(client_failure_schedule(10, f, seed=7))
        points.append(dict(tcp=DEFAULT, chaos=chaos, min_fit=0.1))
        points.append(dict(tcp=DEFAULT, chaos=chaos, min_fit=0.5))
    return rates, points


def compute_rows(fast: bool = False, engine: str = "grid", device=None):
    rates, points = sweep_points(fast)
    res = run_points(points, engine, device=device)
    rows = []
    for i, f in enumerate(rates):
        relaxed, strict = res[2 * i], res[2 * i + 1]
        rows.append([
            f, relaxed["trained"], relaxed["accuracy"], relaxed["training_time_s"],
            strict["trained"],
        ])
    return rows


def main(fast: bool = False, engine: str = "grid", device=None):
    rows = compute_rows(fast, engine, device)
    emit_csv(
        "fig5_client_failure: min_fit=10% vs 50% under pod kills",
        ["failure_rate", "minfit10_trains", "minfit10_acc", "minfit10_time_s",
         "minfit50_trains"],
        rows,
    )
    at90 = [r for r in rows if abs(r[0] - 0.9) < 1e-9]
    if at90:
        assert at90[0][1] == 1.0, "min_fit=10% must tolerate 90% failure (Rec #3)"
    return rows


if __name__ == "__main__":
    main()
