"""Paper §V validation: three tuned TCP knobs restore training capability
where defaults fail — the paper's core validated claim, end-to-end through
the FL engine (not just the transport model). All scenario pairs run as
one grid plane (the port of ``benchmarks/tuned_vs_default.py``)."""

from repro_torch.experiments.common import emit_csv, run_points
from repro_torch.transport import DEFAULT, LAB, TUNED_EDGE

SCENARIOS = [
    ("lab", LAB),
    ("extreme_latency_6s", LAB.replace(delay=6.0)),
    ("extreme_latency_8s", LAB.replace(delay=8.0)),
    ("long_idle_lossy", LAB.replace(delay=0.3, loss=0.15, middlebox_timeout=120.0)),
]


def sweep_points(fast: bool = False):
    points = []
    for name, link in SCENARIOS:
        points.append(dict(tcp=DEFAULT, link=link, local_steps=6))
        points.append(dict(tcp=TUNED_EDGE, link=link, local_steps=6))
    return points


def main(fast: bool = False, engine: str = "grid", device=None):
    res = run_points(sweep_points(fast), engine, device=device)
    rows = []
    for i, (name, link) in enumerate(SCENARIOS):
        d, t = res[2 * i], res[2 * i + 1]
        speedup = (
            round(d["training_time_s"] / t["training_time_s"], 2)
            if t["trained"] and d["trained"]
            else ("restored" if t["trained"] and not d["trained"] else "-")
        )
        rows.append([
            name, d["trained"], d["training_time_s"], t["trained"],
            t["training_time_s"], speedup,
        ])
    emit_csv(
        "tuned_vs_default: 3-knob TCP tuning (paper SecV validation)",
        ["scenario", "default_trains", "default_time_s",
         "tuned_trains", "tuned_time_s", "speedup_or_restored"],
        rows,
    )
    by = {r[0]: r for r in rows}
    assert by["extreme_latency_6s"][1] == 0.0 and by["extreme_latency_6s"][3] == 1.0
    return rows


if __name__ == "__main__":
    main()
