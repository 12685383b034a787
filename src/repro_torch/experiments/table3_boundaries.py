"""Paper Table III: acceptable / tolerable / failure operating regions (the
port of ``benchmarks/table3_boundaries.py``).

Grid over (delay, loss, client-failure) classified by the transport model +
quorum semantics, matching the paper's summary table:

    Network delay:   <0.3s acceptable | ~5s tolerable | >5s failure
    Packet loss:     <10% acceptable | 30-40% tolerable | >50% failure
    Client failure:  <50% acceptable | 50-70% tolerable | >90% failure
"""

from repro_torch.core import fedavg
from repro_torch.experiments.common import emit_csv
from repro_torch.transport import DEFAULT, LAB, classify

DELAYS = [0.05, 0.3, 1.0, 5.0, 6.0, 10.0]
LOSSES = [0.05, 0.1, 0.3, 0.4, 0.5, 0.6]
FAILS = [0.3, 0.5, 0.7, 0.9, 0.95]


def classify_failure_rate(rate: float, min_fit: float = 0.1) -> str:
    quorum = fedavg(min_fit=min_fit).quorum(10)
    alive = int(10 * (1 - rate) + 1e-9)  # floor: 95% of 10 leaves 0 whole clients
    if alive < quorum:
        return "failure"
    if rate >= 0.5:
        return "tolerable"  # trains, but slower convergence (paper: +23%)
    return "acceptable"


def compute_rows(fast: bool = False):
    rows = []
    for d in DELAYS:
        rows.append(["delay", d, classify(DEFAULT, LAB.replace(delay=d))])
    for p in LOSSES:
        rows.append(["loss", p, classify(DEFAULT, LAB.replace(loss=p))])
    for f in FAILS:
        rows.append(["client_failure", f, classify_failure_rate(f)])
    return rows


def main(fast: bool = False):
    rows = compute_rows(fast)
    emit_csv("table3_boundaries", ["dimension", "value", "region"], rows)

    got = {(r[0], r[1]): r[2] for r in rows}
    assert got[("delay", 0.05)] == "acceptable"
    assert got[("delay", 6.0)] == "failure"
    assert got[("loss", 0.05)] == "acceptable"
    assert got[("loss", 0.6)] == "failure"
    assert got[("client_failure", 0.95)] == "failure"
    assert got[("client_failure", 0.9)] == "tolerable"
    return rows


if __name__ == "__main__":
    main()
