"""Paper Fig. 4: impact of packet loss (the port of
``benchmarks/fig4_loss.py``).

Claims reproduced: <30% loss mild (TCP retransmits recover); 30-50%
degraded (training time inflates steeply, small accuracy cost); >50%
catastrophic failure (reorder-buffer exhaustion); bigger buffers (Rec #2)
extend the envelope at a time cost.

The (loss x tcp-config) grid runs as one scenario-parallel plane by
default; ``engine="per_point"`` reproduces the same rows point by point.
"""

from repro_torch.experiments.common import emit_csv, run_points
from repro_torch.transport import BIG_BUFFER, DEFAULT, LAB

LOSSES = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.55, 0.6, 0.8]


def sweep_points(fast: bool = False):
    losses = LOSSES[::2] if fast else LOSSES
    points = []
    for p in losses:
        link = LAB.replace(loss=p, name=f"loss{p}")
        points.append(dict(tcp=DEFAULT, link=link))
        points.append(dict(tcp=BIG_BUFFER, link=link))
    return losses, points


def compute_rows(fast: bool = False, engine: str = "grid", device=None):
    losses, points = sweep_points(fast)
    res = run_points(points, engine, device=device)
    rows = []
    for i, p in enumerate(losses):
        r_def, r_big = res[2 * i], res[2 * i + 1]
        rows.append([
            p, r_def["trained"], r_def["training_time_s"], r_def["accuracy"],
            r_big["trained"], r_big["training_time_s"],
        ])
    return rows


def main(fast: bool = False, engine: str = "grid", device=None):
    rows = compute_rows(fast, engine, device)
    emit_csv(
        "fig4_loss: training vs packet loss (default vs big-buffer TCP)",
        ["loss", "default_trains", "default_time_s", "default_acc",
         "bigbuf_trains", "bigbuf_time_s"],
        rows,
    )
    by_loss = {r[0]: r for r in rows}
    if 0.3 in by_loss and 0.5 in by_loss and 0.0 in by_loss:
        assert by_loss[0.3][2] > by_loss[0.0][2]  # slower under loss
    dead = [r for r in rows if r[0] > 0.5 and r[0] <= 0.7]
    assert all(r[1] == 0.0 for r in dead), ">50% loss must kill training"
    return rows


if __name__ == "__main__":
    main()
