"""Port parity: the paper's sweeps (``repro_torch.experiments``) against
their namesakes in ``benchmarks/``. Table III and Figs. 6-8 (transport
model and tuning, pure numpy) give EQUAL rows; the FL sweeps declare the
same points; fig3's thresholds hold on the port at full width (10 clients
x 200 examples, 8 rounds) on the CPU; the harness's grid and per-point
engines give equal rows."""

import dataclasses
import math
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # benchmarks/

from _torch_parity import one_torch_thread  # noqa: E402,F401 (fixture)
from benchmarks import adaptive_daemon as r_daemon  # noqa: E402
from benchmarks import fig3_latency as r_fig3  # noqa: E402
from benchmarks import fig4_loss as r_fig4  # noqa: E402
from benchmarks import fig5_client_failure as r_fig5  # noqa: E402
from benchmarks import fig678_tcp_params as r_fig678  # noqa: E402
from benchmarks import table3_boundaries as r_table3  # noqa: E402
from benchmarks import tuned_vs_default as r_tuned  # noqa: E402
from repro_torch.experiments import adaptive_daemon as p_daemon  # noqa: E402
from repro_torch.experiments import common  # noqa: E402
from repro_torch.experiments import fig3_latency as p_fig3  # noqa: E402
from repro_torch.experiments import fig4_loss as p_fig4  # noqa: E402
from repro_torch.experiments import fig5_client_failure as p_fig5  # noqa: E402
from repro_torch.experiments import fig678_tcp_params as p_fig678  # noqa: E402
from repro_torch.experiments import table3_boundaries as p_table3  # noqa: E402
from repro_torch.experiments import tuned_vs_default as p_tuned  # noqa: E402

FL = {"fig3": (p_fig3, r_fig3), "fig4": (p_fig4, r_fig4), "fig5": (p_fig5, r_fig5)}
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_table3_rows_equal_reference():
    assert p_table3.compute_rows() == r_table3.compute_rows()
    assert p_table3.main() == r_table3.main()


@pytest.mark.parametrize("fast", [True, False])
def test_fig678_rows_equal_reference(fast, capsys):
    """Every (value x latency) CSV row, the suboptimal counts and the
    keepalive cohort traces: the same text."""
    r_out = r_fig678.main(fast)
    r_text = capsys.readouterr().out
    p_out = p_fig678.main(fast)
    assert p_out == r_out
    assert capsys.readouterr().out == r_text


def test_adaptive_daemon_rows_equal_reference():
    for policy in ("default", "static_tuned", "adaptive"):
        assert p_daemon.simulate(policy) == r_daemon.simulate(policy)
    assert p_daemon.main() == r_daemon.main()


def _point_record(kw: dict) -> dict:
    """A sweep point's kwargs as plain data (either package's objects)."""
    return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            for k, v in kw.items()}


@pytest.mark.parametrize("fig", sorted(FL))
@pytest.mark.parametrize("fast", [True, False])
def test_fl_sweep_points_equal_reference(fig, fast):
    port, ref = FL[fig]
    p_vals, p_points = port.sweep_points(fast)
    r_vals, r_points = ref.sweep_points(fast)
    assert p_vals == r_vals
    assert [_point_record(kw) for kw in p_points] == [_point_record(kw) for kw in r_points]


def test_tuned_vs_default_points_equal_reference():
    r_points = []
    for _, link in r_tuned.SCENARIOS:  # the reference builds them inline in main()
        r_points.append(dict(tcp=r_tuned.DEFAULT, link=link, local_steps=6))
        r_points.append(dict(tcp=r_tuned.TUNED_EDGE, link=link, local_steps=6))
    assert [_point_record(kw) for kw in p_tuned.sweep_points()] == [
        _point_record(kw) for kw in r_points
    ]
    assert [n for n, _ in p_tuned.SCENARIOS] == [n for n, _ in r_tuned.SCENARIOS]


def test_harness_constants_equal_reference():
    from benchmarks import common as r_common

    for name in ("N_CLIENTS", "ROUNDS", "LOCAL_STEPS", "EXAMPLES_PER_CLIENT"):
        assert getattr(common, name) == getattr(r_common, name)
    assert common.spawn_point_seeds(5, root=3) == r_common.spawn_point_seeds(5, root=3)
    assert common._summarize(
        {"completed_rounds": 3, "total_time_s": 12.345, "final_accuracy": 0.91234,
         "mean_reconnects": 0.333}, 8
    ) == r_common._summarize(
        {"completed_rounds": 3, "total_time_s": 12.345, "final_accuracy": 0.91234,
         "mean_reconnects": 0.333}, 8
    )


def test_fig3_paper_thresholds_hold_on_the_port():
    """fig3's ``main`` at full width asserts the paper's cliff: the default
    stack stops training past 5 s one-way delay, the tuned one trains on.
    (fig4, fig5 and tuned_vs_default assert theirs on the card, in
    ``chip_smoke.py``'s ``paper_sweeps``.)"""
    rows = p_fig3.main(device="cpu")
    assert [r[0] for r in rows] == p_fig3.DELAYS


def test_grid_and_per_point_engines_give_equal_rows():
    """``run_points(engine="grid")`` == ``engine="per_point"`` on the fast
    fig3 points, shortened to 2 rounds of 1 local step (nan-equal)."""
    _, points = p_fig3.sweep_points(fast=True)
    points = [dict(kw, rounds=2, local_steps=1) for kw in points]
    grid, stats = common.run_fl_grid_experiments(points, return_stats=True, device="cpu")
    per_point = common.run_points(points, engine="per_point", device="cpu")
    for g, p in zip(grid, per_point):
        assert g.keys() == p.keys()
        for k in g:
            assert g[k] == p[k] or (math.isnan(g[k]) and math.isnan(p[k])), k
    assert stats.fit_rows_unique < stats.fit_rows_total  # the latency grid coalesced
    with pytest.raises(ValueError, match="unknown engine"):
        common.run_points(points, engine="nope", device="cpu")
