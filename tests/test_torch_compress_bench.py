"""``repro_torch.experiments.compress_bench`` on the CPU, held to
``benchmarks/compress_bench.py``.

The bench runs whole through its ``main`` at a thinned size: both
packages' sweep harness at 4 clients x 64 examples, 2 rounds of 1 local
step, the port's task started from the reference's params. Both parity
flags hold, and the plane grid's numpy-computed fields (``trained``,
``training_time_s``, ``GridStats``, the fused transport's dispatches and
rows) equal the reference's; accuracy within 1e-3. The default size runs
on the card (``chip_smoke.py``'s ``engine_benches``).
"""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # benchmarks/

from _torch_parity import (  # noqa: E402,F401 (fixture)
    assert_rows_match,
    one_torch_thread,
    record_rows,
    thin_sweep_harnesses,
    with_ref_init,
)
from benchmarks import common as r_common  # noqa: E402
from benchmarks import compress_bench as r_compress  # noqa: E402
import repro_torch.core as p_core  # noqa: E402
from repro_torch.experiments import common as p_common  # noqa: E402
from repro_torch.experiments import compress_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-3
P_TASK = with_ref_init(p_core.mnist_cnn_task(device="cpu"))


def test_compress_bench_matches_reference(monkeypatch):
    """Plane == unstacked exactly (CSV text), both sections; the timed
    plane pass's rows, its ``GridStats`` and the fused section's
    dispatches and rows against the reference's plane grid."""
    thin_sweep_harnesses(monkeypatch, (r_common, p_common), p_common, P_TASK)
    rows = record_rows(monkeypatch, compress_bench, "plane")
    got = compress_bench.main(fast=True, device="cpu")
    assert got["parity"] and got["fused_transport"]["parity"]
    assert got["config"]["points"] == len(r_compress.sweep_points(True)[1])
    assert got["config"]["reps"] == 1 and len(got["plane_times_s"]) == 1
    want_rows = r_compress.compute_rows(fast=True, engine="plane")
    assert dataclasses.asdict(r_common.last_grid_stats) == got["grid_stats"]
    assert got["grid_stats"]["compress_computed"] > 0
    assert_rows_match(want_rows, rows[-1], acc_cols=(5,), tol=TOL)
    _, stats = r_common.run_fl_grid_experiments(r_compress.stochastic_points(True),
                                                transport="fused", return_stats=True)
    ft = got["fused_transport"]
    assert (ft["transport_dispatches"], ft["transport_rows"]) == (
        stats.transport_dispatches, stats.transport_rows)
