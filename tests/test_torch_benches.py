"""The reliability sweeps of ``repro_torch.experiments`` on the CPU, each
with the reference's gates (the counterparts of ``benchmarks/async_bench.py``,
``benchmarks/resilience_bench.py``, ``benchmarks/population_bench.py``,
``benchmarks/reliability_bench.py``, ``benchmarks/transport_plane_bench.py``
and ``benchmarks/env_profiles.py``), at their ``fast`` sizes: the paper's 10
clients x 200 examples, 4 local steps. The host-numpy sections give the
reference's results exactly. The full sizes run on the card
(``chip_smoke.py``)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # benchmarks/

from _torch_parity import one_torch_thread  # noqa: E402,F401 (fixture)
from benchmarks import env_profiles as r_env  # noqa: E402
from benchmarks import reliability_bench as r_reliability  # noqa: E402
from repro_torch.experiments import (  # noqa: E402
    async_bench,
    env_profiles,
    population_bench,
    reliability_bench,
    resilience_bench,
    transport_plane_bench,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_async_bench_gates_hold(capsys):
    """Degenerate async == sync bitwise; at the 6 s cliff and under 60 %
    dropout sync dies and async trains every tick."""
    r = async_bench.main(fast=True, device="cpu")
    assert r["degenerate"]["params_bitwise"] and r["degenerate"]["clock_equal"]
    cliff = r["latency_cliff"]
    assert cliff["cliff_sync_status"] == "failed" and cliff["cliff_async_completed"] == 4
    assert cliff["tta_sync_s"] == "inf"
    assert r["dropout"]["sync_completed"] == 0 and r["dropout"]["async_completed"] == 4
    assert "BENCH " in capsys.readouterr().out


def test_resilience_bench_gates_hold():
    """A fused-transport sweep killed at its halfway round resumes bitwise;
    a poisoned point is quarantined alone; the retry ladder's closed-form
    56 s clock on both engines; the retry frontier monotone in budget and
    the engines agreeing.

    The cliff gate wants the budget to buy more than +0.05 at the 4 s cliff
    on both planes. The host half holds. The device half is a 128-sample
    statistic of the plane's stream, and the CPU stream (mt19937) falls
    short there (+0.047), so on the CPU ``cliff_improvement`` and
    ``parity`` are false and ``main`` exits 1. ``chip_smoke.py`` holds the
    card's stream to the whole gate."""
    r = resilience_bench.run_bench(fast=True, device="cpu")
    assert [m["resume_parity"] for m in r["kill_resume"]] == [True]
    assert r["quarantine"]["isolation"] and r["quarantine"]["poisoned_status"] == "diverged"
    assert r["retry_degenerate"]["parity"] and r["retry_degenerate"]["device_s"] == 56.0
    f = r["retry_frontier"]
    assert f["monotone"] and f["host_device_agreement"]
    rates = {(d, b): (h, v) for d, b, h, v in f["rates"]}
    assert rates[(4.0, 3)][0] > rates[(4.0, 0)][0] + 0.05  # the host half of the cliff gate
    assert rates[(4.0, 3)][1] > rates[(4.0, 0)][1]
    assert not f["cliff_improvement"] and not r["parity"]  # the device half, on the CPU


def test_reliability_bench_gates_hold(capsys):
    """Every gate of the three sections; the two host sections equal the
    reference's results and CSV rows."""
    r = reliability_bench.main(fast=True, device="cpu")
    p_out = capsys.readouterr().out
    assert r["parity"] and r["degenerate_parity"]["parity"]
    assert r["owd_frontier"] == r_reliability.owd_frontier_section(fast=True)
    assert r["loss_frontier"] == r_reliability.loss_frontier_section(fast=True)
    r_out = capsys.readouterr().out
    assert [ln for ln in p_out.splitlines() if not ln.startswith("BENCH")] == r_out.splitlines()


def test_transport_plane_bench_parity_gates():
    """The degenerate grid exact; the 4,082-row fig4 grid within the
    reference's distributional envelopes; the timing path at 64 rows
    reports every field (times on the CPU are not the card's)."""
    assert transport_plane_bench.check_parity_exact(device="cpu")
    dist = transport_plane_bench.check_parity_distributional(device="cpu")
    assert dist["ok"], dist
    row = transport_plane_bench.time_plane_size(64, device="cpu")
    assert row["rows"] == 26 * 2 and row["rounds"] == transport_plane_bench.ROUNDS
    assert row["device_s"] > 0 and row["speedup_vs_loop"] > 0


def test_env_profiles_rows_equal_reference(capsys):
    assert env_profiles.main() == r_env.main()


def test_population_bench_parity_gate():
    """Dense == sparse bitwise for every engine x plane compressor, and the
    lazy Population == the list."""
    r = population_bench.run_parity_gate(device="cpu")
    assert len(r["cells"]) == 10 and r["all_bitwise"], r["cells"]
