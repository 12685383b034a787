"""The reliability sweeps of ``repro_torch.experiments`` on the CPU, each
with the reference's gates (the counterparts of ``benchmarks/async_bench.py``,
``benchmarks/resilience_bench.py`` and ``benchmarks/population_bench.py``),
at their ``fast`` sizes: the paper's 10 clients x 200 examples, 4 local
steps. The full sizes run on the card (``chip_smoke.py``)."""

import pytest

from _torch_parity import one_torch_thread  # noqa: F401 (fixture)
from repro_torch.experiments import async_bench, population_bench, resilience_bench

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
    a poisoned point is quarantined alone."""
    r = resilience_bench.main(fast=True, device="cpu")
    assert [m["resume_parity"] for m in r["kill_resume"]] == [True]
    assert r["quarantine"]["isolation"] and r["quarantine"]["poisoned_status"] == "diverged"
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1, item 13\)"):
        resilience_bench.retry_degenerate_section()


def test_population_bench_parity_gate():
    """Dense == sparse bitwise for every engine x plane compressor, and the
    lazy Population == the list."""
    r = population_bench.run_parity_gate(device="cpu")
    assert len(r["cells"]) == 10 and r["all_bitwise"], r["cells"]
