"""Two engine benches of ``repro_torch.experiments`` and the runner on the
CPU (the counterparts of ``benchmarks/round_engine_bench.py``,
``benchmarks/sweep_bench.py`` and ``benchmarks/run.py``;
``compress_bench`` is held in ``test_torch_compress_bench.py``).

Each bench runs whole through its ``main`` at a thinned size: both
packages' sweep harness at 4 clients x 64 examples, 2 rounds of 1 local
step, the port's task started from the reference's params. Every parity
flag holds, and the numpy-computed fields (completed rounds, clocks,
``trained``, ``training_time_s``, ``GridStats``, the fused transport's
dispatches and rows) equal the reference's; accuracy within 1e-3. The
default sizes run on the card (``chip_smoke.py``'s ``engine_benches``).
"""

import dataclasses
import inspect
import re
import sys
import time
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
from benchmarks import fig3_latency as r_fig3  # noqa: E402
from benchmarks import round_engine_bench as r_round  # noqa: E402
from benchmarks import sweep_bench as r_sweep  # noqa: E402
import repro_torch.core as p_core  # noqa: E402
from repro_torch.experiments import common as p_common  # noqa: E402
from repro_torch.experiments import fig3_latency, round_engine_bench, run, sweep_bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-3
P_TASK = with_ref_init(p_core.mnist_cnn_task(device="cpu"))


@pytest.fixture
def thinned(monkeypatch):
    """Both harnesses thinned; the port's shared CPU task starts from the
    reference's params."""
    thin_sweep_harnesses(monkeypatch, (r_common, p_common), p_common, P_TASK)


def test_round_engine_bench_matches_reference(monkeypatch, capsys):
    """Sequential vs batched at 4 clients x 320 examples, 2 rounds of 2
    local steps: both parity flags, and completed rounds, the clock's
    agreement and both final accuracies against the reference's."""
    monkeypatch.setattr(round_engine_bench, "mnist_cnn_task", lambda device=None: P_TASK)
    size = dict(n_clients=4, rounds=2, local_steps=2, reps=1)
    monkeypatch.setitem(round_engine_bench.SIZES, False, size)
    got = round_engine_bench.main(device="cpu")
    assert "BENCH " in capsys.readouterr().out
    want = r_round.run_bench(**size)
    for k in ("seq_completed_rounds", "bat_completed_rounds", "agree_completed_rounds",
              "agree_total_time", "accuracy_within_tol"):
        assert got[k] == want[k], k
    assert got["agree_total_time"] and got["accuracy_within_tol"]
    assert got["config"] == want["config"]
    for k in ("seq_final_accuracy", "bat_final_accuracy"):
        assert abs(got[k] - want[k]) <= TOL, k


def test_sweep_bench_matches_reference(thinned, monkeypatch):
    """Every parity flag; the timed fig3 grid's rows and ``GridStats`` and
    the fused transport section's dispatches and rows against the
    reference's."""
    rows = record_rows(monkeypatch, fig3_latency, "grid")
    got = sweep_bench.main(fast=True, device="cpu")
    assert got["parity_fig3"] and got["parity_fig4"] and got["parity_table3"]
    assert got["fused_transport"]["parity"] and got["parity"]
    assert got["config"]["reps"] == 1 and len(got["grid_times_s"]) == 1
    want_rows = r_fig3.compute_rows(fast=True, engine="grid")
    assert dataclasses.asdict(r_common.last_grid_stats) == got["grid_stats"]
    assert_rows_match(want_rows, rows[-1], acc_cols=(3, 6), tol=TOL)
    _, stats = r_common.run_fl_grid_experiments(r_sweep.stochastic_fig4_points(True),
                                                transport="fused", return_stats=True)
    ft = got["fused_transport"]
    assert (ft["transport_dispatches"], ft["transport_rows"]) == (
        stats.transport_dispatches, stats.transport_rows)
    assert ft["points"] == len(r_sweep.stochastic_fig4_points(True))


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def _reference_bench_names():
    """The reference runner's bench list, in its order (it lives inside
    ``benchmarks/run.py:main``)."""
    text = (ROOT / "benchmarks" / "run.py").read_text()
    return re.findall(r'\("(\w+)", \w+\.main\)', text)


def test_runner_lists_the_reference_benches_but_kernel_bench():
    names = run.BENCHES
    assert names == [n for n in _reference_bench_names() if n != "kernel_bench"]
    assert len(names) == 16


def test_runner_calls_each_main_with_the_arguments_it_takes(monkeypatch, capsys):
    """Every bench through the runner (each ``main`` replaced by a recorder
    with its signature): ``fast`` and ``device`` passed only where taken,
    and the summary lists all of them, ok."""
    import importlib

    calls = {}
    for name in run.BENCHES:
        mod = importlib.import_module(f"repro_torch.experiments.{name}")

        def record(_name=name, **kw):
            calls[_name] = kw

        record.__signature__ = inspect.signature(mod.main)
        monkeypatch.setattr(mod, "main", record)
    assert run.main(["--fast", "--device", "cpu"]) == 0
    assert calls["transport_plane_bench"] == {"device": "cpu"}
    for name in ("env_profiles", "fig678_tcp_params", "table3_boundaries", "adaptive_daemon"):
        assert calls[name] == {"fast": True}
    assert calls["round_engine_bench"] == {"fast": True, "device": "cpu"}
    summary = capsys.readouterr().out.split("##### summary #####")[1].split()
    assert summary[0] == "name,seconds,status"
    assert [ln.split(",")[0] for ln in summary[1:]] == run.BENCHES
    assert all(ln.endswith(",ok") for ln in summary[1:])


@pytest.mark.parametrize("only,text", [
    ("nope", "unknown benchmark(s): ['nope']"),
    ("kernel_bench", "chip_smoke.py's kernel, quant_kernels and lm_kernels phases"),
])
def test_runner_refuses_unknown_and_unported_names(capsys, only, text):
    assert run.main(["--only", only]) == 2
    out = capsys.readouterr()
    assert text in out.err and "summary" not in out.out


def test_runner_runs_the_transport_benches_on_the_cpu(capsys):
    assert run.main(["--only", "env_profiles,table3_boundaries", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = out.split("##### summary #####")[1].split()
    assert lines[0] == "name,seconds,status"
    assert [ln.split(",")[0] for ln in lines[1:]] == ["env_profiles", "table3_boundaries"]
    assert all(ln.endswith(",ok") for ln in lines[1:])
    assert "# table3_boundaries" in out


def test_runner_reports_failures(monkeypatch, capsys):
    """A bench that raises is ``FAIL:<type>``, one over ``--max-seconds`` is
    ``FAIL:TimeoutError``, a parity gate's exit ``FAIL:exit1``; the others
    still run, and the runner exits 1."""
    from repro_torch.experiments import adaptive_daemon, env_profiles, table3_boundaries

    def boom(fast=False):
        raise ValueError("boom")

    def slow(fast=False):
        time.sleep(5)

    def gate(fast=False):
        raise SystemExit(1)

    monkeypatch.setattr(env_profiles, "main", boom)
    monkeypatch.setattr(table3_boundaries, "main", slow)
    monkeypatch.setattr(adaptive_daemon, "main", gate)
    rc = run.main(["--only", "env_profiles,table3_boundaries,adaptive_daemon,fig678_tcp_params",
                   "--max-seconds", "1", "--fast"])
    assert rc == 1
    lines = capsys.readouterr().out.split("##### summary #####")[1].split()[1:]
    status = {ln.split(",")[0]: ln.split(",")[2] for ln in lines}
    assert status == {"env_profiles": "FAIL:ValueError", "table3_boundaries": "FAIL:TimeoutError",
                      "fig678_tcp_params": "ok", "adaptive_daemon": "FAIL:exit1"}
