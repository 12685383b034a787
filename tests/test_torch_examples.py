"""The port's example drivers (``repro_torch.examples``) against the
reference's scripts (``examples/*.py``, loaded from their files) on the
same inputs, on the CPU.

- quickstart: ``run(tcp, label)`` under DEFAULT and TUNED_EDGE TCP;
- edge_africa: ``run(link, tcp)`` on three profiles (Europe, Africa, rural
  Africa: acceptable, tolerable and failing under default TCP), and the
  region of all seven;
- tcp_tuning: its printed output, line for line (numpy only);
- train_100m: ``lm_100m_cfg()`` field by field, and a run killed after its
  step-2 checkpoint and resumed against the uninterrupted run.

Rounds, simulated time, reconnects, status and cause are numpy on both
sides and must be equal; accuracy is held within the FL parity tolerance
(1e-3), both packages starting from the reference's initial params
(``_torch_parity.with_ref_init``; the threefry draws have no torch
counterpart)."""

import dataclasses
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from repro import transport as r_transport
from repro_torch import transport as p_transport
from repro_torch.core import mnist_cnn_task
from repro_torch.examples import edge_africa as p_edge
from repro_torch.examples import quickstart as p_quick
from repro_torch.examples import tcp_tuning as p_tcp
from repro_torch.examples import train_100m as p_100m

from _torch_parity import one_torch_thread, with_ref_init  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
ACC_TOL = 1e-3
EXACT = ("rounds", "completed_rounds", "total_time_s", "mean_reconnects", "status", "cause")


def _reference(name):
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def ref_init_task(monkeypatch):
    """The drivers' CNN task on the CPU from the reference's initial params."""
    def task(device=None):
        return with_ref_init(mnist_cnn_task(device="cpu"))

    for mod in (p_quick, p_edge):
        monkeypatch.setattr(mod, "mnist_cnn_task", task)


def _assert_summaries_match(got, want):
    assert set(got) == set(want)
    for k in EXACT:
        assert got[k] == want[k], k
    a, b = got["final_accuracy"], want["final_accuracy"]
    assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= ACC_TOL, (a, b)


@pytest.mark.parametrize("tcp,label", [("DEFAULT", "default"), ("TUNED_EDGE", "tuned")])
def test_quickstart_run_matches_the_reference(ref_init_task, capsys, tcp, label):
    want = _reference("quickstart").run(getattr(r_transport, tcp), label)
    ref_line = capsys.readouterr().out
    got = p_quick.run(getattr(p_transport, tcp), label, device="cpu")
    line = capsys.readouterr().out
    _assert_summaries_match(got, want)
    assert line.split(" acc=")[0] == ref_line.split(" acc=")[0]
    assert line.split("reconnects/round=")[1] == ref_line.split("reconnects/round=")[1]


@pytest.mark.parametrize("profile", ["europe", "africa", "africa_rural"])
def test_edge_africa_run_matches_the_reference(ref_init_task, profile):
    ref = _reference("edge_africa")
    for tcp in ("DEFAULT", "TUNED_EDGE"):
        want = ref.run(r_transport.PROFILES[profile], getattr(r_transport, tcp))
        got = p_edge.run(p_transport.PROFILES[profile], getattr(p_transport, tcp), device="cpu")
        _assert_summaries_match(got, want)


def test_edge_africa_regions_match_the_reference():
    regions = {name: p_transport.classify(p_transport.DEFAULT, p_transport.PROFILES[name])
               for name in p_edge.NAMES}
    assert regions == {name: r_transport.classify(r_transport.DEFAULT, r_transport.PROFILES[name])
                       for name in p_edge.NAMES}


def test_tcp_tuning_prints_the_reference_lines(capsys):
    _reference("tcp_tuning").main()
    want = capsys.readouterr().out
    p_tcp.main()
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert len(want.splitlines()) == 19


def test_train_100m_config_matches_the_reference(capsys):
    want = _reference("train_100m").lm_100m_cfg()
    ref_line = capsys.readouterr().out
    got = p_100m.lm_100m_cfg()
    assert capsys.readouterr().out == ref_line
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.param_count() == want.param_count()


def test_train_100m_resumes_from_its_checkpoint(tmp_path, monkeypatch):
    """--steps 4 --batch 2 --seq 32, a checkpoint every 2 steps: a run that
    dies when it fetches step 3's batch, then a restart in the same
    directory, against the uninterrupted run: steps 3-4's losses and the
    step-4 checkpoint equal."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.tokens import token_batch_for
    import repro_torch.launch.train as T

    kw = dict(ckpt_every=2, device="cpu")
    whole = p_100m.run(4, 2, 32, ckpt_dir=str(tmp_path / "whole"), **kw)

    def dies_at_step_3(cfg, *, batch, seq, seed=0, client_id=0):
        if seed == 2:
            raise RuntimeError("killed")
        return token_batch_for(cfg, batch=batch, seq=seq, seed=seed, client_id=client_id)

    monkeypatch.setattr(T, "token_batch_for", dies_at_step_3)
    with pytest.raises(RuntimeError, match="killed"):
        p_100m.run(4, 2, 32, ckpt_dir=str(tmp_path / "resumed"), **kw)
    monkeypatch.setattr(T, "token_batch_for", token_batch_for)
    resumed = p_100m.run(4, 2, 32, ckpt_dir=str(tmp_path / "resumed"), **kw)
    assert len(whole["losses"]) == 4 and len(resumed["losses"]) == 2
    assert resumed["losses"] == whole["losses"][2:]
    a = CheckpointManager(str(tmp_path / "whole")).latest_step()
    b = CheckpointManager(str(tmp_path / "resumed")).latest_step()
    assert a == b == 4
    with np.load(tmp_path / "whole" / "step_000000004" / "arrays.npz") as fa, \
            np.load(tmp_path / "resumed" / "step_000000004" / "arrays.npz") as fb:
        assert sorted(fa.files) == sorted(fb.files) and fa.files
        for k in fa.files:
            assert np.array_equal(fa[k], fb[k]), k
    assert all(math.isfinite(x) for x in whole["losses"])
    assert torch.get_num_threads() == 1
