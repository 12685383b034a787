"""The committed reference Histories (``tests/data/card_reference.json``,
written by ``tests/_card_reference.py``) against the reference run now
and against the port on the CPU. The first keeps the fixture from going
stale; the second holds the port to it as ``test_torch_cuda_history.py``
does on the card. Numpy-computed fields exactly; accuracy, loss and client
metrics within ``HISTORY_TOL``, which also keeps the first check steady
across CPUs. The committed round-2 checkpoint likewise: the reference
writes the same one now, and the port finishes the run from it."""

import json

import numpy as np
import pytest

import _card_reference as card
from _torch_parity import ref_params_np
import repro.chaos as r_chaos
import repro.compress as r_comp
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr

R_TASK = r_core.mnist_cnn_task()
P_TASK = card.port_task("cpu")
RECORDS = card.load_records()


def test_fixture_params_are_the_reference_init():
    want, got = ref_params_np(0), card.load_params()
    assert sorted(want) == sorted(got)
    for layer in want:
        assert sorted(want[layer]) == sorted(got[layer])
        for leaf in want[layer]:
            a, b = want[layer][leaf], got[layer][leaf]
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


@pytest.mark.parametrize("name", card.RUNS)
def test_reference_matches_fixture(name):
    hist, clients = card.run(name, R_TASK, r_core, r_data, r_tr, r_chaos, r_comp)
    assert sorted(RECORDS) == sorted(card.RUNS)
    card.assert_records_match(RECORDS[name], card.history_record(hist, clients),
                              clock_rtol=card.CLOCK_RTOL.get(name, 0.0))


@pytest.mark.parametrize("name", card.RUNS)
def test_port_on_cpu_matches_fixture(name):
    hist, clients = card.run(name, P_TASK, *card.port_packages())
    assert hist.completed_rounds > 0
    card.assert_records_match(RECORDS[name], card.history_record(hist, clients),
                              clock_rtol=card.CLOCK_RTOL.get(name, 0.0))


def test_reference_checkpoint_is_current(tmp_path):
    """The reference writes the committed checkpoint again: the same
    manifest, and the same array bits under the same keys."""
    card.write_checkpoint(R_TASK, tmp_path / "ckpt",
                          (r_core, r_data, r_tr, r_chaos, r_comp))
    step = "step_000000002"
    assert (tmp_path / "ckpt" / "LATEST").read_text() == "2"
    want = json.loads((card.CHECKPOINT_PATH / step / "manifest.json").read_text())
    got = json.loads((tmp_path / "ckpt" / step / "manifest.json").read_text())
    assert got["keys"] == want["keys"] and got["orig_dtypes"] == want["orig_dtypes"]
    assert got["metadata"]["fingerprint"] == want["metadata"]["fingerprint"]
    g_point, w_point = got["metadata"]["point"], want["metadata"]["point"]
    g_rounds, w_rounds = g_point.pop("rounds"), w_point.pop("rounds")
    g_evals, w_evals = g_point.pop("eval_metrics"), w_point.pop("eval_metrics")
    assert g_point == w_point
    rec = lambda rounds, evals: {"rounds": rounds, "eval_metrics": evals,  # noqa: E731
                                 "status": "healthy", "cause": "", "clients": []}
    card.assert_records_match(rec(w_rounds, w_evals), rec(g_rounds, g_evals))
    with np.load(card.CHECKPOINT_PATH / step / "arrays.npz") as a, \
            np.load(tmp_path / "ckpt" / step / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files) == sorted(want["keys"])
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_port_on_cpu_resumes_the_reference_checkpoint(tmp_path):
    """The port restores the reference's round-2 checkpoint and finishes the
    run, held to the committed History of the uninterrupted run."""
    hist, clients = card.resume(P_TASK, tmp_path / "ckpt", *card.port_packages())
    assert len(hist.rounds) == 3
    card.assert_records_match(RECORDS[card.CHECKPOINT_RUN], card.history_record(hist, clients))
