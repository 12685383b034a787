"""The committed reference Histories (``tests/data/card_reference.json``,
written by ``tests/_card_reference.py``) against the reference run now
and against the port on the CPU. The first keeps the fixture from going
stale; the second holds the port to it as ``test_torch_cuda_history.py``
does on the card. Numpy-computed fields exactly; accuracy, loss and client
metrics within ``HISTORY_TOL``, which also keeps the first check steady
across CPUs."""

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
    card.assert_records_match(RECORDS[name], card.history_record(hist, clients))


@pytest.mark.parametrize("name", card.RUNS)
def test_port_on_cpu_matches_fixture(name):
    hist, clients = card.run(name, P_TASK, *card.port_packages())
    assert hist.completed_rounds > 0
    card.assert_records_match(RECORDS[name], card.history_record(hist, clients))
