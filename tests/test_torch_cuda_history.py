"""The port's FL History on the card against the reference's, written on
the CPU and committed (``tests/data/card_reference.json``; see
``tests/_card_reference.py``): the 8 engine runs (the device transport
plane's degenerate run among them), the int8 / bf16 compressed runs and the
two async runs, started from the reference's params; and the reference's
committed round-2 checkpoint finished on the card. Numpy-computed fields
exactly (the device plane's clocks within ``CLOCK_RTOL``: it computes in
f32); accuracy, loss and client metrics within ``HISTORY_TOL``.

The runs keep PyTorch's TF32 defaults: the port itself must compute the
CNN in f32. Marked ``cuda``; skips without a CUDA device. Imports neither
jax nor repro, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda_history.py
"""

import pytest
import torch

import _card_reference as card

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def task():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return card.port_task("cuda")


@pytest.mark.parametrize("name", card.RUNS)
def test_port_on_cuda_matches_fixture(task, name):
    assert torch.backends.cudnn.allow_tf32, "runs with PyTorch's default TF32 flags"
    hist, clients = card.run(name, task, *card.port_packages())
    assert hist.completed_rounds > 0
    card.assert_records_match(card.load_records()[name], card.history_record(hist, clients),
                              clock_rtol=card.CLOCK_RTOL.get(name, 0.0))


def test_port_on_cuda_resumes_the_reference_checkpoint(task, tmp_path):
    hist, clients = card.resume(task, tmp_path / "ckpt", *card.port_packages())
    assert len(hist.rounds) == 3
    card.assert_records_match(card.load_records()[card.CHECKPOINT_RUN],
                              card.history_record(hist, clients))
