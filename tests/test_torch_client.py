"""Port parity: local training. The port's batched (plane) fit and its
sequential fit are held to the reference's SEQUENTIAL ``local_fit`` from
the same carried-across params and the same numpy batch-plan stream."""

import jax
import numpy as np
import pytest

from _torch_parity import max_abs_diff, ref_params_np
from repro.core import EdgeClient as REdgeClient
from repro.core import client as r_client
from repro.data import make_federated_mnist as r_make
from repro_torch.convert import params_from_numpy
from repro_torch.core import client as p_client
from repro_torch.data import make_federated_mnist as p_make
from repro_torch.utils import tree_unstack

R_TASK = r_client.mnist_cnn_task()
P_TASK = p_client.mnist_cnn_task(device="cpu")


def _clients(n=4, seed=1):
    r = [REdgeClient(i, dataset=s) for i, s in enumerate(r_make(n, 64, seed=seed))]
    p = [p_client.EdgeClient(i, dataset=s) for i, s in enumerate(p_make(n, 64, seed=seed))]
    return r, p


def _ref_sequential(params_np, clients, steps, rng, mu):
    params = jax.tree.map(jax.numpy.asarray, params_np)
    return [R_TASK.local_fit(params, c, steps, rng, mu) for c in clients]


@pytest.mark.parametrize("steps,mu", [(2, 0.0), (3, 0.05)])
def test_batched_local_fit_matches_reference_sequential(steps, mu):
    params_np = ref_params_np(0)
    r_clients, p_clients = _clients()
    r_rng, p_rng = np.random.default_rng(9), np.random.default_rng(9)
    expect = _ref_sequential(params_np, r_clients, steps, r_rng, mu)
    stacked, weights, metrics = P_TASK.batched_local_fit(
        params_from_numpy(params_np, "cpu"), p_clients, steps, p_rng, mu
    )
    assert tuple(stacked["fc1"]["w"].shape) == (4, 1568, 128)
    for i, (d, n_ex, m) in enumerate(expect):
        assert weights[i] == n_ex
        assert max_abs_diff(d, tree_unstack(stacked)[i]) <= 1e-5
        assert abs(metrics[i]["loss"] - m["loss"]) <= 1e-4
    # both paths left the generators at the same position
    assert r_rng.integers(0, 2**31) == p_rng.integers(0, 2**31)


def test_sequential_local_fit_matches_reference_sequential():
    params_np = ref_params_np(1)
    r_clients, p_clients = _clients(3, seed=2)
    r_rng, p_rng = np.random.default_rng(4), np.random.default_rng(4)
    expect = _ref_sequential(params_np, r_clients, 2, r_rng, 0.0)
    for c, (d, n_ex, m) in zip(p_clients, expect):
        delta, n, pm = P_TASK.local_fit(params_from_numpy(params_np, "cpu"), c, 2, p_rng, 0.0)
        assert n == n_ex
        assert max_abs_diff(d, delta) <= 1e-5
        assert abs(pm["loss"] - m["loss"]) <= 1e-4
        assert abs(pm["accuracy"] - m["accuracy"]) <= 1e-6
    assert r_rng.integers(0, 2**31) == p_rng.integers(0, 2**31)


def test_plans_buckets_and_digests_match_reference():
    r_clients, p_clients = _clients(3)
    r_plans = R_TASK.plan_fit(r_clients, 5, np.random.default_rng(0))
    p_plans = P_TASK.plan_fit(p_clients, 5, np.random.default_rng(0))
    for a, b in zip(r_plans, p_plans):
        np.testing.assert_array_equal(a, b)
    assert P_TASK.plan_digest(p_clients[0], p_plans[0])[1] == p_plans[0].tobytes()
    for n in list(range(1, 140)) + [200, 1000]:
        assert p_client.bucket_rows(n) == r_client.bucket_rows(n)
    assert P_TASK.update_bytes == R_TASK.update_bytes


def test_fit_rows_pads_to_bucket_and_gathers_anchors():
    """fit_rows over two anchors: 5 rows pad to a bucket of 6, and each row
    equals its own batched fit from its anchor."""
    anchors_np = [ref_params_np(0), ref_params_np(3)]
    _, p_clients = _clients(5)
    plans = P_TASK.plan_fit(p_clients, 2, np.random.default_rng(1))
    rows = list(zip(p_clients, plans))
    aidx = [0, 1, 1, 0, 1]
    anchors = [params_from_numpy(a, "cpu") for a in anchors_np]
    plane, n_ex, metrics = P_TASK.fit_rows(anchors, rows, 2, [0.0] * 5, False, anchor_idx=aidx)
    assert tuple(plane["fc2"]["b"].shape) == (6, 10) and n_ex == [64] * 5
    assert P_TASK.plane_dispatch_widths()[-1] == 6
    assert P_TASK.plane_anchor_widths()[-1] == 2
    for r, a in enumerate(aidx):
        one, _, m = P_TASK.fit_rows([anchors[a]], [rows[r]], 2, [0.0], False)
        assert max_abs_diff(tree_unstack(one)[0], tree_unstack(plane)[r]) <= 1e-6
        assert abs(m[0]["loss"] - metrics[r]["loss"]) <= 1e-6


def test_f32_math_turns_tf32_off_on_cuda_only_and_restores():
    """The guard the CNN task runs under: on a CUDA device TF32 is off for
    cuDNN and cuBLAS inside the block and both flags come back after it,
    also after an exception; on the CPU nothing changes. (The flags are
    process-wide settings, so this needs no card.)"""
    import torch

    from repro_torch.utils import f32_math

    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    saved = flags()
    try:
        for start in ((True, False), (True, True), (False, True)):
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = start
            with f32_math("cpu"):
                assert flags() == start
            with f32_math(torch.device("cuda")):
                assert flags() == (False, False)
            assert flags() == start
            with pytest.raises(KeyError):
                with f32_math("cuda:0"):
                    raise KeyError("inside")
            assert flags() == start
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_f32_math_holds_cudnn_to_deterministic_algorithms_and_restores():
    """The same guard holds cuDNN to deterministic algorithms without
    autotuning on a CUDA device (two runs of the sequential engine, whose
    convs run on cuDNN, then give the same bits), and restores both flags;
    on the CPU nothing changes."""
    import torch

    from repro_torch.utils import f32_math

    cudnn = torch.backends.cudnn
    flags = lambda: (cudnn.deterministic, cudnn.benchmark)  # noqa: E731
    saved = flags()
    try:
        for start in ((False, False), (False, True), (True, True)):
            cudnn.deterministic, cudnn.benchmark = start
            with f32_math("cpu"):
                assert flags() == start
            with f32_math("cuda"):
                assert flags() == (True, False)
            assert flags() == start
            with pytest.raises(KeyError):
                with f32_math("cuda:0"):
                    raise KeyError("inside")
            assert flags() == start
    finally:
        cudnn.deterministic, cudnn.benchmark = saved
