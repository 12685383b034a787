"""Port parity: the robust order-statistic strategies (``trimmed_mean``,
``median``, ``krum`` in ``repro_torch.core.strategy``) against the
reference's on the same stacked deltas, list and stacked entry points, and
in a server run.

``median`` (the midpoint of two order statistics) and ``krum``'s pick are
held to the reference's bits. ``trimmed_mean`` and ``krum``'s weighted-mean
fallback (n <= 2f + 2) sum in f32 in an order of their own; they are held
within 4 ulp of the largest |input| (``SUM_ULPS``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _card_reference import assert_histories_match
from _torch_parity import one_torch_thread, to_np, with_ref_init  # noqa: F401
import repro.chaos as r_chaos
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.transport as p_tr

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SHAPES = {"conv": {"w": (3, 3, 1, 4), "b": (4,)}, "fc": {"w": (36, 10)}}
SUM_ULPS = 4


def _deltas(c, seed, outlier=False):
    rng = np.random.default_rng(seed)

    def leaf(shape):
        x = rng.normal(size=(c,) + shape).astype(np.float32)
        if outlier:
            x[0] *= 1e3  # one corrupt client
        return x

    return {k: {n: leaf(s) for n, s in v.items()} for k, v in SHAPES.items()}


def _as(tree, fn):
    return {k: _as(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _unstack(tree, c):
    return [_as(tree, lambda x, _i=i: x[_i]) for i in range(c)]


STRATS = {
    "trimmed_mean_0.1": lambda core: core.trimmed_mean(0.1),
    "trimmed_mean_0.25": lambda core: core.trimmed_mean(0.25),
    "median": lambda core: core.median(),
    "krum_1": lambda core: core.krum(1),
    "krum_2": lambda core: core.krum(2),
}


def _compare(want, got, atol=0.0):
    for a, b in zip(_leaves(to_np(want)), _leaves(to_np(got)), strict=True):
        assert a.dtype == b.dtype
        if atol:
            assert np.max(np.abs(a - b)) <= atol
        else:
            assert np.array_equal(a, b)


def _leaves(tree):
    return [x for k in sorted(tree) for x in (_leaves(tree[k]) if isinstance(tree[k], dict)
                                              else [tree[k]])]


@pytest.mark.parametrize("c", [1, 2, 5, 8, 10])
@pytest.mark.parametrize("name", list(STRATS))
@pytest.mark.parametrize("outlier", [False, True])
def test_robust_aggregation_matches_reference(name, c, outlier):
    """Same stacked deltas through both packages, stacked and list entry
    points (below 2f+3 clients krum falls back to the weighted mean)."""
    x = _deltas(c, seed=c, outlier=outlier)
    weights = list(np.arange(1, c + 1) * 32)
    r_s, p_s = STRATS[name](r_core), STRATS[name](p_core)
    assert p_s.robust and p_s.agg_fingerprint == r_s.agg_fingerprint
    summed = name.startswith("trimmed") or (name.startswith("krum") and c <= 2 * int(name[-1]) + 2)
    atol = SUM_ULPS * 2.0**-23 * max(np.abs(v).max() for v in _leaves(x)) if summed else 0.0
    want = r_s.stacked_aggregate_fn(_as(x, jnp.asarray), weights)
    got = p_s.stacked_aggregate_fn(_as(x, torch.from_numpy), weights)
    _compare(want, got, atol)
    want_l = r_s.aggregate_fn(_unstack(_as(x, jnp.asarray), c), weights)
    got_l = p_s.aggregate_fn(_unstack(_as(x, torch.from_numpy), c), weights)
    _compare(want_l, got_l, atol)


def test_median_of_an_even_count_is_the_midpoint_and_nan_propagates():
    x = torch.tensor([[1.0, 5.0], [4.0, float("nan")], [2.0, 1.0], [3.0, 2.0]])
    got = p_core.median().stacked_aggregate_fn({"a": x}, [1, 1, 1, 1])["a"]
    want = np.asarray(r_core.median().stacked_aggregate_fn({"a": jnp.asarray(x.numpy())},
                                                           [1, 1, 1, 1])["a"])
    assert got[0] == 2.5 and torch.isnan(got[1])
    assert np.array_equal(got.numpy(), want, equal_nan=True)


def test_strategy_table_and_unported_server_optimizers():
    """The robust strategies sit in the table beside the server-optimizer
    ones, which are now ported (``test_torch_server_opt.py`` holds them):
    neither kind is the other."""
    assert {"trimmed_mean", "median", "krum"} <= set(p_core.STRATEGIES)
    assert not p_core.fedavg().robust and p_core.fedavg().server_state is None
    for make in (p_core.fedopt, p_core.diloco):
        s = make()
        assert s.server_opt is not None and s.server_state is None and not s.robust


P_TASK = with_ref_init(p_core.mnist_cnn_task(device="cpu"))
R_TASK = r_core.mnist_cnn_task()


@pytest.mark.parametrize("name,batched", [("median", True), ("trimmed_mean_0.25", False),
                                          ("krum_1", True)])
def test_robust_server_history_matches_reference(name, batched):
    """A 3-round synchronous run of 6 clients with each robust strategy:
    numpy History fields equal, accuracy and loss within 1e-3."""
    runs = {}
    for pkg, (core, data, tr, chaos, task) in {
        "ref": (r_core, r_data, r_tr, r_chaos, R_TASK),
        "port": (p_core, p_data, p_tr, p_chaos, P_TASK),
    }.items():
        shards = data.make_federated_mnist(6, 64, seed=0)
        clients = [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
        strat = STRATS[name](core)
        strat.min_fit_fraction = 0.5
        srv = core.FederatedServer(
            task, clients, strat, tcp=tr.DEFAULT, chaos=chaos.ChaosSchedule(tr.LAB),
            config=core.ServerConfig(rounds=3, local_steps=2, seed=0, batched=batched),
            eval_data=data.synthetic_mnist(150, seed=7),
        )
        runs[pkg] = (srv.run(), clients)
    assert runs["port"][0].completed_rounds == 3
    assert_histories_match(*runs["ref"], *runs["port"])
