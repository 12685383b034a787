"""Port parity: the scenario-parallel grid engine (``repro_torch.core.grid``).

Two contracts, at the reference tests' small size (6 clients x 64
examples, 2 local steps, as ``tests/test_grid_engine.py``; 2 rounds):

- inside the port, ``run_fl_grid`` equals per-point batched runs BITWISE:
  every History field and the final params, through coalescing on and
  off, chaos-variable cohorts, mixed strategies, and the parity and fused
  transport modes;
- against the reference's ``run_fl_grid`` on the same points and initial
  params: numpy History fields equal, eval accuracy and loss within 1e-3,
  and every ``GridStats`` field equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _card_reference import assert_histories_match
from _torch_parity import assert_same, one_torch_thread, ref_params_np  # noqa: F401 (fixture)
import repro.chaos as r_chaos
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.transport as p_tr
from repro_torch.convert import params_from_numpy
from repro_torch.core.client import _ROW_BUCKETS
from repro_torch.utils import tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_PARAMS = {}


def _ref_params(seed: int):
    """The reference's initial params for ``seed``, as the port's tree."""
    if seed not in _PARAMS:
        _PARAMS[seed] = ref_params_np(seed)
    return params_from_numpy(_PARAMS[seed], "cpu")


# the port's task starts every seed from the reference's cnn_init(seed):
# FederatedServer seeds its generator with config.seed
P_TASK = dataclasses.replace(
    p_core.mnist_cnn_task(device="cpu"), init_fn=lambda g: _ref_params(g.initial_seed())
)
R_TASK = r_core.mnist_cnn_task()
PKGS = {
    "port": (p_core, p_chaos, p_tr, p_data.make_federated_mnist(6, 64, seed=0),
             p_data.synthetic_mnist(300, seed=77)),
    "ref": (r_core, r_chaos, r_tr, r_data.make_federated_mnist(6, 64, seed=0),
            r_data.synthetic_mnist(300, seed=77)),
}
TASKS = {"port": P_TASK, "ref": R_TASK}


def _point(pkg, *, tcp="DEFAULT", link=None, failures=None, strategy=None, min_fit=0.5,
           rounds=2, seed=0, local_steps=2, stochastic=False, batched=True,
           rng_streams="single", engine="default"):
    """One GridPoint of ``pkg`` ("port" or "ref"); ``link`` is a dict of
    LinkProfile overrides on LAB, ``failures`` a client-failure rate."""
    core, chaos_pkg, tr, shards, _ = PKGS[pkg]
    base = tr.LAB.replace(**(link or {}))
    chaos = chaos_pkg.ChaosSchedule(base)
    if failures is not None:
        chaos = chaos.add(chaos_pkg.client_failure_schedule(6, failures, seed=7))
    if strategy == "fedprox":
        strat = core.fedprox(0.01, min_fit=min_fit)
    else:
        strat = core.fedavg(min_fit=min_fit)
    return core.GridPoint(
        [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)],
        strat,
        getattr(tr, tcp),
        chaos,
        core.ServerConfig(
            rounds=rounds, local_steps=local_steps, seed=seed, batched=batched,
            stochastic=stochastic, rng_streams=rng_streams, engine=engine,
        ),
    )


def _grid(pkg, kwargs, **grid_kw):
    core, _, _, _, eval_data = PKGS[pkg]
    points = [_point(pkg, **kw) for kw in kwargs]
    return points, core.run_fl_grid(TASKS[pkg], points, eval_data=eval_data, **grid_kw)


def _per_point(point):
    """The port's per-point run of a point built afresh."""
    srv = p_core.FederatedServer(
        P_TASK, point.clients, point.strategy, tcp=point.tcp, chaos=point.chaos,
        config=point.config, compressor=point.compressor, eval_data=PKGS["port"][4],
    )
    srv.run()
    return srv


def assert_bitwise(grid_srv, pp_srv):
    """History, clients and final params of two port servers: equal bits."""
    assert_same(grid_srv.history, pp_srv.history, "history")
    assert [(c.connected, c.rounds_participated, c.bytes_sent) for c in grid_srv.clients] == [
        (c.connected, c.rounds_participated, c.bytes_sent) for c in pp_srv.clients
    ]
    for a, b in zip(tree_leaves(grid_srv.global_params), tree_leaves(pp_srv.global_params)):
        assert torch.equal(a, b)


_SPLIT = dict(stochastic=True, rng_streams="split")

# case -> (point kwargs, run_fl_grid kwargs)
CASES = {
    "analytic": ([
        dict(),
        dict(tcp="TUNED_EDGE"),
        dict(link=dict(delay=0.3)),
        dict(link=dict(loss=0.15)),
        dict(link=dict(delay=8.0)),  # dead run -> nan accuracy
        dict(tcp="TUNED_EDGE", link=dict(delay=8.0)),
    ], {}),
    "stochastic": ([
        dict(stochastic=True),
        dict(stochastic=True, link=dict(loss=0.05)),
        dict(stochastic=True, tcp="TUNED_EDGE", link=dict(delay=0.5)),
    ], {}),
    "chaos": ([dict(failures=f, min_fit=0.1) for f in (0.0, 0.3, 0.5)], {}),
    # fedprox rows run in their own (steps, use_prox) group
    "mixed_strategies": ([dict(), dict(strategy="fedprox")], {}),
    "coalesce_off": ([dict(), dict()], dict(coalesce=False)),
    "parity": ([
        dict(**_SPLIT),
        dict(**_SPLIT, link=dict(loss=0.05)),
        dict(**_SPLIT, tcp="TUNED_EDGE", link=dict(delay=0.5)),
        dict(**_SPLIT, min_fit=0.1, failures=0.4),
    ], dict(transport="parity")),
    "fused": ([dict(**_SPLIT), dict(**_SPLIT, link=dict(loss=0.1))], dict(transport="fused")),
}


@pytest.mark.parametrize("case", [c for c in CASES if c != "fused"])
def test_grid_matches_per_point_exactly(case):
    """Every History field, every client's state and the final params are
    the same bits in the grid and in per-point batched runs. Not a
    tolerance check."""
    kwargs, grid_kw = CASES[case]
    _, res = _grid("port", kwargs, **grid_kw)
    for kw, grid_srv in zip(kwargs, res.servers):
        assert_bitwise(grid_srv, _per_point(_point("port", **kw)))
    if case == "coalesce_off":
        assert res.stats.fit_rows_unique == res.stats.fit_rows_total
    if case == "parity":
        assert res.stats.transport_dispatches == 2  # one hoisted call per round
        assert res.stats.transport_rows > 0


@pytest.mark.parametrize("case", list(CASES))
def test_grid_matches_reference(case):
    """The port's grid against the reference's on the same points and
    initial params: numpy History fields equal, accuracy and loss within
    1e-3, every GridStats field equal."""
    kwargs, grid_kw = CASES[case]
    r_points, r_res = _grid("ref", kwargs, **grid_kw)
    p_points, p_res = _grid("port", kwargs, **grid_kw)
    for rp, rh, pp, ph in zip(r_points, r_res.histories, p_points, p_res.histories):
        assert_histories_match(rh, rp.clients, ph, pp.clients)
    assert dataclasses.asdict(p_res.stats) == dataclasses.asdict(r_res.stats)
    assert any(h.completed_rounds for h in p_res.histories)


def test_grid_coalesces_shared_trajectories():
    """A pure-latency grid (transport times change, gradients don't)
    computes ONE trajectory and one eval per round, and it is the
    per-point one."""
    kwargs = [dict(link=dict(delay=d)) for d in (0.0, 0.1, 0.3, 1.0)]
    _, res = _grid("port", kwargs)
    s = res.stats
    assert s.fit_rows_total == 4 * s.fit_rows_unique
    assert s.evals_computed * 4 == s.evals_requested
    assert s.anchor_rows_stacked == s.rounds  # one shared anchor per round
    ref = _per_point(_point("port", **kwargs[0]))
    assert_bitwise(res.servers[0], ref)
    evals = [(m["accuracy"], m["loss"]) for m in ref.history.eval_metrics]
    for srv in res.servers:
        for a, b in zip(tree_leaves(srv.global_params), tree_leaves(ref.global_params)):
            assert torch.equal(a, b)
        assert [(m["accuracy"], m["loss"]) for m in srv.history.eval_metrics] == evals


@pytest.mark.parametrize("width", [1, 3, 24])  # 64 on the card (test_torch_cuda.py)
@pytest.mark.parametrize("mu", [0.0, 0.01])
def test_plane_rows_width_and_position_independent(width, mu):
    """A row's delta and metrics are the same bits at every dispatch width
    and row position, beside other rows from other anchors (with and
    without the prox term, which reduces over a row's own leaves)."""
    shards = PKGS["port"][3]
    clients = [p_core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    plans = P_TASK.plan_fit(clients, 2, np.random.default_rng(3))
    rows = list(zip(clients, plans))
    anchors = [_ref_params(0), _ref_params(1)]
    target = rows[3]
    want, _, want_m = P_TASK.fit_rows(anchors, [target], 2, [mu], mu > 0, anchor_idx=[1])
    for pos in sorted({0, width // 2, width - 1}):
        rs = [rows[(k * 5) % len(rows)] for k in range(width)]
        aidx = [k % 2 for k in range(width)]
        rs[pos], aidx[pos] = target, 1
        plane, _, mets = P_TASK.fit_rows(anchors, rs, 2, [mu] * width, mu > 0, anchor_idx=aidx)
        for a, b in zip(tree_leaves(plane), tree_leaves(want)):
            assert torch.equal(a[pos], b[0]), (width, pos)
        assert mets[pos] == want_m[0]


def test_plane_dispatches_use_bucket_widths():
    """Chaos-variable cohort sizes land on the reference's bucket ladder."""
    before = len(P_TASK.plane_dispatch_widths())
    kwargs = [dict(failures=f, min_fit=0.1) for f in (0.0, 0.2, 0.4, 0.6)]
    _grid("port", kwargs)
    widths = P_TASK.plane_dispatch_widths()[before:]
    assert widths, "plane path did not run"
    assert all(w in set(_ROW_BUCKETS) or w % 64 == 0 for w in widths), widths


def test_split_streams_selection_invariant_across_transport_engines():
    """rng_streams="split": the selection sequence is the same whichever
    engine samples transport — per-point default, per-point
    fused_transport, the grid's parity plane or its shared fused plane."""
    base = dict(**_SPLIT, link=dict(loss=0.05))
    ids = lambda h: [r.selected_ids for r in h.rounds]  # noqa: E731
    ref = ids(_per_point(_point("port", **base)).history)
    assert ref
    assert ids(_per_point(_point("port", **base, engine="fused_transport")).history) == ref
    for mode in ("parity", "fused"):
        _, res = _grid("port", [base], transport=mode)
        assert ids(res.histories[0]) == ref, mode


def test_fused_grid_shared_stream_deterministic():
    """transport="fused" is deterministic run to run and counts one hoisted
    dispatch per round."""
    kwargs, grid_kw = CASES["fused"]
    _, a = _grid("port", kwargs, **grid_kw)
    _, b = _grid("port", kwargs, **grid_kw)
    assert a.stats.transport_dispatches == 2
    for sa, sb in zip(a.servers, b.servers):
        assert_bitwise(sa, sb)


def test_hoisted_grid_runs_ineligible_points_per_point():
    """Analytic and single-stream points fall back to per-point transport
    inside a hoisted grid, exactly."""
    kwargs = [dict(), dict(stochastic=True), dict(**_SPLIT)]
    _, res = _grid("port", kwargs, transport="fused")
    for kw, srv in zip(kwargs[:2], res.servers[:2]):
        assert_bitwise(srv, _per_point(_point("port", **kw)))


def test_unknown_transport_mode_raises():
    with pytest.raises(ValueError, match="unknown transport mode"):
        _grid("port", [dict()], transport="nope")
