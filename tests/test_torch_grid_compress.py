"""Port parity: compressed points in the grid engine. The grid's shared
compression (residual-digest provenance, one ``compress_rows`` pass per
coinciding point-round, each point scattering its own residual plane)
equals per-point batched runs bitwise, on the dense and the sparse
StatePlane; against the reference's ``run_fl_grid`` numpy History fields
are equal, accuracy and loss within 1e-3 and GridStats equal. Small size as
``tests/test_compress_plane.py``: 6 clients x 64 examples, 2 rounds, 2
local steps."""

import dataclasses

import numpy as np
import pytest
import torch

from _card_reference import assert_histories_match
from _torch_parity import assert_same, one_torch_thread, ref_params_np  # noqa: F401 (fixture)
import repro.chaos as r_chaos
import repro.compress as r_comp
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.compress as p_comp
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.transport as p_tr
from repro_torch.convert import params_from_numpy
from repro_torch.utils import tree_leaves

PARAMS0 = ref_params_np(0)
P_TASK = dataclasses.replace(
    p_core.mnist_cnn_task(device="cpu"), init_fn=lambda _g: params_from_numpy(PARAMS0, "cpu")
)
R_TASK = r_core.mnist_cnn_task()
PKGS = {
    "port": (p_core, p_chaos, p_tr, p_comp, p_data.make_federated_mnist(6, 64, seed=0),
             p_data.synthetic_mnist(200, seed=77), P_TASK),
    "ref": (r_core, r_chaos, r_tr, r_comp, r_data.make_federated_mnist(6, 64, seed=0),
            r_data.synthetic_mnist(200, seed=77), R_TASK),
}


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _compressor(pkg, spec, cache):
    """One shared instance per spec within a grid (as the sweep harness
    shares them); randk always fresh."""
    comp_pkg = PKGS[pkg][3]
    name, _, arg = spec.partition(":")
    kw = {"ratio": float(arg)} if arg else {}
    if name == "randk":
        return comp_pkg.get_compressor(name, **kw)
    if spec not in cache:
        cache[spec] = comp_pkg.get_compressor(name, **kw)
    return cache[spec]


def _points(pkg, kwargs, state_plane="dense"):
    core, chaos_pkg, tr, _, shards, _, _ = PKGS[pkg]
    cache = {}
    return [
        core.GridPoint(
            [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)],
            core.fedavg(min_fit=0.5),
            tr.DEFAULT,
            chaos_pkg.ChaosSchedule(tr.LAB.replace(**kw.get("link", {}))),
            core.ServerConfig(rounds=2, local_steps=2, seed=0, batched=True,
                              state_plane=state_plane),
            compressor=_compressor(pkg, kw["compressor"], cache),
        )
        for kw in kwargs
    ]


def _grid(pkg, kwargs, state_plane="dense", **grid_kw):
    core, _, _, _, _, eval_data, task = PKGS[pkg]
    points = _points(pkg, kwargs, state_plane)
    return points, core.run_fl_grid(task, points, eval_data=eval_data, **grid_kw)


def _per_point(kw, state_plane="dense"):
    (p,) = _points("port", [kw], state_plane)
    srv = p_core.FederatedServer(
        P_TASK, p.clients, p.strategy, tcp=p.tcp, chaos=p.chaos, config=p.config,
        compressor=p.compressor, eval_data=PKGS["port"][5],
    )
    srv.run()
    return srv


def assert_bitwise(a, b):
    assert_same(a.history, b.history, "history")
    for x, y in zip(tree_leaves(a.global_params), tree_leaves(b.global_params)):
        assert torch.equal(x, y)
    if b._residual_plane is not None:
        pa, pb = a._residual_plane, b._residual_plane
        slots = list(range(len(b.clients)))
        ra = pa.rows_for(slots, allocate=False) if pa.storage == "sparse" else slots
        rb = pb.rows_for(slots, allocate=False) if pb.storage == "sparse" else slots
        for x, y in zip(tree_leaves(pa.buffer), tree_leaves(pb.buffer)):
            assert torch.equal(x[torch.as_tensor(ra)], y[torch.as_tensor(rb)])


MIXED = [
    dict(compressor="topk:0.1"),
    dict(compressor="topk:0.1", link=dict(delay=0.3)),
    dict(compressor="int8"),
    dict(compressor="bf16", link=dict(loss=0.15)),
]


@pytest.mark.parametrize("state_plane", ["dense", "sparse"])
@pytest.mark.parametrize("coalesce", [True, False])
def test_compressed_grid_matches_per_point_exactly(state_plane, coalesce):
    """topk, int8 and bf16 points: History, final params and every
    residual row are the same bits as per-point runs."""
    _, res = _grid("port", MIXED, state_plane, coalesce=coalesce)
    for kw, srv in zip(MIXED, res.servers):
        assert_bitwise(srv, _per_point(kw, state_plane))
    assert res.stats.compress_requested == (len(MIXED) * 2 if coalesce else 0)


@pytest.mark.parametrize("state_plane", ["dense", "sparse"])
def test_compressed_grid_matches_reference(state_plane):
    r_points, r_res = _grid("ref", MIXED, state_plane)
    p_points, p_res = _grid("port", MIXED, state_plane)
    for rp, rh, pp, ph in zip(r_points, r_res.histories, p_points, p_res.histories):
        assert ph.completed_rounds == 2
        assert_histories_match(rh, rp.clients, ph, pp.clients)
    assert dataclasses.asdict(p_res.stats) == dataclasses.asdict(r_res.stats)


@pytest.mark.parametrize("compressor", ["int8", "bf16", "topk:0.05"])
def test_compressed_grid_coalesces_with_residual_digest(compressor):
    """A compressed pure-latency grid regains full row sharing: one
    trajectory, one eval, ONE heavy compression per round across all
    points, and the shared trajectory is the per-point one."""
    kwargs = [dict(compressor=compressor, link=dict(delay=d)) for d in (0.0, 0.1, 0.5)]
    _, res = _grid("port", kwargs)
    s = res.stats
    assert s.fit_rows_total == 3 * s.fit_rows_unique
    assert s.evals_computed * 3 == s.evals_requested
    assert s.compress_requested == 3 * s.compress_computed == 6
    assert_bitwise(res.servers[0], _per_point(kwargs[0]))


def test_randk_grid_stays_opaque_but_exact():
    """Stateful randk has no plane twin: its points take the per-client
    loop, share no compression, and still reproduce per-point runs."""
    kwargs = [dict(compressor="randk:0.25")]
    _, res = _grid("port", kwargs)
    assert res.stats.compress_requested == 0
    assert_same(res.histories[0], _per_point(kwargs[0]).history, "history")


def test_fit_rows_anchor_gather_bitwise():
    """fit_rows with a shared unique anchor + gather index is bitwise
    identical to per-row anchor stacking."""
    params = params_from_numpy(PARAMS0, "cpu")
    clients = [p_core.EdgeClient(i, dataset=s) for i, s in enumerate(PKGS["port"][4][:4])]
    plans = P_TASK.plan_fit(clients, 2, np.random.default_rng(3))
    rows = list(zip(clients, plans))
    mus = [0.0] * len(rows)
    per_row, _, _ = P_TASK.fit_rows([params] * len(rows), rows, 2, mus, False)
    gathered, _, _ = P_TASK.fit_rows([params], rows, 2, mus, False, anchor_idx=[0] * len(rows))
    for a, b in zip(tree_leaves(per_row), tree_leaves(gathered)):
        assert torch.equal(a, b)


def test_grid_stacks_unique_anchors_only():
    """A coalescing latency grid stacks O(rounds) anchors, not O(rows)."""
    kwargs = [dict(compressor="int8", link=dict(delay=d)) for d in (0.0, 0.2, 0.8)]
    _, res = _grid("port", kwargs)
    s = res.stats
    assert s.anchor_rows_stacked == s.rounds == 2
    assert s.anchor_rows_stacked < s.fit_rows_unique
