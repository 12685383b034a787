"""Port parity: the server-side optimizers (``optim::{fedopt_server,
nesterov_outer}``) and the strategies that carry them (``fedopt`` as
FedAdam / FedYogi / FedAdagrad, ``diloco``) through every engine and
checkpoint, at the reference tests' size (6 clients x 64 examples, 2
local steps).

- The optimizers on the same numpy inputs give the reference's bits: the
  largest gap over several steps of each kind, updates and state, is 0
  (the f32 square root is taken correctly rounded, as XLA's).
- Sequential, batched and async Histories against the reference's: numpy
  fields equal, accuracy and loss within 1e-3; a grid of server-optimizer
  points equals its per-point runs bitwise, with every ``GridStats`` field
  equal to the reference's ``run_fl_grid``.
- A point or grid killed and resumed equals the uninterrupted run bitwise
  (the ``server_state`` rides the checkpoint), and a point checkpoint
  written by either package finishes in the other.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _card_reference import assert_histories_match
from _torch_parity import assert_same, one_torch_thread, to_np, with_ref_init  # noqa: F401
import repro.chaos as r_chaos
import repro.core as r_core
import repro.data as r_data
import repro.optim as r_optim
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.optim as p_optim
import repro_torch.transport as p_tr
from repro_torch.utils import tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P_TASK = with_ref_init(p_core.mnist_cnn_task(device="cpu"))
R_TASK = r_core.mnist_cnn_task()
PKGS = {
    "ref": (r_core, r_data, r_tr, r_chaos, R_TASK, r_data.make_federated_mnist(6, 64, seed=0),
            r_data.synthetic_mnist(200, seed=77)),
    "port": (p_core, p_data, p_tr, p_chaos, P_TASK, p_data.make_federated_mnist(6, 64, seed=0),
             p_data.synthetic_mnist(200, seed=77)),
}
SERVER_OPTS = ("fedadam", "fedyogi", "fedadagrad", "diloco")


def _strategy(core, name, min_fit=0.5):
    return core.STRATEGIES[name](min_fit=min_fit)


def _chaos(pkg, link=None):
    _, _, tr, chaos_pkg, *_ = PKGS[pkg]
    return chaos_pkg.ChaosSchedule(link or tr.LAB).add(
        chaos_pkg.netem(1.5, 10_000.0, delay=0.4, loss=0.05),
        chaos_pkg.client_failure_schedule(6, 0.3, t_start=2.0, seed=3),
    )


def _server(pkg, strategy="fedadam", *, slow=(), chaos=None, **cfg_kw):
    core, _, tr, _, task, shards, eval_data = PKGS[pkg]
    clients = [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    for i in slow:
        clients[i].compute_rate = 0.2
    cfg = dict(rounds=3, local_steps=2, seed=0, batched=True)
    cfg.update(cfg_kw)
    return core.FederatedServer(
        task, clients, _strategy(core, strategy, 0.3), tcp=tr.DEFAULT,
        chaos=chaos or _chaos(pkg),
        config=core.ServerConfig(**cfg), eval_data=eval_data,
    )


def _point(pkg, strategy="fedadam", link=None, **cfg_kw):
    core, _, tr, chaos_pkg, _, shards, _ = PKGS[pkg]
    cfg = dict(rounds=3, local_steps=2, seed=0, batched=True)
    cfg.update(cfg_kw)
    return core.GridPoint(
        [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)],
        _strategy(core, strategy), tr.DEFAULT, chaos_pkg.ChaosSchedule(link or tr.LAB),
        core.ServerConfig(**cfg),
    )


def _same_server(a, b):
    """Two port servers: History, clients, clock, params and server state,
    the same bits."""
    assert_same(a.history, b.history, "history")
    assert a.sim_time == b.sim_time
    assert [(c.connected, c.rounds_participated, c.bytes_sent) for c in a.clients] == [
        (c.connected, c.rounds_participated, c.bytes_sent) for c in b.clients]
    for x, y in zip(tree_leaves(a.global_params), tree_leaves(b.global_params)):
        assert torch.equal(x, y)
    for x, y in zip(tree_leaves(a.strategy.server_state), tree_leaves(b.strategy.server_state)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the optimizers on the same numpy inputs
# ---------------------------------------------------------------------------

SHAPES = {"conv1": {"b": (32,), "w": (5, 5, 1, 32)}, "fc2": {"b": (10,), "w": (512, 10)}}


def _np_tree(rng, scale=1.0, fill=None):
    return {k: {l: (np.full(s, fill, np.float32) if fill is not None
                    else (rng.standard_normal(s) * scale).astype(np.float32))
                for l, s in v.items()} for k, v in SHAPES.items()}


def _as(tree, to):
    return {k: {l: to(x) for l, x in v.items()} for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["adam", "yogi", "adagrad", "nesterov"])
def test_server_optimizer_matches_reference(kind):
    """Six steps of deltas spanning four decades (at step 2 ``v`` is set to
    the delta's square, which sends yogi through ``sign(0)``): every update
    and every state leaf has the reference's bits. Largest gap found: 0."""
    if kind == "nesterov":
        ref, port = r_optim.nesterov_outer(), p_optim.nesterov_outer()
    else:
        ref, port = r_optim.fedopt_server(kind), p_optim.fedopt_server(kind)
    rng = np.random.default_rng(0)
    params = _np_tree(rng)
    r_state = ref.init(_as(params, jnp.asarray))
    p_state = port.init(_as(params, torch.from_numpy))
    assert all(x.dtype == torch.float32 for x in tree_leaves(p_state))
    for step in range(6):
        delta = _np_tree(rng, scale=10.0 ** -int(rng.integers(0, 4)))
        if step == 2 and "v" in p_state:
            v = _as(delta, np.square)
            r_state, p_state = dict(r_state, v=_as(v, jnp.asarray)), dict(
                p_state, v=_as(v, torch.from_numpy))
        r_upd, r_state = ref.update(_as(delta, jnp.asarray), r_state, None, jnp.int32(step))
        p_upd, p_state = port.update(_as(delta, torch.from_numpy), p_state, None, step)
        for a, b in ((r_upd, p_upd), (r_state, p_state)):
            a, b = to_np(a), to_np(b)
            for x, y in zip(tree_leaves(a), tree_leaves(b)):
                assert x.dtype == y.dtype and np.array_equal(x.view(np.int32), y.view(np.int32))


def test_nesterov_outer_fedavg_reduction():
    """lr=1, momentum=0 == plain FedAvg application
    (``test_substrates.py::test_nesterov_outer_fedavg_reduction``)."""
    outer = p_optim.nesterov_outer(lr=1.0, momentum=0.0)
    params = {"w": torch.zeros(4)}
    state = outer.init(params)
    delta = {"w": torch.ones(4)}
    upd, state = outer.update(delta, state, params, 0)
    assert torch.equal(upd["w"], delta["w"])


@pytest.mark.parametrize("kind", ["adam", "yogi", "adagrad"])
def test_fedopt_server_moves_toward_delta(kind):
    """``test_substrates.py::test_fedopt_server_moves_toward_delta``."""
    opt = p_optim.fedopt_server(kind, lr=0.1)
    params = {"w": torch.zeros(4)}
    state = opt.init(params)
    upd, _ = opt.update({"w": torch.ones(4)}, state, params, 0)
    assert float(torch.min(upd["w"])) > 0.0


def test_fedopt_server_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown fedopt kind 'sgd'"):
        p_optim.fedopt_server("sgd")


def test_strategy_table_equals_reference():
    """Every strategy of the table: the same name, quorum knobs and
    aggregation fingerprint as the reference's (the grid coalesces on it)."""
    assert list(p_core.STRATEGIES) == list(r_core.STRATEGIES)
    for name in p_core.STRATEGIES:
        p, r = p_core.STRATEGIES[name](), r_core.STRATEGIES[name]()
        assert (p.name, p.min_fit_fraction, p.agg_fingerprint, p.robust) == (
            r.name, r.min_fit_fraction, r.agg_fingerprint, r.robust)
        assert (p.server_opt is None) == (r.server_opt is None) and p.server_state is None


@pytest.mark.parametrize("name", SERVER_OPTS)
def test_alternative_strategies_run(name):
    """``test_fl_core.py::test_alternative_strategies_run[fedopt]`` for each
    server optimizer: two rounds complete, and the state is f32 on the
    params' device, shaped like them."""
    srv = _server("port", name, rounds=2, batched=False, chaos=p_chaos.ChaosSchedule(p_tr.LAB))
    assert srv.run().completed_rounds == 2
    state = srv.strategy.server_state
    assert sorted(state) == (["m"] if name == "diloco" else ["m", "v"])
    for slot in state.values():
        for s, p in zip(tree_leaves(slot), tree_leaves(srv.global_params)):
            assert s.dtype == torch.float32 and s.shape == p.shape and s.device == p.device


# ---------------------------------------------------------------------------
# Histories against the reference, every engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["fedadam", "diloco"])
@pytest.mark.parametrize("batched", [False, True])
def test_history_matches_reference(name, batched):
    runs = {pkg: _server(pkg, name, batched=batched) for pkg in ("ref", "port")}
    hists = {pkg: srv.run() for pkg, srv in runs.items()}
    assert hists["port"].completed_rounds == 3
    assert_histories_match(hists["ref"], runs["ref"].clients, hists["port"], runs["port"].clients)


def test_async_fedadam_matches_reference():
    """Buffered async (k=3, half the clients throttled, staleness weights):
    each flush aggregates through ``aggregate_stacked`` and then the server
    optimizer, as the reference's."""
    runs = {pkg: _server(pkg, "fedadam", rounds=4, async_mode=True, async_buffer_k=3,
                         staleness_alpha=0.5, slow=(0, 1, 2)) for pkg in ("ref", "port")}
    hists = {pkg: srv.run() for pkg, srv in runs.items()}
    assert any(r.metrics.get("async_flush_size") for r in hists["port"].rounds)
    assert_histories_match(hists["ref"], runs["ref"].clients, hists["port"], runs["port"].clients)
    assert runs["port"].model_version == runs["ref"].model_version > 1


def _grid_points(pkg):
    """Twin fedadam points (they coalesce), a diloco and a fedavg point on
    the same inputs (different fingerprints: they must not) and a fedadam
    point under 10 % loss."""
    tr = PKGS[pkg][2]
    return [_point(pkg, "fedadam"), _point(pkg, "fedadam"), _point(pkg, "diloco"),
            _point(pkg, "fedavg"), _point(pkg, "fedadam", tr.LAB.replace(loss=0.1))]


def test_grid_equals_per_point_and_reference():
    """The port's grid == its per-point runs bitwise (History, params,
    server state); against the reference's ``run_fl_grid`` the Histories
    match and every ``GridStats`` field is equal."""
    core, _, _, _, task, _, eval_data = PKGS["port"]
    res = core.run_fl_grid(task, _grid_points("port"), eval_data=eval_data)
    for gsrv, p in zip(res.servers, _grid_points("port")):
        srv = core.FederatedServer(task, p.clients, p.strategy, tcp=p.tcp, chaos=p.chaos,
                                   config=p.config, eval_data=eval_data)
        srv.run()
        assert_same(gsrv.history, srv.history, "history")
        if p.strategy.server_opt is not None:
            _same_server(gsrv, srv)
    a, b, c = (res.servers[i].global_params for i in range(3))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert not all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(c)))
    r_core_, _, _, _, r_task, _, r_eval = PKGS["ref"]
    r_points = _grid_points("ref")
    r_res = r_core_.run_fl_grid(r_task, r_points, eval_data=r_eval)
    for rp, rh, ph, psrv in zip(r_points, r_res.histories, res.histories, res.servers):
        assert_histories_match(rh, rp.clients, ph, psrv.clients)
    assert dataclasses.asdict(res.stats) == dataclasses.asdict(r_res.stats)
    assert res.stats.fit_rows_unique < res.stats.fit_rows_total


# ---------------------------------------------------------------------------
# checkpoints: kill-and-resume and across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,cfg", [
    ("fedadam", dict(batched=True)),
    ("diloco", dict(batched=False)),
    ("fedyogi", dict(async_mode=True, async_buffer_k=2)),
], ids=["fedadam_batched", "diloco_sequential", "fedyogi_async"])
def test_point_kill_and_resume_bitwise(tmp_path, name, cfg):
    d = str(tmp_path / "ckpt")
    ref = _server("port", name, rounds=4, **cfg)
    ref.run()
    part = _server("port", name, rounds=4, **cfg)
    part.run(checkpoint_dir=d, stop_after_round=2)
    manifest = json.loads(open(os.path.join(d, "step_000000002", "manifest.json")).read())
    assert manifest["metadata"]["point"]["has_server_state"]
    assert "server_state/m/conv1/b" in manifest["keys"]
    res = _server("port", name, rounds=4, **cfg)
    res.run(checkpoint_dir=d)
    _same_server(ref, res)


def test_grid_kill_and_resume_bitwise(tmp_path):
    """A fedadam grid on the fused transport plane (split streams) killed
    after round 2 and resumed: each point's state, the same bits."""
    def pts():
        tr = PKGS["port"][2]
        return [_point("port", "fedadam", l, rounds=4, stochastic=True, rng_streams="split")
                for l in (tr.LAB, tr.LAB.replace(delay=0.3), tr.LAB.replace(loss=0.1))]

    core, _, _, _, task, _, eval_data = PKGS["port"]
    d = str(tmp_path / "ckpt")
    ref = core.run_fl_grid(task, pts(), eval_data=eval_data, transport="fused")
    core.run_fl_grid(task, pts(), eval_data=eval_data, transport="fused",
                     checkpoint_dir=d, stop_after_round=2)
    res = core.run_fl_grid(task, pts(), eval_data=eval_data, transport="fused",
                           checkpoint_dir=d)
    assert res.stats.resumed_round == 2
    for a, b in zip(ref.servers, res.servers):
        _same_server(a, b)


_REF = {}


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_point_checkpoint_crosses_packages(tmp_path, writer, reader):
    """A fedadam run killed after round 2 by either package and resumed in
    the other: ``server_state/{m,v}/<layer>/<leaf>`` restores, and the
    finished History equals the reference's uninterrupted run (numpy
    fields exactly, accuracy and loss within 1e-3)."""
    d = str(tmp_path / "ckpt")
    _server(writer, rounds=4).run(checkpoint_dir=d, stop_after_round=2)
    res = _server(reader, rounds=4)
    hist = res.run(checkpoint_dir=d)
    if "ref" not in _REF:
        srv = _server("ref", rounds=4)
        _REF["ref"] = (srv.run(), srv.clients)
    assert_histories_match(*_REF["ref"], hist, res.clients)
    assert hist.completed_rounds == 4
