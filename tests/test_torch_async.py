"""Port parity: the event-driven async engine (the counterparts of
``tests/test_async_engine.py``), at the reference tests' size (4 clients x
64 examples, 2 local steps).

Inside the port, BITWISE: degenerate async (one client, clean link,
``async_buffer_k=1``) equals the sync engine, params, clock and eval trace,
on the sequential and batched engines; a point or grid killed and resumed
equals the uninterrupted run; async grid points equal their per-point runs
and coalesce. Against the reference: a buffered run's numpy History fields
equal, accuracy and loss within 1e-3, async ``GridStats`` equal, and the
staleness weight ``d * (1 + s)^-alpha`` gives the reference's bits.
"""

import dataclasses
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _card_reference import assert_histories_match
from _torch_parity import one_torch_thread, with_ref_init  # noqa: F401
import repro.chaos as r_chaos
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.transport as p_tr
from repro_torch.compress import get_compressor
from repro_torch.kernels import ops as kernel_ops
from repro_torch.utils import tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P_TASK = with_ref_init(p_core.mnist_cnn_task(device="cpu"))
R_TASK = r_core.mnist_cnn_task()
EVAL = p_data.synthetic_mnist(150, seed=7)
PKGS = {
    "port": (p_core, p_data, p_tr, p_chaos, P_TASK, EVAL),
    "ref": (r_core, r_data, r_tr, r_chaos, R_TASK, r_data.synthetic_mnist(150, seed=7)),
}


def _server(n_clients=4, *, strategy=None, chaos=None, compressor=None, data_seed=0,
            pkg="port", slow=(), **cfg_kw):
    core, data, tr, chaos_pkg, task, eval_data = PKGS[pkg]
    shards = data.make_federated_mnist(n_clients, 64, seed=data_seed)
    clients = [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    for i in slow:
        clients[i].compute_rate = 0.2
    base = dict(rounds=4, local_steps=2, seed=0)
    base.update(cfg_kw)
    return core.FederatedServer(
        task, clients, strategy or core.fedavg(), tcp=tr.DEFAULT,
        chaos=chaos or chaos_pkg.ChaosSchedule(tr.LAB), config=core.ServerConfig(**base),
        compressor=compressor, eval_data=eval_data,
    )


def _params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _losses(hist):
    return [m.get("loss") for m in hist.eval_metrics]


# ---------------------------------------------------------------------------
# degenerate parity: async == sync bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
def test_degenerate_async_equals_sync_bitwise(batched):
    sync = _server(1, rounds=3, batched=batched)
    hs = sync.run()
    asy = _server(1, rounds=3, batched=batched, async_mode=True, async_buffer_k=1)
    ha = asy.run()
    assert _params_equal(sync.global_params, asy.global_params)
    assert sync.sim_time == asy.sim_time
    assert _losses(hs) == _losses(ha)
    assert [r.t_end for r in hs.rounds] == [r.t_end for r in ha.rounds]


def test_staleness_weight_gives_the_reference_bits():
    """``d * w`` with ``w = (1 + s)^-alpha`` a Python float: torch and jax
    both round w to f32 and multiply once, so the bits agree."""
    x = np.random.default_rng(0).normal(size=(4096,)).astype(np.float32) * 3.0
    for alpha in (0.5, 0.3, 1.0):
        for s in range(6):
            w = (1.0 + s) ** (-alpha)
            got = (torch.from_numpy(x) * w).numpy()
            want = np.asarray(jnp.asarray(x) * w)
            assert got.dtype == want.dtype == np.float32
            assert np.array_equal(got, want), (alpha, s)


# ---------------------------------------------------------------------------
# robust aggregation over the buffer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [p_core.median, lambda: p_core.trimmed_mean(0.25),
                                  p_core.krum])
def test_robust_strategy_rejects_buffer_of_one(make):
    with pytest.raises(ValueError, match="async_buffer_k"):
        _server(4, strategy=make(), async_mode=True, async_buffer_k=1)


def test_robust_strategy_aggregates_whole_buffer():
    srv = _server(4, strategy=p_core.median(min_fit=0.25), rounds=5,
                  async_mode=True, async_buffer_k=2)
    seen = []
    orig = srv.strategy.aggregate_fn

    def spy(deltas, weights):
        seen.append(len(list(deltas)))
        return orig(deltas, weights)

    srv.strategy.aggregate_fn = spy
    hist = srv.run()
    assert hist.completed_rounds > 0
    assert seen and all(n == 2 for n in seen)


def test_async_validation_errors():
    with pytest.raises(ValueError, match="async_buffer_k"):
        p_core.ServerConfig(async_buffer_k=0)
    with pytest.raises(ValueError, match="async_concurrency"):
        p_core.ServerConfig(async_concurrency=0)
    with pytest.raises(ValueError, match="synchronous"):
        p_core.FederatedServer(
            P_TASK, p_core.Population(10, lambda cid: None), p_core.fedavg(),
            tcp=p_tr.DEFAULT, chaos=p_chaos.ChaosSchedule(p_tr.LAB),
            config=p_core.ServerConfig(async_mode=True, state_plane="sparse"))


def test_async_concurrency_cap():
    hist = _server(6, rounds=5, async_mode=True, async_buffer_k=2, async_concurrency=2).run()
    assert all(r.selected <= 2 for r in hist.rounds)
    assert hist.completed_rounds > 0


# ---------------------------------------------------------------------------
# chaos at land time + breaker semantics
# ---------------------------------------------------------------------------


def test_client_death_after_dispatch_drops_update():
    chaos = p_chaos.ChaosSchedule(p_tr.LAB).add(
        p_chaos.netem(0, float("inf"), delay=2.0),
        p_chaos.client_failure_schedule(1, 1.0, t_start=1.0),
    )
    srv = _server(1, chaos=chaos, rounds=10, async_mode=True, async_buffer_k=1,
                  max_consecutive_failures=3)
    init = [l.clone() for l in tree_leaves(srv.global_params)]
    hist = srv.run()
    assert hist.rounds[0].selected == 1
    assert hist.rounds[0].metrics.get("async_dropped_dead") == 1.0
    assert hist.rounds[0].failed_round and hist.rounds[0].cause == "no_updates"
    assert all(torch.equal(a, b) for a, b in zip(init, tree_leaves(srv.global_params)))
    assert hist.status == "failed" and hist.cause == "max_consecutive_failures"
    assert len(hist.rounds) == 3


def test_async_breaker_resets_on_progress():
    chaos = p_chaos.ChaosSchedule(p_tr.LAB).add(
        p_chaos.client_failure_schedule(2, 1.0, t_start=0.5, t_end=1500.0),
    )
    srv = _server(2, chaos=chaos, rounds=8, async_mode=True, async_buffer_k=1,
                  max_consecutive_failures=4)
    hist = srv.run()
    assert hist.status == "healthy"
    assert "no_updates" in [r.cause for r in hist.rounds]
    assert hist.completed_rounds > 0
    assert srv.consecutive_failures == 0


def test_server_restart_voids_the_queue_and_buffer():
    """A crash inside a tick's deadline horizon loses the tick, the
    in-flight events and the unflushed buffer."""
    chaos = p_chaos.ChaosSchedule(p_tr.LAB).add(p_chaos.server_restart(3.0, downtime=20.0))
    srv = _server(4, chaos=chaos, rounds=4, async_mode=True, async_buffer_k=3, slow=(0, 1))
    hist = srv.run()
    crashed = [r for r in hist.rounds if r.cause == "server_restart"]
    assert len(crashed) == 1 and crashed[0].t_end == 23.0
    assert hist.rounds[-1].t_end > 23.0


# ---------------------------------------------------------------------------
# the reference's numbers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True])
def test_buffered_async_history_matches_reference(batched):
    """Buffered (k=3) async with a throttled half and staleness weights: the
    port's History against the reference's."""
    runs = {pkg: _server(4, pkg=pkg, rounds=5, batched=batched, async_mode=True,
                         async_buffer_k=3, staleness_alpha=0.5, slow=(0, 1))
            for pkg in ("ref", "port")}
    hists = {pkg: srv.run() for pkg, srv in runs.items()}
    assert hists["port"].completed_rounds > 0
    assert any(r.metrics.get("async_flush_size") for r in hists["port"].rounds)
    assert_histories_match(hists["ref"], runs["ref"].clients, hists["port"], runs["port"].clients)
    assert runs["port"].model_version == runs["ref"].model_version > 1


def test_buffered_engine_learns_as_the_reference():
    """``test_fl_core.py::test_async_mode_buffered_engine_learns`` on the
    port, held to the reference's final loss (within 1e-3) rather than the
    test's 2.35 bound."""
    runs = {}
    for pkg in ("ref", "port"):
        core, data, tr, chaos_pkg, task, _ = PKGS[pkg]
        shards = data.make_federated_mnist(8, 64, seed=4)
        clients = [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
        clients[0].compute_rate = clients[1].compute_rate = 0.2
        srv = core.FederatedServer(
            task, clients, core.fedavg(min_fit=0.25), tcp=tr.DEFAULT,
            chaos=chaos_pkg.ChaosSchedule(tr.LAB),
            config=core.ServerConfig(rounds=6, local_steps=2, seed=4, async_mode=True,
                                     staleness_alpha=0.5, async_buffer_k=2),
            eval_data=data.synthetic_mnist(150, seed=5),
        )
        runs[pkg] = (srv.run(), clients)
    hist = runs["port"][0]
    assert hist.completed_rounds == 6
    assert abs(hist.eval_metrics[-1]["loss"] - runs["ref"][0].eval_metrics[-1]["loss"]) <= 1e-3
    sizes = [r.metrics["async_flush_size"] for r in hist.rounds if "async_flush_size" in r.metrics]
    assert sizes and all(s == 2.0 for s in sizes)
    assert all(rec.delivered <= 2 for rec in hist.rounds)
    assert_histories_match(*runs["ref"], *runs["port"])


def test_one_fedavg_reduce_per_flush(monkeypatch):
    """A batched async run aggregates each flush's whole buffer in one
    ``fedavg_reduce`` call (one kernel launch on the card)."""
    calls = []
    orig = kernel_ops.fedavg_reduce

    def count(stacked, w):
        calls.append(tree_leaves(stacked)[0].shape[0])
        return orig(stacked, w)

    monkeypatch.setattr(kernel_ops, "fedavg_reduce", count)
    srv = _server(4, rounds=5, batched=True, async_mode=True, async_buffer_k=3, slow=(0, 1))
    hist = srv.run()
    flushes = [r.metrics["async_flush_size"] for r in hist.rounds if "async_flush_size" in r.metrics]
    assert len(calls) == len(flushes) == srv.model_version > 0
    assert calls == [int(f) for f in flushes]


# ---------------------------------------------------------------------------
# per-point checkpointing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("async_mode", [False, True])
def test_point_kill_resume_bitwise(async_mode):
    kw = dict(rounds=4, async_mode=async_mode, async_buffer_k=2 if async_mode else 1,
              slow=(0,) if async_mode else ())
    ref = _server(4, **kw)
    href = ref.run()
    with tempfile.TemporaryDirectory() as d:
        _server(4, **kw).run(checkpoint_dir=d, stop_after_round=2)
        res = _server(4, **kw)
        hres = res.run(checkpoint_dir=d)
    assert _params_equal(ref.global_params, res.global_params)
    assert ref.sim_time == res.sim_time
    assert _losses(href) == _losses(hres)
    assert [r.t_end for r in href.rounds] == [r.t_end for r in hres.rounds]
    assert ref.model_version == res.model_version


def test_point_checkpoint_persists_randk_counter():
    mk = lambda: get_compressor("randk", ratio=0.25)  # noqa: E731
    ref = _server(3, compressor=mk())
    ref.run()
    with tempfile.TemporaryDirectory() as d:
        _server(3, compressor=mk()).run(checkpoint_dir=d, stop_after_round=2)
        res = _server(3, compressor=mk())
        res.run(checkpoint_dir=d)
    assert _params_equal(ref.global_params, res.global_params)


def test_point_checkpoint_rejects_mismatched_run():
    with tempfile.TemporaryDirectory() as d:
        _server(3).run(checkpoint_dir=d, stop_after_round=1)
        with pytest.raises(ValueError, match="DIFFERENT"):
            _server(3, seed=1).run(checkpoint_dir=d)


# ---------------------------------------------------------------------------
# grid: async points in the transport plane + provenance coalescing
# ---------------------------------------------------------------------------


def _grid_cfg(core, **kw):
    base = dict(rounds=5, local_steps=2, seed=0, batched=True, stochastic=True,
                rng_streams="split", async_mode=True, async_buffer_k=2)
    base.update(kw)
    return core.ServerConfig(**base)


def _grid_point(shards, *, compressor=None, pkg="port", **cfg_kw):
    core, _, tr, chaos_pkg, _, _ = PKGS[pkg]
    return core.GridPoint(
        clients=[core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)],
        strategy=core.fedavg(), tcp=tr.DEFAULT, chaos=chaos_pkg.ChaosSchedule(tr.LAB),
        config=_grid_cfg(core, **cfg_kw), compressor=compressor,
    )


SHARDS4 = p_data.make_federated_mnist(4, 64, seed=0)


def test_grid_async_parity_and_coalescing():
    ref = p_core.FederatedServer(
        P_TASK, [p_core.EdgeClient(i, dataset=s) for i, s in enumerate(SHARDS4)],
        p_core.fedavg(), tcp=p_tr.DEFAULT, chaos=p_chaos.ChaosSchedule(p_tr.LAB),
        config=_grid_cfg(p_core), eval_data=EVAL,
    )
    href = ref.run()
    res = p_core.run_fl_grid(P_TASK, [_grid_point(SHARDS4), _grid_point(SHARDS4)],
                             eval_data=EVAL, transport="parity")
    for srv, hist in zip(res.servers, res.histories):
        assert _params_equal(ref.global_params, srv.global_params)
        assert srv.sim_time == ref.sim_time
        assert _losses(hist) == _losses(href)
    s = res.stats
    assert s.async_flushes > 0
    assert s.fit_rows_unique == s.fit_rows_total // 2
    assert s.evals_computed == s.evals_requested // 2
    assert s.transport_dispatches > 0


def test_grid_async_stats_match_reference():
    """Async points in a grid beside a sync point: every GridStats field
    (async_flushes included) equals the reference's, Histories match."""
    r_shards = r_data.make_federated_mnist(4, 64, seed=0)
    out = {}
    for pkg, shards in (("ref", r_shards), ("port", SHARDS4)):
        core, _, _, _, task, eval_data = PKGS[pkg]
        points = [_grid_point(shards, pkg=pkg), _grid_point(shards, pkg=pkg, seed=1),
                  _grid_point(shards, pkg=pkg, async_mode=False, async_buffer_k=1)]
        out[pkg] = (points, core.run_fl_grid(task, points, eval_data=eval_data,
                                             transport="parity"))
    for rp, rh, pp, ph in zip(out["ref"][0], out["ref"][1].histories, out["port"][0],
                              out["port"][1].histories):
        assert_histories_match(rh, rp.clients, ph, pp.clients)
    assert dataclasses.asdict(out["port"][1].stats) == dataclasses.asdict(out["ref"][1].stats)
    assert out["port"][1].stats.async_flushes > 0


def test_grid_async_kill_resume_bitwise():
    mk = lambda: [_grid_point(SHARDS4), _grid_point(SHARDS4, seed=1)]  # noqa: E731
    ref = p_core.run_fl_grid(P_TASK, mk(), eval_data=EVAL, transport="parity")
    with tempfile.TemporaryDirectory() as d:
        p_core.run_fl_grid(P_TASK, mk(), eval_data=EVAL, transport="parity",
                           checkpoint_dir=d, stop_after_round=2)
        res = p_core.run_fl_grid(P_TASK, mk(), eval_data=EVAL, transport="parity",
                                 checkpoint_dir=d)
    assert res.stats.resumed_round == 2
    for a, b in zip(ref.servers, res.servers):
        assert _params_equal(a.global_params, b.global_params)
        assert a.sim_time == b.sim_time
        assert _losses(a.history) == _losses(b.history)
    assert res.stats.async_flushes == ref.stats.async_flushes


def test_grid_checkpoint_accepts_randk():
    shards = p_data.make_federated_mnist(3, 64, seed=0)

    def mk():
        return [_grid_point(shards, compressor=get_compressor("randk", ratio=0.25),
                            async_mode=False, async_buffer_k=1)]

    ref = p_core.run_fl_grid(P_TASK, mk(), eval_data=EVAL, transport="parity")
    with tempfile.TemporaryDirectory() as d:
        p_core.run_fl_grid(P_TASK, mk(), eval_data=EVAL, transport="parity",
                           checkpoint_dir=d, stop_after_round=2)
        res = p_core.run_fl_grid(P_TASK, mk(), eval_data=EVAL, transport="parity",
                                 checkpoint_dir=d)
    assert _params_equal(ref.servers[0].global_params, res.servers[0].global_params)
