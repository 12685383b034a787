"""Port parity: ``transport_backend="device"`` through the engines, on the
CPU at the reference tests' size (1-6 clients x 48 examples, 1 local step,
torch on one thread).

- ``ServerConfig`` validates the backend as the reference does;
- a per-point run and a mixed host/device ``fused`` grid on clean links
  (no draw decides anything) give the reference's Histories and
  ``GridStats``, one device plane pass per round;
- ``parity`` mode leaves a device point on its own path: it equals its solo
  run field for field;
- point and grid kill-and-resume on the device backend are bitwise within
  the port (the plane's streams are keyed per round);
- an async point rides the device plane with no transport path of its own:
  it completes, and its degenerate case equals its sync twin bitwise.
"""

import dataclasses
import tempfile

import pytest
import torch

from _card_reference import assert_histories_match
from _torch_parity import assert_same, one_torch_thread, with_ref_init  # noqa: F401
import repro.chaos as r_chaos
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.transport as p_tr
from repro_torch.utils import tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P_TASK = with_ref_init(p_core.mnist_cnn_task(device="cpu"))
R_TASK = r_core.mnist_cnn_task()
PKGS = {
    "port": (p_core, p_data, p_tr, p_chaos, P_TASK),
    "ref": (r_core, r_data, r_tr, r_chaos, R_TASK),
}
EVAL = {name: pkg[1].synthetic_mnist(150, seed=77) for name, pkg in PKGS.items()}


def _point(pkg="port", *, backend="device", link=None, chaos_fn=None, n=4, **cfg_kw):
    core, data, tr, chaos_pkg, _ = PKGS[pkg]
    shards = data.make_federated_mnist(n, 48, seed=0)
    clients = [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    kw = dict(rounds=2, local_steps=1, seed=0, batched=True, stochastic=True,
              transport_backend=backend)
    kw.update(cfg_kw)
    chaos = chaos_pkg.ChaosSchedule(link(tr) if link else tr.LAB)
    if chaos_fn is not None:
        chaos_fn(chaos, chaos_pkg)
    return core.GridPoint(clients, core.fedavg(min_fit=0.5), tr.DEFAULT, chaos,
                          core.ServerConfig(**kw))


def _server(point, pkg="port"):
    core, *_, task = PKGS[pkg]
    return core.FederatedServer(task, point.clients, point.strategy, tcp=point.tcp,
                                chaos=point.chaos, config=point.config, eval_data=EVAL[pkg])


def _grid(points, pkg="port", **kw):
    core, *_, task = PKGS[pkg]
    return core.run_fl_grid(task, points, eval_data=EVAL[pkg], **kw)


def _params_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _assert_servers_bitwise(a, b):
    assert_same(a.history, b.history, "history")
    assert [(c.connected, c.rounds_participated, c.bytes_sent) for c in a.clients] == [
        (c.connected, c.rounds_participated, c.bytes_sent) for c in b.clients]
    assert _params_equal(a.global_params, b.global_params)


def test_transport_backend_validation():
    with pytest.raises(ValueError):
        p_core.ServerConfig(transport_backend="cuda")
    with pytest.raises(ValueError):
        p_core.ServerConfig(transport_backend="device", stochastic=False)
    with pytest.raises(ValueError):
        p_core.ServerConfig(transport_backend="device", stochastic=True, batched=False)
    cfg = p_core.ServerConfig(transport_backend="device", stochastic=True, batched=True)
    srv = _server(dataclasses.replace(_point(), config=cfg))
    assert srv.split_streams


def _delay_step(chaos, chaos_pkg):
    chaos.add(chaos_pkg.netem(1.5, 10_000.0, delay=0.4))


def test_degenerate_point_matches_the_reference():
    """A device-backend point on a clean link with a delay step: the
    reference's History (numpy fields exactly, metrics within 1e-3)."""
    p = _server(_point(chaos_fn=_delay_step, rounds=3))
    r = _server(_point("ref", chaos_fn=_delay_step, rounds=3), "ref")
    hp, hr = p.run(), r.run()
    assert hp.completed_rounds == 3
    assert_histories_match(hr, r.clients, hp, p.clients)


def test_fused_grid_partitions_by_backend_as_the_reference():
    """Mixed host/device grid under ``fused``: one device plane pass per
    round for the two device points; clean links, so every History and
    every ``GridStats`` field equals the reference's."""
    def pts(pkg):  # the host point on split streams, so that it is hoisted too
        return [_point(pkg), _point(pkg), _point(pkg, backend="host", rng_streams="split")]

    got = _grid(pts("port"), transport="fused")
    want = _grid(pts("ref"), "ref", transport="fused")
    assert got.stats.transport_device_dispatches == 2  # one per round
    assert got.stats.transport_dispatches == 2
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    for hg, sg, hw, sw in zip(got.histories, got.servers, want.histories, want.servers):
        assert hg.summary()["completed_rounds"] == 2
        assert_histories_match(hw, sw.clients, hg, sg.clients)


def test_parity_mode_reproduces_device_per_point():
    """A device point is excluded from the parity hoist: it equals its solo
    run field for field, on a lossy link where the draws decide."""
    lossy = lambda tr: tr.LAB.replace(loss=0.05)  # noqa: E731
    solo = _server(_point(link=lossy))
    solo.run()
    res = _grid([_point(link=lossy)], transport="parity")
    assert res.stats.transport_device_dispatches == 0
    _assert_servers_bitwise(solo, res.servers[0])


@pytest.mark.parametrize("mode", ["fused", "per_point"])
def test_grid_kill_and_resume_bitwise_device_backend(tmp_path, mode):
    def pts():
        return [_point(rounds=4, n=6), _point(rounds=4, n=6, link=lambda tr: tr.LAB.replace(
            loss=0.05))]

    d = str(tmp_path / "ckpt")
    ref = _grid(pts(), transport=mode)
    part = _grid(pts(), transport=mode, checkpoint_dir=d, stop_after_round=2)
    res = _grid(pts(), transport=mode, checkpoint_dir=d)
    assert part.stats.checkpoints_saved == 2 and res.stats.resumed_round == 2
    for a, b in zip(ref.servers, res.servers):
        _assert_servers_bitwise(a, b)


def test_point_kill_and_resume_bitwise_device_backend():
    make = lambda: _server(_point(rounds=4, link=lambda tr: tr.LAB.replace(loss=0.1)))  # noqa
    ref = make()
    ref.run()
    with tempfile.TemporaryDirectory() as d:
        make().run(checkpoint_dir=d, stop_after_round=2)
        res = make()
        res.run(checkpoint_dir=d)
    _assert_servers_bitwise(ref, res)


def test_async_point_on_the_device_backend():
    """Degenerate async (one client, clean link, a buffer of one) equals its
    sync twin bitwise on the device plane; a buffered async point on a
    lossy link completes every tick."""
    sync = _server(_point(n=1, rounds=3))
    asy = _server(_point(n=1, rounds=3, async_mode=True, async_buffer_k=1))
    hs, ha = sync.run(), asy.run()
    assert _params_equal(sync.global_params, asy.global_params)
    assert sync.sim_time == asy.sim_time
    assert hs.eval_metrics == ha.eval_metrics
    assert [r.t_end for r in hs.rounds] == [r.t_end for r in ha.rounds]
    buffered = _server(_point(rounds=3, async_mode=True, async_buffer_k=2,
                              link=lambda tr: tr.LAB.replace(loss=0.05)))
    hb = buffered.run()
    assert hb.completed_rounds == 3 and buffered.model_version > 0
