"""Port parity: the fault domain (the counterparts of
``tests/test_resilience.py``'s kill-and-resume, quarantine and
``server_restart`` tests; the device transport backend waits on ROADMAP
Queue 1, item 13).

At the reference tests' size (6 clients x 64 examples, 2 local steps):

- a sweep killed after round 2 and resumed from its ``checkpoint_dir`` is
  BITWISE equal to the uninterrupted sweep inside the port (every History
  field, every client and the final params), through each transport mode,
  the residual plane, sparse storage, a sparse-to-dense resume, a manifest
  without the sparse-era keys and a lazy population; its ``GridStats``
  equal the reference's killed-and-resumed grid field for field;
- a NaN-poisoned point is quarantined while its neighbours keep their bits;
- a ``server_restart`` loses its round and drops every connection.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from _card_reference import assert_histories_match
from _torch_parity import assert_same, one_torch_thread, with_ref_init  # noqa: F401
import repro.chaos as r_chaos
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.compress as p_comp
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.transport as p_tr
from repro_torch.checkpoint import CheckpointManager
from repro_torch.utils import tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P_TASK = with_ref_init(p_core.mnist_cnn_task(device="cpu"))
R_TASK = r_core.mnist_cnn_task()
SHARDS = p_data.make_federated_mnist(6, 64, seed=0)
EVAL = p_data.synthetic_mnist(300, seed=77)
LAB = p_tr.LAB


def _point(shards=SHARDS, *, comp=None, chaos=None, link=LAB, strategy=None, core=p_core,
           tr=p_tr, chaos_pkg=p_chaos, **cfg_kw):
    clients = [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    cfg_kw.setdefault("rounds", 3)
    cfg_kw.setdefault("local_steps", 2)
    cfg_kw.setdefault("seed", 0)
    cfg_kw.setdefault("batched", True)
    return core.GridPoint(
        clients, strategy or core.fedavg(min_fit=0.5), tr.DEFAULT,
        chaos or chaos_pkg.ChaosSchedule(link), core.ServerConfig(**cfg_kw), compressor=comp,
    )


def _grid(points, **kw):
    return p_core.run_fl_grid(P_TASK, points, eval_data=EVAL, **kw)


def _assert_runs_bitwise(ref, got):
    """Two port grid results: every History field, every client's state and
    the final params, the same bits."""
    assert len(ref.servers) == len(got.servers)
    for a, b in zip(ref.servers, got.servers):
        assert_same(a.history, b.history, "history")
        assert [(c.connected, c.rounds_participated, c.bytes_sent) for c in a.clients] == [
            (c.connected, c.rounds_participated, c.bytes_sent) for c in b.clients]
        for x, y in zip(tree_leaves(a.global_params), tree_leaves(b.global_params)):
            assert torch.equal(x, y)


def _kill_and_resume(tmp_path, pts, **kw):
    """(uninterrupted, killed after round 2, resumed) runs of ``pts()``."""
    d = str(tmp_path / "ckpt")
    ref = _grid(pts(), **kw)
    part = _grid(pts(), checkpoint_dir=d, stop_after_round=2, **kw)
    res = _grid(pts(), checkpoint_dir=d, **kw)
    return ref, part, res


# ---------------------------------------------------------------------------
# crash-consistent sweeps: kill-and-resume parity
# ---------------------------------------------------------------------------

_SPLIT = dict(stochastic=True, rng_streams="split")


@pytest.mark.parametrize("mode,extra", [
    ("per_point", dict()),
    ("parity", _SPLIT),
    ("fused", _SPLIT),
])
def test_kill_and_resume_bitwise(tmp_path, mode, extra):
    def pts():
        return [_point(rounds=4, **extra), _point(rounds=4, link=LAB.replace(delay=0.3), **extra)]

    ref, part, res = _kill_and_resume(tmp_path, pts, transport=mode)
    assert part.stats.checkpoints_saved == 2
    assert all(len(h.rounds) == 2 for h in part.histories)
    assert res.stats.resumed_round == 2
    _assert_runs_bitwise(ref, res)


def test_kill_and_resume_sequential_engine(tmp_path):
    """Points off the plane path (the sequential engine) resume bitwise too."""
    def pts():
        return [_point(rounds=4, batched=False), _point(rounds=4, batched=False,
                                                        link=LAB.replace(loss=0.1))]

    ref, _, res = _kill_and_resume(tmp_path, pts)
    _assert_runs_bitwise(ref, res)


def test_kill_and_resume_with_residual_plane(tmp_path):
    def pts():
        return [_point(rounds=4, comp=p_comp.topk_compressor(0.1)),
                _point(rounds=4, comp=p_comp.topk_compressor(0.1), link=LAB.replace(delay=0.3))]

    ref, _, res = _kill_and_resume(tmp_path, pts)
    _assert_runs_bitwise(ref, res)
    assert res.servers[0]._residual_plane is not None


def test_kill_and_resume_sparse_plane_bitwise(tmp_path):
    def pts():
        return [_point(rounds=4, comp=p_comp.int8_compressor(), state_plane="sparse"),
                _point(rounds=4, comp=p_comp.int8_compressor(), state_plane="sparse",
                       link=LAB.replace(delay=0.3))]

    d = str(tmp_path / "ckpt")
    ref = _grid(pts())
    _grid(pts(), checkpoint_dir=d, stop_after_round=2)
    mgr = CheckpointManager(d)
    maps = mgr.slot_maps(mgr.latest_step())
    assert any(k.endswith("/residual") for k in maps), maps
    for v in maps.values():
        assert len(set(v)) == len(v)  # each saved row names a unique slot
    _assert_runs_bitwise(ref, _grid(pts(), checkpoint_dir=d))


def test_kill_and_resume_cross_storage(tmp_path):
    """A checkpoint written by SPARSE points restores into a DENSE run, equal
    to the uninterrupted dense run."""
    def pts(plane):
        return [_point(rounds=4, comp=p_comp.topk_compressor(0.1), state_plane=plane)]

    d = str(tmp_path / "ckpt")
    ref = _grid(pts("dense"))
    _grid(pts("sparse"), checkpoint_dir=d, stop_after_round=2)
    _assert_runs_bitwise(ref, _grid(pts("dense"), checkpoint_dir=d))


def test_dense_manifest_back_compat(tmp_path):
    """A checkpoint without the sparse-era keys (no ``slot_maps``, no
    ``residual_plane`` / ``clients_sparse`` metadata) still resumes
    bitwise."""
    def pts():
        return [_point(rounds=4, comp=p_comp.topk_compressor(0.1))]

    d = str(tmp_path / "ckpt")
    ref = _grid(pts())
    _grid(pts(), checkpoint_dir=d, stop_after_round=2)
    for step_dir in os.listdir(d):
        if not step_dir.startswith("step_"):
            continue
        mf = os.path.join(d, step_dir, "manifest.json")
        with open(mf) as f:
            manifest = json.load(f)
        manifest.pop("slot_maps", None)
        for mp in manifest["metadata"]["points"]:
            mp.pop("residual_plane", None)
            mp.pop("clients_sparse", None)
        with open(mf, "w") as f:
            json.dump(manifest, f)
    _assert_runs_bitwise(ref, _grid(pts(), checkpoint_dir=d))


def test_per_point_sparse_population_resume(tmp_path):
    """One sparse-plane server over a lazy Population checkpoints only its
    materialized clients (``clients_sparse``) and resumes bitwise."""
    def srv():
        return p_core.FederatedServer(
            P_TASK, p_core.Population(len(SHARDS), p_data.shard_list_factory(SHARDS)),
            p_core.fedavg(min_fit=0.5), tcp=p_tr.DEFAULT, chaos=p_chaos.ChaosSchedule(LAB),
            config=p_core.ServerConfig(rounds=4, local_steps=2, seed=0, batched=True,
                                       state_plane="sparse", clients_per_round=0.5),
            compressor=p_comp.topk_compressor(0.1), eval_data=EVAL,
        )

    ref = srv()
    ref.run()
    d = str(tmp_path / "ckpt")
    srv().run(checkpoint_dir=d, stop_after_round=2)
    meta = CheckpointManager(d).metadata(2)["point"]
    assert meta["clients"] is None and meta["clients_sparse"]
    res = srv()
    res.run(checkpoint_dir=d)
    assert_same(ref.history, res.history, "history")
    for x, y in zip(tree_leaves(ref.global_params), tree_leaves(res.global_params)):
        assert torch.equal(x, y)


def test_resume_refuses_mismatched_grid(tmp_path):
    d = str(tmp_path / "ckpt")
    _grid([_point(rounds=3)], checkpoint_dir=d, stop_after_round=1)
    with pytest.raises(ValueError, match="DIFFERENT grid"):
        _grid([_point(rounds=3, seed=1)], checkpoint_dir=d)


def test_checkpoint_rejects_stateful_compressor_without_accessors(tmp_path):
    opaque = dataclasses.replace(p_comp.randk_compressor(0.1), state_get=None, state_set=None)
    with pytest.raises(ValueError, match="state_get"):
        _grid([_point(comp=opaque)], checkpoint_dir=str(tmp_path / "ckpt"))


def test_grid_kill_and_resume_stats_equal_reference(tmp_path):
    """The reference's grid killed and resumed the same way: numpy History
    fields equal the port's, accuracy and loss within 1e-3, and every
    GridStats field (checkpoints_saved and resumed_round included) equal."""
    r_shards = r_data.make_federated_mnist(6, 64, seed=0)
    r_eval = r_data.synthetic_mnist(300, seed=77)

    def pts(core, tr, chaos_pkg, shards):
        return [_point(shards, rounds=4, core=core, tr=tr, chaos_pkg=chaos_pkg, **_SPLIT),
                _point(shards, rounds=4, core=core, tr=tr, chaos_pkg=chaos_pkg,
                       link=tr.LAB.replace(loss=0.1), **_SPLIT)]

    runs = {}
    for name, (core, tr, chaos_pkg, shards, task, ev) in {
        "ref": (r_core, r_tr, r_chaos, r_shards, R_TASK, r_eval),
        "port": (p_core, p_tr, p_chaos, SHARDS, P_TASK, EVAL),
    }.items():
        d = str(tmp_path / name)
        core.run_fl_grid(task, pts(core, tr, chaos_pkg, shards), eval_data=ev,
                         transport="parity", checkpoint_dir=d, stop_after_round=2)
        points = pts(core, tr, chaos_pkg, shards)
        runs[name] = (points, core.run_fl_grid(task, points, eval_data=ev, transport="parity",
                                               checkpoint_dir=d, checkpoint_every=2))
    (r_points, r_res), (p_points, p_res) = runs["ref"], runs["port"]
    for rp, rh, pp, ph in zip(r_points, r_res.histories, p_points, p_res.histories):
        assert_histories_match(rh, rp.clients, ph, pp.clients)
    assert dataclasses.asdict(p_res.stats) == dataclasses.asdict(r_res.stats)
    # the saved stats are the snapshot taken before that save is counted, so
    # the resumed run counts 1 (restored) + 1 (its round-4 save)
    assert p_res.stats.resumed_round == 2 and p_res.stats.checkpoints_saved == 2


# ---------------------------------------------------------------------------
# per-point quarantine: one poisoned row never touches the rest of the sweep
# ---------------------------------------------------------------------------


def _poisoned_shards():
    s = SHARDS[2]
    images = s.images.copy()
    images.reshape(-1)[0] = np.nan
    return [dataclasses.replace(s, images=images)] * len(SHARDS)


def test_quarantine_isolates_poisoned_point():
    links = [LAB, LAB.replace(delay=0.3), LAB.replace(delay=1.0)]
    ref = _grid([_point(link=l) for l in links])
    got = _grid([_point(link=links[0]), _point(_poisoned_shards()),
                 _point(link=links[1]), _point(link=links[2])])
    bad = got.histories[1]
    assert bad.status == "diverged"
    assert bad.cause in ("non_finite_loss", "non_finite_delta")
    assert bad.rounds[-1].failed_round
    assert got.stats.quarantined == 1
    healthy = dataclasses.replace(got, servers=[got.servers[i] for i in (0, 2, 3)])
    _assert_runs_bitwise(ref, healthy)


def _server(point):
    return p_core.FederatedServer(
        P_TASK, point.clients, point.strategy, tcp=point.tcp, chaos=point.chaos,
        config=point.config, eval_data=EVAL,
    )


def test_quarantine_reports_instead_of_raising():
    srv = _server(_point(_poisoned_shards()))
    before = [l.clone() for l in tree_leaves(srv.global_params)]
    hist = srv.run()
    assert hist.status == "diverged"
    assert hist.cause in ("non_finite_loss", "non_finite_delta")
    assert hist.summary()["status"] == "diverged"
    for a, b in zip(before, tree_leaves(srv.global_params)):
        assert torch.equal(a, b)


def test_quarantine_opt_out():
    srv = _server(_point(_poisoned_shards(), quarantine=False, rounds=1))
    hist = srv.run()
    assert hist.status == "healthy"
    total = sum(float(l.sum()) for l in tree_leaves(srv.global_params))
    assert not math.isfinite(total)


# ---------------------------------------------------------------------------
# server_restart chaos
# ---------------------------------------------------------------------------


def test_server_restart_loses_round_and_disconnects():
    chaos = p_chaos.ChaosSchedule(LAB).add(p_chaos.server_restart(3.0, downtime=50.0))
    hist = _server(_point(chaos=chaos, rounds=4)).run()
    crashed = [r for r in hist.rounds if r.cause == "server_restart"]
    assert len(crashed) == 1
    assert crashed[0].failed_round
    assert crashed[0].t_end >= 3.0 + 50.0
    later = [r for r in hist.rounds if r.round_idx > crashed[0].round_idx]
    assert later and not any(r.failed_round for r in later)


def test_server_restart_in_grid_counts_and_isolates():
    chaos = p_chaos.ChaosSchedule(LAB).add(p_chaos.server_restart(3.0, downtime=50.0))
    res = _grid([_point(chaos=chaos), _point()])
    assert res.stats.server_restarts == 1
    assert any(r.cause == "server_restart" for r in res.histories[0].rounds)
    assert not any(r.failed_round for r in res.histories[1].rounds)
