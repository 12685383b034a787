"""Port parity for the LM training drivers on the CPU: the train step
(``launch.steps.build_train_step``) against the reference's on a host mesh,
the trainer (``launch.train.train``: loss falls, crash-resume, local-SGD
mode, as ``tests/test_system.py`` asks of the reference's), and the LM
federated task (``core.lm_task``) through ``FederatedServer`` on both
engines against the reference's Histories. Reduced configs in f32 with the
reference's params carried across by ``repro_torch.convert``; torch on one
thread (``one_torch_thread``).

Tolerances: the train step's loss, grad norm and optimizer state within
``STEP_RTOL`` of their scale (f32 sums in another order); the params within
``PARAM_STEP_ATOL`` of one learning rate per step taken, absolute: AdamW
moves every element by up to the rate whatever its gradient's size, and
where |g| is near its eps (1e-8) a gradient differing in its last bits
(f32 sums in another order: 6e-9 on a gradient of 4.7e-8, 1e-7 of its
leaf's max) moves that element's step by a few percent of the rate (2.7 %
measured after one step); the Histories' numpy fields exactly and accuracy /
loss / client metrics within 1e-3
(``_card_reference.assert_records_match``)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.chaos as r_chaos
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.transport as p_tr
from repro.configs import TrainConfig as RTrainConfig
from repro.configs import get_reduced as r_get_reduced
from repro.configs.base import ShapeSpec
from repro.data.tokens import token_batch_for
from repro.launch.mesh import make_host_mesh, mesh_context
from repro.launch.steps import build_train_step as r_build_train_step
from repro.launch.steps import make_optimizer as r_make_optimizer
from repro.models import Model as RModel
from repro_torch.configs import TrainConfig, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as p_steps
from repro_torch.launch import train as p_train
from repro_torch.launch.mesh import MeshShape, make_device_mesh
from repro_torch.models import Model
from repro_torch.utils import tree_leaves, tree_map

from _card_reference import assert_records_match, history_record
from _torch_parity import one_torch_thread, to_np, with_params  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32 = dict(dtype="float32", param_dtype="float32")
STEP_RTOL = 1e-4
PARAM_STEP_ATOL = 0.05  # of the learning rate, per step


def _cfgs(arch="qwen3-8b"):
    return r_get_reduced(arch).replace(**F32), get_reduced(arch).replace(**F32)


def _ref_params_np(rcfg, seed=0):
    return jax.tree.map(np.asarray, RModel(rcfg).init(jax.random.PRNGKey(seed)))


def _abs_gap(want, got) -> float:
    w, g = jax.tree.leaves(to_np(want)), jax.tree.leaves(to_np(got))
    assert len(w) == len(g)
    return max(float(np.max(np.abs(a - b))) for a, b in zip(w, g))


def _rel_gap(want, got) -> float:
    w, g = jax.tree.leaves(to_np(want)), jax.tree.leaves(to_np(got))
    assert len(w) == len(g)
    return max(float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)) for a, b in zip(w, g))


@pytest.mark.parametrize("optimizer,microbatches", [("adamw", 2), ("adafactor", 2), ("adamw", 1)])
def test_train_step_matches_reference(optimizer, microbatches):
    """Three steps of the port's train step and the reference's (jit on the
    host mesh) from the same params on the same batches."""
    rcfg, pcfg = _cfgs()
    kw = dict(optimizer=optimizer, learning_rate=2e-3, total_steps=6, warmup_steps=1,
              microbatches=microbatches)
    rtcfg, ptcfg = RTrainConfig(**kw), TrainConfig(**kw)
    B, S = 4, 16
    mesh = make_host_mesh()
    built = r_build_train_step(rcfg, rtcfg, ShapeSpec("t", "train", S, B), mesh)
    params = _ref_params_np(rcfg)
    r_opt = r_make_optimizer(rtcfg)
    rp = jax.tree.map(jnp.asarray, params)
    r_state = {"params": rp, "opt": r_opt.init(rp), "step": jnp.int32(0)}
    pp = params_from_numpy(params, "cpu")
    p_state = {"params": pp, "opt": p_steps.make_optimizer(ptcfg).init(pp),
               "step": torch.zeros((), dtype=torch.int32)}
    step_fn = p_steps.build_train_step(pcfg, ptcfg)
    with mesh_context(mesh):
        r_fn = jax.jit(built.fn, in_shardings=built.in_shardings,
                       out_shardings=built.out_shardings)
        for i in range(3):
            batch = token_batch_for(rcfg, batch=B, seq=S, seed=i)
            r_state, r_m = r_fn(r_state, {k: jnp.asarray(v) for k, v in batch.items()})
            p_state, p_m = step_fn(p_state, {k: torch.as_tensor(v) for k, v in batch.items()})
            assert sorted(p_m) == sorted(r_m)
            for k in ("loss", "grad_norm"):
                assert abs(float(r_m[k]) - float(p_m[k])) <= STEP_RTOL * abs(float(r_m[k])), k
            gap = _abs_gap(r_state["params"], p_state["params"])
            assert gap <= PARAM_STEP_ATOL * kw["learning_rate"] * (i + 1)
    assert int(p_state["step"]) == 3
    assert _rel_gap(r_state["opt"], p_state["opt"]) < STEP_RTOL


def test_train_step_updates_the_state_in_place():
    """The port's step adds into the params it is given (the reference
    donates them) and empties nothing else of the caller's."""
    _, pcfg = _cfgs()
    tcfg = TrainConfig(optimizer="adafactor", total_steps=4, warmup_steps=1)
    params = Model(pcfg).init(torch.Generator().manual_seed(0))
    state = {"params": params, "opt": p_steps.make_optimizer(tcfg).init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    wq = params["seg0"]["attn"]["wq"]
    before = wq.clone()
    batch = {k: torch.as_tensor(v) for k, v in token_batch_for(pcfg, batch=2, seq=16).items()}
    out, metrics = p_steps.build_train_step(pcfg, tcfg)(state, batch)
    assert out["params"]["seg0"]["attn"]["wq"] is wq and not torch.equal(wq, before)
    assert set(metrics) == {"loss", "accuracy", "aux", "grad_norm"}
    assert set(out["opt"]["v"]["seg0"]["attn"]["wq"]) == {"vr", "vc"}


def test_trainer_loss_decreases_and_resumes(tmp_path):
    """``tests/test_system.py::test_trainer_loss_decreases_and_resumes`` on
    the port: the loss falls, and a restart resumes from the checkpoint."""
    out = p_train.train("qwen3-8b", reduced=True, steps=16, batch=4, seq=32,
                        ckpt_dir=str(tmp_path), ckpt_every=8, log_every=100, device="cpu")
    assert out["losses"][-1] < out["losses"][0]
    out2 = p_train.train("qwen3-8b", reduced=True, steps=20, batch=4, seq=32,
                         ckpt_dir=str(tmp_path), ckpt_every=8, log_every=100, device="cpu")
    assert len(out2["losses"]) == 4  # only the tail steps ran


def test_trainer_resume_equals_the_uninterrupted_run(tmp_path):
    """A 10-step run checkpoints at steps 4 and 8 (LATEST = 8); a restart in
    the same directory resumes from step 8, and its two losses are the
    uninterrupted run's steps 9 and 10, bit for bit on the CPU."""
    kw = dict(reduced=True, steps=10, batch=2, seq=16, ckpt_dir=str(tmp_path), ckpt_every=4,
              log_every=100, device="cpu")
    full = p_train.train("starcoder2-3b", **kw)
    resumed = p_train.train("starcoder2-3b", **kw)
    assert resumed["losses"] == full["losses"][8:]


def test_trainer_local_sgd_mode():
    """``tests/test_system.py::test_trainer_local_sgd_mode`` on the port,
    with RWKV6 as there."""
    out = p_train.train("rwkv6-1.6b", reduced=True, steps=12, inner_steps=4, batch=4, seq=32,
                        log_every=100, device="cpu")
    assert out["final_loss"] < out["losses"][0] + 0.5
    assert len(out["losses"]) == 12


def _prod_mesh_raises():
    with pytest.raises(ValueError, match="256 ranks"):
        p_train.train("qwen3-8b", steps=1, mesh_kind="prod", device="cpu")
    with pytest.raises(ValueError, match="512 ranks"):
        p_train.train("qwen3-8b", steps=1, inner_steps=2, mesh_kind="prod", device="cpu")


def _outer_sync_needs_pods():
    mesh = make_device_mesh(MeshShape(("data", "model"), (1, 1)), device="cpu")
    with pytest.raises(ValueError, match="multi-pod"):
        p_steps.build_outer_sync(get_reduced("qwen3-8b"), TrainConfig(), mesh)


def _build_step_dispatches():
    mesh = make_device_mesh(MeshShape(("data", "model"), (1, 1)), device="cpu")
    cfg = get_reduced("qwen3-8b")
    names = [p_steps.build_step(cfg, TrainConfig(), ShapeSpec("s", kind, 16, 2), mesh).name
             for kind in ("train", "prefill", "decode")]
    assert names == [f"train:{cfg.name}:s:sync", f"prefill:{cfg.name}:s", f"decode:{cfg.name}:s"]


def _local_sgd_without_a_mesh_is_sync():
    _, pcfg = _cfgs()
    tcfg = TrainConfig(optimizer="adafactor", total_steps=4, warmup_steps=1)
    params = Model(pcfg).init(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in token_batch_for(pcfg, batch=2, seq=16).items()}
    out = []
    for mode in ("local_sgd", "sync"):
        p = tree_map(torch.clone, params)
        state = {"params": p, "opt": p_steps.make_optimizer(tcfg).init(p),
                 "step": torch.zeros((), dtype=torch.int32)}
        out.append(p_steps.build_train_step(pcfg, tcfg, mode=mode)(state, batch))
    assert _abs_gap(out[0][0]["params"], out[1][0]["params"]) == 0.0
    assert float(out[0][1]["loss"]) == float(out[1][1]["loss"])


@pytest.mark.parametrize("build", [_prod_mesh_raises, _outer_sync_needs_pods, _build_step_dispatches,
                                   _local_sgd_without_a_mesh_is_sync],
                         ids=["prod_mesh", "outer_sync", "build_step", "local_sgd_step"])
def test_item_16_parts_raise(build):
    """Item 16's sharded steps, once raise cases: the production mesh asks
    for its 256 / 512 ranks, the outer sync for a "pod" axis, ``build_step``
    dispatches on the shape kind, and ``mode="local_sgd"`` without a mesh
    (no pods) is the sync step, bit for bit, as the reference's mode is on
    a mesh without pods."""
    build()


def _lm_server(core, data, tr, chaos, task, batched):
    """4 clients (their MNIST shards unused by the LM task), fedavg
    min_fit 0.5, 2 rounds of 2 local steps."""
    shards = data.make_federated_mnist(4, 16, seed=0)
    return core.FederatedServer(
        task, [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)],
        core.fedavg(min_fit=0.5), tcp=tr.DEFAULT, chaos=chaos.ChaosSchedule(tr.LAB),
        config=core.ServerConfig(rounds=2, local_steps=2, seed=0, batched=batched),
        eval_data=data.synthetic_mnist(16, seed=1),
    )


@pytest.mark.parametrize("batched", [False, True], ids=["sequential", "batched"])
def test_lm_task_history_matches_reference(batched):
    rcfg, pcfg = _cfgs()
    r_task = r_core.lm_task(rcfg, batch_size=2, seq=16)
    p_task = with_params(p_core.lm_task(pcfg, batch_size=2, seq=16, device="cpu"),
                         _ref_params_np(rcfg))
    assert p_task.update_bytes == r_task.update_bytes and p_task.name == r_task.name
    r_srv = _lm_server(r_core, r_data, r_tr, r_chaos, r_task, batched)
    p_srv = _lm_server(p_core, p_data, p_tr, p_chaos, p_task, batched)
    r_hist, p_hist = r_srv.run(), p_srv.run()
    assert p_hist.completed_rounds == 2
    assert_records_match(history_record(r_hist, r_srv.clients), history_record(p_hist, p_srv.clients))
    assert sorted(p_hist.eval_metrics[-1]) == sorted(r_hist.eval_metrics[-1])


def test_lm_task_plane_runs_only_the_real_rows():
    """``lm_task.fit_rows`` dispatches the R real rows unpadded (its
    ``cohort_loss`` runs each row's model on its own, so a padding row would
    be a whole forward and backward thrown away), and each row's delta is
    the one it gets alone: the same bits at width 1 and width 3."""
    _, pcfg = _cfgs()
    task = p_core.lm_task(pcfg, batch_size=2, seq=16, device="cpu")
    anchor = task.init_fn(torch.Generator().manual_seed(0))
    rows = [(p_core.EdgeClient(i), [11 + i, 21 + i]) for i in range(3)]
    plane, n_ex, mets = task.fit_rows([anchor], rows, 2, [0.0] * 3, False, anchor_idx=[0] * 3)
    assert task.plane_dispatch_widths()[-1] == 3 and n_ex == [4] * 3 and len(mets) == 3
    for i, row in enumerate(rows):
        alone, _, alone_m = task.fit_rows([anchor], [row], 2, [0.0], False)
        assert alone_m[0] == mets[i]
        for a, b in zip(tree_leaves(alone), tree_leaves(plane)):
            assert a.shape[0] == 1 and b.shape[0] == 3
            assert torch.equal(a[0], b[i])
