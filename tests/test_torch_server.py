"""Port parity: the synchronous round engine. With the same config and the
same initial params, the port's History equals the reference's exactly on
every numpy-computed field, and within 1e-3 on eval accuracy and loss.
Also the paper's system claims, run on the port."""

import pytest
import torch

from _card_reference import ENGINES, _run, assert_histories_match
from _torch_parity import one_torch_thread, ref_params_np, with_params  # noqa: F401
import repro.chaos as r_chaos
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.configs as p_configs
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.transport as p_tr
from repro_torch.configs import DECODE_32K, TrainConfig
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.tokens import token_batch_for
from repro_torch.launch import steps as p_steps
from repro_torch.launch import train as p_train
from repro_torch.launch.mesh import MeshShape, make_device_mesh
from repro_torch import models as p_models
from repro_torch.utils import tree_leaves, tree_map

pytestmark = pytest.mark.usefixtures("one_torch_thread")

R_TASK = r_core.mnist_cnn_task()
P_TASK = with_params(p_core.mnist_cnn_task(device="cpu"), ref_params_np(0))


@pytest.mark.parametrize("name,overrides,chaos_kind,tcp_name", ENGINES, ids=[e[0] for e in ENGINES])
def test_history_matches_reference(name, overrides, chaos_kind, tcp_name):
    r_hist, r_clients = _run(r_core, r_data, r_tr, r_chaos, R_TASK, name, overrides, chaos_kind, tcp_name)
    p_hist, p_clients = _run(p_core, p_data, p_tr, p_chaos, P_TASK, name, overrides, chaos_kind, tcp_name)
    assert p_hist.completed_rounds > 0
    assert_histories_match(r_hist, r_clients, p_hist, p_clients)


def _port_server(tcp, link=p_tr.LAB, rounds=4, chaos=None, min_fit=0.5, batched=False):
    shards = p_data.make_federated_mnist(8, 80, seed=0)
    clients = [p_core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    return p_core.FederatedServer(
        P_TASK,
        clients,
        p_core.fedavg(min_fit=min_fit),
        tcp=tcp,
        chaos=chaos or p_chaos.ChaosSchedule(link),
        config=p_core.ServerConfig(rounds=rounds, local_steps=3, seed=0, batched=batched),
        eval_data=p_data.synthetic_mnist(250, seed=11),
    )


@pytest.mark.parametrize("batched", [False, True])
def test_paper_headline_claim_on_the_port(batched):
    """At 6 s one-way delay the default stack cannot train; the three tuned
    TCP parameters restore training."""
    link = p_tr.LAB.replace(delay=6.0)
    dead = _port_server(p_tr.DEFAULT, link, batched=batched).run()
    alive = _port_server(p_tr.TUNED_EDGE, link, batched=batched).run()
    assert dead.completed_rounds == 0
    assert alive.completed_rounds == 4
    assert alive.final_accuracy() is not None and alive.final_accuracy() > 0.3


def test_rec3_min_fit_under_90pct_failure_on_the_port():
    chaos = p_chaos.ChaosSchedule(p_tr.LAB).add(p_chaos.client_failure_schedule(8, 0.875, seed=2))
    hist = _port_server(p_tr.DEFAULT, chaos=chaos, min_fit=0.1, rounds=3).run()
    assert hist.completed_rounds == 3  # one surviving client suffices


def _whisper_decode_builds():
    mesh = make_device_mesh(MeshShape(("data", "model"), (1, 1)), device="cpu")
    built = p_steps.build_step(p_configs.get_config("whisper-base"), TrainConfig(), DECODE_32K,
                               mesh)
    assert built.name == "decode:whisper-base:decode_32k" and built.donate_argnums == (1,)
    params_abs, cache_abs, tok_abs = built.abstract_args
    assert tuple(tok_abs.shape) == (DECODE_32K.global_batch, 1)
    assert set(cache_abs) == set(built.in_shardings[1]) == {"self", "cross_k", "cross_v"}


def _local_mode_is_sync():
    cfg = p_configs.get_reduced("whisper-base").replace(dtype="float32", param_dtype="float32")
    tcfg = TrainConfig(total_steps=2, warmup_steps=1)
    model = p_models.Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in token_batch_for(cfg, batch=2, seq=8).items()}
    losses = []
    for mode in ("local", "sync"):
        p = tree_map(torch.clone, params)
        state = {"params": p, "opt": p_steps.make_optimizer(tcfg).init(p),
                 "step": torch.zeros((), dtype=torch.int32)}
        _, metrics = p_steps.build_train_step(cfg, tcfg, mode=mode)(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[0] == losses[1]


def _prod_mesh_asks_for_its_ranks():
    with pytest.raises(ValueError, match="256 ranks"):
        p_train.train("qwen3-8b", steps=1, mesh_kind="prod", device="cpu")


def _outer_sync_builds_on_pods():
    mesh = make_device_mesh(MeshShape(("pod", "data", "model"), (1, 1, 1)), device="cpu")
    cfg = p_configs.get_reduced("qwen3-8b")
    built = p_steps.build_outer_sync(cfg, TrainConfig(), mesh)
    assert built.name == f"outer_sync:{cfg.name}:none" and built.donate_argnums == (0, 1, 2)
    assert all(s[0] == "pod" for s in tree_leaves(built.in_shardings[0],))


def _serving_step_runs(kind, arch):
    """A sharded prefill (then decode) step on a 1 x 1 mesh equals the
    model's own on one device (f32)."""
    cfg = p_configs.get_reduced(arch).replace(dtype="float32", param_dtype="float32")
    mesh = make_device_mesh(MeshShape(("data", "model"), (1, 1)), device="cpu")
    model = p_models.Model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    pre = p_steps.build_prefill_step(cfg, ShapeSpec("p", "prefill", 20, 2), mesh)
    logits, cache = p_steps.run_built(pre, mesh, params, {"tokens": tokens})
    want, want_cache = model.prefill(params, {"tokens": tokens}, 20)
    assert float((logits.full_tensor() - want).abs().max()) <= 1e-4
    if kind == "decode":
        nxt = torch.argmax(want, -1)[:, None].to(torch.int32)
        dec = p_steps.build_decode_step(cfg, ShapeSpec("d", "decode", 20, 2), mesh)
        logits, cache = p_steps.run_built(dec, mesh, params, cache, nxt)
        want, _ = model.decode_step(params, want_cache, nxt)
        assert float((logits.full_tensor() - want).abs().max()) <= 1e-4


@pytest.mark.parametrize(
    "build,item",
    [
        (_whisper_decode_builds, 16),
        (_local_mode_is_sync, 16),
        (_prod_mesh_asks_for_its_ranks, 16),
        (_outer_sync_builds_on_pods, 16),
        (lambda: _serving_step_runs("prefill", "zamba2-7b"), 16),
        (lambda: _serving_step_runs("decode", "rwkv6-1.6b"), 16),
    ],
    ids=["step-builder", "local-train-step", "train-prod-mesh", "outer-sync",
         "prefill-step", "decode-step"],
)
def test_configs_outside_the_slice_raise(build, item):
    """Item 16's sharded steps, raise cases until they were ported: each is
    now its behaviour (a whisper decode step built for ``decode_32k``,
    ``mode="local"`` as ``sync``, the production mesh asking for its 256
    ranks, the outer sync on a pod mesh, Zamba2's sharded prefill and
    RWKV6's sharded decode equal to the model's own)."""
    assert item == 16
    build()
