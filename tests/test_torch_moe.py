"""Port parity for the mixture of experts and Mixtral on the CPU: the
config, the router, both dispatch paths (``gather`` and ``einsum``) with
their gradients, and reduced Mixtral's prefill / decode, ``Server.run``,
``lm_loss`` with the router's aux loss and one train step, held against
``repro`` on seeded numpy inputs. The reference's params are carried across
by ``repro_torch.convert``; torch runs on one thread (``one_torch_thread``).

Tolerances, each from the arithmetic it covers:
- router ids equal, gates and aux within 1e-6 (f32 softmax and means);
- block outputs within 1e-5 in f32 (products of d = 128 summed in another
  order), their gradients within 1e-4 of each leaf's max |grad|;
- logits within 1e-4 in f32 and 3e-2 of max |logit| in bf16
  (``tests/test_torch_lm.py``'s bounds), the loss within 1e-5, a train
  step's loss and grad norm within 1e-4 of their size."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as RTrainConfig
from repro.configs import get_config as r_get_config
from repro.configs import get_reduced as r_get_reduced
from repro.configs.base import ShapeSpec
from repro.data.tokens import token_batch_for
from repro.launch.mesh import make_host_mesh, mesh_context
from repro.launch.serve import Request as RRequest
from repro.launch.serve import Server as RServer
from repro.launch.steps import build_train_step as r_build_train_step
from repro.launch.steps import make_optimizer as r_make_optimizer
from repro.models import Model as RModel
from repro.models import mlp as r_mlp
from repro.models.base import Ctx as RCtx
from repro_torch import configs as p_configs
from repro_torch.configs import TrainConfig
from repro_torch.convert import params_from_numpy
from repro_torch.launch import Request, Server
from repro_torch.launch import steps as p_steps
from repro_torch.launch.mesh import MeshShape, make_device_mesh
from repro_torch.models import Model
from repro_torch.models import mlp as p_mlp
from repro_torch.sharding.rules import full_tree

from _torch_parity import max_abs_diff, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROUTER_TOL = 1e-6
OUT_TOL = 1e-5
GRAD_RTOL = 1e-4
LOGIT_TOL = 1e-4
BF16_LOGIT_RTOL = 3e-2
LOSS_TOL = 1e-5
STEP_RTOL = 1e-4
IMPLS = ["gather", "einsum"]


def _cfgs(dtype="float32", **moe):
    """The reduced Mixtral config of both packages (E = 4, top-2, d_ff 64,
    capacity 1.5, window 32), with MoE fields replaced by ``moe``."""
    kw = dict(dtype=dtype, param_dtype=dtype)
    r, p = r_get_reduced("mixtral-8x7b").replace(**kw), p_configs.get_reduced("mixtral-8x7b")
    p = p.replace(**kw)
    return (r.replace(moe=dataclasses.replace(r.moe, **moe)),
            p.replace(moe=dataclasses.replace(p.moe, **moe)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ref_block(num_shared: int):
    """The reference's MoE block params (f32, threefry)."""
    rcfg, _ = _cfgs(num_shared=num_shared)
    return r_mlp.moe_params(RCtx("init", jax.random.PRNGKey(1), jnp.float32), rcfg)


@functools.lru_cache(maxsize=None)
def _ref_lm(dtype: str, seed: int = 0):
    """The reference's reduced Mixtral params, drawn once per dtype."""
    return jax.jit(RModel(_cfgs(dtype)[0]).init)(jax.random.PRNGKey(seed))


def _carried(dtype="float32"):
    rp = _ref_lm(dtype)
    return rp, params_from_numpy(_np(rp), "cpu")


def test_config_is_the_reference_config():
    for r_get, p_get in ((r_get_config, p_configs.get_config),
                         (r_get_reduced, p_configs.get_reduced)):
        assert dataclasses.asdict(r_get("mixtral-8x7b")) == dataclasses.asdict(p_get("mixtral-8x7b"))
    full, ref = p_configs.get_config("mixtral-8x7b"), r_get_config("mixtral-8x7b")
    assert full.param_count() == ref.param_count()
    assert full.param_count(active_only=True) == ref.param_count(active_only=True)
    # tests/test_models.py::test_moe_active_params: top-2 of 8 experts + attention
    assert full.param_count(active_only=True) < 0.45 * full.param_count()
    reduced = p_configs.get_reduced("mixtral-8x7b")
    assert reduced.param_count() == r_get_reduced("mixtral-8x7b").param_count()


@pytest.mark.parametrize("T,seed", [(32, 2), (7, 3), (1, 4)])
def test_router_matches(T, seed):
    rcfg, pcfg = _cfgs()
    rp = _ref_block(0)
    pp = params_from_numpy(_np(rp), "cpu")
    x = _x((T, pcfg.d_model), seed)
    r_gates, r_ids, r_aux = r_mlp._router(rcfg, rp, jnp.asarray(x))
    p_gates, p_ids, p_aux = p_mlp._router(pcfg, pp, torch.from_numpy(x))
    assert np.array_equal(np.asarray(r_ids), p_ids.numpy())
    assert max_abs_diff(r_gates, p_gates) < ROUTER_TOL
    assert abs(float(r_aux) - float(p_aux)) < ROUTER_TOL


def test_router_ties_take_the_lower_expert():
    """Equal probabilities (a zero router): top-k takes experts 0, 1 in
    that order, as ``jax.lax.top_k`` does."""
    rcfg, pcfg = _cfgs()
    rp = dict(_ref_block(0), router=jnp.zeros_like(_ref_block(0)["router"]))
    pp = params_from_numpy(_np(rp), "cpu")
    x = _x((5, pcfg.d_model), 5)
    _, r_ids, _ = r_mlp._router(rcfg, rp, jnp.asarray(x))
    _, p_ids, _ = p_mlp._router(pcfg, pp, torch.from_numpy(x))
    assert np.array_equal(np.asarray(r_ids), p_ids.numpy())
    assert p_ids.tolist() == [[0, 1]] * 5


# capacity 1.5 (the reduced config's), 0.5 (tokens dropped: C = T / 2 of
# 2T routed), and one shared expert (DeepSeek-V2's form)
CASES = [dict(), dict(capacity_factor=0.5), dict(num_shared=1)]
CASE_IDS = ["default", "drops", "shared"]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("moe", CASES, ids=CASE_IDS)
def test_moe_forward_matches(impl, moe):
    rcfg, pcfg = _cfgs(impl=impl, **moe)
    rp = _ref_block(moe.get("num_shared", 0))
    pp = params_from_numpy(_np(rp), "cpu")
    x = _x((2, 16, pcfg.d_model), 6)
    r_y, r_aux = jax.jit(functools.partial(r_mlp.moe_forward, rcfg))(rp, jnp.asarray(x))
    p_y, p_aux = p_mlp.moe_forward(pcfg, pp, torch.from_numpy(x))
    assert max_abs_diff(r_y, p_y) < OUT_TOL
    assert abs(float(r_aux) - float(p_aux)) < ROUTER_TOL
    if moe.get("capacity_factor") == 0.5:  # the case drops tokens in both packages
        T = 32
        C = p_mlp.capacity(pcfg, T)
        _, ids, _ = p_mlp._router(pcfg, pp, torch.from_numpy(x.reshape(T, -1)))
        assert C == 8 and int(torch.bincount(ids.reshape(-1), minlength=4).max()) > C


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("moe", CASES, ids=CASE_IDS)
def test_moe_gradients_match_jax_grad(impl, moe):
    rcfg, pcfg = _cfgs(impl=impl, **moe)
    rp = _ref_block(moe.get("num_shared", 0))
    x, cot = _x((2, 16, pcfg.d_model), 7), _x((2, 16, pcfg.d_model), 8)

    def ref(p, x):
        y, aux = r_mlp.moe_forward(rcfg, p, x)
        return jnp.sum(y * cot) + aux

    want_p, want_x = jax.jit(jax.grad(ref, argnums=(0, 1)))(rp, jnp.asarray(x))
    pp = {k: v.requires_grad_(True) for k, v in params_from_numpy(_np(rp), "cpu").items()
          if not isinstance(v, dict)}
    if "shared" in rp:
        pp["shared"] = {k: v.requires_grad_(True)
                        for k, v in params_from_numpy(_np(rp["shared"]), "cpu").items()}
    px = torch.from_numpy(x).requires_grad_(True)
    y, aux = p_mlp.moe_forward(pcfg, pp, px)
    leaves = [px] + [pp[k] for k in sorted(k for k in pp if k != "shared")]
    wants = [want_x] + [want_p[k] for k in sorted(k for k in pp if k != "shared")]
    if "shared" in pp:
        leaves += [pp["shared"][k] for k in sorted(pp["shared"])]
        wants += [want_p["shared"][k] for k in sorted(pp["shared"])]
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(cot)) + aux, leaves)
    for w, g in zip(wants, got):
        assert max_abs_diff(w, g) <= GRAD_RTOL * float(jnp.max(jnp.abs(w)))


def _serve_steps(dtype, impl, n_decode=3):
    """Prefill a seeded batch and decode ``n_decode`` greedy steps in both
    packages; the port is fed the reference's tokens. Returns the logits and
    each step's router ids from both (recorded through ``_router``)."""
    rcfg, pcfg = _cfgs(dtype, impl=impl)
    rp, pp = _carried(dtype)
    rm, pm = RModel(rcfg), Model(pcfg)
    r_prefill = jax.jit(lambda p, b: rm.prefill(p, b, 40))
    r_decode = jax.jit(rm.decode_step)
    toks = np.random.default_rng(9).integers(0, pcfg.vocab_size, (2, 9)).astype(np.int32)
    rl, rc = r_prefill(rp, {"tokens": jnp.asarray(toks)})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, 40)
    logits = [(rl, pl)]
    for _ in range(n_decode):
        cur = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
        rl, rc = r_decode(rp, rc, jnp.asarray(cur))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(cur))
        logits.append((rl, pl))
    return logits, (rc, pc)


@pytest.mark.parametrize("impl", IMPLS)
def test_mixtral_prefill_and_decode_match_in_f32(impl):
    logits, (rc, pc) = _serve_steps("float32", impl)
    for r, p in logits:
        assert p.dtype == torch.float32 and p.shape == (2, 512)
        assert max_abs_diff(r, p) < LOGIT_TOL
    # k, v, pos and the ring's kv_pos (40 > window 32: a ring of 32 slots)
    assert sorted(pc["seg0"]) == ["k", "kv_pos", "pos", "v"]
    assert pc["seg0"]["k"].shape[2] == 32
    assert max_abs_diff(rc, pc) < LOGIT_TOL


@pytest.mark.parametrize("impl", IMPLS)
def test_mixtral_prefill_and_decode_match_in_bf16(impl, record_property):
    """Within 3e-2 of max |logit|; the routes that bf16 flips between the
    packages are counted and recorded, not hidden."""
    rcfg, pcfg = _cfgs("bfloat16", impl=impl)
    flips = []
    r_router, p_router = r_mlp._router, p_mlp._router
    seen = {"ref": [], "port": []}

    def r_rec(cfg, p, x):
        out = r_router(cfg, p, x)
        jax.debug.callback(lambda ids: seen["ref"].append(np.asarray(ids)), out[1], ordered=True)
        return out

    def p_rec(cfg, p, x):
        out = p_router(cfg, p, x)
        seen["port"].append(out[1].numpy())
        return out

    r_mlp._router, p_mlp._router = r_rec, p_rec
    try:
        logits, _ = _serve_steps("bfloat16", impl, n_decode=2)
    finally:
        r_mlp._router, p_mlp._router = r_router, p_router
    assert len(seen["ref"]) == len(seen["port"]) == 3 * pcfg.n_layers
    for a, b in zip(seen["ref"], seen["port"]):
        flips.append(int(np.sum(a != b)))
    record_property("bf16_flipped_routes", sum(flips))
    for r, p in logits:
        assert p.dtype == torch.float32
        assert max_abs_diff(r, p) <= BF16_LOGIT_RTOL * float(np.max(np.abs(np.asarray(r))))


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_matches_prefill_at_drop_free_capacity(impl):
    """prefill(S-1) + decode(1 token) == prefill(S)'s last logits, as
    ``tests/test_models.py::test_decode_matches_prefill`` asks of the
    reference (capacity 16: no token dropped in either call)."""
    _, pcfg = _cfgs(impl=impl, capacity_factor=16.0)
    _, pp = _carried()
    model = Model(pcfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, pcfg.vocab_size, (2, 16))
                            .astype(np.int32))
    full, _ = model.prefill(pp, {"tokens": toks}, 32)
    short, cache = model.prefill(pp, {"tokens": toks[:, :15]}, 32)
    step, _ = model.decode_step(pp, cache, toks[:, 15:])
    assert max_abs_diff(full, step) < LOGIT_TOL


def _f32_servers(batch, max_len):
    ref = RServer("mixtral-8x7b", batch=batch, max_len=max_len)
    rcfg, pcfg = _cfgs()
    ref.cfg, ref.model = rcfg, RModel(rcfg)
    ref.params = _ref_lm("float32")
    ref._prefill = jax.jit(lambda p, b: ref.model.prefill(p, b, max_len))
    ref._decode = jax.jit(ref.model.decode_step)
    port = Server("mixtral-8x7b", batch=batch, max_len=max_len, device="cpu")
    port.cfg, port.model = pcfg, Model(pcfg)
    port._prefill = lambda p, b: port.model.prefill(p, b, max_len)
    port._decode = port.model.decode_step
    port.params = params_from_numpy(_np(ref.params), "cpu")
    return ref, port


def test_server_run_generates_the_reference_tokens_in_f32():
    """serve.py:main's traffic shape (8 prompts of 4-15 tokens, batch 4, 12
    new tokens) on reduced Mixtral: the same tokens; max_len 40 passes the
    window (32), so decode runs on the ring."""
    ref, port = _f32_servers(4, 40)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, size=rng.integers(4, 16)).astype(np.int32) for _ in range(8)]
    want = ref.run([RRequest(i, p, max_new=12) for i, p in enumerate(prompts)])
    got = port.run([Request(i, p, max_new=12) for i, p in enumerate(prompts)])
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 12 for r in got)


def test_server_cuts_depth_only_when_asked():
    assert Server("mixtral-8x7b", device="cpu").cfg.n_layers == 2
    server = Server("mixtral-8x7b", n_layers=1, device="cpu")
    assert server.cfg.n_layers == 1 and server.cfg.d_model == 128
    assert server.params["seg0"]["mlp"]["w_gate"].shape == (1, 4, 128, 64)


@pytest.mark.parametrize("impl", IMPLS)
def test_lm_loss_with_aux_matches(impl):
    rcfg, pcfg = _cfgs(impl=impl)
    rp, pp = _carried()
    b = token_batch_for(rcfg, batch=2, seq=16, seed=3)
    rl, rm = jax.jit(RModel(rcfg).loss)(rp, {k: jnp.asarray(v) for k, v in b.items()})
    pl, pm = Model(pcfg).loss(pp, {k: torch.as_tensor(v) for k, v in b.items()})
    assert sorted(pm) == sorted(rm) == ["accuracy", "aux", "loss"]
    assert float(pm["aux"]) > 0
    assert abs(float(rm["aux"]) - float(pm["aux"])) < ROUTER_TOL
    assert abs(float(rl) - float(pl)) < LOSS_TOL
    assert abs(float(rm["accuracy"]) - float(pm["accuracy"])) < LOSS_TOL


@pytest.mark.parametrize("impl", IMPLS + ["auto"])
def test_train_step_matches_reference(impl):
    """Two Adafactor steps of the port's train step and the reference's
    (jit on the host mesh) from the same params. ``impl`` names the
    dispatch in both. With ``auto`` the reference's step takes its
    expert-parallel ``ep_a2a`` path on the host mesh, and so does the
    port's built step on a 1 x 1 mesh (``models.moe_sharded``); the
    one-device step takes the named path."""
    rcfg, pcfg = _cfgs(impl=impl)
    kw = dict(optimizer="adafactor", learning_rate=2e-3, total_steps=4, warmup_steps=1)
    B, S = 2, 16
    mesh = make_host_mesh()
    built = r_build_train_step(rcfg, RTrainConfig(**kw), ShapeSpec("t", "train", S, B), mesh)
    rp, pp = _carried()
    r_state = {"params": rp, "opt": r_make_optimizer(RTrainConfig(**kw)).init(rp),
               "step": jnp.int32(0)}
    tcfg = TrainConfig(**kw)
    p_state = {"params": pp, "opt": p_steps.make_optimizer(tcfg).init(pp),
               "step": torch.zeros((), dtype=torch.int32)}
    if impl == "auto":
        p_mesh = make_device_mesh(MeshShape(("data", "model"), (1, 1)), device="cpu")
        p_built = p_steps.build_train_step(pcfg, tcfg, ShapeSpec("t", "train", S, B), p_mesh)

        def step_fn(state, batch):
            state, metrics = p_steps.run_built(p_built, p_mesh, state, batch)
            return full_tree(state), full_tree(metrics)
    else:
        step_fn = p_steps.build_train_step(pcfg, tcfg)
    with mesh_context(mesh):
        r_fn = jax.jit(built.fn, in_shardings=built.in_shardings, out_shardings=built.out_shardings)
        for i in range(2):
            batch = token_batch_for(rcfg, batch=B, seq=S, seed=i)
            r_state, r_m = r_fn(r_state, {k: jnp.asarray(v) for k, v in batch.items()})
            p_state, p_m = step_fn(p_state, {k: torch.as_tensor(v) for k, v in batch.items()})
            assert sorted(p_m) == sorted(r_m) == ["accuracy", "aux", "grad_norm", "loss"]
            for k in ("loss", "aux", "grad_norm"):
                assert abs(float(r_m[k]) - float(p_m[k])) <= STEP_RTOL * abs(float(r_m[k])), k
    gap = max(float(np.max(np.abs(a - b.numpy()))) for a, b in
              zip(jax.tree.leaves(_np(r_state["params"])), _leaves(p_state["params"])))
    assert gap <= 0.05 * kw["learning_rate"] * 2


def test_trainer_trains_mixtral_with_its_aux():
    """``train()`` on reduced Mixtral cut to one layer under Adafactor:
    finite losses and a positive router aux loss at every step."""
    from repro_torch.launch import train as p_train

    out = p_train.train("mixtral-8x7b", steps=3, batch=2, seq=16, n_layers=1,
                        optimizer="adafactor", device="cpu", log_every=100)
    assert len(out["losses"]) == len(out["aux"]) == 3
    assert all(np.isfinite(out["losses"])) and all(a > 0 for a in out["aux"])


def _leaves(tree):
    from repro_torch.utils import tree_leaves

    return [t.detach() for t in tree_leaves(tree)]
