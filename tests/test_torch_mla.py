"""Port parity for MLA (multi-head latent attention) and DeepSeek-V2 on the
CPU: the config, ``mla_forward``'s naive prefill and its absorbed decode,
and reduced DeepSeek-V2 (a dense layer 0, then MoE layers with a shared
expert) through ``lm_loss``, prefill / decode, one train step and remat,
held against ``repro`` on seeded numpy inputs. The reference's params are
carried across by ``repro_torch.convert``; torch runs on one thread
(``one_torch_thread``).

Tolerances, each from the arithmetic it covers:
- the MLA block's prefill output and cache within 1e-5 in f32 (products of
  d = 64 summed in another order);
- the absorbed decode against the naive forward within 1e-4, the bound of
  ``tests/test_attention.py::test_mla_absorbed_decode_matches_naive``;
- the loss and the router's aux loss within 1e-4, logits within 1e-4 in
  f32 and 3e-2 of max |logit| in bf16 (``tests/test_torch_lm.py``'s
  bounds), decode == prefill within 2e-2 (``tests/test_models.py``'s);
- a train step's loss and grad norm within 1e-4 of their size, the params
  within 0.05 of the learning rate (``tests/test_torch_trainer.py``'s);
  gradients within 1e-4 of each leaf's max |grad|."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import TrainConfig as RTrainConfig
from repro.configs import get_config as r_get_config
from repro.configs import get_reduced as r_get_reduced
from repro.configs.base import ShapeSpec
from repro.data.tokens import token_batch_for
from repro.launch.mesh import make_host_mesh, mesh_context
from repro.launch.steps import build_train_step as r_build_train_step
from repro.launch.steps import make_optimizer as r_make_optimizer
from repro.models import Model as RModel
from repro.models import attention as r_attn
from repro.models.base import Ctx as RCtx
from repro_torch import configs as p_configs
from repro_torch.configs import TrainConfig
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import swiglu as sw
from repro_torch.launch import steps as p_steps
from repro_torch.models import Model
from repro_torch.models import attention as p_attn
from repro_torch.utils import tree_leaves, tree_map

from _torch_parity import max_abs_diff, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "deepseek-v2-236b"
F32 = dict(dtype="float32", param_dtype="float32")
BLOCK_TOL = 1e-5
DECODE_TOL = 1e-4
LOSS_TOL = 1e-4
LOGIT_TOL = 1e-4
BF16_LOGIT_RTOL = 3e-2
DECODE_PREFILL_TOL = 2e-2
STEP_RTOL = 1e-4
PARAM_STEP_ATOL = 0.05  # of the learning rate, per step
GRAD_RTOL = 1e-4


def _cfgs(dtype="float32", **moe):
    """Reduced DeepSeek-V2 of both packages (3 layers, d 64, 4 heads, MLA
    ranks 48 / 32, qk 16 + 8 rope, v 16; 8 experts top-2 with one shared,
    layer 0 dense), with MoE fields replaced by ``moe``."""
    kw = dict(dtype=dtype, param_dtype=dtype)
    r, p = r_get_reduced(ARCH).replace(**kw), p_configs.get_reduced(ARCH).replace(**kw)
    return (r.replace(moe=dataclasses.replace(r.moe, **moe)),
            p.replace(moe=dataclasses.replace(p.moe, **moe)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ref_lm(dtype: str):
    return jax.jit(RModel(_cfgs(dtype)[0]).init)(jax.random.PRNGKey(0))


def _carried(dtype="float32"):
    rp = _ref_lm(dtype)
    return rp, params_from_numpy(_np(rp), "cpu")


@functools.lru_cache(maxsize=None)
def _ref_block():
    rcfg, _ = _cfgs()
    return r_attn.mla_params(RCtx("init", jax.random.PRNGKey(1), jnp.float32), rcfg)


def test_config_is_the_reference_config():
    """Both configs equal the reference's, and so do ``param_count``s. That
    count takes layer 0 as a MoE layer: the tree holds a dense SwiGLU of
    ``dense_d_ff`` there instead (and the routers and norms, which the
    count leaves out)."""
    for r_get, p_get in ((r_get_config, p_configs.get_config),
                         (r_get_reduced, p_configs.get_reduced)):
        assert dataclasses.asdict(r_get(ARCH)) == dataclasses.asdict(p_get(ARCH))
    full, ref = p_configs.get_config(ARCH), r_get_config(ARCH)
    assert full.param_count() == ref.param_count() == 239_325_675_520
    assert full.param_count(active_only=True) == ref.param_count(active_only=True)
    m, d, L = full.moe, full.d_model, full.n_layers
    tree = sum(t.numel() for t in tree_leaves(Model(full).abstract_params()))
    norms = L * (2 * d + full.mla.q_lora_rank + full.mla.kv_lora_rank) + d
    assert tree == (full.param_count() - 3 * d * m.expert_d_ff * (m.num_experts + m.num_shared)
                    + 3 * d * m.dense_d_ff + (L - 1) * d * m.num_experts + norms)
    assert tree == 235_741_434_880


def test_mla_prefill_matches():
    """The naive form (flash at D = 24, Dv = 16 here) and the cache it
    fills: the normed c_kv and the roped k_pe."""
    rcfg, pcfg = _cfgs()
    rp = _ref_block()
    pp = params_from_numpy(_np(rp), "cpu")
    x = _x((2, 12, pcfg.d_model), 2)
    r_cache = jax.tree.map(lambda a: a[0], r_attn.mla_cache_init(rcfg, 2, 20, 1))
    p_cache = tree_map(lambda a: a[0], p_attn.mla_cache_init(pcfg, 2, 20, 1))
    r_out, r_new = r_attn.mla_forward(rcfg, rp, jnp.asarray(x), cache=r_cache)
    p_out, p_new = p_attn.mla_forward(pcfg, pp, torch.from_numpy(x), cache=p_cache)
    assert p_new is p_cache and p_out.shape == (2, 12, pcfg.d_model)
    assert max_abs_diff(r_out, p_out) < BLOCK_TOL
    for key in ("c_kv", "k_pe"):
        assert max_abs_diff(r_new[key], p_new[key]) < BLOCK_TOL
        assert float(torch.abs(p_new[key][:, 12:]).max()) == 0.0


def test_mla_absorbed_decode_matches_naive():
    """Prefill 4 positions, then 12 absorbed decode steps: each step's
    output against the naive forward over all 16 positions, and against the
    reference's decode stepped alike."""
    rcfg, pcfg = _cfgs()
    rp = _ref_block()
    pp = params_from_numpy(_np(rp), "cpu")
    x = _x((2, 16, pcfg.d_model), 3)
    naive, _ = p_attn.mla_forward(pcfg, pp, torch.from_numpy(x))
    r_cache = jax.tree.map(lambda a: a[0], r_attn.mla_cache_init(rcfg, 2, 32, 1))
    p_cache = tree_map(lambda a: a[0], p_attn.mla_cache_init(pcfg, 2, 32, 1))
    _, r_cache = r_attn.mla_forward(rcfg, rp, jnp.asarray(x[:, :4]), cache=r_cache)
    p_attn.mla_forward(pcfg, pp, torch.from_numpy(x[:, :4]), cache=p_cache)
    r_cache = dict(r_cache, pos=jnp.full((2,), 4, jnp.int32))
    p_cache["pos"] = torch.full((2,), 4, dtype=torch.int32)
    r_step = jax.jit(functools.partial(r_attn.mla_forward, rcfg, decode=True))
    for t in range(4, 16):
        r_out, r_cache = r_step(rp, jnp.asarray(x[:, t:t + 1]), cache=r_cache)
        p_out, p_cache = p_attn.mla_forward(pcfg, pp, torch.from_numpy(x[:, t:t + 1]),
                                            cache=p_cache, decode=True)
        assert p_out.shape == (2, 1, pcfg.d_model)
        assert max_abs_diff(naive[:, t:t + 1], p_out) < DECODE_TOL
        assert max_abs_diff(r_out, p_out) < DECODE_TOL
    assert p_cache["pos"].tolist() == [16, 16]
    assert max_abs_diff(r_cache["c_kv"], p_cache["c_kv"]) < DECODE_TOL


def test_loss_and_aux_match():
    rcfg, pcfg = _cfgs(impl="gather")
    rp, pp = _carried()
    b = token_batch_for(rcfg, batch=2, seq=16, seed=3)
    rl, rm = jax.jit(RModel(rcfg).loss)(rp, {k: jnp.asarray(v) for k, v in b.items()})
    pl, pm = Model(pcfg).loss(pp, {k: torch.as_tensor(v) for k, v in b.items()})
    assert sorted(pm) == sorted(rm) == ["accuracy", "aux", "loss"]
    assert float(pm["aux"]) > 0
    assert abs(float(rm["aux"]) - float(pm["aux"])) < LOSS_TOL
    assert abs(float(rl) - float(pl)) < LOSS_TOL


def _serve_steps(dtype, n_decode=3, **moe):
    """Prefill a seeded batch and decode ``n_decode`` greedy steps in both
    packages; the port is fed the reference's tokens."""
    rcfg, pcfg = _cfgs(dtype, **moe)
    rp, pp = _carried(dtype)
    rm, pm = RModel(rcfg), Model(pcfg)
    r_prefill = jax.jit(lambda p, b: rm.prefill(p, b, 24))
    r_decode = jax.jit(rm.decode_step)
    toks = np.random.default_rng(9).integers(0, pcfg.vocab_size, (2, 9)).astype(np.int32)
    rl, rc = r_prefill(rp, {"tokens": jnp.asarray(toks)})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, 24)
    logits = [(rl, pl)]
    for _ in range(n_decode):
        cur = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
        rl, rc = r_decode(rp, rc, jnp.asarray(cur))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(cur))
        logits.append((rl, pl))
    return logits, (rc, pc)


def test_prefill_and_decode_match_in_f32():
    logits, (rc, pc) = _serve_steps("float32", impl="gather")
    for r, p in logits:
        assert p.dtype == torch.float32 and p.shape == (2, 512)
        assert max_abs_diff(r, p) < LOGIT_TOL
    assert sorted(pc) == ["seg0", "seg1"]  # the dense layer 0, then the MoE layers
    assert sorted(pc["seg1"]) == ["c_kv", "k_pe", "pos"]
    assert tuple(pc["seg1"]["c_kv"].shape) == (2, 2, 24, 32)
    assert max_abs_diff(rc, pc) < LOGIT_TOL


def test_prefill_and_decode_match_in_bf16():
    logits, _ = _serve_steps("bfloat16", n_decode=2, impl="gather")
    for r, p in logits:
        assert p.dtype == torch.float32
        assert max_abs_diff(r, p) <= BF16_LOGIT_RTOL * float(np.max(np.abs(np.asarray(r))))


def test_decode_matches_prefill_at_drop_free_capacity():
    """prefill(S-1) + decode(1 token) == prefill(S)'s last logits
    (capacity 16: no token dropped in either call), the absorbed decode
    against the naive prefill through the whole model."""
    _, pcfg = _cfgs(capacity_factor=16.0)
    _, pp = _carried()
    model = Model(pcfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, pcfg.vocab_size, (2, 16))
                            .astype(np.int32))
    full, _ = model.prefill(pp, {"tokens": toks}, 32)
    short, cache = model.prefill(pp, {"tokens": toks[:, :15]}, 32)
    step, _ = model.decode_step(pp, cache, toks[:, 15:])
    assert max_abs_diff(full, step) < DECODE_PREFILL_TOL
    assert max_abs_diff(full, step) < LOGIT_TOL


def test_train_step_matches_reference():
    """One Adafactor step of the port's train step and the reference's (jit
    on the host mesh) from the same params; ``gather`` dispatch in both."""
    rcfg, pcfg = _cfgs(impl="gather")
    kw = dict(optimizer="adafactor", learning_rate=2e-3, total_steps=4, warmup_steps=1)
    B, S = 2, 16
    mesh = make_host_mesh()
    built = r_build_train_step(rcfg, RTrainConfig(**kw), ShapeSpec("t", "train", S, B), mesh)
    rp, pp = _carried()
    rp = jax.tree.map(jnp.array, rp)  # a copy: the step donates its state
    r_state = {"params": rp, "opt": r_make_optimizer(RTrainConfig(**kw)).init(rp),
               "step": jnp.int32(0)}
    tcfg = TrainConfig(**kw)
    p_state = {"params": pp, "opt": p_steps.make_optimizer(tcfg).init(pp),
               "step": torch.zeros((), dtype=torch.int32)}
    batch = token_batch_for(rcfg, batch=B, seq=S, seed=0)
    with mesh_context(mesh):
        r_fn = jax.jit(built.fn, in_shardings=built.in_shardings, out_shardings=built.out_shardings)
        r_state, r_m = r_fn(r_state, {k: jnp.asarray(v) for k, v in batch.items()})
    p_state, p_m = p_steps.build_train_step(pcfg, tcfg)(
        p_state, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert sorted(p_m) == sorted(r_m) == ["accuracy", "aux", "grad_norm", "loss"]
    for k in ("loss", "aux", "grad_norm"):
        assert abs(float(r_m[k]) - float(p_m[k])) <= STEP_RTOL * abs(float(r_m[k])), k
    gap = max(float(np.max(np.abs(a - b.detach().numpy()))) for a, b in
              zip(jax.tree.leaves(_np(r_state["params"])), tree_leaves(p_state["params"])))
    assert gap <= PARAM_STEP_ATOL * kw["learning_rate"]


# remat: per layer and training step, (flash, swiglu) calls; swiglu runs in
# the dense layer 0 only
CALLS = {"none": (1, 1), "block": (2, 1), "full": (2, 2)}
# the 2-D products that "full" runs again per block: MLA's w_dq, w_uq, w_dkv,
# w_uk, w_uv and wo; in a MoE block also the router and the shared expert's
# gate and up. Its down projection is the block's last product, and nothing
# the backward needs comes after it, so the recompute (non-reentrant
# checkpointing stops once every saved tensor is rebuilt) ends before it
DENSE_MMS, MOE_MMS = 6, 9


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _port_grads(remat, monkeypatch):
    """The port's gradients at ``remat``, the kernels' calls in the forward
    and backward, and the backward's matrix products."""
    _, pcfg = _cfgs(impl="gather")
    pcfg = pcfg.replace(remat=remat)
    calls = {"flash": 0, "swiglu": 0}

    def counting(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(fa, "flash_attention_bhsd", counting("flash", fa.flash_attention_bhsd))
    monkeypatch.setattr(sw, "swiglu_fused", counting("swiglu", sw.swiglu_fused))
    params = tree_map(lambda t: t.requires_grad_(True), _carried()[1])
    b = token_batch_for(pcfg, batch=2, seq=16, seed=3)
    loss, _ = Model(pcfg).loss(params, {k: torch.as_tensor(v) for k, v in b.items()})
    with _CountMM() as mm:
        grads = torch.autograd.grad(loss, tree_leaves(params))
    monkeypatch.undo()
    return b, grads, calls, mm.n


def test_remat_saves_what_the_reference_saves(monkeypatch):
    """Gradients at remat "block" (the config's) against ``jax.grad`` of the
    reference's loss, "none" and "full" against "block"; the kernels' calls
    per layer; the backward's 2-D products: "block" runs exactly "none"'s,
    "full" those and every block's forward products once more."""
    rcfg, pcfg = _cfgs(impl="gather")
    runs = {remat: _port_grads(remat, monkeypatch) for remat in ("none", "block", "full")}
    b, got, _, _ = runs["block"]
    want = jax.jit(jax.grad(lambda p, b: RModel(rcfg).loss(p, b)[0]))(
        _ref_lm("float32"), {k: jnp.asarray(v) for k, v in b.items()})
    want = jax.tree.leaves(want)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert max_abs_diff(w, g) <= GRAD_RTOL * float(np.max(np.abs(np.asarray(w))))
    for remat in ("none", "full"):
        for w, g in zip(want, runs[remat][1]):
            assert max_abs_diff(w, g) <= GRAD_RTOL * float(np.max(np.abs(np.asarray(w))))
    L, dense = pcfg.n_layers, pcfg.moe.first_k_dense
    for remat, (flash, swiglu) in CALLS.items():
        assert runs[remat][2] == {"flash": flash * L, "swiglu": swiglu * dense}, remat
    mms = {remat: run[3] for remat, run in runs.items()}
    assert mms["block"] == mms["none"]
    assert mms["full"] == mms["none"] + DENSE_MMS * dense + MOE_MMS * (L - dense)
