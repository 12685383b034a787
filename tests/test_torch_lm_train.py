"""Port parity for LM training on the CPU: the dense configs, LayerNorm,
the loss and its gradients, the flash-attention and SwiGLU autograd
ops, AdamW / Adafactor, the schedules and the token stream, held
against ``repro`` on seeded numpy inputs at the reduced configs in f32.
The reference's params are carried across by ``repro_torch.convert``.

Tolerances, each from the arithmetic it covers:
- ``F32_TOL`` 1e-4 absolute for f32 activations and logits (a few layers
  of f32 sums taken in another order);
- loss and accuracy within 1e-5 (one f32 mean of O(1) values);
- gradients per leaf within 1e-4 of the leaf's max |grad|;
- optimizer updates within 1e-6 of the leaf's max |update| (the same f32
  expressions; the reductions and ``pow`` / ``cos`` may differ in the last
  bit);
- the learning rates within 4 ulp of f32 (XLA's and numpy's f32 cosines
  differ in the last bit, and 1 + cos loses bits to cancellation late in
  the decay: 2 ulp measured at one step of 40);
- the token stream bit for bit (numpy on both sides)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro.configs import get_config as r_get_config
from repro.configs import get_reduced as r_get_reduced
from repro.data.tokens import token_batch_for as r_token_batch_for
from repro.models import Model as RModel
from repro.models import attention as r_attn
from repro.models import base as r_base
from repro.models import mlp as r_mlp
from repro_torch import configs as p_configs
from repro_torch import optim as p_optim
from repro_torch.convert import params_from_numpy
from repro_torch.data.tokens import token_batch_for as p_token_batch_for
from repro_torch.kernels import ops
from repro_torch.models import Model
from repro_torch.models import base as p_base
from repro_torch.models.base import Ctx
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

from _torch_parity import one_torch_thread, max_abs_diff, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
UPDATE_RTOL = 1e-6
DENSE_ARCHS = ["qwen3-8b", "starcoder2-3b", "phi3-medium-14b", "minitron-8b"]
F32 = dict(dtype="float32", param_dtype="float32")


def _cfgs(arch, **kw):
    kw = dict(F32, **kw)
    return r_get_reduced(arch).replace(**kw), p_configs.get_reduced(arch).replace(**kw)


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    """The reference's f32 params for ``arch`` (threefry init), drawn once."""
    return jax.jit(RModel(_cfgs(arch)[0]).init)(jax.random.PRNGKey(0))


def _carried(arch):
    rp = _ref_params(arch)
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _batch(cfg, B=2, S=16, seed=3):
    b = r_token_batch_for(cfg, batch=B, seq=S, seed=seed)
    return {k: jnp.asarray(v) for k, v in b.items()}, {k: torch.as_tensor(v) for k, v in b.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _max_rel_leaf_gap(want, got) -> float:
    """Largest per-leaf max |want - got| over that leaf's max |want|."""
    w, g = jax.tree.leaves(to_np(want)), jax.tree.leaves(to_np(got))
    assert len(w) == len(g)
    return max(float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)) for a, b in zip(w, g))


def _port_grads(loss_fn, params):
    ps = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(ps)
    return loss, metrics, tree_unflatten(ps, torch.autograd.grad(loss, tree_leaves(ps)))


# ---------------------------------------------------------------------------
# configs, norms, init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE_ARCHS + ["paper-mnist-cnn"])
def test_configs_are_the_reference_configs(arch):
    for r_get, p_get in ((r_get_config, p_configs.get_config), (r_get_reduced, p_configs.get_reduced)):
        assert dataclasses.asdict(r_get(arch)) == dataclasses.asdict(p_get(arch))
    assert p_configs.get_config(arch).param_count() == r_get_config(arch).param_count()


def test_train_config_is_the_reference_train_config():
    from repro.configs import TrainConfig as RTrainConfig

    assert dataclasses.asdict(RTrainConfig()) == dataclasses.asdict(p_configs.TrainConfig())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches(dtype):
    x = 3.0 + 2.0 * _x((2, 5, 96), seed=1)
    w, b = 1.0 + 0.1 * _x((96,), seed=2), 0.1 * _x((96,), seed=3)
    rx, px = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    got = p_base.layer_norm(px, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    want = r_base.layer_norm(rx, jnp.asarray(w), jnp.asarray(b), 1e-5)
    assert got.dtype == px.dtype
    # bf16: both round the f32 result once (<= 1 bf16 ulp of values ~4)
    assert max_abs_diff(want.astype(jnp.float32), got.float()) < (F32_TOL if dtype == "float32" else 3e-2)


def test_init_uniform_and_abstract_params():
    """``uniform`` draws in [-scale, scale); the abstract params have the
    reference's shapes and dtypes without storage; a LayerNorm model's
    norms carry a zero bias."""
    ctx = Ctx(torch.Generator().manual_seed(0), torch.float32)
    u = ctx.param((4096,), ("embed",), init="uniform", scale=0.5)
    assert float(u.min()) >= -0.5 and float(u.max()) < 0.5 and abs(float(u.mean())) < 0.02
    rcfg, pcfg = _cfgs("starcoder2-3b")
    ref = jax.eval_shape(lambda: RModel(rcfg).init(jax.random.PRNGKey(0)))
    got = Model(pcfg).abstract_params()
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert [l.shape for l in jax.tree.leaves(ref)] == [tuple(t.shape) for t in tree_leaves(got)]
    p = Model(pcfg).init(torch.Generator().manual_seed(0))
    assert torch.equal(p["seg0"]["ln1"]["bias"], torch.zeros_like(p["seg0"]["ln1"]["bias"]))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_logits_match(arch):
    rcfg, pcfg = _cfgs(arch)
    rp, pp = _carried(arch)
    toks = np.random.default_rng(9).integers(0, pcfg.vocab_size, (2, 9)).astype(np.int32)
    rl, _ = jax.jit(lambda p, b: RModel(rcfg).prefill(p, b, 16))(rp, {"tokens": jnp.asarray(toks)})
    pl, _ = Model(pcfg).prefill(pp, {"tokens": torch.from_numpy(toks)}, 16)
    assert max_abs_diff(rl, pl) < F32_TOL


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [0, 8], ids=["unchunked", "chunked"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "starcoder2-3b"])
def test_lm_loss_matches(arch, chunk):
    """chunk 8 over 32 targets takes the chunked-vocab path (4 chunks)."""
    rcfg, pcfg = _cfgs(arch, loss_chunk=chunk)
    rp, pp = _carried(arch)
    rb, pb = _batch(rcfg, S=32)
    pb["loss_mask"][1, :5] = 0.0
    rb["loss_mask"] = rb["loss_mask"].at[1, :5].set(0.0)
    rl, rm = jax.jit(RModel(rcfg).loss)(rp, rb)
    pl, pm = Model(pcfg).loss(pp, pb)
    assert sorted(pm) == sorted(rm) == ["accuracy", "aux", "loss"]
    assert abs(float(rl) - float(pl)) < LOSS_TOL
    assert abs(float(rm["accuracy"]) - float(pm["accuracy"])) < LOSS_TOL
    assert float(pm["aux"]) == float(rm["aux"]) == 0.0


@pytest.mark.parametrize("arch,remat", [("qwen3-8b", "block"), ("qwen3-8b", "none"),
                                        ("starcoder2-3b", "block"), ("minitron-8b", "block")])
def test_lm_loss_gradients_match_jax_grad(arch, remat):
    """Per leaf within GRAD_RTOL of the leaf's max |grad|; with remat the
    port checkpoints each block, which must not change a value."""
    rcfg, pcfg = _cfgs(arch, remat=remat)
    rp, pp = _carried(arch)
    rb, pb = _batch(rcfg)
    model = RModel(rcfg)
    want = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))(rp, rb)
    loss, _, got = _port_grads(lambda ps: Model(pcfg).loss(ps, pb), pp)
    assert _max_rel_leaf_gap(want, got) < GRAD_RTOL


@pytest.mark.parametrize(
    "B,S,Hq,Hkv,D,window", [(2, 24, 4, 2, 32, 0), (1, 40, 6, 2, 16, 0), (2, 33, 4, 4, 32, 8),
                            (1, 17, 8, 1, 64, 5)],
    ids=["gqa", "gqa3", "window", "mqa_window"])
def test_flash_attention_backward_matches_jax_grad(B, S, Hq, Hkv, D, window):
    q, k, v = _x((B, S, Hq, D), 1), _x((B, S, Hkv, D), 2), _x((B, S, Hkv, D), 3)
    cot = _x((B, S, Hq, D), 4)

    def ref(q, k, v):
        return jnp.sum(r_attn.full_attention(q, k, v, causal=True, window=window) * cot)

    want = jax.grad(ref, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    pq, pk, pv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = ops.flash_attention(pq, pk, pv, causal=True, window=window)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), (pq, pk, pv))
    for w, g in zip(want, got):
        assert max_abs_diff(w, g) < GRAD_RTOL * float(jnp.max(jnp.abs(w)))


@pytest.mark.parametrize("M,d,F", [(16, 64, 96), (7, 128, 256)])
def test_swiglu_backward_matches_jax_grad(M, d, F):
    rcfg, _ = _cfgs("qwen3-8b")
    rcfg = rcfg.replace(d_model=d)
    w = {"w_gate": _x((d, F), 5) * d ** -0.5, "w_up": _x((d, F), 6) * d ** -0.5,
         "w_down": _x((F, d), 7) * F ** -0.5}
    x, cot = _x((2, M, d), 8), _x((2, M, d), 9)

    def ref(x, w):
        return jnp.sum(r_mlp.mlp_forward(rcfg, w, x) * cot)

    want_x, want_w = jax.grad(ref, argnums=(0, 1))(jnp.asarray(x), jax.tree.map(jnp.asarray, w))
    px = torch.from_numpy(x).requires_grad_(True)
    pw = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    out = ops.swiglu(px, pw["w_gate"], pw["w_up"], pw["w_down"])
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot)), [px] + [pw[k] for k in w])
    for want, g in zip([want_x] + [want_w[k] for k in w], got):
        assert max_abs_diff(want, g) < GRAD_RTOL * float(jnp.max(jnp.abs(want)))


def test_autograd_functions_launch_nothing_on_the_cpu():
    """On CPU tensors the autograd ops run the plain versions forward and the
    plain backward: no kernel launch and no counted backward pass."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import swiglu as sw

    before = (fa.launches, fa.backward_calls, sw.launches, sw.backward_calls)
    q = torch.randn(4, 8, 32, requires_grad=True)
    fa.flash_attention_grad(q, torch.randn(2, 8, 32), torch.randn(2, 8, 32)).sum().backward()
    x = torch.randn(3, 16, requires_grad=True)
    sw.swiglu_grad(x, torch.randn(16, 32), torch.randn(16, 32), torch.randn(32, 16)).sum().backward()
    assert q.grad is not None and x.grad is not None
    assert (fa.launches, fa.backward_calls, sw.launches, sw.backward_calls) == before


# ---------------------------------------------------------------------------
# optimizers and schedules
# ---------------------------------------------------------------------------


def _opt_tree(seed):
    return {"a": {"w": _x((6, 10), seed), "v": _x((10,), seed + 1)}, "b": _x((3, 4, 5), seed + 2)}


OPTIMIZERS = {
    "adamw": (lambda m: m.adamw(m.cosine_warmup(3e-3, 2, 6)), torch.float32),
    "adamw_wd0": (lambda m: m.adamw(1e-2, b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.0), torch.float32),
    "adafactor": (lambda m: m.adafactor(m.cosine_warmup(3e-2, 2, 6)), torch.float32),
    "adafactor_const": (lambda m: m.adafactor(1e-2, decay=0.5, clip_threshold=0.5), torch.float32),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match(name):
    """Four steps of each optimizer on the same params and gradients; the
    updates and the state within UPDATE_RTOL of their leaf's max."""
    make, _ = OPTIMIZERS[name]
    r_opt, p_opt = make(r_optim), make(p_optim)
    params = _opt_tree(0)
    rp, pp = jax.tree.map(jnp.asarray, params), tree_map(torch.from_numpy, params)
    rs, ps = r_opt.init(rp), p_opt.init(pp)
    assert jax.tree.structure(rs) == jax.tree.structure(to_np(ps))
    for step in range(4):
        grads = _opt_tree(10 + step)
        ru, rs = r_opt.update(jax.tree.map(jnp.asarray, grads), rs, rp, jnp.int32(step))
        pu, ps = p_opt.update(tree_map(torch.from_numpy, grads), ps, pp, step)
        assert _max_rel_leaf_gap(ru, pu) < UPDATE_RTOL
        assert _max_rel_leaf_gap(rs, ps) < UPDATE_RTOL
        rp, pp = r_optim.apply_updates(rp, ru), p_optim.apply_updates(pp, pu)


def test_adamw_bf16_state_with_master_matches():
    """bf16 params with bf16 moments and an f32 master copy (the reference's
    setting for the huge configs): the master copy within UPDATE_RTOL, the
    bf16 params within one bf16 ulp of the reference's."""
    params = _opt_tree(0)
    r_opt = r_optim.adamw(1e-2, state_dtype=jnp.bfloat16, master_dtype=jnp.float32)
    p_opt = p_optim.adamw(1e-2, state_dtype=torch.bfloat16, master_dtype=torch.float32)
    rp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    pp = tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), params)
    rs, ps = r_opt.init(rp), p_opt.init(pp)
    for step in range(3):
        grads = _opt_tree(10 + step)
        ru, rs = r_opt.update(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), grads), rs, rp,
                              jnp.int32(step))
        pu, ps = p_opt.update(tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), grads),
                              ps, pp, step)
        rp, pp = r_optim.apply_updates(rp, ru), p_optim.apply_updates(pp, pu)
    assert _max_rel_leaf_gap(rs["master"], ps["master"]) < UPDATE_RTOL
    for a, b in zip(jax.tree.leaves(rp), tree_leaves(pp)):
        a = np.asarray(a.astype(jnp.float32))
        assert np.max(np.abs(a - b.float().numpy())) <= 2.0 ** -7 * np.max(np.abs(a))


@pytest.mark.parametrize("make", [
    lambda m: m.cosine_warmup(3e-4, 10, 100), lambda m: m.cosine_warmup(2e-3, 1, 8, final_frac=0.0),
    lambda m: m.linear_warmup(1e-3, 7), lambda m: m.constant(0.05)],
    ids=["cosine_warmup", "cosine_short", "linear_warmup", "constant"])
def test_schedules_match(make):
    r_fn, p_fn = make(r_optim), make(p_optim)
    for step in range(0, 120, 3):
        want = np.float32(r_fn(jnp.int32(step)))
        got = p_fn(step)
        assert isinstance(got, float)
        assert abs(float(want) - got) <= 4 * float(np.spacing(want))


@pytest.mark.parametrize("arch,seed,client_id", [("qwen3-8b", 0, 0), ("starcoder2-3b", 5, 3),
                                                 ("minitron-8b", 123, 10_000)])
def test_token_batch_for_bit_for_bit(arch, seed, client_id):
    cfg = r_get_reduced(arch)
    want = r_token_batch_for(cfg, batch=3, seq=21, seed=seed, client_id=client_id)
    got = p_token_batch_for(p_configs.get_reduced(arch), batch=3, seq=21, seed=seed,
                            client_id=client_id)
    assert sorted(want) == sorted(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k])
