"""Port parity for the Mamba2 / shared-attention hybrid (``zamba2-7b``) on
the CPU: the config, the params' tree, the loss, prefill and decode logits
and the cache (its layout that of the reference's ``hybrid_cache``),
decode against prefill, one train step, remat by super-block, the serving
driver, and the flash plain version at Zamba2's D = Dv = 112 (Mamba2's
gradients at the published 128-step chunk, C7, are in
``test_torch_ssm.py``). Held against ``repro`` on
the reduced config (7 layers: 2 super-blocks of 3 Mamba2 layers and the
shared block, then a 1-layer tail; d 128, 4 heads of 32, window 32, chunk
16) with the reference's params carried across by ``repro_torch.convert``;
torch on one thread (``one_torch_thread``).

Tolerances (``_torch_recurrent``): logits, caches and losses within 1e-4
in f32 and 3e-2 of max |logit| in bf16; a train step's loss and grad norm
within 1e-4 of their size, the params within 0.05 of the learning rate;
gradients within 1e-4 of each leaf's max |grad|; the flash plain version
within 1e-5 (f32 sums in another order)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import get_reduced as r_get_reduced
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.launch.serve import Request as RRequest
from repro.models import Model as RModel
from repro.models import hybrid as r_hybrid
from repro_torch import configs as p_configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import swiglu as sw
from repro_torch.launch import Request, Server
from repro_torch.launch import train as p_train
from repro_torch.models import Model
from repro_torch.utils import tree_leaves, tree_map

import _torch_recurrent as rec
from _torch_parity import max_abs_diff, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "zamba2-7b"
GRAD_RTOL = 1e-4
FLASH_TOL = 1e-5


def test_config_is_the_reference_config():
    """Both configs equal the reference's, ``param_count`` too; the tree
    holds 6,751,130,832 params (13.50 GB in bf16); the shared attention's
    heads are 3584 / 32 = 112 wide."""
    for r_get, p_get in ((r_get_config, p_configs.get_config),
                         (r_get_reduced, p_configs.get_reduced)):
        assert dataclasses.asdict(r_get(ARCH)) == dataclasses.asdict(p_get(ARCH))
    full = p_configs.get_config(ARCH)
    assert full.param_count() == r_get_config(ARCH).param_count()
    assert full.resolved_head_dim == 112
    ref_tree = jax.eval_shape(lambda: RModel(r_get_config(ARCH)).init(jax.random.PRNGKey(0)))
    port_tree = Model(full).abstract_params()
    assert rec.tree_layout(port_tree) == rec.tree_layout(ref_tree)
    assert sum(t.numel() for t in tree_leaves(port_tree)) == 6_751_130_832
    assert tuple(port_tree["mamba"]["body"]["w_in"].shape) == (78, 3584, 2 * 7168 + 128 + 112)
    assert tuple(port_tree["tail"]["body"]["w_in"].shape)[0] == 3


def test_init_draws_every_leaf_by_its_rule():
    _, pcfg = rec.cfgs(ARCH, "bfloat16")
    p = Model(pcfg).init(torch.Generator().manual_seed(0))
    body = p["mamba"]["body"]
    assert body["w_in"].dtype == torch.bfloat16
    assert abs(float(body["w_in"].float().std()) - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert float(body["a_log"].float().abs().max()) <= 1.0
    assert torch.equal(body["d_skip"], torch.ones_like(body["d_skip"]))
    assert float(body["conv_b"].float().abs().max()) == 0.0
    assert sorted(p["shared_attn"]) == ["attn", "ln1", "ln2", "mlp"]


@pytest.mark.parametrize("S", [32, 12], ids=["two_chunks", "one_chunk"])
def test_loss_matches(S):
    rcfg, pcfg = rec.cfgs(ARCH)
    rp, pp = rec.carried(ARCH)
    toks, tgts = (rec.tokens((2, S), pcfg.vocab_size, s) for s in (1, 2))
    rl, rm = jax.jit(RModel(rcfg).loss)(rp, {"tokens": jnp.asarray(toks),
                                             "targets": jnp.asarray(tgts)})
    pl, pm = Model(pcfg).loss(pp, {"tokens": torch.from_numpy(toks),
                                   "targets": torch.from_numpy(tgts)})
    assert sorted(pm) == ["accuracy", "aux", "loss"] and float(pm["aux"]) == 0.0
    assert abs(float(rl) - float(pl)) < rec.LOGIT_TOL
    assert abs(float(rm["accuracy"]) - float(pm["accuracy"])) < rec.LOGIT_TOL


@pytest.mark.parametrize("S", [16, 11])
def test_prefill_and_decode_match_in_f32(S):
    logits, (rc, pc) = rec.serve_steps(ARCH, "float32", S, 3)
    for r, p in logits:
        assert p.dtype == torch.float32 and p.shape == (2, 512)
        assert max_abs_diff(r, p) < rec.LOGIT_TOL
    assert pc["attn"]["pos"].tolist() == [[S + 3] * 2] * 2
    assert max_abs_diff(rc, pc) < rec.LOGIT_TOL


def test_prefill_and_decode_match_in_bf16():
    logits, _ = rec.serve_steps(ARCH, "bfloat16", 16, 2)
    for r, p in logits:
        assert p.dtype == torch.float32
        assert max_abs_diff(r, p) <= rec.BF16_LOGIT_RTOL * float(np.max(np.abs(np.asarray(r))))


@pytest.mark.parametrize("S", [16, 12])
def test_decode_matches_prefill(S):
    """prefill(S - 1) then one decode step == prefill(S)'s last logits:
    the Mamba2 decode step and the shared attention's ring against the
    chunked forward and the flash prefill."""
    full, step = rec.decode_against_prefill(ARCH, S)
    assert max_abs_diff(full, step) < rec.DECODE_PREFILL_TOL


@pytest.mark.parametrize("max_len", [40, 20])
def test_cache_layout_is_hybrid_caches(max_len):
    """mamba {ssm, conv} [n_super, every, ...], one GQA cache per shared
    block application (a ring of min(max_len, 32) slots with kv_pos -1),
    the tail's {ssm, conv} [tail, ...]: shapes and dtypes as the
    reference's ``hybrid_cache``, values as its concrete cache."""
    for dtype in ("float32", "bfloat16"):
        rcfg, pcfg = rec.cfgs(ARCH, dtype)
        want = r_hybrid.hybrid_cache(rcfg, 3, max_len)
        got = Model(pcfg).init_cache(3, max_len, device="cpu")
        assert rec.tree_layout(got) == rec.tree_layout(want)
        assert max_abs_diff(jax.tree.map(lambda a: a.astype(jnp.float32), want),
                            tree_map(lambda t: t.float(), got)) == 0.0
        assert tuple(got["attn"]["k"].shape) == (2, 3, min(max_len, 32), 4, 32)


def test_train_step_matches_reference():
    kw = dict(optimizer="adafactor", learning_rate=2e-3, total_steps=4, warmup_steps=1)
    r_m, p_m, gap = rec.train_step_metrics(ARCH, 2, 32, **kw)
    assert sorted(p_m) == ["accuracy", "aux", "grad_norm", "loss"]
    for k in ("loss", "grad_norm"):
        assert np.isfinite(float(p_m[k]))
        assert abs(float(r_m[k]) - float(p_m[k])) <= rec.STEP_RTOL * abs(float(r_m[k])), k
    assert gap <= rec.PARAM_STEP_ATOL * kw["learning_rate"]


def _batch(S, seed):
    return {"tokens": rec.tokens((2, S), 512, seed), "targets": rec.tokens((2, S), 512, seed + 1)}


@functools.lru_cache(maxsize=None)
def _ref_grads(chunk_len, S, seed):
    """``jax.grad`` of the reference's loss on ``_batch(S, seed)`` at a
    Mamba2 chunk of ``chunk_len``, once per arguments for the module."""
    rcfg, _ = rec.cfgs(ARCH)
    cfg = rcfg.replace(ssm=dataclasses.replace(rcfg.ssm, chunk_len=chunk_len))
    return jax.tree.leaves(jax.jit(jax.grad(lambda p, b: RModel(cfg).loss(p, b)[0]))(
        rec.ref_params(ARCH, "float32"), {k: jnp.asarray(v) for k, v in _batch(S, seed).items()}))


def _port_grads(pcfg, b, monkeypatch=None):
    """The port's gradients, and the (flash, swiglu) calls of the forward
    and backward when ``monkeypatch`` is given."""
    calls = {"flash": 0, "swiglu": 0}
    if monkeypatch is not None:
        def counting(name, fn):
            def call(*a, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            return call

        monkeypatch.setattr(fa, "flash_attention_bhsd", counting("flash", fa.flash_attention_bhsd))
        monkeypatch.setattr(sw, "swiglu_fused", counting("swiglu", sw.swiglu_fused))
    params = tree_map(lambda t: t.requires_grad_(True), rec.carried(ARCH)[1])
    loss, _ = Model(pcfg).loss(params, {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, tree_leaves(params))
    if monkeypatch is not None:
        monkeypatch.undo()
    return grads, calls


# remat: per super-block and training step, (flash, swiglu) calls of the
# shared block: "block" keeps the SwiGLU's output and recomputes attention
CALLS = {"none": (1, 1), "block": (2, 1), "full": (2, 2)}


@pytest.mark.parametrize("remat", ["none", "block", "full"])
def test_gradients_at_every_remat_match_jax_grad(remat, monkeypatch):
    """The remat unit is the super-block (the reference's ``hybrid.py:135``),
    the tail outside it; the values are the same at every setting, and the
    kernels run as often as the unit's policy says."""
    _, pcfg = rec.cfgs(ARCH)
    want = _ref_grads(16, 32, 4)
    got, calls = _port_grads(pcfg.replace(remat=remat), _batch(32, 4), monkeypatch)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert max_abs_diff(w, g) <= GRAD_RTOL * float(np.max(np.abs(np.asarray(w))))
    n_super = pcfg.n_layers // pcfg.hybrid.attn_every
    assert calls == {"flash": CALLS[remat][0] * n_super, "swiglu": CALLS[remat][1] * n_super}


def test_server_run_generates_the_reference_tokens_in_f32():
    """serve.py:main's traffic (8 prompts of 4-15 tokens, batch 4, 12 new
    tokens) through a 32-slot ring."""
    ref, port = rec.f32_servers(ARCH, 4, 128)
    ps = rec.prompts(8, 4, 16, 512)
    want = ref.run([RRequest(i, p, max_new=12) for i, p in enumerate(ps)])
    got = port.run([Request(i, p, max_new=12) for i, p in enumerate(ps)])
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 12 for r in got)


def test_server_and_trainer_run_the_hybrid_in_bf16():
    server = Server(ARCH, batch=2, max_len=64, device="cpu")
    done = server.run([Request(i, p, max_new=4) for i, p in enumerate(rec.prompts(4, 6, 7, 100))])
    assert all(len(r.generated) == 4 for r in done)
    assert all(0 <= t < server.cfg.padded_vocab for r in done for t in r.generated)
    out = p_train.train(ARCH, reduced=True, steps=6, batch=2, seq=32, optimizer="adafactor",
                        log_every=100, device="cpu")
    assert all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]


# Zamba2's shared attention: D = Dv = 112; (B, Sq, Skv, Hq, Hkv)
FLASH_112_SHAPES = [(2, 16, 16, 4, 4), (1, 40, 40, 4, 2), (1, 24, 70, 2, 2)]


def _qkv(B, Sq, Skv, Hq, Hkv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, 112), (B, Skv, Hkv, 112), (B, Skv, Hkv, 112))]


def _oracle_bshd(q, k, v):
    """The reference's jnp oracle (causal) on BSHD inputs."""
    B, Sq, Hq, D = q.shape
    bhsd = lambda t: t.transpose(0, 2, 1, 3).reshape(-1, t.shape[1], D)
    out = r_ref.flash_attention_ref(bhsd(q), bhsd(k), bhsd(v), causal=True)
    return out.reshape(B, Hq, Sq, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv", FLASH_112_SHAPES)
def test_flash_plain_version_at_head_dim_112_matches_the_oracle(B, Sq, Skv, Hq, Hkv):
    """The plain version at D = Dv = 112 against the reference's oracle, and
    the custom op's gradients against ``jax.grad`` of the oracle."""
    q, k, v = _qkv(B, Sq, Skv, Hq, Hkv, seed=Sq)
    got = p_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert got.shape == (B, Sq, Hq, 112)
    assert max_abs_diff(jax.jit(_oracle_bshd)(q, k, v), got) < FLASH_TOL
    cot = np.random.default_rng(1).standard_normal((B, Sq, Hq, 112)).astype(np.float32)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(_oracle_bshd(q, k, v) * cot),
                            argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    grads = torch.autograd.grad(p_ops.flash_attention(*ts, causal=True), ts,
                                torch.from_numpy(cot))
    for w, g in zip(want, grads):
        assert max_abs_diff(w, g) < FLASH_TOL * float(np.max(np.abs(np.asarray(w))))


def test_flash_plain_version_at_head_dim_112_matches_pallas_interpret():
    q, k, v = _qkv(1, 128, 128, 2, 2, seed=7)
    got = p_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    pallas = r_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                   interpret=True)
    assert max_abs_diff(pallas, got) < FLASH_TOL


def test_flash_op_fake_shape_and_wrapper_at_head_dim_112():
    """The custom op's shape rule at D = Dv = 112, and the wrapper's pair
    table: (112, 112) is a pair of the kernels, (112, 96) and (128, 112)
    are not (the CPU runs the plain version for any D)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q, k, v = torch.empty(8, 5, 112), torch.empty(4, 7, 112), torch.empty(4, 7, 112)
        out = fa.flash_attention_op(q, k, v, True, 0, 112 ** -0.5)
    assert tuple(out.shape) == (8, 5, 112) and out.dtype == torch.float32
    assert (112, 112) in fa.HEAD_PAIRS
    assert (112, 96) not in fa.HEAD_PAIRS and (128, 112) not in fa.HEAD_PAIRS
