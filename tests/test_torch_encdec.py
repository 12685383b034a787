"""Port parity for the encoder-decoder (``whisper-base``) on the CPU: the
config, the params' tree and axes, the sinusoidal table, the encoder, the
cross k / v and the decoder, the loss, prefill and decode logits with every
cache leaf, decode against prefill, the serving driver, one train step,
gradients under every remat setting, cross attention alone, and the flash
plain version without a mask at Sq != Skv. Held against ``repro`` on the
reduced config (2 encoder and 2 decoder layers, d 64, 4 heads of 16, d_ff
128, vocab 512, 16 frames) with the reference's params carried across by
``repro_torch.convert``; torch on one thread (``one_torch_thread``).

Tolerances: the encoder's states, the cross k / v and the decoder's hidden
states within 1e-5 in f32; logits and losses within 1e-4 in f32 and 3e-2
of max |logit| (of the loss, for the loss) in bf16; cache leaves within
1e-5; a train step's loss and grad norm within 1e-4 of their size, the
params within 0.05 of the learning rate; gradients within 1e-4 of each
leaf's max |grad|; the flash plain version within 1e-5 (f32 sums in
another order)."""

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
from repro.launch.serve import Server as RServer
from repro.models import Model as RModel
from repro.models import attention as r_attn
from repro.models import base as r_base
from repro.models import encdec as r_encdec
from repro_torch import configs as p_configs
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as p_ops
from repro_torch.launch import Request, Server
from repro_torch.launch import train as p_train
from repro_torch.models import Model
from repro_torch.models import attention as p_attn
from repro_torch.models import base as p_base
from repro_torch.models import encdec as p_encdec
from repro_torch.utils import tree_leaves, tree_map

import _torch_recurrent as rec
from _torch_parity import max_abs_diff, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "whisper-base"
STATE_TOL = 1e-5  # encoder states, cross k / v, decoder hidden states, cache leaves (f32)
GRAD_RTOL = 1e-4
FLASH_TOL = 1e-5
B, SE = 2, 16  # batch, the reduced config's frames


def _frames(seed=5, B=B):
    return np.random.default_rng(seed).standard_normal((B, SE, 64)).astype(np.float32)


def _to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_config_is_the_reference_config():
    """Both configs equal the reference's, ``param_count`` too (it counts
    an unembedding the tied model lacks and leaves out the cross attention,
    ``dec_pos``, the norms and the biases); the tree holds 87,488,512
    params (0.17 GB in bf16), its layout and its logical axes the
    reference's."""
    for r_get, p_get in ((r_get_config, p_configs.get_config),
                         (r_get_reduced, p_configs.get_reduced)):
        assert dataclasses.asdict(r_get(ARCH)) == dataclasses.asdict(p_get(ARCH))
    full = p_configs.get_config(ARCH)
    assert full.param_count() == r_get_config(ARCH).param_count() == 90_963_968
    ref_model = RModel(r_get_config(ARCH))
    port_model = Model(full)
    ref_tree = jax.eval_shape(lambda: ref_model.init(jax.random.PRNGKey(0)))
    port_tree = port_model.abstract_params()
    assert rec.tree_layout(port_tree) == rec.tree_layout(ref_tree)
    assert sum(t.numel() for t in tree_leaves(port_tree)) == 87_488_512
    assert tuple(port_tree["dec_pos"].shape) == (p_encdec.MAX_DEC_POSITIONS, 512)
    assert port_model.param_axes() == ref_model.param_axes()


@pytest.mark.parametrize("n,d", [(1536, 512), (16, 64), (7, 6)])
def test_sinusoidal_positions_bit_for_bit(n, d):
    want = np.asarray(r_base.sinusoidal_positions(n, d))
    got = p_base.sinusoidal_positions(n, d).numpy()
    assert got.dtype == np.float32 and np.array_equal(want.view(np.uint32), got.view(np.uint32))


def test_encode_cross_kv_and_decoder_match():
    rcfg, pcfg = rec.cfgs(ARCH)
    rp, pp = rec.carried(ARCH)
    frames = _frames()
    toks = rec.tokens((B, 12), 512, 6)

    @jax.jit
    def ref(p, frames, toks):
        enc = r_encdec.encode(rcfg, p, frames)
        kv = r_encdec._cross_kv(rcfg, p["decoder"], enc)
        return enc, kv, r_encdec.decoder_forward(rcfg, p, toks, kv)[0]

    r_enc, r_kv, r_h = ref(rp, jnp.asarray(frames), jnp.asarray(toks))
    p_enc = p_encdec.encode(pcfg, pp, torch.from_numpy(frames))
    assert p_enc.shape == (B, SE, 64) and max_abs_diff(r_enc, p_enc) < STATE_TOL
    p_kv = p_encdec._cross_kv(pcfg, pp["decoder"], p_enc)
    assert tuple(p_kv[0].shape) == (2, B, SE, 4, 16)
    assert max_abs_diff(r_kv[0], p_kv[0]) < STATE_TOL and max_abs_diff(r_kv[1], p_kv[1]) < STATE_TOL
    p_h, _ = p_encdec.decoder_forward(pcfg, pp, torch.from_numpy(toks), p_kv)
    assert max_abs_diff(r_h, p_h) < STATE_TOL


def _loss_batch(S=12, seed=1):
    toks = rec.tokens((B, S + 1), 512, seed)
    return {"frames": _frames(seed), "tokens": toks[:, :-1], "targets": toks[:, 1:]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches(dtype):
    rcfg, pcfg = rec.cfgs(ARCH, dtype)
    rp, pp = rec.carried(ARCH, dtype)
    b = _loss_batch()
    rl, rm = jax.jit(RModel(rcfg).loss)(rp, _to_jax(b))
    pl, pm = Model(pcfg).loss(pp, _to_torch(b))
    assert sorted(pm) == ["accuracy", "aux", "loss"] and float(pm["aux"]) == 0.0
    tol = rec.LOGIT_TOL if dtype == "float32" else rec.BF16_LOGIT_RTOL * abs(float(rl))
    assert abs(float(rl) - float(pl)) < tol


MAX_LEN = 24


@functools.lru_cache(maxsize=None)
def _ref_serving(dtype):
    """The reference's jitted prefill (to ``MAX_LEN``) and decode step, once
    per dtype for the module."""
    rm = RModel(rec.cfgs(ARCH, dtype)[0])
    return jax.jit(lambda p, b: rm.prefill(p, b, MAX_LEN)), jax.jit(rm.decode_step)


def _serve_steps(dtype, S, n_decode):
    """Prefill a seeded [2, S] prompt over seeded frames, then ``n_decode``
    greedy decode steps in both packages, the port fed the reference's
    tokens: the (reference, port) logits of each call and the last caches."""
    _, pcfg = rec.cfgs(ARCH, dtype)
    rp, pp = rec.carried(ARCH, dtype)
    pm = Model(pcfg)
    r_prefill, r_decode = _ref_serving(dtype)
    b = {"tokens": rec.tokens((B, S), 512, 9), "frames": _frames(9)}
    rl, rc = r_prefill(rp, _to_jax(b))
    pl, pc = pm.prefill(pp, _to_torch(b), MAX_LEN)
    logits = [(rl, pl)]
    for _ in range(n_decode):
        cur = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
        rl, rc = r_decode(rp, rc, jnp.asarray(cur))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(cur))
        logits.append((rl, pl))
    return logits, (rc, pc)


@pytest.mark.parametrize("S", [12, 7])
def test_prefill_and_decode_match_in_f32(S):
    """Prefill then 3 decode steps: the logits of each call, then every
    cache leaf (the self cache's k / v / pos, the cross k / v) in the
    reference's layout."""
    logits, (rc, pc) = _serve_steps("float32", S, 3)
    for r, p in logits:
        assert p.dtype == torch.float32 and p.shape == (B, 512)
        assert max_abs_diff(r, p) < rec.LOGIT_TOL
    assert rec.tree_layout(pc) == rec.tree_layout(rc)
    assert pc["self"]["pos"].tolist() == [[S + 3] * B] * 2
    assert max_abs_diff(rc, pc) < STATE_TOL


def test_prefill_and_decode_match_in_bf16():
    logits, _ = _serve_steps("bfloat16", 12, 2)
    for r, p in logits:
        assert p.dtype == torch.float32
        assert max_abs_diff(r, p) <= rec.BF16_LOGIT_RTOL * float(np.max(np.abs(np.asarray(r))))


@pytest.mark.parametrize("S", [16, 9])
def test_decode_matches_prefill(S):
    """prefill(S - 1) then one decode step == prefill(S)'s last logits
    (f32, the port alone): the self cache, ``dec_pos[pos]`` and the cross
    attention's one-token query against the flash prefill."""
    _, pcfg = rec.cfgs(ARCH)
    _, pp = rec.carried(ARCH)
    model = Model(pcfg)
    toks, frames = torch.from_numpy(rec.tokens((B, S), 512, 3)), torch.from_numpy(_frames(3))
    full, _ = model.prefill(pp, {"tokens": toks, "frames": frames}, S + 8)
    _, cache = model.prefill(pp, {"tokens": toks[:, :-1], "frames": frames}, S + 8)
    step, _ = model.decode_step(pp, cache, toks[:, -1:])
    assert max_abs_diff(full, step) < rec.DECODE_PREFILL_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_layout_is_encdec_cache(dtype):
    rcfg, pcfg = rec.cfgs(ARCH, dtype)
    want = r_encdec.encdec_cache(rcfg, 3, 20)
    got = Model(pcfg).init_cache(3, 20, device="cpu")
    assert rec.tree_layout(got) == rec.tree_layout(want)
    assert rec.tree_layout(Model(pcfg).cache_spec(3, 20)) == rec.tree_layout(want)
    assert all(float(t.float().abs().max()) == 0.0 for t in tree_leaves(got))


def test_train_step_matches_reference():
    kw = dict(optimizer="adafactor", learning_rate=2e-3, total_steps=4, warmup_steps=1)
    r_m, p_m, gap = rec.train_step_metrics(ARCH, 2, 16, **kw)
    assert sorted(p_m) == ["accuracy", "aux", "grad_norm", "loss"]
    for k in ("loss", "grad_norm"):
        assert np.isfinite(float(p_m[k]))
        assert abs(float(r_m[k]) - float(p_m[k])) <= rec.STEP_RTOL * abs(float(r_m[k])), k
    assert gap <= rec.PARAM_STEP_ATOL * kw["learning_rate"]


@functools.lru_cache(maxsize=None)
def _ref_grads():
    rcfg, _ = rec.cfgs(ARCH)
    return jax.tree.leaves(jax.jit(jax.grad(lambda p, b: RModel(rcfg).loss(p, b)[0]))(
        rec.ref_params(ARCH, "float32"), _to_jax(_loss_batch(seed=4))))


# flash calls of one loss and gradient, each pass: each encoder layer one
# (non-causal), each decoder layer two (causal self, non-causal cross);
# "block" and "full" run the pass again in the backward
PASSES = {"none": 1, "block": 2, "full": 2}


@pytest.mark.parametrize("remat", ["none", "block", "full"])
def test_gradients_at_every_remat_match_jax_grad(remat, monkeypatch):
    """The remat unit is the block, encoder and decoder alike; the values
    are the same at every setting, the gradients of the encoder's weights
    reaching them only through the cross attention's k and v."""
    _, pcfg = rec.cfgs(ARCH, remat=remat)
    calls = []
    bhsd = fa.flash_attention_bhsd
    monkeypatch.setattr(fa, "flash_attention_bhsd",
                        lambda *a, **kw: calls.append(kw.get("causal")) or bhsd(*a, **kw))
    params = tree_map(lambda t: t.requires_grad_(True), rec.carried(ARCH)[1])
    loss, _ = Model(pcfg).loss(params, _to_torch(_loss_batch(seed=4)))
    got = torch.autograd.grad(loss, tree_leaves(params))
    monkeypatch.undo()
    want = _ref_grads()
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert max_abs_diff(w, g) <= GRAD_RTOL * float(np.max(np.abs(np.asarray(w))))
    assert calls[:6] == [False] * 2 + [True, False] * 2  # encoder, then decoder
    assert sorted(calls) == sorted(calls[:6] * PASSES[remat])


def test_cross_attention_matches_reference():
    """``gqa_forward(cross_kv=...)`` of a decoder layer against the
    reference's, in prefill (Sq = 7) and decode (Sq = 1) shapes, over the
    16 encoder keys."""
    rcfg, pcfg = rec.cfgs(ARCH)
    rp, pp = rec.carried(ARCH)
    r_layer = jax.tree.map(lambda a: a[1], rp["decoder"]["cross_attn"])
    p_layer = tree_map(lambda t: t[1], pp["decoder"]["cross_attn"])
    rng = np.random.default_rng(8)
    k, v = (rng.standard_normal((B, SE, 4, 16)).astype(np.float32) for _ in range(2))
    for Sq in (7, 1):
        x = rng.standard_normal((B, Sq, 64)).astype(np.float32)
        r_out, r_cache = r_attn.gqa_forward(rcfg, r_layer, jnp.asarray(x),
                                            cross_kv=(jnp.asarray(k), jnp.asarray(v)))
        p_out, p_cache = p_attn.gqa_forward(pcfg, p_layer, torch.from_numpy(x),
                                            cross_kv=(torch.from_numpy(k), torch.from_numpy(v)))
        assert r_cache is None and p_cache is None
        assert max_abs_diff(r_out, p_out) < STATE_TOL


def _f32_servers(batch, max_len):
    """The reference's and the port's server on the reduced config in f32,
    both holding the reference's params (the reference's built without its
    own bf16 draws, which it would make eagerly)."""
    rcfg, pcfg = rec.cfgs(ARCH)
    rp, pp = rec.carried(ARCH)
    ref = RServer.__new__(RServer)
    ref.cfg, ref.model, ref.params, ref.batch, ref.max_len = rcfg, RModel(rcfg), rp, batch, max_len
    ref._prefill = jax.jit(lambda p, b: ref.model.prefill(p, b, max_len))
    ref._decode = jax.jit(ref.model.decode_step)
    port = Server(ARCH, batch=batch, max_len=max_len, device="cpu")
    port.cfg, port.model, port.params = pcfg, Model(pcfg), pp
    port._prefill = lambda p, b: port.model.prefill(p, b, max_len)
    port._decode = port.model.decode_step
    return ref, port


def test_server_run_generates_the_reference_tokens_in_f32():
    """serve.py:main's traffic (8 prompts of 4-15 tokens, batch 4, 12 new
    tokens) over zero frames."""
    ref, port = _f32_servers(4, 32)
    ps = rec.prompts(8, 4, 16, 512)
    want = ref.run([RRequest(i, p, max_new=12) for i, p in enumerate(ps)])
    got = port.run([Request(i, p, max_new=12) for i, p in enumerate(ps)])
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 12 for r in got)


def test_server_and_trainer_run_whisper_in_bf16():
    server = Server(ARCH, batch=2, max_len=32, device="cpu")
    done = server.run([Request(i, p, max_new=4) for i, p in enumerate(rec.prompts(4, 6, 7, 100))])
    assert all(len(r.generated) == 4 for r in done)
    assert all(0 <= t < server.cfg.padded_vocab for r in done for t in r.generated)
    out = p_train.train(ARCH, reduced=True, steps=6, batch=2, seq=16, log_every=100,
                        device="cpu")
    assert all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]
    assert out["aux"] == [0.0] * 6


def _qkv(Sq, Skv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((2, Sq, 4, 16), (2, Skv, 4, 16), (2, Skv, 4, 16))]


def _oracle_bshd(q, k, v):
    """The reference's jnp oracle (no mask) on BSHD inputs."""
    Bq, Sq, Hq, D = q.shape
    bhsd = lambda t: t.transpose(0, 2, 1, 3).reshape(-1, t.shape[1], D)
    out = r_ref.flash_attention_ref(bhsd(q), bhsd(k), bhsd(v), causal=False)
    return out.reshape(Bq, Hq, Sq, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("Sq", [5, 1])
def test_flash_plain_version_without_a_mask_matches_pallas_interpret(Sq):
    """The plain version at ``causal=False`` with Sq != Skv (a cross
    attention's prefill and decode query over 16 keys) against the
    reference's Pallas kernel in interpret mode, and the custom op's
    gradients (dk / dv at Skv from a short Sq) against ``jax.grad`` of the
    reference's oracle."""
    q, k, v = _qkv(Sq, 16, seed=Sq)
    got = p_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=False)
    pallas = r_ops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                   interpret=True)
    assert got.shape == (2, Sq, 4, 16) and max_abs_diff(pallas, got) < FLASH_TOL
    cot = np.random.default_rng(1).standard_normal((2, Sq, 4, 16)).astype(np.float32)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(_oracle_bshd(q, k, v) * cot),
                            argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    grads = torch.autograd.grad(p_ops.flash_attention(*ts, causal=False), ts,
                                torch.from_numpy(cot))
    for w, g in zip(want, grads):
        assert max_abs_diff(w, g) < FLASH_TOL * float(np.max(np.abs(np.asarray(w))))
