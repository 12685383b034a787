"""Port parity for the dense GQA LM (``repro_torch.models``) on the CPU,
against ``repro.models`` on the reduced Qwen3 config (2 layers, d = 128,
4 q heads, 2 kv heads, head_dim 32, d_ff 256, vocab 512). The reference's
params are carried across by ``repro_torch.convert``; inputs come from a
numpy seed. In f32 (dtype = param_dtype = "float32") outputs, caches and
logits agree within 1e-4; in bf16 the logits agree within
``BF16_LOGIT_RTOL`` of max |logit|, the port's decode teacher-forced on the
reference's tokens so that a near-tie cannot make the runs diverge."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.configs import get_config as r_get_config
from repro.configs import get_reduced as r_get_reduced
from repro.models import Model as RModel
from repro.models import attention as r_attn
from repro.models import base as r_base
from repro.models import lm as r_lm
from repro.models import mlp as r_mlp
from repro.models.base import Ctx as RCtx
from repro_torch import configs as p_configs
from repro_torch.configs import SSMConfig
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import Model
from repro_torch.models import attention as p_attn
from repro_torch.models import base as p_base
from repro_torch.models import lm as p_lm
from repro_torch.models import mlp as p_mlp

from _torch_parity import one_torch_thread, max_abs_diff  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32_TOL = 1e-4
# bf16 logits: one bf16 rounding of every activation (~2**-9 relative) over
# 2 layers, measured at ~1.2e-2 of max |logit|; the bound leaves ~2.5x room
BF16_LOGIT_RTOL = 3e-2


def _cfgs(dtype="float32"):
    kw = dict(dtype=dtype, param_dtype=dtype)
    return r_get_reduced("qwen3-8b").replace(**kw), p_configs.get_reduced("qwen3-8b").replace(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_params(dtype: str, seed: int):
    """The reference's LM params (threefry init), drawn once per dtype and
    seed for the whole module."""
    return jax.jit(RModel(_cfgs(dtype)[0]).init)(jax.random.PRNGKey(seed))


def _carried(dtype="float32", seed=0):
    """The reference's params and the same values as the port's tree on
    the CPU."""
    rp = _ref_params(dtype, seed)
    return rp, params_from_numpy(_np(rp), "cpu")


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_config_is_the_reference_config():
    for r_get, p_get in ((r_get_config, p_configs.get_config), (r_get_reduced, p_configs.get_reduced)):
        assert dataclasses.asdict(r_get("qwen3-8b")) == dataclasses.asdict(p_get("qwen3-8b"))
    full = p_configs.get_config("qwen3-8b")
    assert full.param_count() == r_get_config("qwen3-8b").param_count() == 8_191_475_712
    assert full.padded_vocab == 152_064 and full.resolved_head_dim == 128


def test_unknown_arch_raises_key_error():
    assert p_configs.ARCH_IDS == r_configs.ARCH_IDS and p_configs.GRID_ARCHS == r_configs.GRID_ARCHS
    for get in (p_configs.get_config, p_configs.get_reduced):
        with pytest.raises(KeyError):
            get("no-such-arch")


@pytest.mark.parametrize(
    "change",
    [dict(enc_dec=True, n_enc_layers=1, enc_seq_len=8, tie_embeddings=True),
     dict(frontend="audio_stub"),
     dict(attn_kind="none")],
    ids=["encdec", "audio_stub", "attn_kind_none"],
)
def test_qwen3_variants_build_the_references_model(change):
    """Reduced Qwen3 with one field changed builds what the reference
    builds: turned encoder-decoder (qk-norm, SwiGLU, RMSNorm blocks, one
    encoder layer over 8 frames; tied, as the family's loss needs), with an ``audio_stub`` frontend (which
    the ``lm`` family ignores) and with attention kind "none" and no SSM
    (GQA blocks, as the reference's ``segments`` gives). Loss, prefill and
    one decode step in f32 against the reference's."""
    rcfg, pcfg = (c.replace(**change) for c in _cfgs())
    rp = jax.jit(RModel(rcfg).init)(jax.random.PRNGKey(0))
    pp = params_from_numpy(_np(rp), "cpu")
    toks = np.random.default_rng(4).integers(0, pcfg.vocab_size, (2, 12)).astype(np.int32)
    b = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if pcfg.enc_dec:
        b["frames"] = _x((2, 8, pcfg.d_model), seed=12)
    rm = RModel(rcfg)
    rl, _ = jax.jit(rm.loss)(rp, {k: jnp.asarray(v) for k, v in b.items()})
    pl, _ = Model(pcfg).loss(pp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(rl) - float(pl)) < F32_TOL
    pre = {k: v[:, :11] if k == "tokens" else v for k, v in b.items() if k != "targets"}
    r_logits, r_cache = jax.jit(lambda p, b: rm.prefill(p, b, 16))(
        rp, {k: jnp.asarray(v) for k, v in pre.items()})
    p_logits, p_cache = Model(pcfg).prefill(pp, {k: torch.from_numpy(v) for k, v in pre.items()},
                                            16)
    assert max_abs_diff(r_logits, p_logits) < F32_TOL
    r_logits, _ = jax.jit(rm.decode_step)(rp, r_cache, jnp.asarray(toks[:, 11:]))
    p_logits, _ = Model(pcfg).decode_step(pp, p_cache, torch.from_numpy(toks[:, 11:]))
    assert max_abs_diff(r_logits, p_logits) < F32_TOL


def test_cross_attention_matches():
    """Cross attention with Qwen3's q-norm weights present: the reference
    projects q with neither norm nor rope, and so does the port."""
    rcfg, pcfg = _cfgs()
    rp, pp = _carried()
    r_layer, p_layer = _layer(rp["seg0"]["attn"], 0), p_lm._index(pp["seg0"]["attn"], 0)
    x, k, v = _x((2, 5, pcfg.d_model), 13), _x((2, 9, 2, 32), 14), _x((2, 9, 2, 32), 15)
    r_out, _ = r_attn.gqa_forward(rcfg, r_layer, jnp.asarray(x),
                                  cross_kv=(jnp.asarray(k), jnp.asarray(v)))
    p_out, cache = p_attn.gqa_forward(pcfg, p_layer, torch.from_numpy(x),
                                      cross_kv=(torch.from_numpy(k), torch.from_numpy(v)))
    assert cache is None and max_abs_diff(r_out, p_out) < F32_TOL


@pytest.mark.parametrize(
    "change",
    [dict(ssm=SSMConfig(kind="mamba2")), dict(ssm=SSMConfig(kind="rwkv6", head_dim=32, chunk_len=8))],
    ids=["mamba2_is_dense", "rwkv6_segment"],
)
def test_ssm_on_a_gqa_config_builds_the_references_model(change):
    """An ``lm``-family config with an ``ssm`` builds what the reference
    builds: a Mamba2 ``ssm`` without ``hybrid`` leaves the dense model (the
    reference's ``segments`` looks only for RWKV6), an RWKV6 one makes every
    layer an RWKV block. Loss, prefill and one decode step in f32 against
    the reference's."""
    rcfg, pcfg = (c.replace(**change) for c in _cfgs())
    rp = jax.jit(RModel(rcfg).init)(jax.random.PRNGKey(0))
    pp = params_from_numpy(_np(rp), "cpu")
    assert [k for k, _ in p_lm.segments(pcfg)] == [k for k, _ in r_lm.segments(rcfg)]
    toks = np.random.default_rng(4).integers(0, pcfg.vocab_size, (2, 16)).astype(np.int32)
    b = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    rl, _ = RModel(rcfg).loss(rp, {k: jnp.asarray(v) for k, v in b.items()})
    pl, _ = Model(pcfg).loss(pp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert abs(float(rl) - float(pl)) < F32_TOL
    r_logits, r_cache = RModel(rcfg).prefill(rp, {"tokens": jnp.asarray(toks[:, :15])}, 24)
    p_logits, p_cache = Model(pcfg).prefill(pp, {"tokens": torch.from_numpy(toks[:, :15])}, 24)
    assert max_abs_diff(r_logits, p_logits) < F32_TOL
    r_logits, _ = RModel(rcfg).decode_step(rp, r_cache, jnp.asarray(toks[:, 15:]))
    p_logits, _ = Model(pcfg).decode_step(pp, p_cache, torch.from_numpy(toks[:, 15:]))
    assert max_abs_diff(r_logits, p_logits) < F32_TOL


def test_init_tree_matches_reference_layout():
    """Same tree, shapes and dtypes as the reference's init; draws in f32
    cast to bf16, fan-in scaled (the reference's rule)."""
    rcfg, pcfg = _cfgs("bfloat16")
    ref = jax.eval_shape(lambda: RModel(rcfg).init(jax.random.PRNGKey(0)))
    got = Model(pcfg).init(torch.Generator().manual_seed(0))
    r_leaves = jax.tree_util.tree_leaves_with_path(ref)
    p_flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            p_flat[path] = t

    walk(got, ())
    assert len(p_flat) == len(r_leaves)
    for path, leaf in r_leaves:
        t = p_flat[tuple(k.key for k in path)]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.bfloat16
    wg = got["seg0"]["mlp"]["w_gate"].float()
    assert abs(float(wg.std()) - pcfg.d_model ** -0.5) < 0.1 * pcfg.d_model ** -0.5
    assert torch.equal(got["seg0"]["ln1"]["scale"], torch.ones_like(got["seg0"]["ln1"]["scale"]))


def test_bf16_params_round_trip_through_convert_bit_for_bit():
    rp = _np(_ref_params("bfloat16", 1))
    port = params_from_numpy(rp, "cpu")
    assert port["embed"].dtype == torch.bfloat16
    back = params_to_numpy(port)
    for a, t, b in zip(jax.tree.leaves(rp), jax.tree.leaves(port), jax.tree.leaves(back)):
        assert np.array_equal(a.view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))
        assert b.dtype == np.float32 and np.array_equal(a.astype(np.float32), b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match(dtype):
    x = _x((2, 5, 4, 32), seed=1)
    w = 1.0 + 0.1 * _x((32,), seed=2)
    rx, px = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    tol = F32_TOL if dtype == "float32" else 1e-2
    got = p_base.rms_norm(px, torch.from_numpy(w), 1e-5)
    assert max_abs_diff(r_base.rms_norm(rx, jnp.asarray(w), 1e-5), got.float()) < tol
    pos = np.array([[0, 1, 2, 3, 4]], np.int32)
    got = p_base.apply_rope(px, torch.from_numpy(pos), 1e6)
    assert max_abs_diff(r_base.apply_rope(rx, jnp.asarray(pos), 1e6), got.float()) < tol
    dec_pos = np.array([[7], [11]], np.int32)  # decode: one position per row
    got = p_base.apply_rope(px[:, :1], torch.from_numpy(dec_pos), 1e6)
    want = r_base.apply_rope(rx[:, :1], jnp.asarray(dec_pos), 1e6)
    assert max_abs_diff(want, got.float()) < tol


def test_gqa_forward_prefill_and_decode_match_with_cache():
    rcfg, pcfg = _cfgs()
    rp, pp = _carried()
    r_layer, p_layer = _layer(rp["seg0"]["attn"], 1), p_lm._index(pp["seg0"]["attn"], 1)
    B, S, Smax = 2, 9, 16
    x = _x((B, S, pcfg.d_model), seed=3)
    rc = r_attn.gqa_cache_init(rcfg, B, Smax, 1)
    pc = p_attn.gqa_cache_init(pcfg, B, Smax, 1)
    rc1, pc1 = _layer(rc, 0), p_lm._index(pc, 0)
    r_gqa = jax.jit(functools.partial(r_attn.gqa_forward, rcfg), static_argnames=("decode",))
    r_out, rc1 = r_gqa(r_layer, jnp.asarray(x), cache=rc1)
    p_out, pc1 = p_attn.gqa_forward(pcfg, p_layer, torch.from_numpy(x), cache=pc1)
    assert max_abs_diff(r_out, p_out) < F32_TOL
    assert max_abs_diff({k: rc1[k] for k in ("k", "v")}, {k: pc1[k] for k in ("k", "v")}) < F32_TOL
    rc1 = dict(rc1, pos=jnp.full((B,), S, jnp.int32))
    pc1["pos"].fill_(S)
    x1 = _x((B, 1, pcfg.d_model), seed=4)
    r_out, rc1 = r_gqa(r_layer, jnp.asarray(x1), cache=rc1, decode=True)
    p_out, pc1 = p_attn.gqa_forward(pcfg, p_layer, torch.from_numpy(x1), cache=pc1, decode=True)
    assert max_abs_diff(r_out, p_out) < F32_TOL
    assert max_abs_diff(rc1, pc1) < F32_TOL  # k, v (slot S written) and pos (S + 1)
    assert pc1["pos"].tolist() == [S + 1] * B


def test_gqa_forward_refuses_a_cache_shorter_than_the_prompt():
    """(The name is kept from when the port refused such a cache.) A dense
    cache shorter than the prompt keeps the prompt's last Smax tokens at
    slots 0..Smax-1, as the reference's does; a one-token cross attention
    over those 4 slots equals the reference's."""
    rcfg, pcfg = _cfgs()
    rp, pp = _carried()
    r_layer, p_layer = _layer(rp["seg0"]["attn"], 0), p_lm._index(pp["seg0"]["attn"], 0)
    x = _x((2, 8, pcfg.d_model), seed=10)
    rc = _layer(r_attn.gqa_cache_init(rcfg, 2, 4, 1), 0)
    pc = p_lm._index(p_attn.gqa_cache_init(pcfg, 2, 4, 1), 0)
    r_out, rc = r_attn.gqa_forward(rcfg, r_layer, jnp.asarray(x), cache=rc)
    p_out, pc = p_attn.gqa_forward(pcfg, p_layer, torch.from_numpy(x), cache=pc)
    assert max_abs_diff(r_out, p_out) < F32_TOL
    assert max_abs_diff({k: rc[k] for k in ("k", "v")}, {k: pc[k] for k in ("k", "v")}) < F32_TOL
    x1 = _x((2, 1, pcfg.d_model), seed=11)
    r_out, _ = r_attn.gqa_forward(rcfg, r_layer, jnp.asarray(x1), cross_kv=(rc["k"], rc["v"]))
    p_out, _ = p_attn.gqa_forward(pcfg, p_layer, torch.from_numpy(x1), cross_kv=(pc["k"], pc["v"]))
    assert max_abs_diff(r_out, p_out) < F32_TOL


def test_decode_attention_matches():
    B, Smax, Hq, Hkv, D = 2, 12, 4, 2, 32
    q, k, v = _x((B, 1, Hq, D), 5), _x((B, Smax, Hkv, D), 6), _x((B, Smax, Hkv, D), 7)
    pos = np.array([3, 9], np.int32)
    want = r_attn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos=jnp.asarray(pos))
    got = p_attn.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)), pos=torch.from_numpy(pos))
    assert max_abs_diff(want, got) < F32_TOL
    full = r_attn.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=3)
    got = p_attn.full_attention(*(torch.from_numpy(a) for a in (q, k, v)), q_offset=3)
    assert max_abs_diff(full, got) < F32_TOL


@pytest.mark.parametrize("mlp_kind", ["swiglu", "gelu"])
def test_mlp_forward_matches(mlp_kind):
    rcfg, pcfg = (c.replace(mlp_kind=mlp_kind) for c in _cfgs())
    rp = r_mlp.mlp_params(RCtx("init", jax.random.PRNGKey(0), jnp.float32), rcfg)
    pp = params_from_numpy(_np(rp), "cpu")
    x = _x((2, 16, pcfg.d_model), seed=8)
    want = r_mlp.mlp_forward(rcfg, rp, jnp.asarray(x))
    got = p_mlp.mlp_forward(pcfg, pp, torch.from_numpy(x))
    assert max_abs_diff(want, got) < F32_TOL


def _serve_steps(dtype, n_decode=3):
    """Prefill a seeded batch and decode ``n_decode`` greedy steps in both
    packages; the port is fed the reference's tokens."""
    rcfg, pcfg = _cfgs(dtype)
    rp, pp = _carried(dtype, seed=1)
    rm, pm = RModel(rcfg), Model(pcfg)
    r_prefill = jax.jit(lambda p, b: rm.prefill(p, b, 32))
    r_decode = jax.jit(rm.decode_step)
    toks = np.random.default_rng(9).integers(0, pcfg.vocab_size, (2, 9)).astype(np.int32)
    rl, rc = r_prefill(rp, {"tokens": jnp.asarray(toks)})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, 32)
    logits = [(rl, pl)]
    for _ in range(n_decode):
        cur = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
        rl, rc = r_decode(rp, rc, jnp.asarray(cur))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(cur))
        logits.append((rl, pl))
    return logits, (rc, pc)


def test_lm_prefill_and_decode_match_in_f32():
    logits, (rc, pc) = _serve_steps("float32")
    for r, p in logits:
        assert p.dtype == torch.float32 and p.shape == (2, 512)
        assert max_abs_diff(r, p) < F32_TOL
    assert max_abs_diff(rc, pc) < F32_TOL  # both layers' k / v, pos = 9 + 3
    assert pc["seg0"]["pos"].tolist() == [[12, 12], [12, 12]]


def test_lm_prefill_and_decode_match_in_bf16():
    logits, _ = _serve_steps("bfloat16")
    for r, p in logits:
        assert p.dtype == torch.float32  # f32 logits from bf16 h and w
        scale = float(np.max(np.abs(np.asarray(r))))
        assert max_abs_diff(r, p) <= BF16_LOGIT_RTOL * scale
