"""The sliding-window ring cache of the port (``models/attention.py``)
against the reference on the CPU, in f32, reduced Mixtral with a window of
8 (so a ring of 8 slots):

- the cache's layout: ``Smax = min(max_len, window)`` slots and a
  ``kv_pos`` leaf initialised to -1, as ``gqa_cache_spec`` /
  ``gqa_cache_init`` give them;
- one-token decodes from an empty ring (the reference's
  ``tests/test_attention.py::test_swa_ring_cache_decode``): equal to the
  reference's step by step within 1e-5 and to the full windowed forward
  within 1e-4;
- a prompt longer than the ring, then decode: at S = 16 (a multiple of the
  ring) the port's cache and logits equal the reference's; at S = 13 the
  port stays within 1e-4 of the full windowed forward, where the
  reference's decode is off by more than 0.1: it puts the prompt's last
  8 tokens at slots 0..7, and its decode, writing position p at slot
  p % 8, overwrites a token still inside the window (ROADMAP Queue 3, C5).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as r_get_reduced
from repro.models import Model as RModel
from repro.models import attention as r_attn
from repro.models import lm as r_lm
from repro.models.base import Ctx as RCtx
from repro_torch import configs as p_configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import Model
from repro_torch.models import attention as p_attn
from repro_torch.models import lm as p_lm

from _torch_parity import max_abs_diff, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WINDOW = 8
STEP_TOL = 1e-5
TOL = 1e-4
C5_GAP = 0.1  # the reference's decode past a wrapped prompt of 13 tokens
N_DECODE = 6


def _cfgs(**kw):
    """Reduced Mixtral in f32, window 8, drop-free capacity (16: a T-token
    call and a 1-token decode route the same tokens to the same experts)."""
    out = []
    for get in (r_get_reduced, p_configs.get_reduced):
        cfg = get("mixtral-8x7b").replace(dtype="float32", param_dtype="float32",
                                          sliding_window=WINDOW, **kw)
        out.append(cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=16.0)))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_lm():
    return jax.jit(RModel(_cfgs()[0]).init)(jax.random.PRNGKey(0))


@pytest.mark.parametrize("max_len,slots", [(32, 8), (8, 8), (5, 5)])
def test_cache_layout_matches(max_len, slots):
    rcfg, pcfg = _cfgs()
    rc = r_lm.lm_cache(rcfg, 2, max_len)
    pc = Model(pcfg).init_cache(2, max_len, device="cpu")
    assert sorted(pc["seg0"]) == sorted(rc["seg0"]) == ["k", "kv_pos", "pos", "v"]
    for k in rc["seg0"]:
        assert tuple(pc["seg0"][k].shape) == rc["seg0"][k].shape
        assert np.array_equal(pc["seg0"][k].numpy(), np.asarray(rc["seg0"][k]))
    assert pc["seg0"]["k"].shape[2] == slots
    assert (pc["seg0"]["kv_pos"] == -1).all()
    dense = p_configs.get_reduced("qwen3-8b")
    assert "kv_pos" not in Model(dense).init_cache(2, max_len, device="cpu")["seg0"]


def test_decode_attention_with_ring_positions_matches():
    B, Smax, Hq, Hkv, D = 2, 8, 4, 2, 32
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 1, Hq, D), (B, Smax, Hkv, D), (B, Smax, Hkv, D)))
    kv_pos = np.array([[8, 9, 10, 3, 4, 5, 6, 7], [0, 1, 2, -1, -1, -1, -1, -1]], np.int32)
    pos = np.array([10, 2], np.int32)
    want = r_attn.decode_attention(*(jnp.asarray(a) for a in (q, k, v)), pos=jnp.asarray(pos),
                                   window=WINDOW, kv_positions=jnp.asarray(kv_pos))
    got = p_attn.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  pos=torch.from_numpy(pos), window=WINDOW,
                                  kv_positions=torch.from_numpy(kv_pos))
    assert max_abs_diff(want, got) < STEP_TOL


def test_swa_ring_cache_decode_matches_the_reference():
    """The setup of ``tests/test_attention.py::test_swa_ring_cache_decode``
    (B = 1, 24 tokens, decoded one at a time through 8 slots)."""
    rcfg, pcfg = _cfgs()
    p = r_attn.gqa_params(RCtx("init", jax.random.PRNGKey(0), jnp.float32), rcfg)
    pp = params_from_numpy(_np(p), "cpu")
    B, S = 1, 24
    x = jax.random.normal(jax.random.PRNGKey(1), (B, S, rcfg.d_model), jnp.float32)
    full, _ = r_attn.gqa_forward(rcfg, p, x)
    hd = rcfg.resolved_head_dim
    rc = {"k": jnp.zeros((B, WINDOW, rcfg.n_kv_heads, hd)),
          "v": jnp.zeros((B, WINDOW, rcfg.n_kv_heads, hd)),
          "pos": jnp.zeros((B,), jnp.int32), "kv_pos": jnp.full((B, WINDOW), -1, jnp.int32)}
    pc = {k: torch.from_numpy(np.array(v)) for k, v in rc.items()}
    px = torch.from_numpy(np.array(x))
    r_outs, p_outs = [], []
    for t in range(S):
        o, rc = r_attn.gqa_forward(rcfg, p, x[:, t:t + 1], cache=rc, decode=True)
        r_outs.append(o)
        o, pc = p_attn.gqa_forward(pcfg, pp, px[:, t:t + 1], cache=pc, decode=True)
        p_outs.append(o)
        assert max_abs_diff(r_outs[-1], p_outs[-1]) < STEP_TOL
        assert max_abs_diff(rc, pc) < STEP_TOL  # k, v, kv_pos and pos
    assert max_abs_diff(full, torch.cat(p_outs, dim=1)) < TOL


def _decode_vs_full(S):
    """Prefill S tokens of a seeded sequence into a 32-token cache (a ring
    of 8), then decode the next 6 teacher-forced, in both packages. Returns
    (reference logits, port logits, full windowed forward logits) at
    positions S-1 .. S+5, and both caches after the prefill."""
    rcfg, pcfg = _cfgs()
    rp = _ref_lm()
    pp = params_from_numpy(_np(rp), "cpu")
    rm, pm = RModel(rcfg), Model(pcfg)
    toks = np.random.default_rng(5).integers(0, pcfg.vocab_size, (2, S + N_DECODE))
    toks = toks.astype(np.int32)
    rl, rc = jax.jit(lambda p, b: rm.prefill(p, b, 32))(rp, {"tokens": jnp.asarray(toks[:, :S])})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :S])}, 32)
    caches = (rc, {k: {n: t.clone() for n, t in c.items()} for k, c in pc.items()})
    r_dec = jax.jit(rm.decode_step)
    ref, port = [rl], [pl]
    for j in range(N_DECODE):
        cur = toks[:, S + j:S + j + 1]
        rl, rc = r_dec(rp, rc, jnp.asarray(cur))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(cur))
        ref.append(rl)
        port.append(pl)
    h, _, _ = p_lm.lm_forward(pcfg, pp, {"tokens": torch.from_numpy(toks)})
    full = p_lm.unembed(pcfg, pp, h[:, S - 1:])
    return (np.stack([np.asarray(r) for r in ref], 1), torch.stack(port, 1), full, caches)


def test_long_prefill_a_multiple_of_the_ring_matches_the_reference():
    ref, port, full, (rc, pc) = _decode_vs_full(16)
    assert max_abs_diff(rc, pc) < TOL  # k, v, pos and kv_pos: the same layout
    assert pc["seg0"]["kv_pos"][0, 0].tolist() == list(range(8, 16))
    assert max_abs_diff(ref, port) < TOL
    assert max_abs_diff(full, port) < TOL


def test_long_prefill_past_the_ring_keeps_the_window():
    """S = 13: the port holds position p at slot p % 8 and decodes as the
    full windowed forward does; the reference's gap is the record of C5."""
    ref, port, full, (rc, pc) = _decode_vs_full(13)
    slots = pc["seg0"]["kv_pos"][0, 0].tolist()
    assert slots == [8, 9, 10, 11, 12, 5, 6, 7]  # position p at slot p % 8
    assert np.asarray(rc["seg0"]["kv_pos"])[0, 0].tolist() == list(range(5, 13))
    assert max_abs_diff(full, port) < TOL
    assert max_abs_diff(full[:, 0], ref[:, 0]) < TOL  # the prefill's own logits agree
    assert max_abs_diff(full, ref) > C5_GAP
