"""Port parity for the recurrent blocks (``repro_torch.models.ssm``) on the
CPU: RWKV6's time mix (the chunked form and the step-by-step recurrence)
and channel mix, Mamba2's chunked SSD, its causal conv and its decode
step, held against ``repro.models.ssm`` on seeded numpy inputs with the
reference's params carried across by ``repro_torch.convert``; and C7,
Mamba2's gradients at the published 128-step chunk through reduced Zamba2.
Configs are the reduced RWKV6 (d 128, 2 heads of 64, chunk 16) and Zamba2
(d 128, expand 2, 8 heads of 32, state 16, chunk 16), in f32.

Tolerances: the blocks' outputs and states within 1e-4 (the f32 products
summed in another order); the port's own paths against each other
(chunked against step by step, one segment against two, decode steps
against the chunked forward) within 1e-4 as well; gradients within 1e-4 of
each leaf's max |grad|."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as r_get_reduced
from repro.models import Model as RModel
from repro.models import ssm as r_ssm
from repro.models.base import Ctx as RCtx
from repro_torch import configs as p_configs
from repro_torch.convert import params_from_numpy
from repro_torch.models import Model
from repro_torch.models import ssm as p_ssm
from repro_torch.utils import tree_leaves, tree_map

from _torch_parity import max_abs_diff, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-4
F32 = dict(dtype="float32", param_dtype="float32")


def _cfgs(arch):
    return r_get_reduced(arch).replace(**F32), p_configs.get_reduced(arch).replace(**F32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ref_rwkv():
    rcfg, _ = _cfgs("rwkv6-1.6b")
    return r_ssm.rwkv6_params(RCtx("init", jax.random.PRNGKey(1), jnp.float32), rcfg)


@functools.lru_cache(maxsize=None)
def _ref_mamba():
    rcfg, _ = _cfgs("zamba2-7b")
    return r_ssm.mamba2_params(RCtx("init", jax.random.PRNGKey(2), jnp.float32), rcfg)


def _carried(ref):
    return ref, params_from_numpy(_np(ref), "cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


def test_token_shift():
    x = _x((2, 5, 3), 0)
    last = _x((2, 1, 3), 1)
    for carried in (None, last):
        want = r_ssm._token_shift(jnp.asarray(x), None if carried is None else jnp.asarray(carried))
        got = p_ssm._token_shift(_t(x), None if carried is None else _t(carried))
        assert max_abs_diff(want, got) == 0.0


@pytest.mark.parametrize("T", [32, 7, 1], ids=["chunked", "steps", "one_step"])
def test_rwkv6_time_mix_matches(T):
    """T = 32 takes the chunked form (2 chunks of 16), 7 and 1 the step-by-
    step recurrence; from a carried state and last input, as a cache gives
    them."""
    rcfg, pcfg = _cfgs("rwkv6-1.6b")
    rp, pp = _carried(_ref_rwkv()["tm"])
    x = _x((2, T, pcfg.d_model), 3)
    state = _x((2, 2, 64, 64), 4, 0.1)
    last = _x((2, 1, pcfg.d_model), 5)
    r_y, (r_s, r_last) = r_ssm.rwkv6_time_mix(rcfg, rp, jnp.asarray(x), state=jnp.asarray(state),
                                              last_x=jnp.asarray(last))
    p_y, (p_s, p_last) = p_ssm.rwkv6_time_mix(pcfg, pp, _t(x), state=_t(state), last_x=_t(last))
    assert p_y.shape == (2, T, pcfg.d_model) and p_s.dtype == torch.float32
    assert max_abs_diff(r_y, p_y) < TOL
    assert max_abs_diff(r_s, p_s) < TOL
    assert max_abs_diff(r_last, p_last) == 0.0


def test_rwkv6_chunked_equals_steps_and_carries_its_state():
    """The chunked form against the recurrence on the same inputs, and two
    segments of 16 (the state and last input carried) against one of 32."""
    _, pcfg = _cfgs("rwkv6-1.6b")
    _, pp = _carried(_ref_rwkv()["tm"])
    x = _t(_x((2, 32, pcfg.d_model), 6))
    y, (S, last) = p_ssm.rwkv6_time_mix(pcfg, pp, x)
    steps_cfg = pcfg.replace(ssm=dataclasses.replace(pcfg.ssm, chunk_len=1))
    y_steps, (S_steps, _) = p_ssm.rwkv6_time_mix(steps_cfg, pp, x)
    assert max_abs_diff(y, y_steps) < TOL and max_abs_diff(S, S_steps) < TOL
    y1, (S1, last1) = p_ssm.rwkv6_time_mix(pcfg, pp, x[:, :16])
    y2, (S2, last2) = p_ssm.rwkv6_time_mix(pcfg, pp, x[:, 16:], state=S1, last_x=last1)
    assert max_abs_diff(y, torch.cat([y1, y2], dim=1)) < TOL
    assert max_abs_diff(S, S2) < TOL and torch.equal(last, last2)


def test_rwkv6_chunked_gradients_are_finite_at_strong_decay():
    """w0 = 4 (log decay -e^4 per step) makes the differences above the
    diagonal ~+870 over a chunk: masked before the exp, the gradients stay
    finite, as the reference's do."""
    _, pcfg = _cfgs("rwkv6-1.6b")
    _, pp = _carried(_ref_rwkv()["tm"])
    pp = dict(pp, w0=torch.full_like(pp["w0"], 4.0))
    ps = {k: v.clone().requires_grad_(True) for k, v in pp.items()}
    y, _ = p_ssm.rwkv6_time_mix(pcfg, ps, _t(_x((1, 32, pcfg.d_model), 7)))
    grads = torch.autograd.grad(y.square().sum(), list(ps.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_rwkv6_channel_mix_matches():
    rcfg, pcfg = _cfgs("rwkv6-1.6b")
    rp, pp = _carried(_ref_rwkv()["cm"])
    x = _x((2, 9, pcfg.d_model), 8)
    last = _x((2, 1, pcfg.d_model), 9)
    r_y, r_last = r_ssm.rwkv6_channel_mix(rcfg, rp, jnp.asarray(x), last_x=jnp.asarray(last))
    p_y, p_last = p_ssm.rwkv6_channel_mix(pcfg, pp, _t(x), last_x=_t(last))
    assert max_abs_diff(r_y, p_y) < TOL and max_abs_diff(r_last, p_last) == 0.0


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def test_causal_conv_matches_with_its_state():
    """The depthwise conv (K = 4) from zeros and from a carried state, and
    two segments with the state carried against one."""
    x = _x((2, 10, 24), 10)
    w = _x((24, 4), 11, 0.3)
    b = _x((24,), 12, 0.1)
    state = _x((2, 3, 24), 13)
    for carried in (None, state):
        r_out, r_st = r_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                         None if carried is None else jnp.asarray(carried))
        p_out, p_st = p_ssm._causal_conv(_t(x), _t(w), _t(b),
                                         None if carried is None else _t(carried))
        assert max_abs_diff(r_out, p_out) < 1e-6 and max_abs_diff(r_st, p_st) == 0.0
    whole, st = p_ssm._causal_conv(_t(x), _t(w), _t(b))
    a, st_a = p_ssm._causal_conv(_t(x[:, :6]), _t(w), _t(b))
    c, st_c = p_ssm._causal_conv(_t(x[:, 6:]), _t(w), _t(b), st_a)
    assert max_abs_diff(whole, torch.cat([a, c], dim=1)) < 1e-6 and torch.equal(st, st_c)


@pytest.mark.parametrize("T", [32, 12], ids=["two_chunks", "one_short_chunk"])
def test_mamba2_forward_matches(T):
    """T = 32 runs 2 chunks of 16, T = 12 one chunk of 12; from a carried
    SSM and conv state."""
    rcfg, pcfg = _cfgs("zamba2-7b")
    rp, pp = _carried(_ref_mamba())
    x = _x((2, T, pcfg.d_model), 14)
    s = pcfg.ssm
    H, C = s.expand * pcfg.d_model // s.head_dim, s.expand * pcfg.d_model + 2 * s.d_state
    state = _x((2, H, s.d_state, s.head_dim), 15, 0.1)
    conv = _x((2, s.conv_kernel - 1, C), 16)
    r_y, (r_s, r_c) = r_ssm.mamba2_forward(rcfg, rp, jnp.asarray(x), state=jnp.asarray(state),
                                           conv_state=jnp.asarray(conv))
    p_y, (p_s, p_c) = p_ssm.mamba2_forward(pcfg, pp, _t(x), state=_t(state), conv_state=_t(conv))
    assert p_y.shape == (2, T, pcfg.d_model) and p_s.shape == (2, H, s.d_state, s.head_dim)
    assert max_abs_diff(r_y, p_y) < TOL
    assert max_abs_diff(r_s, p_s) < TOL and max_abs_diff(r_c, p_c) < TOL


def test_mamba2_decode_steps_match_the_forward_and_the_reference():
    """Prefill 16 positions, then 8 decode steps: each against the chunked
    forward over 32 positions (causal: position t sees 0..t), and against
    the reference's step."""
    rcfg, pcfg = _cfgs("zamba2-7b")
    rp, pp = _carried(_ref_mamba())
    x = _x((2, 32, pcfg.d_model), 17)
    full, _ = p_ssm.mamba2_forward(pcfg, pp, _t(x))
    _, (p_s, p_c) = p_ssm.mamba2_forward(pcfg, pp, _t(x[:, :16]))
    _, (r_s, r_c) = r_ssm.mamba2_forward(rcfg, rp, jnp.asarray(x[:, :16]))
    r_step = jax.jit(functools.partial(r_ssm.mamba2_decode, rcfg))
    for t in range(16, 24):
        r_y, (r_s, r_c) = r_step(rp, jnp.asarray(x[:, t:t + 1]), r_s, r_c)
        p_y, (p_s, p_c) = p_ssm.mamba2_decode(pcfg, pp, _t(x[:, t:t + 1]), p_s, p_c)
        assert max_abs_diff(full[:, t:t + 1], p_y) < TOL
        assert max_abs_diff(r_y, p_y) < TOL
    assert max_abs_diff(r_s, p_s) < TOL


def test_mamba2_forward_refuses_a_ragged_length():
    _, pcfg = _cfgs("zamba2-7b")
    _, pp = _carried(_ref_mamba())
    with pytest.raises(ValueError, match="T=20 is not a multiple of the chunk 16"):
        p_ssm.mamba2_forward(pcfg, pp, _t(_x((1, 20, pcfg.d_model), 18)))


# ---------------------------------------------------------------------------
# C7: Mamba2's gradients at the published chunk length
# ---------------------------------------------------------------------------

ZAMBA = "zamba2-7b"


def _zamba_grads(chunk_len, batch, port):
    """Gradients of reduced Zamba2's loss (f32) at a Mamba2 chunk of
    ``chunk_len``, through the port (the reference's params carried across)
    or through the reference; and the loss."""
    rcfg, pcfg = _cfgs(ZAMBA)
    rp = jax.jit(RModel(rcfg).init)(jax.random.PRNGKey(0))
    if not port:
        cfg = rcfg.replace(ssm=dataclasses.replace(rcfg.ssm, chunk_len=chunk_len))
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: RModel(cfg).loss(p, b)[0]))(
            rp, {k: jnp.asarray(v) for k, v in batch.items()})
        return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]
    cfg = pcfg.replace(ssm=dataclasses.replace(pcfg.ssm, chunk_len=chunk_len), remat="none")
    ps = tree_map(lambda t: t.requires_grad_(True), params_from_numpy(_np(rp), "cpu"))
    loss, _ = Model(cfg).loss(ps, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(loss.detach()), torch.autograd.grad(loss, tree_leaves(ps))


def test_mamba2_gradients_are_finite_at_the_published_chunk():
    """C7: reduced Zamba2 in f32, B = 2, T = 128. At chunk_len 128 (the full
    config's) the reference exps its decay within a chunk before it masks
    it: above the diagonal the exp overflows and its gradient, 0 * inf, is
    NaN in most leaves, while its loss is finite. The port masks before the
    exp: at 128 its gradients are finite and equal the reference's at
    chunk 16 (the same function) within 1e-4 of each leaf's max |grad|, and
    its loss equals the reference's."""
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, 512, (2, 128)).astype(np.int32) for k in ("tokens", "targets")}
    ref_loss_128, ref_128 = _zamba_grads(128, batch, port=False)
    assert np.isfinite(ref_loss_128)
    assert sum(bool(np.isnan(g).any()) for g in ref_128) > len(ref_128) // 2
    _, want = _zamba_grads(16, batch, port=False)
    loss, got = _zamba_grads(128, batch, port=True)
    assert len(got) == len(want) == len(ref_128)
    for w, g in zip(want, got):
        assert bool(torch.isfinite(g).all())
        assert max_abs_diff(w, g) <= TOL * float(np.max(np.abs(w)))
    assert abs(loss - ref_loss_128) < TOL
