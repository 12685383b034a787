"""The port's sharded steps across four ranks on the CPU: one spawn of four
``gloo`` processes (``tests/_torch_multirank.py``) in a module fixture, and
tests that assert on what the ranks return. It rehearses on the CPU what
the card's four-rank runs do over ``nccl``.

- (2, 2) ("data", "model"): a sync train step (2 microbatches, Adafactor)
  and a prefill then a decode step of reduced Qwen3-8B and of reduced
  Phi-3-medium (5 heads padded to 6 on "model") against the same on one
  rank: loss and grad norm within ``STEP_RTOL``, params within
  ``PARAM_ATOL``, logits within 1e-4 and the cache within 1e-5.
- ``moe_sharded``'s three mesh paths on one MoE block at capacities that
  drop tokens: ``ep_a2a`` (tokens over data x model), ``ep_local`` (a
  decode's one token) and ``local`` (3 experts on a 2-way "model"), held to
  the reference's ``_route`` / ``_dispatch_local`` / ``_expert_ffn`` /
  ``_combine_local`` applied shard by shard: outputs within 1e-5, the aux
  within 1e-6, gradients (``jax.grad``) within 1e-4 of each leaf's max.
- The loss with its vocab split over "model" (``loss_from_hidden`` on the
  (2, 2) mesh, chunked and unchunked): h split over "data", an identity
  unembedding, so the logits are h and d logits is d h, exactly; argmax
  ties across the split and targets in the padded columns. Loss, accuracy
  and both gradients within ``XENT_RTOL`` of the reference's
  ``loss_from_hidden`` and ``jax.grad``.
- (2, 2, 1) ("pod", "data", "model"): local-SGD, where pod 0 takes a second
  step with pod 1 sitting it out (a collective across "pod" would time
  out): pod 0's params equal a one-rank run on its batches, and no
  collective in the step names a group across pods; the outer sync, int8
  and uncompressed, equals a plain-torch computation bit for bit, and over
  "pod" the int8 one moves int8 codes and f32 scales only.

Tolerances: f32 sums in another order (the shards' partial sums).

On four cards: ``PYTHONPATH=src:tests python tests/_torch_multirank.py DIR
cuda`` (DIR holding the ``inputs.pkl`` this module's ``_inputs()``
writes), then ``REPRO_MULTIRANK_RESULTS=DIR/rank0.pkl`` with this file."""

import dataclasses
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.configs import get_reduced as r_get_reduced
from repro.data.tokens import token_batch_for
from repro.models import lm as r_lm
from repro.models import Model as RModel
from repro.models import mlp as r_mlp
from repro.models import moe_sharded as r_moe
from repro.models.base import Ctx as RCtx

import _torch_multirank

STEP_RTOL = 1e-4
PARAM_ATOL = 1e-5
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
OUT_TOL = 1e-5
ROUTER_TOL = 1e-6
GRAD_RTOL = 1e-4
F32 = dict(dtype="float32", param_dtype="float32", loss_chunk=0)
LAYERS = 1  # the dense models' depth here: the shards, not the depth, are under test

XENT_RTOL = 1e-6
# the split loss's cases: (name, loss_chunk); 16 positions, a padded vocab of
# 64 (= d_model, the unembedding the identity) over 60 real tokens
XENT_CASES = [("chunked", 4), ("unchunked", 0)]
XENT_V, XENT_VOCAB, XENT_B, XENT_S = 64, 60, 4, 16

# (name, MoE fields, x shape, token shards (data, model))
MOE_CASES = [
    ("ep_a2a", dict(capacity_factor=1.0), (4, 8), (2, 2)),
    ("ep_local", dict(capacity_factor=1.0), (4, 1), (2, 1)),
    ("local", dict(num_experts=3, capacity_factor=1.0), (4, 8), (2, 1)),
]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _moe_cfg(moe):
    base = r_get_reduced("mixtral-8x7b").replace(**F32)
    return base.replace(moe=dataclasses.replace(base.moe, **moe))


@functools.lru_cache(maxsize=None)
def _moe_inputs(name):
    _, moe, (B, S), _ = next(c for c in MOE_CASES if c[0] == name)
    cfg = _moe_cfg(moe)
    p = r_mlp.moe_params(RCtx("init", jax.random.PRNGKey(3), jnp.float32), cfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return cfg, _np(p), x, r


def _xent_cfg(chunk):
    return dict(dtype="float32", param_dtype="float32", loss_chunk=chunk, vocab_size=XENT_VOCAB,
                vocab_pad_to=XENT_V, d_model=XENT_V, tie_embeddings=False)


@functools.lru_cache(maxsize=None)
def _xent_inputs():
    """h [4, 16, 64] (the logits: the unembedding is the identity), targets
    and a 0 / 1 mask. Ties: at 6 positions the row's max sits in a column of
    each model rank's half (the lower column the argmax), the target the
    lower column at 4 of them and the upper at the other 2; at 2 more two
    columns of one half tie, the target the lower at one. 4 targets sit in
    the padded columns 60-63."""
    rng = np.random.default_rng(21)
    h = (3.0 * rng.standard_normal((XENT_B, XENT_S, XENT_V))).astype(np.float32)
    targets = rng.integers(0, XENT_VOCAB, (XENT_B, XENT_S)).astype(np.int32)
    mask = (rng.random((XENT_B, XENT_S)) < 0.75).astype(np.float32)
    half = XENT_V // 2
    spots = [(b, s) for b in range(XENT_B) for s in range(XENT_S)]
    pick = rng.permutation(len(spots))
    for n, i in enumerate(pick[:8]):
        b, s = spots[i]
        lo = int(rng.integers(0, half - 1))
        hi = int(rng.integers(half, XENT_V)) if n < 6 else lo + 1
        h[b, s, lo] = h[b, s, hi] = h[b, s].max() + 1.0
        targets[b, s] = lo if n in (0, 1, 2, 3, 6) else hi
        mask[b, s] = 1.0
    for i in pick[8:12]:
        b, s = spots[i]
        targets[b, s] = int(rng.integers(XENT_VOCAB, XENT_V))
        mask[b, s] = 1.0
    return h, np.eye(XENT_V, dtype=np.float32), {"targets": targets, "loss_mask": mask}


def _inputs():
    out = {"moe": []}
    for arch in ("qwen3-8b", "phi3-medium-14b"):
        cfg = r_get_reduced(arch).replace(**F32, n_layers=LAYERS)
        out[arch] = {
            "params": _np(jax.jit(RModel(cfg).init)(jax.random.PRNGKey(0))),
            "batch": token_batch_for(cfg, batch=4, seq=16, seed=1),
            "prompt": np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32),
        }
    for name, moe, _, _ in MOE_CASES:
        _, p, x, r = _moe_inputs(name)
        out["moe"].append({"name": name, "moe": moe, "p": p, "x": x, "r": r})
    cfg = r_get_reduced("qwen3-8b").replace(**F32, n_layers=LAYERS)

    def pods(seed):
        b = token_batch_for(cfg, batch=4, seq=16, seed=seed)
        return {k: v.reshape((2, 2) + v.shape[1:]) for k, v in b.items()}

    out["local_sgd"] = {"batches": [pods(3), pods(4)]}
    h, unembed, batch = _xent_inputs()
    out["xent"] = [{"name": name, "cfg": _xent_cfg(chunk), "h": h, "unembed": unembed,
                    "batch": batch} for name, chunk in XENT_CASES]
    out["layers"] = LAYERS
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What rank 0 of the four-rank world returns (see the module docstring).
    With ``REPRO_MULTIRANK_RESULTS`` set, the ``rank0.pkl`` of a run made
    elsewhere (four cards over nccl: ``_torch_multirank.py DIR cuda`` on
    the inputs this module writes) is held to the same assertions."""
    done = os.environ.get("REPRO_MULTIRANK_RESULTS")
    if done:
        with open(done, "rb") as f:
            return pickle.load(f)
    root = str(tmp_path_factory.mktemp("multirank"))
    with open(os.path.join(root, "inputs.pkl"), "wb") as f:
        pickle.dump(_inputs(), f)
    world = mp.start_processes(_torch_multirank.main, args=(root,),
                               nprocs=_torch_multirank.WORLD, join=False, start_method="spawn")
    for name, *_ in MOE_CASES:  # the reference's side while the ranks run
        _moe_reference(name)
    for name, _ in XENT_CASES:
        _xent_reference(name)
    while not world.join():
        pass
    with open(os.path.join(root, "rank0.pkl"), "rb") as f:
        return pickle.load(f)


def _arch_results(ranks, arch, what):
    return ranks[f"{arch}/{what}"]


@pytest.mark.parametrize("arch", ["qwen3-8b", "phi3-medium-14b"])
def test_sync_train_step_equals_one_rank(ranks, arch):
    got = _arch_results(ranks, arch, "train")
    for k, (sharded, one) in got["metrics"].items():
        assert abs(sharded - one) <= STEP_RTOL * max(abs(one), 1e-6), k
    assert got["param_gap"] <= PARAM_ATOL
    assert got["opt_rel_gap"] <= STEP_RTOL
    assert got["step"] == 1


@pytest.mark.parametrize("arch", ["qwen3-8b", "phi3-medium-14b"])
def test_prefill_and_decode_equal_one_rank(ranks, arch):
    got = _arch_results(ranks, arch, "serve")
    assert got["prefill_gap"] <= LOGIT_TOL and got["decode_gap"] <= LOGIT_TOL
    assert got["cache_gap"] <= CACHE_TOL
    assert got["pos"] == 13  # 12 prompt tokens, then one decode step


def _shard_ref(cfg, p, x, shards):
    """The reference's MoE block shard by shard: routing over all tokens,
    then dispatch, expert FFN and combine per token shard with its own
    capacity. Returns (y, aux, slots dropped)."""
    m = cfg.moe
    B, S, d = x.shape
    gates, ids, aux = r_moe._route(cfg, p, x.reshape(B * S, d))
    gates, ids = gates.reshape(B, S, -1), ids.reshape(B, S, -1)
    nd, nm = shards
    rows, dropped = [], 0
    for i in range(nd):
        cols = []
        for j in range(nm):
            sl = (slice(i * B // nd, (i + 1) * B // nd), slice(j * S // nm, (j + 1) * S // nm))
            xs, gs, is_ = x[sl], gates[sl], ids[sl]
            T = xs.shape[0] * xs.shape[1]
            C = max(int(m.capacity_factor * m.top_k * T / m.num_experts), 1)
            buf, dest, tok, fg, keep = r_moe._dispatch_local(
                cfg, xs.reshape(T, d), gs.reshape(T, -1), is_.reshape(T, -1), C)
            if not isinstance(keep, jax.core.Tracer):
                dropped += int(np.sum(~np.asarray(keep)))
            yb = r_moe._expert_ffn(p["w_gate"], p["w_up"], p["w_down"], buf)
            out = r_moe._combine_local(yb, dest, tok, fg, keep, T, d, xs.dtype)
            cols.append(out.reshape(xs.shape))
        rows.append(jnp.concatenate(cols, axis=1))
    return jnp.concatenate(rows, axis=0), aux, dropped


@functools.lru_cache(maxsize=None)
def _moe_reference(name):
    """The reference shard by shard on a case: (y, aux, slots dropped, the
    ``jax.grad`` of ``sum(y * r) + aux`` in x and the weights)."""
    shards = next(c[3] for c in MOE_CASES if c[0] == name)
    cfg, p, x, r = _moe_inputs(name)
    p = jax.tree.map(jnp.asarray, p)
    y, aux, dropped = _shard_ref(cfg, p, jnp.asarray(x), shards)

    def loss(p, x):
        y, aux, _ = _shard_ref(cfg, p, x, shards)
        return jnp.sum(y * r) + aux

    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jnp.asarray(x))
    return y, aux, dropped, {"x": want_x, **want_p}


@pytest.mark.parametrize("name", [c[0] for c in MOE_CASES])
def test_moe_path_matches_the_reference_shard_by_shard(ranks, name):
    got = ranks[f"moe/{name}"]
    assert got["path"] == name
    y, aux, dropped, wants = _moe_reference(name)
    assert float(jnp.max(jnp.abs(y - got["y"]))) <= OUT_TOL
    assert abs(float(aux) - got["aux"]) <= ROUTER_TOL
    assert dropped > 0  # the per-shard capacity drops tokens here
    for k, g in got["grads"].items():
        w = np.asarray(wants[k])
        assert float(np.max(np.abs(w - g))) <= GRAD_RTOL * float(np.max(np.abs(w))), k


@functools.lru_cache(maxsize=None)
def _xent_reference(name):
    """The reference's ``loss_from_hidden`` on a case: (loss, accuracy,
    ``jax.grad`` of the loss in h and the unembedding)."""
    chunk = dict(XENT_CASES)[name]
    cfg = r_get_reduced("qwen3-8b").replace(**_xent_cfg(chunk))
    h, unembed, batch = _xent_inputs()
    batch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(w, h):
        return r_lm.loss_from_hidden(cfg, {"unembed": w}, h, batch)

    (val, metrics), (g_w, g_h) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(unembed), jnp.asarray(h))
    return float(val), float(metrics["accuracy"]), np.asarray(g_h), np.asarray(g_w)


def test_split_vocab_inputs_plant_ties_across_the_split():
    h, _, batch = _xent_inputs()
    half = XENT_V // 2
    top = h.max(-1, keepdims=True)
    across = ((h[..., :half] == top).any(-1) & (h[..., half:] == top).any(-1))
    assert across.sum() == 6 and batch["loss_mask"][across].all()
    assert ((batch["targets"] >= XENT_VOCAB) & (batch["loss_mask"] > 0)).sum() >= 4


@pytest.mark.parametrize("name", [c[0] for c in XENT_CASES])
def test_split_vocab_loss_matches_the_reference(ranks, name):
    got = ranks[f"xent/{name}"]
    loss, acc, g_h, g_w = _xent_reference(name)
    assert abs(got["loss"] - loss) <= XENT_RTOL * abs(loss)
    assert abs(got["accuracy"] - acc) <= XENT_RTOL * abs(acc)
    for g, want in ((got["grad_h"], g_h), (got["grad_unembed"], g_w)):
        assert float(np.max(np.abs(g - want))) <= XENT_RTOL * float(np.max(np.abs(want)))


def test_local_sgd_trains_each_pod_alone(ranks):
    got = ranks["local_sgd"]
    assert got["pod0_gap"] <= PARAM_ATOL
    assert got["metrics_shape"] == (2,)
    pods = ({0, 1}, {2, 3})
    for name, group, _ in got["calls"]:
        assert set(group) <= pods[0] or set(group) <= pods[1], (name, group)


@pytest.mark.parametrize("comp", ["int8", "none"])
def test_outer_sync_matches_plain_torch(ranks, comp):
    got = ranks[f"outer/{comp}"]
    assert got["anchor_equal"] and got["m_equal"] and got["replicas_reset"] and got["changed"]
    want = ["torch.float32", "torch.int8"] if comp == "int8" else ["torch.float32"]
    assert got["pod_dtypes"] == want
