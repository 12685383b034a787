"""Port parity for the vision stub and Phi-3-vision on the CPU: the config,
the params' tree with ``patch_proj``, reduced Phi-3-vision's loss and one
train step on the trainer's batches (8 patch embeddings before 24 tokens)
against ``repro``, and the cache position after a prefill with patches,
where the port departs from the reference (ROADMAP Queue 3, C6). The
reference's params are carried across by ``repro_torch.convert``; torch
runs on one thread (``one_torch_thread``).

Tolerances: the loss and the logits within 1e-4 in f32
(``tests/test_torch_lm.py``'s bound); a train step's loss and grad norm
within 1e-4 of their size and the params within 0.05 of the learning rate
(``tests/test_torch_trainer.py``'s)."""

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
from repro.launch.steps import build_train_step as r_build_train_step
from repro.launch.steps import make_optimizer as r_make_optimizer
from repro.models import VLM_PATCH_TOKENS as R_VLM_PATCH_TOKENS
from repro.models import Model as RModel
from repro_torch import configs as p_configs
from repro_torch.configs import TrainConfig
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as p_steps
from repro_torch.models import VLM_PATCH_TOKENS, Model
from repro_torch.utils import tree_leaves

from _torch_parity import max_abs_diff, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "phi-3-vision-4.2b"
F32 = dict(dtype="float32", param_dtype="float32")
LOSS_TOL = 1e-4
LOGIT_TOL = 1e-4
STEP_RTOL = 1e-4
PARAM_STEP_ATOL = 0.05  # of the learning rate, per step
# the reference's first decode step after P patches: its query roped P
# positions early and a live cache slot overwritten; its logits differ from
# the full prefill's by 2.56 here (max |logit| 3.20), far above this floor
REF_C6_FLOOR = 1e-2


def _cfgs():
    """Reduced Phi-3-vision of both packages in f32 (2 layers, d 64, 4
    heads of 16, d_ff 128, vocab 512)."""
    return r_get_reduced(ARCH).replace(**F32), p_configs.get_reduced(ARCH).replace(**F32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_params():
    return jax.jit(RModel(_cfgs()[0]).init)(jax.random.PRNGKey(0))


def _carried():
    rp = _ref_params()
    return rp, params_from_numpy(_np(rp), "cpu")


def _batch(cfg, seed=3, B=2, S=32):
    """The trainer's batch: 8 patch embeddings, then S - 8 tokens."""
    b = token_batch_for(cfg, batch=B, seq=S, seed=seed)
    assert b["patch_embed"].shape == (B, 8, cfg.d_model) and b["tokens"].shape == (B, S - 8)
    return b


def test_config_is_the_reference_config():
    for r_get, p_get in ((r_get_config, p_configs.get_config),
                         (r_get_reduced, p_configs.get_reduced)):
        assert dataclasses.asdict(r_get(ARCH)) == dataclasses.asdict(p_get(ARCH))
    full = p_configs.get_config(ARCH)
    assert full.param_count() == r_get_config(ARCH).param_count() == 3_822_059_520
    assert full.resolved_head_dim == 96 and full.frontend == "vision_stub"
    assert VLM_PATCH_TOKENS == R_VLM_PATCH_TOKENS == 256
    # the tree also holds patch_proj [d, d] and the norms, which the count leaves out
    d, L = full.d_model, full.n_layers
    tree = sum(t.numel() for t in tree_leaves(Model(full).abstract_params()))
    assert tree == full.param_count() + d * d + (2 * L + 1) * d == 3_831_696_384


def test_init_tree_matches_reference_layout():
    rcfg, pcfg = _cfgs()
    ref = jax.eval_shape(lambda: RModel(rcfg).init(jax.random.PRNGKey(0)))
    got = Model(pcfg).init(torch.Generator().manual_seed(0))
    assert tuple(got["patch_proj"].shape) == (pcfg.d_model, pcfg.d_model)
    r_leaves = jax.tree_util.tree_leaves_with_path(ref)
    p_leaves = tree_leaves(got)
    assert len(r_leaves) == len(p_leaves)
    for (_, r), p in zip(r_leaves, p_leaves):
        assert tuple(p.shape) == r.shape


def test_loss_matches_reference():
    rcfg, pcfg = _cfgs()
    rp, pp = _carried()
    b = _batch(rcfg)
    rl, rm = jax.jit(RModel(rcfg).loss)(rp, {k: jnp.asarray(v) for k, v in b.items()})
    pl, pm = Model(pcfg).loss(pp, {k: torch.as_tensor(v) for k, v in b.items()})
    assert sorted(pm) == sorted(rm)
    assert abs(float(rl) - float(pl)) < LOSS_TOL
    assert abs(float(rm["accuracy"]) - float(pm["accuracy"])) < LOSS_TOL
    # the patches change the loss: without them it is another number
    no_patch = {k: torch.as_tensor(v) for k, v in b.items() if k != "patch_embed"}
    assert abs(float(Model(pcfg).loss(pp, no_patch)[0]) - float(pl)) > 1e-3


def test_train_step_matches_reference():
    """One Adafactor step of the port's train step and the reference's (jit
    on the host mesh) on the trainer's batch, from the same params."""
    rcfg, pcfg = _cfgs()
    kw = dict(optimizer="adafactor", learning_rate=2e-3, total_steps=4, warmup_steps=1)
    B, S = 2, 32
    mesh = make_host_mesh()
    # the shape only names the input shardings: the stub's 256 patches and
    # the tokens after them
    shape = ShapeSpec("t", "train", R_VLM_PATCH_TOKENS + S, B)
    built = r_build_train_step(rcfg, RTrainConfig(**kw), shape, mesh)
    rp, pp = _carried()
    rp = jax.tree.map(jnp.array, rp)  # a copy: the step donates its state
    r_state = {"params": rp, "opt": r_make_optimizer(RTrainConfig(**kw)).init(rp),
               "step": jnp.int32(0)}
    tcfg = TrainConfig(**kw)
    p_state = {"params": pp, "opt": p_steps.make_optimizer(tcfg).init(pp),
               "step": torch.zeros((), dtype=torch.int32)}
    batch = _batch(rcfg, seed=0, B=B, S=S)
    with mesh_context(mesh):
        r_fn = jax.jit(built.fn, in_shardings=built.in_shardings, out_shardings=built.out_shardings)
        r_state, r_m = r_fn(r_state, {k: jnp.asarray(v) for k, v in batch.items()})
    p_state, p_m = p_steps.build_train_step(pcfg, tcfg)(
        p_state, {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        assert abs(float(r_m[k]) - float(p_m[k])) <= STEP_RTOL * abs(float(r_m[k])), k
    gap = max(float(np.max(np.abs(a - b.detach().numpy()))) for a, b in
              zip(jax.tree.leaves(_np(r_state["params"])), tree_leaves(p_state["params"])))
    assert gap <= PARAM_STEP_ATOL * kw["learning_rate"]
    moved = p_state["params"]["patch_proj"].numpy() - _np(_ref_params())["patch_proj"]
    assert float(np.max(np.abs(moved))) > 0


def test_decode_after_patches_matches_the_full_prefill():
    """C6: prefill P = 8 patches and S - 1 = 23 tokens, then decode token S:
    its logits against the full prefill's (P patches and S tokens) last
    logits. The port sets ``pos`` to P + S - 1 after the prefill and is
    within 1e-4; the reference sets it to S - 1, writes slot S - 1 (a patch
    position) and ropes the query there, and is off by more than 1e-2."""
    rcfg, pcfg = _cfgs()
    rp, pp = _carried()
    b = _batch(rcfg, seed=5)
    toks, patches = b["tokens"], b["patch_embed"]  # [2, 24], [2, 8, d]
    P, S = patches.shape[1], toks.shape[1]

    rm, pm = RModel(rcfg), Model(pcfg)
    r_full, _ = jax.jit(lambda p, b: rm.prefill(p, b, 32))(
        rp, {"tokens": jnp.asarray(toks), "patch_embed": jnp.asarray(patches)})
    r_short, r_cache = jax.jit(lambda p, b: rm.prefill(p, b, 32))(
        rp, {"tokens": jnp.asarray(toks[:, :-1]), "patch_embed": jnp.asarray(patches)})
    r_step, _ = jax.jit(rm.decode_step)(rp, r_cache, jnp.asarray(toks[:, -1:]))

    p_full, _ = pm.prefill(pp, {"tokens": torch.from_numpy(toks),
                                "patch_embed": torch.from_numpy(patches)}, 32)
    p_short, p_cache = pm.prefill(pp, {"tokens": torch.from_numpy(toks[:, :-1]),
                                       "patch_embed": torch.from_numpy(patches)}, 32)
    assert p_cache["seg0"]["pos"].unique().tolist() == [P + S - 1]
    assert np.unique(np.asarray(r_cache["seg0"]["pos"])).tolist() == [S - 1]
    p_step, p_cache = pm.decode_step(pp, p_cache, torch.from_numpy(toks[:, -1:]))
    assert p_cache["seg0"]["pos"].unique().tolist() == [P + S]

    # the prefills agree (the difference is in the cache's pos only)
    assert max_abs_diff(r_full, p_full) < LOGIT_TOL
    assert max_abs_diff(r_short, p_short) < LOGIT_TOL
    assert max_abs_diff(p_full, p_step) < LOGIT_TOL
    assert max_abs_diff(r_full, r_step) > REF_C6_FLOOR
