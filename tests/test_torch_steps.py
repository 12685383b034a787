"""Port parity for the sharded steps (``repro_torch.launch.steps``) against
the reference's ``BuiltStep``s run under ``jit`` on its host mesh, the port
of ``tests/test_launch_steps.py``: the port's built steps on a 1 x 1 (and a
1 x 1 x 1 pod) ``gloo`` mesh on the CPU, from the reference's params
carried by ``convert``, in f32, one layer deep.

- Train steps (Qwen3-8B, and Mixtral through ``ep_a2a``, which both
  packages pick on a 1 x 1 mesh), Adafactor, 2 microbatches, two steps: loss and grad
  norm within ``STEP_RTOL``, params within ``PARAM_STEP_ATOL`` of the
  learning rate per step (``tests/test_torch_trainer.py``'s bounds).
- A prefill then a decode step: logits within 1e-4, every cache leaf
  within 1e-5.
- (``tests/test_torch_local_sgd.py``: local-SGD on a pod mesh and the
  outer sync.)
- The abstract parts: the dry-run's ``input_specs`` check, the optimizer
  state's specs (``_mirror_state_shardings``) and ``pick_moe_path`` for
  every full config and shape on the production meshes, against the
  reference's."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import GRID_ARCHS
from repro.configs import TrainConfig as RTrainConfig
from repro.configs import get_config as r_get_config
from repro.configs import get_reduced as r_get_reduced
from repro.configs.base import ShapeSpec as RShapeSpec
from repro.data.tokens import token_batch_for
from repro.launch import steps as r_steps
from repro.launch.mesh import make_host_mesh, mesh_context
from repro.models import Model as RModel
from repro.models import moe_sharded as r_moe
from repro.sharding import spec_for_leaf as r_spec_for_leaf
from repro_torch.configs import TrainConfig, get_config, get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as p_steps
from repro_torch.launch.mesh import MeshShape, make_device_mesh
from repro_torch.models import Model
from repro_torch.models import moe_sharded as p_moe
from repro_torch.sharding import param_shardings
from repro_torch.sharding.rules import full_tree
from repro_torch.utils import tree_map

from _torch_parity import one_torch_thread, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STEP_RTOL = 1e-4
PARAM_STEP_ATOL = 0.05  # of the learning rate, per step
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
OUTER_RTOL = 1e-6
F32 = dict(dtype="float32", param_dtype="float32", loss_chunk=0, n_layers=1)
KW = dict(learning_rate=2e-3, total_steps=10, warmup_steps=1, microbatches=2,
          optimizer="adafactor")


def _cfgs(arch):
    return r_get_reduced(arch).replace(**F32), get_reduced(arch).replace(**F32)


def _mesh(*shape):
    names = ("pod", "data", "model")[3 - len(shape):]
    return make_device_mesh(MeshShape(names, shape), device="cpu")


def _r_jit(built, mesh):
    return jax.jit(built.fn, in_shardings=built.in_shardings, out_shardings=built.out_shardings)


def _leaf_gaps(want, got):
    w, g = jax.tree.leaves(to_np(want)), jax.tree.leaves(to_np(got))
    assert len(w) == len(g)
    return [(float(np.max(np.abs(a - b))), float(np.max(np.abs(a)))) for a, b in zip(w, g)]


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's params (f32, one layer) as numpy, drawn once."""
    rcfg = _cfgs(arch)[0]
    return jax.tree.map(np.asarray, jax.jit(RModel(rcfg).init)(jax.random.PRNGKey(0)))


def _states(rcfg, tcfg_kw, arch, stack=0):
    params = _ref_params(arch)
    r_opt = r_steps.make_optimizer(RTrainConfig(**tcfg_kw))
    rp = jax.tree.map(jnp.asarray, params)
    r_state = {"params": rp, "opt": r_opt.init(rp), "step": jnp.int32(0)}
    pp = params_from_numpy(params, "cpu")
    p_state = {"params": pp, "opt": p_steps.make_optimizer(TrainConfig(**tcfg_kw)).init(pp),
               "step": torch.zeros((), dtype=torch.int32)}
    if stack:
        r_state = jax.tree.map(lambda a: jnp.stack([a] * stack), r_state)
        p_state = tree_map(lambda t: torch.stack([t] * stack), p_state)
    return params, r_state, p_state


@pytest.mark.parametrize("arch", ["qwen3-8b", "mixtral-8x7b"])
def test_train_step_matches_the_reference_built_step(arch):
    rcfg, pcfg = _cfgs(arch)
    B, S = 4, 16
    r_mesh, p_mesh = make_host_mesh(), _mesh(1, 1)
    r_built = r_steps.build_train_step(rcfg, RTrainConfig(**KW), RShapeSpec("t", "train", S, B),
                                       r_mesh)
    p_built = p_steps.build_train_step(pcfg, TrainConfig(**KW), ShapeSpec("t", "train", S, B),
                                       p_mesh)
    assert p_built.name == r_built.name and p_built.donate_argnums == r_built.donate_argnums
    _, r_state, p_state = _states(rcfg, KW, arch)
    with mesh_context(r_mesh):
        r_fn = _r_jit(r_built, r_mesh)
        for i in range(2):
            batch = token_batch_for(rcfg, batch=B, seq=S, seed=i)
            r_state, r_m = r_fn(r_state, {k: jnp.asarray(v) for k, v in batch.items()})
            p_state, p_m = p_steps.run_built(p_built, p_mesh, p_state,
                                             {k: torch.as_tensor(v) for k, v in batch.items()})
            p_m = full_tree(p_m)
            assert sorted(p_m) == sorted(r_m)
            for k in ("loss", "grad_norm", "aux"):
                assert abs(float(r_m[k]) - float(p_m[k])) <= STEP_RTOL * max(abs(float(r_m[k])), 1e-6), k
            gap = max(g for g, _ in _leaf_gaps(r_state["params"], full_tree(p_state["params"])))
            assert gap <= PARAM_STEP_ATOL * KW["learning_rate"] * (i + 1)
    assert int(full_tree({"s": p_state["step"]})["s"]) == 2


def test_prefill_then_decode_match_the_reference_built_steps():
    rcfg, pcfg = _cfgs("qwen3-8b")
    r_mesh, p_mesh = make_host_mesh(), _mesh(1, 1)
    params = _ref_params("qwen3-8b")
    rp, pp = jax.tree.map(jnp.asarray, params), params_from_numpy(params, "cpu")
    toks = np.random.default_rng(1).integers(0, rcfg.vocab_size, (2, 32)).astype(np.int32)
    pre_shape, dec_shape = ("p", "prefill", 32, 2), ("d", "decode", 32, 2)
    r_pre = r_steps.build_prefill_step(rcfg, RShapeSpec(*pre_shape), r_mesh)
    r_dec = r_steps.build_decode_step(rcfg, RShapeSpec(*dec_shape), r_mesh)
    p_pre = p_steps.build_prefill_step(pcfg, ShapeSpec(*pre_shape), p_mesh)
    p_dec = p_steps.build_decode_step(pcfg, ShapeSpec(*dec_shape), p_mesh)
    with mesh_context(r_mesh):
        r_logits, r_cache = _r_jit(r_pre, r_mesh)(rp, {"tokens": jnp.asarray(toks)})
        nxt = np.asarray(jnp.argmax(r_logits, -1)[:, None]).astype(np.int32)
        r_logits2, r_cache = jax.jit(r_dec.fn, in_shardings=r_dec.in_shardings,
                                     out_shardings=r_dec.out_shardings)(rp, r_cache, jnp.asarray(nxt))
    p_logits, p_cache = p_steps.run_built(p_pre, p_mesh, pp, {"tokens": torch.as_tensor(toks)})
    assert float(np.max(np.abs(np.asarray(r_logits) - p_logits.full_tensor().numpy()))) <= LOGIT_TOL
    p_logits2, p_cache = p_steps.run_built(p_dec, p_mesh, pp, p_cache, torch.as_tensor(nxt))
    assert float(np.max(np.abs(np.asarray(r_logits2) - p_logits2.full_tensor().numpy()))) <= LOGIT_TOL
    for gap, _ in _leaf_gaps(r_cache, full_tree(p_cache)):
        assert gap <= CACHE_TOL
    assert int(full_tree(p_cache)["seg0"]["pos"].min()) == 33


def test_input_specs_cover_every_model_input():
    """``tests/test_launch_steps.py::test_dryrun_cell_runner_smoke`` on the
    port: every grid arch's ``input_specs`` of every valid shape carry the
    tokens, each input with the shape's global batch."""
    for arch in GRID_ARCHS:
        cfg = get_config(arch)
        m = Model(cfg)
        for shape in cfg.valid_shapes():
            specs = m.input_specs(shape)
            assert "tokens" in specs
            for k, v in specs.items():
                assert v.shape[0] == shape.global_batch, (arch, shape.name, k)


class _FakeMesh:
    """Duck-typed mesh: axis names and a devices array's shape."""

    def __init__(self, names, shape):
        self.axis_names = names
        self.devices = np.empty(shape)


PROD = [(("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16))]


def _r_named(spec_tree, mesh):
    return jax.tree.map(lambda s: NamedSharding(mesh, P(*s)), spec_tree,
                        is_leaf=lambda x: isinstance(x, tuple))


@pytest.mark.parametrize("arch", GRID_ARCHS)
def test_state_specs_and_moe_paths_match_on_the_production_meshes(arch):
    rcfg, pcfg = r_get_config(arch), get_config(arch)
    for names, shape in PROD:
        abstract = jax.sharding.AbstractMesh(shape, names)
        fake, p_mesh = _FakeMesh(names, shape), MeshShape(names, shape)
        r_abs, p_abs = RModel(rcfg).abstract_params(), Model(pcfg).abstract_params()
        r_specs = jax.tree.map(
            lambda leaf, axes: tuple(r_spec_for_leaf(tuple(leaf.shape), tuple(axes), fake)),
            r_abs, RModel(rcfg).param_axes(), is_leaf=lambda x: isinstance(x, tuple))
        p_specs = param_shardings(p_abs, Model(pcfg).param_axes(), p_mesh)
        for opt in ("adamw", "adafactor"):
            r_opt = r_steps.make_optimizer(RTrainConfig(optimizer=opt))
            r_state = jax.eval_shape(r_opt.init, r_abs)
            want = r_steps._mirror_state_shardings(
                r_state, jax.tree.structure(r_abs), _r_named(r_specs, abstract), abstract,
                abstract_params=r_abs)
            p_state = p_steps.make_optimizer(TrainConfig(optimizer=opt)).init(p_abs)
            got = p_steps._mirror_state_shardings(p_state, p_abs, p_specs)
            want = jax.tree.map(lambda s: tuple(s.spec), want,
                                is_leaf=lambda x: isinstance(x, NamedSharding))
            assert _specs_equal(want, got), (arch, opt)
        if pcfg.moe is not None:
            r_cfg = r_steps._with_act_sharding(rcfg, fake)
            p_cfg = p_steps._with_act_sharding(pcfg, p_mesh)
            for s in pcfg.valid_shapes():
                B, S = s.global_batch, (1 if s.kind == "decode" else s.seq_len)
                assert p_moe.pick_moe_path(p_cfg, B, S) == r_moe.pick_moe_path(r_cfg, B, S)


def _specs_equal(want, got) -> bool:
    """Spec trees equal entry for entry (trailing Nones aside)."""
    if isinstance(want, dict):
        return isinstance(got, dict) and want.keys() == got.keys() and all(
            _specs_equal(want[k], got[k]) for k in want)
    def strip(spec):
        spec = list(spec)
        while spec and spec[-1] is None:
            spec.pop()
        return tuple(spec)

    return strip(want) == strip(got)


def test_pick_moe_path_on_the_host_mesh():
    """Both packages pick ``ep_a2a`` on a 1 x 1 mesh, gather without one."""
    rcfg, pcfg = _cfgs("mixtral-8x7b")
    assert p_moe.pick_moe_path(pcfg, 4, 16) == r_moe.pick_moe_path(rcfg, 4, 16) == "gather"
    one = _FakeMesh(("data", "model"), (1, 1))
    r_cfg = r_steps._with_act_sharding(rcfg, one)
    p_cfg = p_steps._with_act_sharding(pcfg, MeshShape(("data", "model"), (1, 1)))
    assert p_moe.pick_moe_path(p_cfg, 4, 16) == r_moe.pick_moe_path(r_cfg, 4, 16) == "ep_a2a"
    forced = p_cfg.replace(moe=dataclasses.replace(p_cfg.moe, impl="einsum"))
    assert p_moe.pick_moe_path(forced, 4, 16) == "einsum"
