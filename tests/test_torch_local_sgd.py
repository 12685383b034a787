"""Port parity for local-SGD over pods and the outer sync
(``repro_torch.launch.steps``) against the reference's ``BuiltStep``s:
two local-SGD steps on a (1, 1, 1) ("pod", "data", "model") ``gloo`` mesh
against the reference's on its (1, 1, 1) mesh, then the outer sync
uncompressed and int8 from the port's replicas in both packages: the
replicas within ``PARAM_STEP_ATOL`` of the learning rate per step, the new
anchor, the outer momentum and the reset replicas within 1e-6 of each
leaf's max. Helpers and bounds are ``tests/test_torch_steps.py``'s."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as RTrainConfig
from repro.configs.base import ShapeSpec as RShapeSpec
from repro.data.tokens import token_batch_for
from repro.launch import steps as r_steps
from repro.launch.mesh import _mesh as r_make_mesh
from repro.launch.mesh import mesh_context
from repro.optim import nesterov_outer as r_outer
from repro_torch.configs import TrainConfig
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps as p_steps
from repro_torch.sharding.rules import full_tree
from repro_torch.utils import tree_map

from _torch_parity import one_torch_thread, to_np  # noqa: F401
from test_torch_steps import (
    KW, OUTER_RTOL, PARAM_STEP_ATOL, STEP_RTOL, _cfgs, _leaf_gaps, _mesh, _r_jit, _states,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_local_sgd_and_outer_sync_match_the_reference():
    """Two local-SGD steps on a (1, 1, 1) pod mesh, then the outer sync
    (none, int8) from the port's replicas in both packages."""
    rcfg, pcfg = _cfgs("qwen3-8b")
    kw = dict(KW, microbatches=1)
    B, S = 4, 16
    r_mesh = r_make_mesh((1, 1, 1), ("pod", "data", "model"))
    p_mesh = _mesh(1, 1, 1)
    shape = ("t", "train", S, B)
    r_built = r_steps.build_train_step(rcfg, RTrainConfig(**kw), RShapeSpec(*shape), r_mesh,
                                       mode="local_sgd")
    p_built = p_steps.build_train_step(pcfg, TrainConfig(**kw), ShapeSpec(*shape), p_mesh,
                                       mode="local_sgd")
    params, r_state, p_state = _states(rcfg, kw, "qwen3-8b", stack=1)
    with mesh_context(r_mesh):
        r_fn = _r_jit(r_built, r_mesh)
        for i in range(2):
            batch = {k: v[None] for k, v in token_batch_for(rcfg, batch=B, seq=S, seed=i).items()}
            r_state, r_m = r_fn(r_state, {k: jnp.asarray(v) for k, v in batch.items()})
            p_state, p_m = p_steps.run_built(p_built, p_mesh, p_state,
                                             {k: torch.as_tensor(v) for k, v in batch.items()})
            assert abs(float(r_m["loss"][0]) - float(full_tree(p_m)["loss"][0])) <= \
                STEP_RTOL * float(r_m["loss"][0])
        replicas = full_tree(p_state["params"])
        gap = max(g for g, _ in _leaf_gaps(r_state["params"], replicas))
        assert gap <= PARAM_STEP_ATOL * kw["learning_rate"] * 2
        np_replicas = to_np(replicas)
        for comp in ("none", "int8"):
            r_sync = r_steps.build_outer_sync(rcfg, RTrainConfig(**kw), r_mesh, compression=comp)
            p_sync = p_steps.build_outer_sync(pcfg, TrainConfig(**kw), p_mesh, compression=comp)
            rt = RTrainConfig(**kw)
            anchor = jax.tree.map(jnp.asarray, params)
            r_o = r_outer(rt.outer_lr, rt.outer_momentum).init(anchor)
            r_new, r_anchor, r_ost = _r_jit(r_sync, r_mesh)(
                jax.tree.map(jnp.asarray, np_replicas), anchor, r_o, jnp.int32(2))
            p_new, p_anchor, p_ost = p_steps.run_built(
                p_sync, p_mesh, params_from_numpy(np_replicas, "cpu"),
                params_from_numpy(params, "cpu"),
                tree_map(lambda t: torch.tensor(np.asarray(t)), r_o),
                torch.full((), 2, dtype=torch.int32))
            for got, want in ((p_anchor, r_anchor), (p_ost, r_ost), (p_new, r_new)):
                for gap, top in _leaf_gaps(want, full_tree(got)):
                    assert gap <= OUTER_RTOL * max(top, 1e-30), comp
