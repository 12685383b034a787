"""Port parity for ``repro_torch.models.moe_sharded`` on the CPU: the local
dispatch's pieces against the reference's on seeded inputs with dropped
tokens, and ``ep_a2a`` on a 1 x 1 ``gloo`` mesh against the reference's
under its host mesh (``shard_map``), forward and ``jax.grad``. The
(2, 2) paths run in ``tests/test_torch_multirank.py``.

Tolerances: router ids, the dispatch's ``dest`` / ``token_idx`` / ``keep``
equal; gates, aux and buffers within 1e-6 (f32 softmax and means, exact
copies); block outputs within 1e-5 and gradients within 1e-4 of each
leaf's max (``tests/test_torch_moe.py``'s bounds)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro.configs import get_reduced as r_get_reduced
from repro.launch.mesh import make_host_mesh, mesh_context as r_mesh_context
from repro.launch.steps import _with_act_sharding as r_with_act
from repro.models import mlp as r_mlp
from repro.models import moe_sharded as r_moe
from repro.models.base import Ctx as RCtx
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch.mesh import MeshShape, make_device_mesh, mesh_context
from repro_torch.launch.steps import _with_act_sharding
from repro_torch.models import mlp as p_mlp
from repro_torch.models import moe_sharded as p_moe
from repro_torch.sharding.rules import distribute_tree

from _torch_parity import max_abs_diff, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-6
OUT_TOL = 1e-5
GRAD_RTOL = 1e-4
F32 = dict(dtype="float32", param_dtype="float32")


def _cfgs(**moe):
    r = r_get_reduced("mixtral-8x7b").replace(**F32)
    p = get_reduced("mixtral-8x7b").replace(**F32)
    return (r.replace(moe=dataclasses.replace(r.moe, **moe)),
            p.replace(moe=dataclasses.replace(p.moe, **moe)))


def _block(rcfg):
    rp = r_mlp.moe_params(RCtx("init", jax.random.PRNGKey(5), jnp.float32), rcfg)
    return rp, params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("T,cap", [(24, 0.5), (7, 1.0), (1, 1.0)])
def test_route_dispatch_and_combine_match(T, cap):
    rcfg, pcfg = _cfgs(capacity_factor=cap)
    rp, pp = _block(rcfg)
    x = _x((T, pcfg.d_model), T)
    r_g, r_i, r_aux = r_moe._route(rcfg, rp, jnp.asarray(x))
    p_g, p_i, p_aux = p_moe._route(pcfg, pp, torch.from_numpy(x))
    assert np.array_equal(np.asarray(r_i), p_i.numpy())
    assert max_abs_diff(r_g, p_g) <= TOL and abs(float(r_aux) - float(p_aux)) <= TOL
    C = max(int(cap * pcfg.moe.top_k * T / pcfg.moe.num_experts), 1)
    r_out = r_moe._dispatch_local(rcfg, jnp.asarray(x), r_g, r_i, C)
    p_out = p_moe._dispatch_local(pcfg, torch.from_numpy(x), p_g, p_i, C)
    for name, r, p in zip(("buf", "dest", "token_idx", "flat_gates", "keep"), r_out, p_out):
        if name in ("dest", "token_idx", "keep"):
            assert np.array_equal(np.asarray(r), p.numpy()), name
        else:
            assert max_abs_diff(r, p) <= TOL, name
    if cap < 1.0:
        assert not bool(np.asarray(r_out[4]).all())  # tokens dropped
    yb = _x(tuple(r_out[0].shape), 99)
    r_y = r_moe._combine_local(jnp.asarray(yb), *r_out[1:], T, pcfg.d_model, jnp.float32)
    p_y = p_moe._combine_local(torch.from_numpy(yb), *p_out[1:], T, pcfg.d_model, torch.float32)
    assert max_abs_diff(r_y, p_y) <= TOL
    r_f = r_moe._expert_ffn(rp["w_gate"], rp["w_up"], rp["w_down"], jnp.asarray(yb))
    p_f = p_moe._expert_ffn(pp["w_gate"], pp["w_up"], pp["w_down"], torch.from_numpy(yb))
    assert max_abs_diff(r_f, p_f) <= OUT_TOL


@pytest.mark.parametrize("cap", [1.5, 0.5])
def test_ep_a2a_matches_the_reference_on_the_host_mesh(cap):
    """``moe_forward`` picks ``ep_a2a`` on a 1 x 1 mesh in both packages;
    the outputs, aux and ``jax.grad`` of ``sum(y * r) + aux`` agree."""
    r_mesh = make_host_mesh()
    p_mesh = make_device_mesh(MeshShape(("data", "model"), (1, 1)), device="cpu")
    rcfg, pcfg = _cfgs(capacity_factor=cap)
    rcfg, pcfg = r_with_act(rcfg, r_mesh), _with_act_sharding(pcfg, p_mesh)
    rp, pp = _block(rcfg)
    x, r = _x((2, 8, pcfg.d_model), 21), _x((2, 8, pcfg.d_model), 22)
    assert p_moe.pick_moe_path(pcfg, 2, 8) == r_moe.pick_moe_path(rcfg, 2, 8) == "ep_a2a"

    def ref(p, x):
        y, aux = r_mlp.moe_forward(rcfg, p, x)
        return jnp.sum(y * r) + aux, (y, aux)

    with r_mesh_context(r_mesh):
        (_, (r_y, r_aux)), (g_p, g_x) = jax.jit(jax.value_and_grad(ref, argnums=(0, 1),
                                                                   has_aux=True))(rp, jnp.asarray(x))
    keys = sorted(pp)
    dp = distribute_tree(pp, {k: (None,) * pp[k].ndim for k in keys}, p_mesh)
    dp = {k: v.detach().requires_grad_(True) for k, v in dp.items()}
    dx = distribute_tree(torch.from_numpy(x), ("data", "model", None), p_mesh).requires_grad_(True)
    with mesh_context(p_mesh), implicit_replication():
        y, aux = p_mlp.moe_forward(pcfg, dp, dx)
        loss = (y * torch.from_numpy(r)).sum() + aux
        grads = torch.autograd.grad(loss.full_tensor(), [dx] + [dp[k] for k in keys])
    assert max_abs_diff(r_y, y.full_tensor()) <= OUT_TOL
    assert abs(float(r_aux) - float(aux.full_tensor().detach())) <= TOL
    for want, got in zip([g_x] + [g_p[k] for k in keys], grads):
        assert max_abs_diff(want, got.full_tensor()) <= GRAD_RTOL * float(jnp.max(jnp.abs(want)))
