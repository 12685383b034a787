"""Port parity: the MNIST CNN of ``repro_torch.models.cnn`` against
``repro.models.cnn`` — forward passes and gradients, per-client and
stacked, and the max-pool's first-max gradient rule under ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, max_abs_diff, ref_params_np, to_np  # noqa: F401
from repro.models import cnn as r_cnn
from repro.utils import tree_stack as r_stack
from repro_torch.convert import params_from_numpy
from repro_torch.models import cnn as p_cnn
from repro_torch.utils import tree_stack as p_stack

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL = 1e-5


def _images(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _torch_grads(loss, params):
    leaves = {k: {n: t.requires_grad_(True) for n, t in v.items()} for k, v in params.items()}
    out = loss(leaves)
    flat = [t for v in leaves.values() for t in v.values()]
    grads = torch.autograd.grad(out, flat)
    it = iter(grads)
    return {k: {n: next(it) for n in v} for k, v in leaves.items()}


def test_cnn_init_shapes_match_reference():
    ref = ref_params_np(0)
    port = p_cnn.cnn_init(torch.Generator().manual_seed(0))
    assert jax.tree.map(np.shape, ref) == {
        k: {n: tuple(t.shape) for n, t in v.items()} for k, v in port.items()
    }
    assert all(t.dtype == torch.float32 for v in port.values() for t in v.values())


@pytest.mark.parametrize("seed", [0, 1])
def test_cnn_apply_and_grads_match_reference(seed):
    params = ref_params_np(seed)
    x = _images((4, 28, 28, 1), seed)
    g_out = np.random.default_rng(seed + 10).standard_normal((4, 10)).astype(np.float32)
    r_logits = r_cnn.cnn_apply(jax.tree.map(jnp.asarray, params), x)
    p_logits = p_cnn.cnn_apply(params_from_numpy(params, "cpu"), torch.from_numpy(x))
    assert max_abs_diff(r_logits, p_logits) <= ATOL

    r_grads = jax.grad(lambda p: jnp.sum(r_cnn.cnn_apply(p, x) * g_out))(
        jax.tree.map(jnp.asarray, params)
    )
    p_grads = _torch_grads(
        lambda p: torch.sum(p_cnn.cnn_apply(p, torch.from_numpy(x)) * torch.from_numpy(g_out)),
        params_from_numpy(params, "cpu"),
    )
    assert max_abs_diff(r_grads, p_grads) <= ATOL


def test_cnn_loss_and_grads_match_reference():
    params = ref_params_np(2)
    rng = np.random.default_rng(2)
    batch = {"images": _images((8, 28, 28, 1), 2), "labels": rng.integers(0, 10, 8).astype(np.int32)}
    (r_loss, r_m), r_grads = jax.value_and_grad(r_cnn.cnn_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params), batch
    )
    p_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p_loss, p_m = p_cnn.cnn_loss(params_from_numpy(params, "cpu"), p_batch)
    p_grads = _torch_grads(lambda p: p_cnn.cnn_loss(p, p_batch)[0], params_from_numpy(params, "cpu"))
    assert abs(float(r_loss) - float(p_loss)) <= ATOL
    assert float(r_m["accuracy"]) == float(p_m["accuracy"])
    assert max_abs_diff(r_grads, p_grads) <= ATOL


def test_cnn_apply_stacked_and_grads_match_reference():
    C, B = 3, 4
    params = [ref_params_np(s) for s in range(C)]
    x = _images((C, B, 28, 28, 1), 5)
    labels = np.random.default_rng(5).integers(0, 10, (C, B)).astype(np.int32)
    r_params = r_stack([jax.tree.map(jnp.asarray, p) for p in params])
    p_params = p_stack([params_from_numpy(p, "cpu") for p in params])
    r_logits = r_cnn.cnn_apply_stacked(r_params, x)
    p_logits = p_cnn.cnn_apply_stacked(p_params, torch.from_numpy(x))
    assert max_abs_diff(r_logits, p_logits) <= ATOL
    # the stacked forward equals the per-client forward, client by client
    for c in range(C):
        per = p_cnn.cnn_apply(params_from_numpy(params[c], "cpu"), torch.from_numpy(x[c]))
        assert max_abs_diff(per, p_logits[c]) <= 1e-4

    batch = {"images": x, "labels": labels}
    (_, r_m), r_grads = jax.value_and_grad(
        lambda p: (lambda l, m: (jnp.sum(l), m))(*r_cnn.cnn_loss_stacked(p, batch)), has_aux=True
    )(r_params)
    p_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    p_grads = _torch_grads(lambda p: p_cnn.cnn_loss_stacked(p, p_batch)[0].sum(), p_params)
    _, p_m = p_cnn.cnn_loss_stacked(p_params, p_batch)
    assert max_abs_diff(r_m["loss"], p_m["loss"]) <= ATOL
    assert max_abs_diff(r_grads, p_grads) <= ATOL


@pytest.mark.parametrize("kind", ["constant", "two_levels", "random"])
def test_maxpool2x2_first_max_rule_with_ties(kind):
    """Forward equals reduce_window; the gradient goes to the FIRST window
    element attaining the max (row-major), as the reference's stacked
    custom VJP and its reduce_window gradient both route it."""
    rng = np.random.default_rng(0)
    shape = (2, 3, 8, 8, 4)  # stacked layout [C, B, H, W, ch]
    if kind == "constant":
        x = np.ones(shape, np.float32)
    elif kind == "two_levels":
        x = rng.integers(0, 2, shape).astype(np.float32)  # ties in most windows
    else:
        x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal((2, 3, 4, 4, 4)).astype(np.float32)

    def pool_ref(v):
        return jax.lax.reduce_window(
            v, -jnp.inf, jax.lax.max, (1, 1, 2, 2, 1), (1, 1, 2, 2, 1), "VALID"
        )

    r_out = pool_ref(jnp.asarray(x))
    r_dx_window = jax.grad(lambda v: jnp.sum(pool_ref(v) * g))(jnp.asarray(x))
    r_dx_vjp = jax.grad(lambda v: jnp.sum(r_cnn.maxpool2x2(v) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    p_out = p_cnn.maxpool2x2(xt)
    (p_dx,) = torch.autograd.grad(torch.sum(p_out * torch.from_numpy(g)), xt)
    np.testing.assert_array_equal(to_np(p_out), np.asarray(r_out))
    np.testing.assert_array_equal(p_dx.numpy(), np.asarray(r_dx_vjp))
    np.testing.assert_array_equal(p_dx.numpy(), np.asarray(r_dx_window))
    if kind == "constant":  # every window's gradient lands on its top-left
        assert np.all(p_dx.numpy()[..., 0::2, 0::2, :] == g)
        assert np.all(p_dx.numpy()[..., 1::2, :, :] == 0)
