"""Port parity: tree helpers and the functional optimizers of
``repro_torch`` against ``repro`` on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, max_abs_diff  # noqa: F401
from repro import optim as ref_optim
from repro import utils as ref_utils
from repro.models.cnn import cnn_init as ref_cnn_init
from repro_torch import optim as pt_optim
from repro_torch import utils as pt_utils
from repro_torch.convert import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _tree(seed, scale=1.0, lead=()):
    """Nested dict inserted in UNSORTED key order, odd leaf shapes."""
    rng = np.random.default_rng(seed)
    shapes = {"zeta": (7,), "alpha": {"w": (3, 5), "b": (5,)}, "mid": (2, 3, 4)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (rng.standard_normal(lead + s) * scale).astype(np.float32)

    return make(shapes)


def _both(tree_np):
    return jax.tree.map(jnp.asarray, tree_np), params_from_numpy(tree_np, "cpu")


def test_params_cross_packages_unchanged():
    """Reference params (threefry init) carried to the port and back are
    bitwise unchanged, dtype and layout included."""
    ref = jax.tree.map(np.asarray, ref_cnn_init(jax.random.PRNGKey(3)))
    port = params_from_numpy(ref, "cpu")
    assert port["conv2"]["w"].shape == (3, 3, 16, 32)  # HWIO kept
    back = params_to_numpy(port)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_leaf_order_is_sorted_key_order():
    ref, pt = _both(_tree(0))
    for a, b in zip(jax.tree.leaves(ref), pt_utils.tree_leaves(pt)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("scale", [0.01, 0.3, 10.0])
def test_clip_by_global_norm_matches_reference(scale):
    ref, pt = _both(_tree(1, scale))
    r_out, r_gn = ref_optim.clip_by_global_norm(ref, 1.0)
    p_out, p_gn = pt_optim.clip_by_global_norm(pt, 1.0)
    assert abs(float(r_gn) - float(p_gn)) <= 1e-6 * max(1.0, float(r_gn))
    assert max_abs_diff(r_out, p_out) <= 1e-6


@pytest.mark.parametrize("slab", [1, 7, 60])
def test_clip_by_global_norm_by_slabs_matches_reference(monkeypatch, slab):
    """Leaves above the slab size are summed slab by slab (the f32
    temporaries of a multi-GB leaf): the same norm and clipped tree."""
    from repro_torch.optim import optimizers

    monkeypatch.setattr(optimizers, "_NORM_SLAB", slab)
    ref, pt = _both(_tree(2, 0.3))
    pt["alpha"]["w"] = pt["alpha"]["w"].t()  # a non-contiguous leaf
    ref["alpha"]["w"] = ref["alpha"]["w"].T
    r_out, r_gn = ref_optim.clip_by_global_norm(ref, 1.0)
    p_out, p_gn = pt_optim.clip_by_global_norm(pt, 1.0)
    assert abs(float(r_gn) - float(p_gn)) <= 1e-6 * max(1.0, float(r_gn))
    assert max_abs_diff(r_out, p_out) <= 1e-6
    assert float(pt_optim.global_norm(pt)) == float(p_gn)


def test_clip_by_global_norm_stacked_matches_reference():
    # per-client scales straddle the clip threshold
    scales = np.array([0.01, 0.2, 1.0, 30.0], np.float32)
    tree = _tree(2, lead=(4,))
    tree = jax.tree.map(lambda l: l * scales.reshape((-1,) + (1,) * (l.ndim - 1)), tree)
    ref, pt = _both(tree)
    r_out, r_gn = ref_optim.clip_by_global_norm_stacked(ref, 1.0)
    p_out, p_gn = pt_optim.clip_by_global_norm_stacked(pt, 1.0)
    np.testing.assert_allclose(p_gn.numpy(), np.asarray(r_gn), rtol=1e-6, atol=1e-6)
    assert max_abs_diff(r_out, p_out) <= 1e-6


@pytest.mark.parametrize("momentum,nesterov", [(0.9, False), (0.0, False), (0.9, True)])
def test_sgd_steps_match_reference(momentum, nesterov):
    params_np = _tree(3)
    r_opt = ref_optim.sgd(0.05, momentum=momentum, nesterov=nesterov)
    p_opt = pt_optim.sgd(0.05, momentum=momentum, nesterov=nesterov)
    r_params, p_params = _both(params_np)
    r_state, p_state = r_opt.init(r_params), p_opt.init(p_params)
    for step in range(2):
        r_g, p_g = _both(_tree(10 + step))
        r_upd, r_state = r_opt.update(r_g, r_state, r_params, jnp.int32(step))
        p_upd, p_state = p_opt.update(p_g, p_state, p_params, step)
        r_params = ref_optim.apply_updates(r_params, r_upd)
        p_params = pt_optim.apply_updates(p_params, p_upd)
        assert max_abs_diff(r_upd, p_upd) <= 1e-6
    assert max_abs_diff(r_params, p_params) <= 1e-6
    if momentum:
        assert max_abs_diff(r_state["m"], p_state["m"]) <= 1e-6
    else:
        assert r_state == {} and p_state == {}


@pytest.mark.parametrize(
    "name", ["tree_add", "tree_sub", "tree_scale", "tree_stack", "tree_unstack",
             "tree_weighted_mean", "tree_size", "flatten_to_vector"]
)
def test_tree_helpers_match_reference(name):
    a_np, b_np = _tree(4), _tree(5)
    (ra, pa), (rb, pb) = _both(a_np), _both(b_np)
    if name in ("tree_add", "tree_sub"):
        r, p = getattr(ref_utils, name)(ra, rb), getattr(pt_utils, name)(pa, pb)
    elif name == "tree_scale":
        r, p = ref_utils.tree_scale(ra, 0.37), pt_utils.tree_scale(pa, 0.37)
    elif name == "tree_stack":
        r, p = ref_utils.tree_stack([ra, rb]), pt_utils.tree_stack([pa, pb])
    elif name == "tree_unstack":
        r = ref_utils.tree_unstack(ref_utils.tree_stack([ra, rb]))
        p = pt_utils.tree_unstack(pt_utils.tree_stack([pa, pb]))
        assert len(r) == len(p) == 2
        r, p = {"0": r[0], "1": r[1]}, {"0": p[0], "1": p[1]}
    elif name == "tree_weighted_mean":
        w = np.array([320.0, 7.0])  # raw example counts, float64 like the server's
        r = ref_utils.tree_weighted_mean([ra, rb], w)
        p = pt_utils.tree_weighted_mean([pa, pb], w)
    elif name == "tree_size":
        assert ref_utils.tree_size(ra) == pt_utils.tree_size(pa) == 7 + 15 + 5 + 24
        return
    else:
        (r, r_meta), (p, p_meta) = ref_utils.flatten_to_vector(ra), pt_utils.flatten_to_vector(pa)
        back = pt_utils.unflatten_from_vector(p, p_meta)
        assert max_abs_diff(back, a_np) == 0.0
        assert p.dtype == torch.float32
    assert max_abs_diff(r, p) <= 1e-6, name
