"""Port parity: ``repro_torch.kernels`` on the CPU (the kernel wrapper's
plain version) against the reference's Pallas ``fedavg_reduce`` run in
interpret mode and against its jnp oracle. The hand-written CUDA kernel
itself is held to the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.utils import tree_unstack as r_unstack
from repro.utils import tree_weighted_mean as r_wmean
from repro_torch.kernels import fedavg_reduce as p_fr
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _x(C, N, seed=0):
    return np.random.default_rng(seed).standard_normal((C, N)).astype(np.float32)


def _pair(x_np, dtype):
    """The same values as a jax and a torch array (bf16 rounding is
    round-to-nearest-even in both)."""
    return jnp.asarray(x_np, getattr(jnp, dtype)), torch.from_numpy(x_np).to(getattr(torch, dtype))


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("C,N", [(3, 1000), (10, 4096), (7, 12345)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_reduce_sweep_matches_pallas_interpret(C, N, dtype):
    rx, px = _pair(_x(C, N), dtype)
    w = np.random.default_rng(1).random(C).astype(np.float32) + 0.05
    got = p_ops.fedavg_reduce({"x": px}, torch.from_numpy(w))["x"]
    pallas = r_ops.fedavg_reduce({"x": rx}, jnp.asarray(w), interpret=True)["x"]
    oracle = r_ref.fedavg_reduce_ref(rx, jnp.asarray(w / w.sum())).astype(rx.dtype)
    assert got.dtype == px.dtype
    assert np.max(np.abs(_f32(got) - _f32(pallas))) <= TOL[dtype]
    assert np.max(np.abs(_f32(got) - _f32(oracle))) <= TOL[dtype]


@pytest.mark.parametrize("N", [1, 100, 2048, 2049, 12345])
def test_fedavg_reduce_padding_sweep(N):
    rx, px = _pair(_x(3, N, seed=2), "float32")
    w = np.array([1.0, 2.0, 5.0], np.float32)
    got = p_ops.fedavg_reduce({"x": px}, torch.from_numpy(w))["x"]
    pallas = r_ops.fedavg_reduce({"x": rx}, jnp.asarray(w), interpret=True)["x"]
    assert got.shape == (N,)
    assert np.max(np.abs(_f32(got) - _f32(pallas))) <= 1e-5
    plain = p_ref.fedavg_reduce_ref(px, torch.from_numpy(w / w.sum()))
    assert np.max(np.abs(_f32(plain) - _f32(got))) <= 1e-6


def test_fedavg_reduce_single_client_identity_and_weight_scale():
    x = _x(1, 3000, seed=3)
    out = p_ops.fedavg_reduce({"x": torch.from_numpy(x)}, torch.tensor([17.0]))["x"]
    np.testing.assert_allclose(out.numpy(), x[0], atol=1e-6)
    x4 = torch.from_numpy(_x(4, 512))
    w = torch.tensor([1.0, 2.0, 3.0, 4.0])
    a = p_ops.fedavg_reduce({"x": x4}, w)["x"]
    b = p_ops.fedavg_reduce({"x": x4}, w * 100)["x"]
    assert torch.allclose(a, b, atol=1e-6)


def test_fedavg_reduce_tree_matches_reference_weighted_mean():
    """Multi-leaf tree with odd sizes, a bf16 leaf and raw example counts,
    against the reference kernel (interpret) and its list-path mean."""
    rng = np.random.default_rng(3)
    C = 5
    tree_np = {
        "conv": {"w": rng.standard_normal((C, 3, 3, 1, 16)).astype(np.float32),
                 "b": rng.standard_normal((C, 16)).astype(np.float32)},
        "fc": rng.standard_normal((C, 123, 37)).astype(np.float32),
        "half": rng.standard_normal((C, 2049)).astype(np.float32),
    }
    dtypes = {"half": "bfloat16"}
    r_tree = {k: (_pair(v, dtypes.get(k, "float32"))[0] if not isinstance(v, dict)
                  else {n: jnp.asarray(a) for n, a in v.items()}) for k, v in tree_np.items()}
    p_tree = {k: (_pair(v, dtypes.get(k, "float32"))[1] if not isinstance(v, dict)
                  else {n: torch.from_numpy(a) for n, a in v.items()}) for k, v in tree_np.items()}
    weights = np.array([320.0, 64.0, 128.0, 7.0, 1.0], np.float32)
    got = p_ops.fedavg_reduce(p_tree, torch.from_numpy(weights))
    pallas = r_ops.fedavg_reduce(r_tree, jnp.asarray(weights), interpret=True)
    listed = r_wmean(r_unstack(r_tree), weights.astype(np.float64))
    for key in ("fc", "half"):
        tol = TOL[dtypes.get(key, "float32")]
        assert got[key].dtype == p_tree[key].dtype
        assert np.max(np.abs(_f32(got[key]) - _f32(pallas[key]))) <= tol
        assert np.max(np.abs(_f32(got[key]) - _f32(listed[key]))) <= tol
    for n in ("w", "b"):
        assert np.max(np.abs(_f32(got["conv"][n]) - _f32(pallas["conv"][n]))) <= 1e-5


def test_cpu_calls_do_not_count_as_launches():
    before = p_fr.launches
    p_fr.fedavg_reduce_flat(torch.ones(2, 8), torch.tensor([0.5, 0.5]))
    assert p_fr.launches == before


def test_wrapper_refuses_devices_without_a_kernel():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        p_fr.fedavg_reduce_flat(x, torch.empty(2, device="meta"))


@pytest.mark.parametrize("C", [1, 10])
def test_fedavg_reduce_mixed_tree_matches_pallas_interpret(C):
    """A tree of leaves of 1, 10, 2049 and 12345 elements and a bf16 leaf
    (one launch per dtype on the card) against the reference kernel."""
    rng = np.random.default_rng(C)
    shapes = {"a": (1,), "b": (10,), "c": (2049,), "d": (3, 4115), "half": (2049,)}
    tree_np = {k: rng.standard_normal((C,) + s).astype(np.float32) for k, s in shapes.items()}
    dt = {k: "bfloat16" if k == "half" else "float32" for k in shapes}
    pairs = {k: _pair(v, dt[k]) for k, v in tree_np.items()}
    w = rng.random(C).astype(np.float32) + 0.05
    got = p_ops.fedavg_reduce({k: p for k, (_, p) in pairs.items()}, torch.from_numpy(w))
    want = r_ops.fedavg_reduce({k: r for k, (r, _) in pairs.items()}, jnp.asarray(w),
                               interpret=True)
    for k in shapes:
        assert got[k].shape == shapes[k] and got[k].dtype == getattr(torch, dt[k])
        assert np.max(np.abs(_f32(got[k]) - _f32(want[k]))) <= TOL[dt[k]], k


def test_fedavg_reduce_leaves_is_the_concatenation_of_leaves():
    """The grouped wrapper's output: leaf l at the offset of the leaves
    before it, each equal to the one-leaf call; zero-size leaves allowed."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.random(3).astype(np.float32))
    xs = [torch.from_numpy(_x(3, n, seed=n)) for n in (5, 0, 4096, 1)]
    xs.append(torch.from_numpy(_x(3, 7, seed=9)).to(torch.bfloat16))
    before = p_fr.launches
    out = p_fr.fedavg_reduce_leaves(xs, w)
    assert p_fr.launches == before  # CPU calls do not count
    assert out.dtype == torch.float32 and out.shape == (sum(x.shape[1] for x in xs),)
    off = 0
    for x in xs:
        assert torch.equal(out[off:off + x.shape[1]], p_fr.fedavg_reduce_flat(x, w))
        off += x.shape[1]
