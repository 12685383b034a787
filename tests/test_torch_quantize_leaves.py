"""Port parity: the grouped bf16 downcast and the stochastic int8 codes on
the CPU. ``downcast_bf16_rows_leaves`` takes every leaf of a tree in one
call (one launch on the card); on a CPU tensor it runs the plain version
per leaf, whose bf16 bits must equal the reference's Pallas kernel in
interpret mode leaf by leaf. The same holds for ``quantize_stochastic_flat``
at ragged lengths and on offset views. The CUDA kernels are held to the
plain versions on the card by ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.compress as r_comp
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
import repro_torch.compress as p_comp
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import quantize as p_q

# the MNIST CNN's leaf sizes in tree_leaves order (conv1.b .. fc2.w)
CNN_LEAVES = [16, 144, 32, 4608, 128, 200704, 10, 1280]
RAGGED_LEAVES = [1, 3, 10, 2049, 12345]


def _rows(R, N, seed=0):
    x = np.random.default_rng(seed).standard_normal((R, N)).astype(np.float32)
    if x.size >= 4:  # halfway between two bf16 numbers: round to nearest even
        x.reshape(-1)[:4] = np.array([1.00390625, 1.01171875, -1.00390625, 3.0e-39], np.float32)
    return x


def _offset_view(R, N, seed=0):
    """[R, N] f32, contiguous, starting one element into its storage."""
    flat = np.random.default_rng(seed).standard_normal(R * N + 1).astype(np.float32)
    return torch.from_numpy(flat)[1:].view(R, N)


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _pallas_bits(x):
    return _bits(r_ops.downcast_bf16_rows(jnp.asarray(np.asarray(x)), interpret=True))


@pytest.mark.parametrize("sizes", [CNN_LEAVES, RAGGED_LEAVES], ids=["cnn", "ragged"])
@pytest.mark.parametrize("R", [1, 10])
def test_downcast_bf16_rows_leaves_bits_equal_pallas_per_leaf(R, sizes):
    xs = [_rows(R, n, seed=i) for i, n in enumerate(sizes)]
    got = p_q.downcast_bf16_rows_leaves([torch.from_numpy(x) for x in xs])
    assert len(got) == len(xs)
    for x, b in zip(xs, got):
        assert b.dtype == torch.bfloat16 and b.shape == x.shape
        assert np.array_equal(_bits(b), _pallas_bits(x))
        assert np.array_equal(_bits(b), _bits(r_ref.downcast_bf16_rows_ref(jnp.asarray(x))))


def test_downcast_bf16_rows_leaves_zero_size_and_offset_views():
    xs = [_offset_view(10, 4096), torch.zeros(10, 0), torch.from_numpy(_rows(10, 1280, seed=1)),
          _offset_view(10, 10, seed=2), torch.zeros(0, 7)]
    got = p_q.downcast_bf16_rows_leaves(xs)
    for x, b in zip(xs, got):
        assert b.dtype == torch.bfloat16 and b.shape == x.shape
        oracle = _bits(r_ref.downcast_bf16_rows_ref(jnp.asarray(x.numpy())))
        assert np.array_equal(_bits(b), oracle)
        if x.numel():
            assert np.array_equal(_bits(b), _pallas_bits(x.numpy()))


def test_ops_downcast_bf16_rows_leaves_equals_one_call_per_leaf():
    """The tree-level wrapper casts and makes contiguous as the one-leaf
    wrapper does, and gives the same bits leaf by leaf."""
    xs = [torch.from_numpy(_rows(3, n, seed=n)).double() for n in (5, 64)]
    xs.append(torch.from_numpy(_rows(6, 3, seed=9)).t())  # not contiguous
    got = p_ops.downcast_bf16_rows_leaves(xs)
    for x, b in zip(xs, got):
        assert torch.equal(b.view(torch.int16), p_ops.downcast_bf16_rows(x).view(torch.int16))


def test_downcast_bf16_rows_leaves_on_the_cpu_counts_no_launch():
    before = dict(p_q.launches)
    p_q.downcast_bf16_rows_leaves([torch.ones(2, 8), torch.ones(3, 5), torch.ones(1, 0)])
    assert p_q.downcast_bf16_rows_leaves([]) == []
    assert p_q.launches == before


def test_downcast_bf16_rows_leaves_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="unsupported device"):
        p_q.downcast_bf16_rows_leaves([torch.empty(2, 8, device="meta")])
    with pytest.raises(ValueError):
        p_q.downcast_bf16_rows_leaves([torch.ones(2, 8), torch.ones(8)])


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("N", [1, 3, 4, 5, 4111])
def test_quantize_stochastic_ragged_lengths_equal_pallas(N, offset):
    rng = np.random.default_rng(N)
    x_all = torch.from_numpy((rng.standard_normal(N + 1) * 3.0).astype(np.float32))
    u_all = torch.from_numpy(rng.random(N + 1, dtype=np.float32))
    cut = slice(1, None) if offset else slice(0, N)
    x, u = x_all[cut], u_all[cut]
    assert x.storage_offset() == int(offset) and x.is_contiguous()
    scale = np.float32(np.maximum(np.abs(x.numpy()).max(), 1e-12) / np.float32(127.0))
    pallas = np.asarray(r_ops.quantize_stochastic_flat(
        jnp.asarray(x.numpy()), jnp.asarray(u.numpy()), scale, interpret=True))
    got = p_q.quantize_stochastic_flat(x, u, torch.tensor(scale))
    assert got.dtype == torch.int8 and got.shape == (N,)
    assert np.array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("with_residual", [False, True])
def test_bf16_compressor_grouped_leaves_equal_reference(with_residual):
    """The per-client bf16 compressor, one grouped call over the leaves,
    against the reference's per-leaf compressor: payload bits and
    residuals equal."""
    rng = np.random.default_rng(3)
    shapes = {"a": (4, 4), "b": (3, 3, 16), "c": (10,), "d": (128, 10)}
    delta = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in shapes.items()}
    res = ({k: (rng.standard_normal(s) * 1e-3).astype(np.float32) for k, s in shapes.items()}
           if with_residual else None)
    r_payload, r_res = r_comp.bf16_compressor().compress(
        {k: jnp.asarray(v) for k, v in delta.items()},
        res and {k: jnp.asarray(v) for k, v in res.items()})
    p_payload, p_res = p_comp.bf16_compressor().compress(
        {k: torch.from_numpy(v) for k, v in delta.items()},
        res and {k: torch.from_numpy(v) for k, v in res.items()})
    for k in shapes:
        assert p_payload[k]["bf16"].shape == shapes[k]
        assert np.array_equal(_bits(p_payload[k]["bf16"]), _bits(r_payload[k]["bf16"])), k
        assert np.array_equal(p_res[k].numpy(), np.asarray(r_res[k])), k
