"""Shared helpers for the port's parity tests: run the JAX reference and the
PyTorch port on the same numpy inputs and compare what comes out."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models.cnn import cnn_init as ref_cnn_init
from repro_torch.convert import params_from_numpy


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module's torch work, restored after it.
    The suite runs several pytest-xdist workers on the same cores; torch's
    default of one thread per core in each of them oversubscribes the cores
    and slows every worker's CNN training many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_params_np(seed: int = 0):
    """The reference's initial CNN params (threefry draws) as numpy."""
    return jax.tree.map(np.asarray, ref_cnn_init(jax.random.PRNGKey(seed)))


def to_np(tree):
    """A reference (jax) or port (torch) tree as a nested dict of numpy."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def with_params(task, params_np):
    """The port's task with ``init_fn`` returning ``params_np`` carried
    across (the reference's threefry init has no torch counterpart)."""
    return dataclasses.replace(task, init_fn=lambda _g: params_from_numpy(params_np, "cpu"))


_REF_PARAMS: dict = {}


def with_ref_init(task):
    """The port's task whose ``init_fn`` gives, for a generator seeded with
    ``seed`` (``FederatedServer`` seeds it with ``config.seed``), the
    reference's ``cnn_init(PRNGKey(seed))`` params."""

    def init(generator):
        seed = generator.initial_seed()
        if seed not in _REF_PARAMS:
            _REF_PARAMS[seed] = ref_params_np(seed)
        return params_from_numpy(_REF_PARAMS[seed], "cpu")

    return dataclasses.replace(task, init_fn=init)


def max_abs_diff(a, b) -> float:
    a, b = to_np(a), to_np(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        return max(max_abs_diff(a[k], b[k]) for k in a)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)), initial=0.0))


def assert_same(a, b, path="out"):
    """Bitwise equality of two results built from the same numpy draws:
    dataclasses, dicts, sequences, arrays (dtype included) and scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b and type(a) is type(b), (path, a, b)
