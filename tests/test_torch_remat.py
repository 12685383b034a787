"""``remat`` in the port's training forward, held to the reference's
``_remat`` (``repro/models/lm.py``) on the CPU: at "none", "block" and
"full" the gradients of reduced Qwen3 and reduced Mixtral equal
``jax.grad``'s (the reference run at the same setting) within 1e-4 of each
leaf's max |grad|, and each setting saves what the reference saves:

- "block" keeps the outputs of the products without a batch dimension
  (``dots_with_no_batch_dims_saveable``): the projections' and the
  router's ``aten.mm`` and the SwiGLU op, so the backward pass runs none of
  them again, while flash attention (a batched product in the reference)
  runs again;
- "full" keeps nothing, so the whole block runs again;
- "none" does not checkpoint.

The kernels' calls are counted at the ops the wrappers launch through
(``flash_attention_bhsd`` and ``swiglu_fused``, which run their plain
versions on the CPU), and the matrix products with a dispatch mode."""

import functools

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_reduced as r_get_reduced
from repro.data.tokens import token_batch_for
from repro.models import Model as RModel
from repro_torch import configs as p_configs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import swiglu as sw
from repro_torch.models import Model
from repro_torch.utils import tree_leaves, tree_map

from _torch_parity import max_abs_diff, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F32 = dict(dtype="float32", param_dtype="float32")
GRAD_RTOL = 1e-4
ARCHS = ["qwen3-8b", "mixtral-8x7b"]
REMATS = ["none", "block", "full"]
# per layer and training step: (flash, swiglu) calls
CALLS = {"none": (1, 1), "block": (2, 1), "full": (2, 2)}
# the 2-D products of one block's forward: q, k, v, o (and Mixtral's router)
BLOCK_MMS = {"qwen3-8b": 4, "mixtral-8x7b": 5}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.jit(RModel(r_get_reduced(arch).replace(**F32)).init)(jax.random.PRNGKey(0))


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _port_step(arch, remat, monkeypatch):
    """Loss and gradients of the port at ``remat``; the kernels' calls in
    the forward and backward, and the matrix products of the backward."""
    pcfg = p_configs.get_reduced(arch).replace(remat=remat, **F32)
    calls = {"flash": 0, "swiglu": 0}

    def counting(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(fa, "flash_attention_bhsd", counting("flash", fa.flash_attention_bhsd))
    monkeypatch.setattr(sw, "swiglu_fused", counting("swiglu", sw.swiglu_fused))
    params = tree_map(lambda t: t.requires_grad_(True),
                      params_from_numpy(jax.tree.map(np.asarray, _ref_params(arch)), "cpu"))
    b = token_batch_for(pcfg, batch=2, seq=16, seed=3)
    loss, _ = Model(pcfg).loss(params, {k: torch.as_tensor(v) for k, v in b.items()})
    with _CountMM() as mm:
        grads = torch.autograd.grad(loss, tree_leaves(params))
    return pcfg, b, grads, calls, mm.n


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch, remat, monkeypatch):
    pcfg, b, got, calls, _ = _port_step(arch, remat, monkeypatch)
    rcfg = r_get_reduced(arch).replace(remat=remat, **F32)
    model = RModel(rcfg)
    want = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))(
        _ref_params(arch), {k: jax.numpy.asarray(v) for k, v in b.items()})
    want = jax.tree.leaves(want)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert max_abs_diff(w, g) <= GRAD_RTOL * float(np.max(np.abs(np.asarray(w))))
    L = pcfg.n_layers
    flash, swiglu = CALLS[remat]
    assert calls == {"flash": flash * L, "swiglu": swiglu * L if arch == "qwen3-8b" else 0}


@pytest.mark.parametrize("arch", ARCHS)
def test_block_saves_the_products_and_full_saves_nothing(arch, monkeypatch):
    """The backward's matrix products: "block" runs exactly "none"'s (no
    forward product is run again); "full" runs those and every block's
    forward products once more."""
    n = {}
    for remat in REMATS:
        pcfg, _, _, _, n[remat] = _port_step(arch, remat, monkeypatch)
    assert n["block"] == n["none"]
    assert n["full"] == n["none"] + BLOCK_MMS[arch] * pcfg.n_layers
