"""Shared parts of the recurrent families' parity tests
(``test_torch_rwkv.py``, ``test_torch_hybrid.py``): the reduced configs of
both packages, the reference's params carried across, prefill and decode
stepped in both, one train step in both, and the serving driver in both,
each on the same numpy inputs."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import TrainConfig as RTrainConfig
from repro.configs import get_reduced as r_get_reduced
from repro.configs.base import ShapeSpec
from repro.data.tokens import token_batch_for
from repro.launch.mesh import make_host_mesh, mesh_context
from repro.launch.serve import Server as RServer
from repro.launch.steps import build_train_step as r_build_train_step
from repro.launch.steps import make_optimizer as r_make_optimizer
from repro.models import Model as RModel
from repro_torch import configs as p_configs
from repro_torch.configs import TrainConfig
from repro_torch.convert import params_from_numpy
from repro_torch.launch import Server
from repro_torch.launch import steps as p_steps
from repro_torch.models import Model
from repro_torch.utils import tree_leaves

LOGIT_TOL = 1e-4  # f32 logits, caches and losses
BF16_LOGIT_RTOL = 3e-2  # bf16 logits, of max |logit| (tests/test_torch_lm.py's bound)
DECODE_PREFILL_TOL = 1e-4  # the port's decode step against its own prefill, f32
STEP_RTOL = 1e-4  # a train step's loss and grad norm, of their size
PARAM_STEP_ATOL = 0.05  # of the learning rate, per step


def cfgs(arch, dtype="float32", **kw):
    kw = dict(dtype=dtype, param_dtype=dtype, **kw)
    return r_get_reduced(arch).replace(**kw), p_configs.get_reduced(arch).replace(**kw)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def ref_params(arch: str, dtype: str):
    """The reference's params (threefry init, key 0), drawn once per arch
    and dtype."""
    return jax.jit(RModel(cfgs(arch, dtype)[0]).init)(jax.random.PRNGKey(0))


def carried(arch, dtype="float32"):
    rp = ref_params(arch, dtype)
    return rp, params_from_numpy(to_np(rp), "cpu")


def tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def serve_steps(arch, dtype, S, n_decode, max_len=40):
    """Prefill a seeded [2, S] batch, then ``n_decode`` greedy decode steps
    in both packages, the port fed the reference's tokens. Returns the
    (reference, port) logits of each call and the last caches."""
    rcfg, pcfg = cfgs(arch, dtype)
    rp, pp = carried(arch, dtype)
    rm, pm = RModel(rcfg), Model(pcfg)
    toks = tokens((2, S), pcfg.vocab_size, 9)
    rl, rc = jax.jit(lambda p, b: rm.prefill(p, b, max_len))(rp, {"tokens": jnp.asarray(toks)})
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, max_len)
    logits = [(rl, pl)]
    r_decode = jax.jit(rm.decode_step)
    for _ in range(n_decode):
        cur = np.asarray(jnp.argmax(rl, -1))[:, None].astype(np.int32)
        rl, rc = r_decode(rp, rc, jnp.asarray(cur))
        pl, pc = pm.decode_step(pp, pc, torch.from_numpy(cur))
        logits.append((rl, pl))
    return logits, (rc, pc)


def decode_against_prefill(arch, S):
    """The port's prefill of S - 1 tokens and one decode step against its
    prefill of all S (f32): (full logits, stepped logits)."""
    _, pcfg = cfgs(arch)
    _, pp = carried(arch)
    model = Model(pcfg)
    toks = torch.from_numpy(tokens((2, S), pcfg.vocab_size, 3))
    full, _ = model.prefill(pp, {"tokens": toks}, S + 8)
    _, cache = model.prefill(pp, {"tokens": toks[:, :-1]}, S + 8)
    step, _ = model.decode_step(pp, cache, toks[:, -1:])
    return full, step


def train_step_metrics(arch, B, S, **kw):
    """One step of the port's train step and of the reference's (jit on the
    host mesh) from the same params and batch: (reference metrics, port
    metrics, the largest gap between the updated params)."""
    rcfg, pcfg = cfgs(arch)
    mesh = make_host_mesh()
    built = r_build_train_step(rcfg, RTrainConfig(**kw), ShapeSpec("t", "train", S, B), mesh)
    rp, pp = carried(arch)
    rp = jax.tree.map(jnp.array, rp)  # a copy: the step donates its state
    r_state = {"params": rp, "opt": r_make_optimizer(RTrainConfig(**kw)).init(rp),
               "step": jnp.int32(0)}
    tcfg = TrainConfig(**kw)
    p_state = {"params": pp, "opt": p_steps.make_optimizer(tcfg).init(pp),
               "step": torch.zeros((), dtype=torch.int32)}
    batch = token_batch_for(rcfg, batch=B, seq=S, seed=0)
    with mesh_context(mesh):
        r_fn = jax.jit(built.fn, in_shardings=built.in_shardings, out_shardings=built.out_shardings)
        r_state, r_m = r_fn(r_state, {k: jnp.asarray(v) for k, v in batch.items()})
    p_state, p_m = p_steps.build_train_step(pcfg, tcfg)(
        p_state, {k: torch.as_tensor(v) for k, v in batch.items()})
    gap = max(float(np.max(np.abs(a - b.detach().numpy()))) for a, b in
              zip(jax.tree.leaves(to_np(r_state["params"])), tree_leaves(p_state["params"])))
    return r_m, p_m, gap


def f32_servers(arch, batch, max_len):
    """The reference's and the port's server on the reduced config in f32,
    the port holding the reference's params."""
    ref = RServer(arch, batch=batch, max_len=max_len)
    cfg = ref.cfg.replace(dtype="float32", param_dtype="float32")
    ref.cfg, ref.model = cfg, RModel(cfg)
    ref.params = jax.jit(ref.model.init)(jax.random.PRNGKey(0))
    ref._prefill = jax.jit(lambda p, b: ref.model.prefill(p, b, max_len))
    ref._decode = jax.jit(ref.model.decode_step)

    port = Server(arch, batch=batch, max_len=max_len, device="cpu")
    port.cfg = port.cfg.replace(dtype="float32", param_dtype="float32")
    port.model = Model(port.cfg)
    port._prefill = lambda p, b: port.model.prefill(p, b, max_len)
    port._decode = port.model.decode_step
    port.params = params_from_numpy(to_np(ref.params), "cpu")
    return ref, port


def prompts(n, lo, hi, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]


def tree_layout(tree):
    """{path: (shape, dtype name)} of a reference (jax) or port (torch) tree."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out[path] = (tuple(t.shape), str(t.dtype).removeprefix("torch."))

    walk(tree, ())
    return out
