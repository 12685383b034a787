"""Port parity for RWKV6 (``rwkv6-1.6b``) on the CPU: the config, the
params' tree, the loss over the chunked and the step-by-step time mix,
prefill and decode logits and caches, decode against prefill, one train
step, remat and the serving driver, each held against ``repro`` on the
reduced config (2 layers, d 128, 2 heads of 64, d_ff 256, chunk 16) with
the reference's params carried across by ``repro_torch.convert``; torch on
one thread (``one_torch_thread``).

Tolerances (``_torch_recurrent``): logits, caches and losses within 1e-4
in f32 and 3e-2 of max |logit| in bf16 (``tests/test_torch_lm.py``'s
bounds); a train step's loss and grad norm within 1e-4 of their size, the
params within 0.05 of the learning rate; gradients within 1e-4 of each
leaf's max |grad|."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import get_reduced as r_get_reduced
from repro.launch.serve import Request as RRequest
from repro.models import Model as RModel
from repro.models import lm as r_lm
from repro_torch import configs as p_configs
from repro_torch.launch import Request, Server
from repro_torch.launch import train as p_train
from repro_torch.models import Model
from repro_torch.models import lm as p_lm
from repro_torch.utils import tree_leaves, tree_map

import _torch_recurrent as rec
from _torch_parity import max_abs_diff, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ARCH = "rwkv6-1.6b"
GRAD_RTOL = 1e-4


def test_config_is_the_reference_config():
    """Both configs equal the reference's, ``param_count`` too (it leaves
    out the decay adapter, the mixes' coefficients, u and the norms); the
    tree holds 1,583,941,632 params (3.17 GB in bf16)."""
    for r_get, p_get in ((r_get_config, p_configs.get_config),
                         (r_get_reduced, p_configs.get_reduced)):
        assert dataclasses.asdict(r_get(ARCH)) == dataclasses.asdict(p_get(ARCH))
    full = p_configs.get_config(ARCH)
    assert full.param_count() == r_get_config(ARCH).param_count()
    assert p_lm.segments(full) == [("rwkv", 24)]
    ref_tree = jax.eval_shape(lambda: RModel(r_get_config(ARCH)).init(jax.random.PRNGKey(0)))
    port_tree = Model(full).abstract_params()
    assert rec.tree_layout(port_tree) == rec.tree_layout(ref_tree)
    assert sum(t.numel() for t in tree_leaves(port_tree)) == 1_583_941_632


def test_init_draws_every_leaf_by_its_rule():
    """Params drawn by the port's generator: the fan-in rule, uniform mixes
    within +-0.5, ones for the norms and the group-norm scale."""
    _, pcfg = rec.cfgs(ARCH, "bfloat16")
    p = Model(pcfg).init(torch.Generator().manual_seed(0))["seg0"]
    tm = p["body"]["tm"]
    assert tm["w_r"].dtype == torch.bfloat16 and tuple(tm["w_r"].shape) == (2, 128, 2, 64)
    std = float(tm["w_g"].float().std())
    assert abs(std - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert float(tm["mu_r"].float().abs().max()) <= 0.5
    assert torch.equal(tm["ln_scale"], torch.ones_like(tm["ln_scale"]))


@pytest.mark.parametrize("S", [32, 12], ids=["chunked", "steps"])
def test_loss_matches(S):
    """S = 32 runs the chunked time mix, S = 12 the recurrence."""
    rcfg, pcfg = rec.cfgs(ARCH)
    rp, pp = rec.carried(ARCH)
    toks, tgts = (rec.tokens((2, S), pcfg.vocab_size, s) for s in (1, 2))
    rl, rm = jax.jit(RModel(rcfg).loss)(rp, {"tokens": jnp.asarray(toks),
                                             "targets": jnp.asarray(tgts)})
    pl, pm = Model(pcfg).loss(pp, {"tokens": torch.from_numpy(toks),
                                   "targets": torch.from_numpy(tgts)})
    assert sorted(pm) == ["accuracy", "aux", "loss"] and float(pm["aux"]) == 0.0
    assert abs(float(rl) - float(pl)) < rec.LOGIT_TOL
    assert abs(float(rm["accuracy"]) - float(pm["accuracy"])) < rec.LOGIT_TOL


@pytest.mark.parametrize("S", [16, 11], ids=["chunked_prefill", "steps_prefill"])
def test_prefill_and_decode_match_in_f32(S):
    logits, (rc, pc) = rec.serve_steps(ARCH, "float32", S, 3)
    for r, p in logits:
        assert p.dtype == torch.float32 and p.shape == (2, 512)
        assert max_abs_diff(r, p) < rec.LOGIT_TOL
    assert sorted(pc) == ["seg0"] and sorted(pc["seg0"]) == ["S", "cm_x", "tm_x"]
    assert max_abs_diff(rc, pc) < rec.LOGIT_TOL


def test_prefill_and_decode_match_in_bf16():
    logits, _ = rec.serve_steps(ARCH, "bfloat16", 16, 2)
    for r, p in logits:
        assert p.dtype == torch.float32
        assert max_abs_diff(r, p) <= rec.BF16_LOGIT_RTOL * float(np.max(np.abs(np.asarray(r))))


@pytest.mark.parametrize("S", [17, 12])
def test_decode_matches_prefill(S):
    """prefill(S - 1) then one decode step == prefill(S)'s last logits:
    the step against the chunked prefill (S = 17: 16 + 1) and against the
    recurrence (S = 12)."""
    full, step = rec.decode_against_prefill(ARCH, S)
    assert max_abs_diff(full, step) < rec.DECODE_PREFILL_TOL


def test_cache_layout_is_the_references():
    """The stacked cache: S [L, B, H, hd, hd] in f32, tm_x and cm_x
    [L, B, 1, d] in the activation dtype, zeros, as ``lm_cache`` builds it."""
    for dtype in ("float32", "bfloat16"):
        rcfg, pcfg = rec.cfgs(ARCH, dtype)
        want = r_lm.lm_cache(rcfg, 3, 40, abstract=True)
        got = Model(pcfg).init_cache(3, 40, device="cpu")
        assert rec.tree_layout(got) == rec.tree_layout(want)
        assert all(float(t.abs().max()) == 0.0 for t in tree_leaves(got))


def test_train_step_matches_reference():
    """One Adafactor step (the optimizer the card trains the large configs
    with). AdamW's first step moves each param by +-lr whatever its
    gradient's size, so a gradient within ~1e-7 of zero, whose sign the
    summation order decides, would move by 2 lr between the packages."""
    kw = dict(optimizer="adafactor", learning_rate=2e-3, total_steps=4, warmup_steps=1)
    r_m, p_m, gap = rec.train_step_metrics(ARCH, 2, 32, **kw)
    assert sorted(p_m) == ["accuracy", "aux", "grad_norm", "loss"]
    for k in ("loss", "grad_norm"):
        assert np.isfinite(float(p_m[k]))
        assert abs(float(r_m[k]) - float(p_m[k])) <= rec.STEP_RTOL * abs(float(r_m[k])), k
    assert gap <= rec.PARAM_STEP_ATOL * kw["learning_rate"]


@pytest.mark.parametrize("remat", ["none", "block", "full"])
def test_gradients_at_every_remat_match_jax_grad(remat):
    """Each block is one remat unit, as in the reference's ``_run_segment``;
    the values are the same at every setting."""
    rcfg, pcfg = rec.cfgs(ARCH)
    b = {"tokens": rec.tokens((2, 32), 512, 4), "targets": rec.tokens((2, 32), 512, 5)}
    want = jax.tree.leaves(jax.jit(jax.grad(lambda p, b: RModel(rcfg).loss(p, b)[0]))(
        rec.ref_params(ARCH, "float32"), {k: jnp.asarray(v) for k, v in b.items()}))
    params = tree_map(lambda t: t.requires_grad_(True), rec.carried(ARCH)[1])
    loss, _ = Model(pcfg.replace(remat=remat)).loss(
        params, {k: torch.from_numpy(v) for k, v in b.items()})
    got = torch.autograd.grad(loss, tree_leaves(params))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert max_abs_diff(w, g) <= GRAD_RTOL * float(np.max(np.abs(np.asarray(w))))


def test_server_run_generates_the_reference_tokens_in_f32():
    """serve.py:main's traffic (8 prompts of 4-15 tokens, batch 4, 12 new
    tokens): the prompts are padded to 8-15 tokens, so each prefill runs the
    step-by-step time mix."""
    ref, port = rec.f32_servers(ARCH, 4, 128)
    ps = rec.prompts(8, 4, 16, 512)
    want = ref.run([RRequest(i, p, max_new=12) for i, p in enumerate(ps)])
    got = port.run([Request(i, p, max_new=12) for i, p in enumerate(ps)])
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 12 for r in got)


def test_server_generates_tokens_in_bf16():
    server = Server(ARCH, batch=2, max_len=64, device="cpu")
    reqs = [Request(i, p, max_new=4) for i, p in enumerate(rec.prompts(4, 6, 7, 100))]
    done = server.run(reqs)
    assert all(len(r.generated) == 4 for r in done)
    assert all(0 <= t < server.cfg.padded_vocab for r in done for t in r.generated)


def test_trainer_runs_rwkv_whole():
    """``train()`` on reduced RWKV6 (chunk 16, seq 32: the chunked form):
    the loss falls and stays finite."""
    out = p_train.train(ARCH, reduced=True, steps=6, batch=2, seq=32, log_every=100,
                        device="cpu")
    assert all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]
