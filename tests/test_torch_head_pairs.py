"""Every (q/k D, v Dv) pair that ``ops.flash_attention`` reaches in a
config the port supports is one the flash kernel is built for
(``kernels.flash_attention.HEAD_PAIRS``, ``csrc/flash_attention.cu``'s
FLASH_PAIRS). On a CUDA tensor the wrapper raises for any other pair, with
no fallback, so a config with a pair outside the table runs only on the
CPU. The pairs are read from the loss and a prefill of every full and
reduced config on ``meta`` tensors (shapes only: nothing is computed): the
GQA models' heads, MLA's naive prefill (nope + rope, v), Whisper's encoder,
decoder and cross attention, the hybrid's shared block."""

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import Model

from _torch_parity import one_torch_thread  # noqa: F401

# the only config with no attention at all: RWKV6's time mix
NO_ATTENTION = {"rwkv6-1.6b"}
LM_ARCHS = [a for a in ARCH_IDS if a != "paper-mnist-cnn"]


def _reached_pairs(cfg, monkeypatch) -> set:
    seen = set()
    orig = ops.flash_attention

    def record(q, k, v, **kw):
        seen.add((int(q.shape[-1]), int(v.shape[-1])))
        return orig(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", record)
    model = Model(cfg)
    params = model.abstract_params()
    with torch.no_grad():
        model.loss(params, model.input_specs(ShapeSpec("pairs", "train", 512, 2)))
        model.prefill(params, model.input_specs(ShapeSpec("pairs", "prefill", 512, 2)), 520)
    return seen


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_every_reached_head_pair_is_built(one_torch_thread, monkeypatch, arch, full):
    cfg = get_config(arch) if full else get_reduced(arch)
    pairs = _reached_pairs(cfg, monkeypatch)
    assert bool(pairs) == (arch not in NO_ATTENTION), (arch, pairs)
    assert pairs <= set(fa.HEAD_PAIRS), (arch, full, pairs - set(fa.HEAD_PAIRS))


def test_the_small_head_pairs_are_the_reduced_configs():
    """The two pairs this table gained, and the reduced configs that need
    them: heads of 16 (Phi-3-medium, StarCoder2, Phi-3-vision, Whisper) and
    reduced DeepSeek-V2's MLA prefill at q / k 16 + 8 = 24, v 16."""
    assert {(16, 16), (24, 16)} <= set(fa.HEAD_PAIRS)
    for arch in ("phi3-medium-14b", "starcoder2-3b", "phi-3-vision-4.2b", "whisper-base"):
        assert get_reduced(arch).resolved_head_dim == 16, arch
    mla = get_reduced("deepseek-v2-236b").mla
    assert (mla.qk_nope_dim + mla.qk_rope_dim, mla.v_head_dim) == (24, 16)
