"""Item 16.2 on the port: ``launch.hlo_analysis`` (one rank's FLOPs, bytes
and collective bytes from a traced step), ``launch.roofline`` and
``launch.dryrun``, against the reference's ``repro.launch`` on the CPU.

- The counterparts of ``tests/test_hlo_analysis.py``'s cases: unrolled
  matmuls counted by the formula, a Python layer loop counted per layer
  (the reference's trip-count multiplication), the backward counted, a
  nested loop counted as the product, collective payload bytes by kind on
  a fake 8-rank group, collectives inside a layer loop counted per layer,
  and the op breakdown.
- One layer of reduced Qwen3-8B (its attention and SwiGLU custom ops)
  against the reference's ``analyze_hlo`` of the same layer under ``jit``:
  FLOPs within 2 %, the reference's own tolerance against
  ``cost_analysis``. Bytes are not compared: eager torch runs unfused ops.
- ``model_flops`` and ``derive`` equal to the reference's for every grid
  arch and shape, given the reference's TPU constants on the port's keys.
- ``run_cell`` on the 16 x 16 and 2 x 16 x 16 fake meshes (2 layers of
  Qwen3-8B x train_4k) and the collectives run in one subprocess: a fake
  process group is the process's default group, which a test worker must
  not hold. One rank holds under 8 GB on both meshes: the loss keeps its
  vocab split over "model", so no rank gathers the f32 logits over the
  whole vocab (64.6 GB and 141.8 GB a rank, and 2.49 GB of the 16 x 16
  cell's 3.50 GB of all-gather, when it did).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import GRID_ARCHS as R_GRID_ARCHS
from repro.configs import SHAPES_BY_NAME as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.configs import get_reduced as r_get_reduced
from repro.launch import roofline as r_roofline
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import TPU_V5E
from repro_torch.configs import GRID_ARCHS, SHAPES_BY_NAME, get_config, get_reduced
from repro_torch.launch import roofline
from repro_torch.launch.hlo_analysis import analyze_graph, trace
from repro_torch.launch.mesh import H100_SXM

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

M = 128
TRUE_FLOPS_1 = 2 * M ** 3
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _chain(x, ws, n):
    for i in range(n):
        x = x @ ws[i]
    return x


def test_unrolled_matmuls_count_the_formula():
    cost = analyze_graph(trace(lambda x, ws: _chain(x, ws, 10), _meta(M, M), _meta(10, M, M)))
    assert cost.flops == 10 * TRUE_FLOPS_1
    assert cost.n_ops == 20  # 10 selects (views, no bytes) and 10 products
    assert cost.bytes == 10 * 3 * M * M * 4
    # the reference's count of the same program
    x, ws = jax.ShapeDtypeStruct((M, M), jnp.float32), jax.ShapeDtypeStruct((10, M, M), jnp.float32)
    ref = analyze_hlo(jax.jit(lambda x, ws: _chain(x, ws, 10)).lower(x, ws).compile().as_text())
    assert cost.flops == pytest.approx(ref.flops, rel=0.01)


@pytest.mark.parametrize("layers", [1, 4, 7])
def test_a_layer_loop_counts_each_layer(layers):
    cost = analyze_graph(trace(lambda x, ws: _chain(x, ws, layers), _meta(M, M),
                               _meta(layers, M, M)))
    assert cost.flops == layers * TRUE_FLOPS_1


def test_forward_and_backward_count_three_times_the_forward():
    def grads(x, ws):
        x, ws = x.detach().requires_grad_(True), ws.detach().requires_grad_(True)
        loss = torch.sum(_chain(x, ws, 10) ** 2)
        return torch.autograd.grad(loss, (x, ws))

    cost = analyze_graph(trace(grads, _meta(M, M), _meta(10, M, M)))
    assert cost.flops == 30 * TRUE_FLOPS_1
    # the reference's gradient in ws alone skips the first input gradient
    x, ws = jax.ShapeDtypeStruct((M, M), jnp.float32), jax.ShapeDtypeStruct((10, M, M), jnp.float32)
    loss = lambda x, ws: jnp.sum(_chain(x, ws, 10) ** 2)
    ref = analyze_hlo(jax.jit(jax.grad(loss, argnums=1)).lower(x, ws).compile().as_text())
    assert cost.flops == pytest.approx(ref.flops, rel=0.05)


def test_a_nested_loop_counts_the_product():
    def nested(x, ws):
        for i in range(10):
            for _ in range(5):
                x = x @ ws[i]
        return x

    assert analyze_graph(trace(nested, _meta(M, M), _meta(10, M, M))).flops == 50 * TRUE_FLOPS_1


def test_the_breakdown_lists_ops_by_kind():
    from repro_torch.kernels.ops import flash_attention, swiglu

    def step(x, w, q, k, v, h, wg, wu, wd):
        return torch.relu(x @ w) + 1.0, flash_attention(q, k, v), swiglu(h, wg, wu, wd)

    args = (_meta(64, 32), _meta(32, 16), _meta(2, 8, 4, 32), _meta(2, 8, 2, 32),
            _meta(2, 8, 2, 16), _meta(16, 64), _meta(64, 96), _meta(64, 96), _meta(96, 64))
    cost = analyze_graph(trace(step, *args), breakdown=True)
    flash = 2 * (2 * 4) * 8 * 8 * (32 + 16)
    assert cost.flops_by_op == {"aten.mm": 2 * 64 * 32 * 16,
                                "repro_torch.flash_attention": flash,
                                "repro_torch.swiglu": 6 * 16 * 64 * 96}
    assert cost.flops == sum(cost.flops_by_op.values())
    assert cost.bytes_by_op["aten.relu"] == 2 * 64 * 16 * 4
    assert cost.bytes_by_op["aten.mm"] == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert cost.bytes == sum(cost.bytes_by_op.values())
    assert cost.collective_bytes == {}


def test_peak_bytes_follow_the_live_storages():
    """Inputs live throughout; an intermediate from the op that makes it to
    its last use; a view shares its base's storage."""
    def f(x):
        y = x * 2.0          # 4 KB, dies after z
        z = y.view(-1) + 1.0  # 4 KB, the output
        return z

    cost = analyze_graph(trace(f, _meta(32, 32)))
    assert cost.peak_bytes == 3 * 32 * 32 * 4


def test_one_qwen3_layer_counts_the_reference_flops():
    """Reduced Qwen3-8B, one dense block at B = 2 x S = 64 (bf16): the port's
    block (the flash and SwiGLU custom ops, on meta tensors) against the
    reference's ``_block_apply`` under jit, read by ``analyze_hlo``."""
    import repro.models.lm as r_lm
    from repro.models import Model as RModel
    import repro_torch.models.lm as p_lm
    from repro_torch.models import Model

    B, S = 2, 64
    r_cfg = r_get_reduced("qwen3-8b")
    r_params = jax.eval_shape(lambda: RModel(r_cfg).init(jax.random.PRNGKey(0)))
    r_layer = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape[1:], a.dtype),
                                     r_params["seg0"])
    x = jax.ShapeDtypeStruct((B, S, r_cfg.d_model), jnp.bfloat16)

    def r_block(p, x):
        return r_lm._block_apply(r_cfg, "dense", p, x, None, decode=False,
                                 positions=jnp.arange(S)[None, :])[0]

    ref = analyze_hlo(jax.jit(r_block).lower(r_layer, x).compile().as_text())

    cfg = get_reduced("qwen3-8b")
    layer = torch.utils._pytree.tree_map(lambda a: a[0], Model(cfg).abstract_params()["seg0"])
    leaves, spec = torch.utils._pytree.tree_flatten(layer)

    def block(h, *flat):
        p = torch.utils._pytree.tree_unflatten(list(flat), spec)
        return p_lm._block_apply(cfg, "dense", p, h, None, decode=False,
                                 positions=torch.arange(S, device=h.device)[None, :])[0]

    cost = analyze_graph(trace(block, _meta(B, S, cfg.d_model, dtype=torch.bfloat16), *leaves),
                         breakdown=True)
    assert cost.flops_by_op["repro_torch.flash_attention"] > 0
    assert cost.flops_by_op["repro_torch.swiglu"] > 0
    assert cost.flops == pytest.approx(ref.flops, rel=0.02)


def _tpu_on_port_keys():
    """The reference's TPU constants on the port's keys: one link rate for
    both links, so every mesh's collective term divides by ``ici_bw``."""
    return {"peak_flops_bf16": TPU_V5E["peak_flops_bf16"], "hbm_bw": TPU_V5E["hbm_bw"],
            "nvlink_bw": TPU_V5E["ici_bw"], "ib_bw": TPU_V5E["ici_bw"], "cards_per_node": 8,
            "hbm_bytes": TPU_V5E["hbm_bytes"]}


def test_model_flops_and_derive_equal_the_reference():
    assert GRID_ARCHS == R_GRID_ARCHS and list(SHAPES_BY_NAME) == list(R_SHAPES)
    coll = {"all-gather": 3.0e9, "reduce-scatter": 1.5e9, "all-reduce": 2.0e7}
    for arch in GRID_ARCHS:
        cfg, r_cfg = get_config(arch), r_get_config(arch)
        for name in SHAPES_BY_NAME:
            shape, r_shape = SHAPES_BY_NAME[name], R_SHAPES[name]
            assert roofline.model_flops(cfg, shape) == r_roofline.model_flops(r_cfg, r_shape)
            for mesh, chips in (("16x16", 256), ("2x16x16", 512)):
                kw = dict(mesh_name=mesh, chips=chips, flops_per_chip=3.2e13,
                          bytes_per_chip=4.1e11, collective_bytes=coll, notes="n")
                got = roofline.derive(cfg, shape, hw=_tpu_on_port_keys(), **kw).as_dict()
                want = r_roofline.derive(r_cfg, r_shape, hw=TPU_V5E, **kw).as_dict()
                assert got.pop("link") == "ib_bw"
                assert got == want, (arch, name, mesh)


def test_the_collective_term_takes_the_slowest_link():
    """Rank-major over nodes of 8 cards: an axis within a node stays on
    NVLink, one that spans nodes (every 16-wide production axis) takes
    InfiniBand, 50e9 B/s each way a card (DGX H100: 400 Gb/s NDR)."""
    assert H100_SXM["ib_bw"] == 50e9 and H100_SXM["nvlink_bw"] == 450e9
    assert H100_SXM["cards_per_node"] == 8
    link = roofline.collective_link
    assert link((16, 16), 8) == link((2, 16, 16), 8) == link((2, 8), 8) == "ib_bw"
    assert link((1, 8), 8) == link((2, 4), 8) == link((8, 1), 8) == link((1, 1), 8) == "nvlink_bw"
    t = roofline.derive(get_config("qwen3-8b"), SHAPES_BY_NAME["train_4k"], mesh_name="16x16",
                        chips=256, flops_per_chip=0.0, bytes_per_chip=0.0,
                        collective_bytes={"all-gather": 1e9})
    assert t.link == "ib_bw" and t.collective_s == 1e9 / 50e9 and t.dominant == "collective"


FAKE_WORLD = r'''
import json, sys
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.hlo_analysis import analyze_graph, trace
from repro_torch.launch import dryrun

out = {}
dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
try:
    dryrun.fake_mesh(dryrun.make_production_mesh())
    out["refused"] = None
except RuntimeError as e:
    out["refused"] = str(e)
dist.destroy_process_group()

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
g = dist.group.WORLD

def kinds(x, y):
    a = funcol.all_gather_tensor(x, 0, g)
    b = funcol.reduce_scatter_tensor(y, "sum", 0, g)
    c = funcol.all_reduce(x, "sum", g)
    d = funcol.all_to_all_single(y, None, None, g)
    z = x.clone()
    dist.all_reduce(z)
    return a, b, c, d, z

x = torch.empty(16, 32, device="meta")
y = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
out["kinds"] = analyze_graph(trace(kinds, x, y)).collective_bytes

def loop(x):
    for _ in range(7):
        x = funcol.all_gather_tensor(x, 0, g)[:16] * 2.0
    return x

out["loop"] = analyze_graph(trace(loop, torch.empty(16, 32, device="meta"))).collective_bytes
out["cell"] = dryrun.run_cell("qwen3-8b", "train_4k", overrides={"n_layers": 2})
out["cell_multi_pod"] = dryrun.run_cell("qwen3-8b", "train_4k", multi_pod=True,
                                        overrides={"n_layers": 2})
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def fake_world():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", FAKE_WORLD], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def test_collective_payload_bytes_by_kind(fake_world):
    f32, bf16 = 16 * 32 * 4, 64 * 32 * 2
    assert fake_world["kinds"] == {"all-gather": f32, "reduce-scatter": bf16,
                                   "all-reduce": 2 * f32, "all-to-all": bf16}


def test_collectives_inside_a_layer_loop_count_per_layer(fake_world):
    assert fake_world["loop"] == {"all-gather": 7 * 16 * 32 * 4}


def test_the_dry_run_refuses_a_process_with_a_real_group(fake_world):
    assert "process of its own" in fake_world["refused"]
    assert "gloo" in fake_world["refused"]


def test_run_cell_on_the_production_mesh(fake_world):
    """Two layers of Qwen3-8B x train_4k on the 16 x 16 fake mesh: the
    reference's cell rules (remat full, 2 microbatches at 65,536 tokens a
    chip, AdamW), one rank's counts, and the roofline on the H100."""
    rec = fake_world["cell"]
    assert rec["status"] == "ok", rec.get("error")
    assert (rec["mesh"], rec["mode"], rec["microbatches"]) == ("16x16", "sync", 2)
    assert rec["step_name"] == "train:qwen3-8b:train_4k:sync"
    assert isinstance(rec["fits_hbm"], bool)
    t = rec["trace"]
    assert t["flops_per_chip"] > 0 and t["bytes_per_chip"] > 0 and t["n_ops"] > 0
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(t["collective_bytes"])
    assert all(v > 0 for v in t["collective_bytes"].values())
    r = rec["roofline"]
    assert r["chips"] == 256 and r["link"] == "ib_bw"
    assert r["compute_s"] == t["flops_per_chip"] / H100_SXM["peak_flops_bf16"]
    assert r["memory_s"] == t["bytes_per_chip"] / H100_SXM["hbm_bw"]
    assert r["collective_s"] == sum(t["collective_bytes"].values()) / H100_SXM["ib_bw"]
    # one rank does about a 256th of the model's work (remat and the
    # loss's extra products on top)
    cfg = get_config("qwen3-8b").replace(n_layers=2)
    useful = roofline.model_flops(cfg, SHAPES_BY_NAME["train_4k"]) / 256
    assert 1.0 < t["flops_per_chip"] / useful < 2.0
    assert rec["memory"]["peak_memory_in_bytes"] >= rec["memory"]["argument_size_in_bytes"] > 0


@pytest.mark.parametrize("cell", ["cell", "cell_multi_pod"])
def test_one_rank_fits_and_gathers_no_vocab(fake_world, cell):
    """Two layers of Qwen3-8B x train_4k on each production mesh: one rank's
    peak under 8 GB (the loss's logits stay [b, chunk, V / 16] a rank), and
    on 16 x 16 the all-gather bytes without the loss's 16 gathers of a
    [8, 512, 9,504] f32 shard (2.49 GB)."""
    rec = fake_world[cell]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == ("16x16" if cell == "cell" else "2x16x16")
    assert rec["memory"]["peak_memory_in_bytes"] < 8e9
    assert rec["fits_hbm"] is True
    if cell == "cell":
        assert rec["trace"]["collective_bytes"]["all-gather"] < 1.5e9
