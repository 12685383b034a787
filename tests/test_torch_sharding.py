"""Item 16's first part on the port, held to ``repro`` on the CPU, all of it
abstract: the shape grid and ``GRID_ARCHS``, ``Model.param_axes`` /
``cache_spec`` / ``cache_axes`` / ``input_specs``, the sharding rules
(``repro_torch.sharding``) leaf for leaf against the reference's
``PartitionSpec``s on the production meshes, ``to_placements`` and the
mesh shapes. The meshes are duck-typed, as in ``tests/test_sharding.py``:
axis names and sizes are all the rules read."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro import configs as r_configs
from repro import sharding as r_sharding
from repro.models import Model as RModel
from repro_torch import configs as p_configs
from repro_torch import sharding as p_sharding
from repro_torch.launch import mesh as p_mesh
from repro_torch.models import Model
from repro_torch.utils import tree_leaves
from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class FakeMesh:
    """Duck-typed mesh: axis_names + devices.shape is all the rules use."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes.keys())
        self.devices = np.empty(tuple(sizes.values()), dtype=object)


MESH = FakeMesh({"data": 16, "model": 16})
POD_MESH = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": POD_MESH}


def _port_mesh(mesh):
    return p_mesh.MeshShape(mesh.axis_names, mesh.devices.shape)


# tests/test_sharding.py's cases: (shape, axes, mesh, keywords, the spec)
RULE_CASES = {
    "embedding_2d": ((102400, 5120), ("vocab", "embed"), MESH, {}, P("model", "data")),
    "attention_weights": ((4096, 32, 128), ("embed", "heads", "head_dim"), MESH, {},
                          P("data", "model", None)),
    "kv_heads_fallback": ((3072, 2, 128), ("embed", "kv_heads", "head_dim"), MESH, {},
                          P("data", None, None)),
    "q_heads_fallback": ((5120, 40, 128), ("embed", "heads", "head_dim"), MESH, {},
                         P("data", None, None)),
    "heads_beat_lora": ((1536, 128, 192), ("lora", "heads", "qk_dim"), MESH, {},
                        P("data", "model", None)),
    "experts": ((160, 5120, 1536), ("experts", "embed", "ffn"), MESH, {},
                P("model", "data", None)),
    "no_fsdp": ((4096, 12288), ("embed", "ffn"), MESH, {"fsdp": False}, P(None, "model")),
    "decode_cache": ((36, 128, 32768, 8, 128),
                     ("layers", "batch", "kvseq", "kv_heads", "head_dim"), MESH, {},
                     P(None, "data", "model", None, None)),
    "tiny_batch": ((24, 1, 32, 64, 64), ("layers", "batch", "heads", "head_dim", "head_dim2"),
                   MESH, {}, P(None, None, "model", None, None)),
    "batch_pod_and_data": ((256, 4096), ("batch", "seq"), POD_MESH,
                           {"batch_axes": ("pod", "data")}, P(("pod", "data"), None)),
    "batch_pod_only": ((2, 4096), ("batch", "seq"), POD_MESH,
                       {"batch_axes": ("pod", "data")}, P("pod", None)),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_cases_of_the_reference(case):
    shape, axes, mesh, kw, want = RULE_CASES[case]
    assert tuple(r_sharding.spec_for_leaf(shape, axes, mesh, **kw)) == tuple(want)
    for m in (mesh, _port_mesh(mesh)):
        assert p_sharding.spec_for_leaf(shape, axes, m, **kw) == tuple(want)


def test_input_shardings_batch_only():
    specs = {"tokens": torch.empty((16, 128), dtype=torch.int32, device="meta"),
             "scalar": torch.empty((), device="meta")}
    out = p_sharding.input_shardings(specs, p_mesh.MeshShape(("data", "model"), (1, 1)))
    assert out == {"tokens": ("data", None), "scalar": ()}
    assert p_sharding.batch_spec(POD_MESH, 256) == ("pod", "data")
    assert p_sharding.batch_spec(POD_MESH, 2) == "pod" and p_sharding.batch_spec(MESH, 1) is None
    assert p_sharding.state_plane_sharding(MESH) == ("data",)
    assert p_sharding.PRIORITY == r_sharding.PRIORITY
    assert p_sharding.CANDIDATES == r_sharding.CANDIDATES


def test_shape_grid_is_the_references():
    assert [dataclasses.asdict(s) for s in p_configs.ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in r_configs.ALL_SHAPES]
    assert sorted(p_configs.SHAPES_BY_NAME) == sorted(r_configs.SHAPES_BY_NAME)
    assert p_configs.GRID_ARCHS == r_configs.GRID_ARCHS and len(p_configs.GRID_ARCHS) == 10
    for arch in p_configs.GRID_ARCHS:
        assert ([s.name for s in p_configs.get_config(arch).valid_shapes()]
                == [s.name for s in r_configs.get_config(arch).valid_shapes()])
    assert p_configs.DECODE_32K.is_decode and not p_configs.TRAIN_4K.is_decode


def _ref_specs(spec_tree, axes_tree, mesh, **kw):
    """The reference's ``_tree_shardings`` without the ``NamedSharding``
    (which wants a mesh of devices): its ``spec_for_leaf`` per leaf."""
    return jax.tree.map(
        lambda leaf, axes: tuple(r_sharding.spec_for_leaf(tuple(leaf.shape), tuple(axes), mesh,
                                                          **kw)),
        spec_tree, axes_tree)


def _flat(tree, path=()):
    """{path: leaf} of a nested dict, a tuple of axes kept whole."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k], path + (k,)).items()}
    return {path: tree}


def _layout(tree):
    """{path: (shape, dtype name)} of a tree of jax or torch leaves."""
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in _flat(tree).items()}


@pytest.mark.parametrize("arch", p_configs.GRID_ARCHS)
def test_param_axes_and_specs_match_every_full_config(arch):
    """``param_axes`` is the reference's tree; the parameter specs agree
    leaf for leaf on both production meshes with FSDP on and off."""
    ref_model, port_model = RModel(r_configs.get_config(arch)), Model(p_configs.get_config(arch))
    r_axes, p_axes = ref_model.param_axes(), port_model.param_axes()
    assert _flat(p_axes) == _flat(r_axes)
    r_abs, p_abs = ref_model.abstract_params(), port_model.abstract_params()
    for mesh in MESHES.values():
        for fsdp in (True, False):
            want = _flat(_ref_specs(r_abs, r_axes, mesh, fsdp=fsdp))
            got = _flat(p_sharding.param_shardings(p_abs, p_axes, _port_mesh(mesh), fsdp=fsdp))
            assert got == want, (arch, mesh.axis_names, fsdp)


@pytest.mark.parametrize("arch", p_configs.GRID_ARCHS)
def test_decode_32k_cache_and_inputs_match_every_full_config(arch):
    """decode_32k's cache (B 128, 32,768 slots, on ``meta``): its layout,
    ``cache_axes`` and its specs (batch over data, and over pod x data on
    the pod mesh) as the reference's; ``input_specs`` of every shape in
    shapes and dtypes, and their specs."""
    ref_model, port_model = RModel(r_configs.get_config(arch)), Model(p_configs.get_config(arch))
    shape = p_configs.DECODE_32K
    B, S = shape.global_batch, shape.seq_len
    r_spec, p_spec = ref_model.cache_spec(B, S), port_model.cache_spec(B, S)
    assert _layout(p_spec) == _layout(r_spec)
    assert all(t.device.type == "meta" for t in tree_leaves(p_spec))
    r_axes, p_axes = ref_model.cache_axes(B, S), port_model.cache_axes(B, S)
    assert _flat(p_axes) == _flat(r_axes)
    for mesh, batch_axes in ((MESH, ("data",)), (POD_MESH, ("data",)),
                             (POD_MESH, ("pod", "data"))):
        want = _flat(_ref_specs(r_spec, r_axes, mesh, batch_axes=batch_axes))
        got = _flat(p_sharding.cache_shardings(p_spec, p_axes, _port_mesh(mesh),
                                               batch_axes=batch_axes))
        assert got == want, (arch, mesh.axis_names, batch_axes)
    for s in p_configs.ALL_SHAPES:
        r_in, p_in = ref_model.input_specs(s), port_model.input_specs(s)
        assert list(p_in) == list(r_in)
        assert _layout(p_in) == _layout(r_in)
        for include_pod in (True, False):
            got = p_sharding.input_shardings(p_in, _port_mesh(POD_MESH), include_pod=include_pod)
            for k, v in r_in.items():
                b = r_sharding.batch_spec(POD_MESH, v.shape[0], include_pod=include_pod)
                assert got[k] == (b, *([None] * (len(v.shape) - 1)))


def test_to_placements_on_cpu_meshes():
    mesh = p_mesh.make_production_mesh()
    assert p_sharding.to_placements(("data", None, "model"), mesh) == (Shard(0), Shard(2))
    assert p_sharding.to_placements((None, "model"), mesh) == (Replicate(), Shard(1))
    assert p_sharding.to_placements((None, None), mesh) == (Replicate(), Replicate())
    pod = p_mesh.make_production_mesh(multi_pod=True)
    assert p_sharding.to_placements((("pod", "data"), None, "model"), pod) == \
        (Shard(0), Shard(0), Shard(2))
    # a parameter spec of Qwen3 on the pod mesh, through the rules
    cfg = p_configs.get_config("qwen3-8b")
    spec = p_sharding.param_shardings(Model(cfg).abstract_params(), Model(cfg).param_axes(), pod)
    assert spec["seg0"]["attn"]["wq"] == (None, "data", "model", None)
    assert p_sharding.to_placements(spec["seg0"]["attn"]["wq"], pod) == \
        (Replicate(), Shard(1), Shard(2))
    with pytest.raises(AssertionError):  # one mesh axis on two dims
        p_sharding.to_placements(("data", "data"), mesh)
    with pytest.raises(AssertionError):  # an axis the mesh lacks
        p_sharding.to_placements(("pod", None), mesh)


def test_mesh_shapes_and_card_constants():
    assert p_mesh.make_production_mesh() == p_mesh.MeshShape(("data", "model"), (16, 16))
    pod = p_mesh.make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model") and pod.shape == (2, 16, 16)
    assert pod.size == 512
    if not torch.cuda.is_available():
        assert p_mesh.make_host_mesh(data=4, model=2) == p_mesh.MeshShape(("data", "model"), (1, 1))
    h = p_mesh.H100_SXM
    assert (h["peak_flops_bf16"], h["hbm_bw"], h["hbm_bytes"], h["nvlink_bw"],
            h["power_limit_w"]) == (989e12, 3.35e12, 80e9, 450e9, 700)
