"""Port parity: the checkpoint store (``repro_torch.checkpoint``) and the
point checkpoint protocol across the two packages.

- The store round-trips f32, int8, uint16, f16 and bf16 leaves bit for bit
  (bf16 as its uint16 bits), keeps ``LATEST`` and the ``keep`` GC, refuses
  a shape mismatch, and leaves the old checkpoint whole when a write dies.
- The on-disk format is the reference's: a tree saved by either package
  loads in the other with equal bits, and the two manifests of one tree are
  the same bytes.
- A point checkpoint written by either package's server (``run(
  checkpoint_dir=..., stop_after_round=2)``) restores into the other's,
  which finishes the run: numpy History fields equal to the reference's
  uninterrupted run, accuracy and loss within 1e-3.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _card_reference import assert_histories_match
from _torch_parity import one_torch_thread, with_ref_init  # noqa: F401
import repro.chaos as r_chaos
import repro.checkpoint.store as r_store
import repro.compress as r_comp
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.checkpoint.store as p_store
import repro_torch.compress as p_comp
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.transport as p_tr

pytestmark = pytest.mark.usefixtures("one_torch_thread")

R_TASK = r_core.mnist_cnn_task()
P_TASK = with_ref_init(p_core.mnist_cnn_task(device="cpu"))


def _tree(seed=0):
    """A port tree with every dtype the store must carry, nested dicts and a
    list (``[i]`` path components)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(3, 17, generator=g)
    return {
        "b": {"w": x, "half": x.to(torch.float16), "bf": x.to(torch.bfloat16)},
        "a": [torch.randint(-128, 127, (5,), generator=g, dtype=torch.int8),
              torch.randint(0, 60000, (4, 2), generator=g).to(torch.int32)],
        "u16": torch.from_numpy(np.arange(7, dtype=np.uint16) * 9000),
    }


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("leaf", ["w", "half", "bf", "int8", "uint16"])
def test_roundtrip_is_bitwise(tmp_path, leaf):
    tree = _tree()
    pick = {"w": tree["b"]["w"], "half": tree["b"]["half"], "bf": tree["b"]["bf"],
            "int8": tree["a"][0], "uint16": tree["u16"]}[leaf]
    d = str(tmp_path / "t")
    p_store.save_tree(d, {"x": pick})
    got, meta = p_store.load_tree(d, {"x": torch.zeros_like(pick)})
    assert meta == {}
    assert got["x"].dtype == pick.dtype
    assert torch.equal(_bits(got["x"]), _bits(pick))
    manifest = json.loads((tmp_path / "t" / "manifest.json").read_text())
    want_stored = {"bf": "uint16", "half": "float16", "w": "float32", "int8": "int8",
                   "uint16": "uint16"}[leaf]
    assert manifest["dtypes"] == {"x": want_stored}
    assert manifest["orig_dtypes"] == {"x": str(pick.dtype).removeprefix("torch.")}


def test_whole_tree_and_numpy_template(tmp_path):
    tree = _tree(1)
    d = str(tmp_path / "t")
    p_store.save_tree(d, tree, metadata={"k": 1})
    tmpl = {"b": {k: torch.zeros_like(v) for k, v in tree["b"].items()},
            "a": [torch.zeros_like(v) for v in tree["a"]], "u16": torch.zeros_like(tree["u16"])}
    got, meta = p_store.load_tree(d, tmpl)
    assert meta == {"k": 1}
    assert isinstance(got["a"], list)
    for k in tree["b"]:
        assert torch.equal(_bits(got["b"][k]), _bits(tree["b"][k]))
    # a numpy template gets numpy leaves (bf16 as its exact f32 values)
    np_got, _ = p_store.load_tree(d, {"b": {"bf": np.zeros((3, 17), np.float32)}})
    assert np.array_equal(np_got["b"]["bf"], tree["b"]["bf"].float().numpy())


def test_latest_pointer_and_gc(tmp_path):
    mgr = p_store.CheckpointManager(str(tmp_path), keep=2)
    x = {"v": torch.arange(4.0)}
    assert mgr.latest_step() is None and mgr.restore_latest(x) is None
    for step in (1, 2, 3, 4):
        mgr.save(step, {"v": x["v"] * step}, metadata={"round": step})
    assert mgr.latest_step() == 4
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == [
        "step_000000003", "step_000000004"]
    got, meta = mgr.restore_latest(x)
    assert torch.equal(got["v"], x["v"] * 4)
    assert meta == {"round": 4, "step": 4} and mgr.metadata(3)["round"] == 3


def test_shape_mismatch_and_missing_leaf_refused(tmp_path):
    d = str(tmp_path / "t")
    p_store.save_tree(d, {"v": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="shape mismatch for v"):
        p_store.load_tree(d, {"v": torch.zeros(4, 3)})
    with pytest.raises(KeyError, match="missing leaf w"):
        p_store.load_tree(d, {"w": torch.zeros(3, 4)})


def test_crash_during_write_keeps_the_old_checkpoint(tmp_path, monkeypatch):
    """A write that dies before the rename leaves the last checkpoint and
    LATEST as they were, and no temp directory behind."""
    mgr = p_store.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"v": torch.ones(3)})

    def boom(*a, **k):
        raise OSError("disk died mid-write")

    monkeypatch.setattr(p_store.np, "savez", boom)
    with pytest.raises(OSError, match="mid-write"):
        mgr.save(2, {"v": torch.zeros(3)})
    monkeypatch.undo()
    assert mgr.latest_step() == 1
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_000000001"]
    got, _ = mgr.restore_latest({"v": torch.zeros(3)})
    assert torch.equal(got["v"], torch.ones(3))


def test_slot_maps_entry(tmp_path):
    mgr = p_store.CheckpointManager(str(tmp_path))
    mgr.save(1, {"v": torch.zeros(2)})
    assert mgr.slot_maps(1) == {}
    mgr.save(2, {"v": torch.zeros(2)}, slot_maps={"p0000/residual": np.array([7, 3])})
    assert mgr.slot_maps(2) == {"p0000/residual": [7, 3]}


# ---------------------------------------------------------------------------
# the format across packages
# ---------------------------------------------------------------------------


def _np_tree():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 17)).astype(np.float32)
    return {"b": {"w": x, "half": x.astype(np.float16)},
            "a": [rng.integers(-128, 127, 5).astype(np.int8)],
            "u16": (np.arange(7) * 9000).astype(np.uint16)}


def test_reference_save_loads_in_the_port(tmp_path):
    x = np.random.default_rng(2).normal(size=(3, 17)).astype(np.float32)
    ref = {**_np_tree(), "bf": jnp.asarray(x, jnp.bfloat16)}
    d = str(tmp_path / "r")
    r_store.save_tree(d, ref, metadata={"from": "reference"}, slot_maps={"res": [4, 1]})
    tmpl = p_store._rebuild(ref, {k: torch.zeros(tuple(np.shape(v)), dtype={
        "bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
        "int8": torch.int8, "uint16": torch.uint16}[str(v.dtype)])
        for k, v in p_store._flatten_with_paths(ref).items()})
    got, meta = p_store.load_tree(d, tmpl)
    assert meta == {"from": "reference"} and p_store.load_slot_maps(d) == {"res": [4, 1]}
    assert torch.equal(got["bf"].view(torch.int16),
                       torch.from_numpy(np.array(np.asarray(ref["bf"]).view(np.int16))))
    for key, want in p_store._flatten_with_paths(_np_tree()).items():
        leaf = p_store._flatten_with_paths(got)[key]
        assert np.array_equal(leaf.numpy(), want) and leaf.numpy().dtype == want.dtype, key


def test_port_save_loads_in_the_reference(tmp_path):
    tree = _tree(3)
    d = str(tmp_path / "p")
    p_store.save_tree(d, tree, metadata={"from": "port"})
    tmpl = p_store._rebuild(tree, {k: jnp.zeros(tuple(v.shape), {
        torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16, torch.float32: jnp.float32,
        torch.int8: jnp.int8, torch.int32: jnp.int32, torch.uint16: jnp.uint16}[v.dtype])
        for k, v in p_store._flatten_with_paths(tree).items()})
    got, meta = r_store.load_tree(d, tmpl)
    assert meta == {"from": "port"}
    assert np.array_equal(np.asarray(got["b"]["bf"]).view(np.uint16),
                          tree["b"]["bf"].view(torch.int16).numpy().view(np.uint16))
    assert np.asarray(got["b"]["bf"]).dtype.name == "bfloat16"
    for key, leaf in p_store._flatten_with_paths(tree).items():
        if leaf.dtype != torch.bfloat16:
            assert np.array_equal(np.asarray(p_store._flatten_with_paths(got)[key]),
                                  leaf.numpy()), key


def test_manifests_are_the_same_bytes(tmp_path):
    """One tree (numpy leaves in both, and the same tree as port tensors)
    gives the same manifest.json bytes from either package."""
    tree = _np_tree()
    r_store.save_tree(str(tmp_path / "r"), tree, metadata={"m": [1.5, "x"]},
                      slot_maps={"s": [2, 0]})
    p_store.save_tree(str(tmp_path / "p"), tree, metadata={"m": [1.5, "x"]},
                      slot_maps={"s": [2, 0]})
    as_tensors = {"b": {k: torch.from_numpy(v) for k, v in tree["b"].items()},
                  "a": [torch.from_numpy(tree["a"][0])], "u16": torch.from_numpy(tree["u16"])}
    p_store.save_tree(str(tmp_path / "t"), as_tensors, metadata={"m": [1.5, "x"]},
                      slot_maps={"s": [2, 0]})
    want = (tmp_path / "r" / "manifest.json").read_bytes()
    assert (tmp_path / "p" / "manifest.json").read_bytes() == want
    assert (tmp_path / "t" / "manifest.json").read_bytes() == want
    assert json.loads(want)["keys"] == ["a/[0]", "b/half", "b/w", "u16"]


# ---------------------------------------------------------------------------
# point checkpoints across packages
# ---------------------------------------------------------------------------

PKGS = {
    "ref": (r_core, r_chaos, r_tr, r_comp, r_data.make_federated_mnist(4, 64, seed=0),
            r_data.synthetic_mnist(150, seed=7), R_TASK),
    "port": (p_core, p_chaos, p_tr, p_comp, p_data.make_federated_mnist(4, 64, seed=0),
             p_data.synthetic_mnist(150, seed=7), P_TASK),
}
CASES = {
    # batched, int8 with the sparse residual plane (slot_maps in the manifest)
    "int8_sparse": (dict(batched=True, state_plane="sparse"), "int8"),
    # buffered async: queue and buffer deltas ride the arrays
    "async_k2": (dict(batched=True, async_mode=True, async_buffer_k=2), None),
    # sequential engine: per-client residuals ("cres") for bf16
    "bf16_sequential": (dict(batched=False), "bf16"),
}


def _server(pkg, case):
    core, chaos, tr, comp, shards, eval_data, task = PKGS[pkg]
    cfg, comp_name = CASES[case]
    return core.FederatedServer(
        task, [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)],
        core.fedavg(min_fit=0.5), tcp=tr.DEFAULT,
        chaos=chaos.ChaosSchedule(tr.LAB.replace(loss=0.05)),
        config=core.ServerConfig(rounds=4, local_steps=2, seed=0, **cfg),
        compressor=None if comp_name is None else getattr(comp, f"{comp_name}_compressor")(),
        eval_data=eval_data,
    )


_REF = {}


def _reference_run(case):
    if case not in _REF:
        srv = _server("ref", case)
        _REF[case] = (srv.run(), srv.clients)
    return _REF[case]


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("case", list(CASES))
def test_point_checkpoint_crosses_packages(tmp_path, case, writer, reader):
    """Kill either package's run after round 2 and resume it in the other:
    the finished History equals the reference's uninterrupted run (numpy
    fields exactly, accuracy and loss within 1e-3)."""
    d = str(tmp_path / "ckpt")
    part = _server(writer, case).run(checkpoint_dir=d, stop_after_round=2)
    assert len(part.rounds) == 2
    res = _server(reader, case)
    hist = res.run(checkpoint_dir=d)
    ref_hist, ref_clients = _reference_run(case)
    assert_histories_match(ref_hist, ref_clients, hist, res.clients)
    assert hist.completed_rounds > 0
    manifest = json.loads(open(os.path.join(d, "step_000000004", "manifest.json")).read())
    point = manifest["metadata"]["point"]
    assert manifest["metadata"]["fingerprint"]["strategy"] == "fedavg"
    if case == "int8_sparse":
        assert "residual" in manifest["slot_maps"] and point["residual_plane"]["storage"] == "sparse"
    if case == "async_k2":
        assert point["model_version"] > 0 and point["event_seq"] > 0
    if case == "bf16_sequential":
        assert point["residual_clients"]
