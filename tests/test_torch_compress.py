"""Port parity: the compressors. The port's compressors against the
reference's on the same numpy deltas and residuals, and, within the port,
the plane formulation against the per-client loop (the port of
``tests/test_compress_plane.py``'s compressor and engine tests)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, ref_params_np, to_np, with_params  # noqa: F401
import repro.compress as r_comp
import repro_torch.chaos as p_chaos
import repro_torch.compress as p_comp
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.transport as p_tr
from repro_torch.utils import tree_stack, tree_unstack

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P_TASK = with_params(p_core.mnist_cnn_task(device="cpu"), ref_params_np(0))
SHARDS = p_data.make_federated_mnist(6, 64, seed=0)
EVAL = p_data.synthetic_mnist(200, seed=77)

PLANE_COMPRESSORS = ["topk", "int8", "bf16"]


def _tree_np(seed, shapes=(("w", (6, 4)), ("b", (7,)), ("c", (3, 3, 2)))):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.7).astype(np.float32) for k, s in shapes}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _ulps(a, b):
    """Largest distance in units of the last place between two f32 arrays."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a.astype(np.float64) - b) / np.spacing(np.maximum(np.abs(a), np.abs(b))),
                        initial=0.0))


# ---------------------------------------------------------------------------
# port == reference on the same numpy inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_residual", [False, True])
def test_int8_codes_and_scales_equal_reference(with_residual):
    delta = _tree_np(0)
    res = _tree_np(1) if with_residual else None
    r_payload, r_res = r_comp.int8_compressor().compress(_jax(delta), res and _jax(res))
    p_payload, p_res = p_comp.int8_compressor().compress(_torch(delta), res and _torch(res))
    r_deq = r_comp.int8_compressor().decompress(r_payload)
    p_deq = p_comp.int8_compressor().decompress(p_payload)
    for k in delta:
        assert np.array_equal(to_np(p_payload[k]["q"]), to_np(r_payload[k]["q"])), k
        assert np.float32(p_payload[k]["scale"]) == np.float32(r_payload[k]["scale"]), k
        # dequantized values and residuals within one ulp (caveat C1 is on
        # the reference side: its jitted plane drifts one ulp from itself)
        assert _ulps(to_np(p_deq[k]), to_np(r_deq[k])) <= 1.0, k
        assert _ulps(to_np(p_res[k]), to_np(r_res[k])) <= 1.0, k


def test_bf16_bits_and_residuals_equal_reference():
    delta, res = _tree_np(2), _tree_np(3)
    r_payload, r_res = r_comp.bf16_compressor().compress(_jax(delta), _jax(res))
    p_payload, p_res = p_comp.bf16_compressor().compress(_torch(delta), _torch(res))
    for k in delta:
        assert np.array_equal(
            p_payload[k]["bf16"].view(torch.int16).numpy(),
            np.asarray(r_payload[k]["bf16"]).view(np.int16),
        ), k
        assert np.array_equal(to_np(p_res[k]), to_np(r_res[k])), k


def test_topk_equal_reference_on_tie_free_input():
    delta, res = _tree_np(4), _tree_np(5)
    r_c, p_c = r_comp.topk_compressor(0.25), p_comp.topk_compressor(0.25)
    r_payload, r_res = r_c.compress(_jax(delta), _jax(res))
    p_payload, p_res = p_c.compress(_torch(delta), _torch(res))
    r_deq, p_deq = r_c.decompress(r_payload), p_c.decompress(p_payload)
    for k in delta:
        assert to_np(p_payload[k]["idx"]).astype(np.int64).tolist() == to_np(
            r_payload[k]["idx"]).astype(np.int64).tolist(), k
        assert np.array_equal(to_np(p_payload[k]["vals"]), to_np(r_payload[k]["vals"])), k
        assert np.array_equal(to_np(p_deq[k]), to_np(r_deq[k])), k
        assert np.array_equal(to_np(p_res[k]), to_np(r_res[k])), k


@pytest.mark.parametrize("name,kw", [
    ("none", {}), ("topk", {"ratio": 0.01}), ("topk", {"ratio": 0.3}),
    ("randk", {"ratio": 0.05}), ("int8", {}), ("bf16", {}),
])
def test_wire_bytes_and_fingerprint_equal_reference(name, kw):
    tree = {"w": np.zeros((10000,), np.float32), "b": np.zeros((50,), np.float32),
            "k": np.zeros((3, 3, 1, 16), np.float32)}
    r_c, p_c = r_comp.get_compressor(name, **kw), p_comp.get_compressor(name, **kw)
    assert p_c.wire_bytes(_torch(tree)) == r_c.wire_bytes(_jax(tree))
    assert p_c.fingerprint == r_c.fingerprint
    assert p_c.name == r_c.name
    assert (p_c.compress_plane is None) == (r_c.compress_plane is None)
    assert (p_c.state_get is None) == (r_c.state_get is None)
    assert p_comp.compressed_bytes(p_c, _torch(tree)) == p_c.wire_bytes(_torch(tree))


def test_wire_bytes_ordered():
    tree = {"w": torch.zeros(10000), "b": torch.zeros(50)}
    topk = p_comp.get_compressor("topk", ratio=0.01)
    assert topk.wire_bytes(tree) == 8 * (100 + 1)
    sizes = [p_comp.get_compressor(n).wire_bytes(tree) for n in ("int8", "bf16", "none")]
    assert topk.wire_bytes(tree) < sizes[0] < sizes[1] < sizes[2]


def test_plane_int8_equal_reference_plane_over_rounds():
    """The port's plane against the reference's plane over 3 rounds on
    arbitrary slots: outputs and residuals within one ulp (the
    reference's jitted plane may round one product differently, C1)."""
    deltas = [_tree_np(10 + i) for i in range(3)]
    slots = [0, 2, 4]
    r_c, p_c = r_comp.int8_compressor(), p_comp.int8_compressor()
    r_plane = r_comp.init_residual_plane(_jax(_tree_np(0)), 5)
    p_plane = p_comp.init_residual_plane(_torch(_tree_np(0)), 5)
    r_stacked = jax.tree.map(lambda *l: jnp.stack(l), *[_jax(d) for d in deltas])
    p_stacked = tree_stack([_torch(d) for d in deltas])
    for _ in range(3):
        r_out, r_plane = r_c.compress_plane(r_stacked, r_plane, jnp.asarray(slots))
        p_out, p_plane = p_c.compress_plane(p_stacked, p_plane, slots)
        for k in r_out:
            assert _ulps(to_np(p_out[k]), to_np(r_out[k])) <= 1.0, k
            assert _ulps(to_np(p_plane[k]), to_np(r_plane[k])) <= 1.0, k


def test_randk_contract():
    """k distinct indices, residual == x - sparse exactly, the selection
    rotates per call, and the counter round-trips through state_get/set."""
    comp = p_comp.randk_compressor(ratio=0.25, seed=3)
    delta = _torch(_tree_np(6))
    res = _torch(_tree_np(7))
    payload, new_res = comp.compress(delta, res)
    for k in delta:
        x = (delta[k] + res[k]).reshape(-1)
        idx = payload[k]["idx"]
        kk = max(int(x.numel() * 0.25), 1)
        assert idx.numel() == kk and len(set(idx.tolist())) == kk
        sparse = torch.zeros_like(x)
        sparse[idx] = x[idx]
        assert torch.equal(payload[k]["vals"], x[idx])
        assert torch.equal(new_res[k].reshape(-1), x - sparse)
        assert torch.equal(comp.decompress(payload)[k].reshape(-1), sparse)
    assert comp.state_get() == {"counter": 1}
    second, _ = comp.compress(delta, res)
    assert any(not torch.equal(second[k]["idx"], payload[k]["idx"]) for k in delta)
    comp.state_set({"counter": 0})
    again, _ = comp.compress(delta, res)
    for k in delta:
        assert torch.equal(again[k]["idx"], payload[k]["idx"])
    assert comp.state_get() == {"counter": 1}
    assert comp.compress_plane is None and comp.fingerprint == ()


# ---------------------------------------------------------------------------
# within the port: plane == per-client loop, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", PLANE_COMPRESSORS)
def test_plane_compressor_bitwise_matches_sequential(name):
    """compress_plane on stacked deltas == compress/decompress client by
    client, bitwise: outputs and the evolving residuals, over 3 rounds,
    with delivering clients on arbitrary plane rows."""
    comp = p_comp.get_compressor(name, ratio=0.25)
    deltas = [_torch(_tree_np(20 + i)) for i in range(3)]
    slots = [0, 2, 4]
    seq_res = [None] * 5
    plane_res = p_comp.init_residual_plane(deltas[0], 5)
    for rnd in range(3):
        seq_out = []
        for j, s in enumerate(slots):
            payload, seq_res[s] = comp.compress(deltas[j], seq_res[s])
            seq_out.append(comp.decompress(payload))
        plane_out, plane_res = comp.compress_plane(tree_stack(deltas), plane_res, slots)
        for j, row in enumerate(tree_unstack(plane_out)):
            for k in row:
                assert torch.equal(seq_out[j][k], row[k]), (name, rnd, j, k)
        for s in slots:
            for k in plane_res:
                assert torch.equal(seq_res[s][k].reshape(plane_res[k][s].shape),
                                   plane_res[k][s]), (name, rnd, s, k)
        assert all(not plane_res[k][1].any() for k in plane_res)  # untouched row


def test_int8_on_the_cnn_tree_groups_every_leaf():
    """int8 on the CNN's 8 leaves, where one grouped call quantizes every
    leaf: the per-client codes and scales equal the reference's per leaf,
    and the plane equals the per-client loop bitwise over 3 rounds. CPU
    calls count no launch."""
    from repro_torch.kernels import quantize as p_q

    params = ref_params_np(0)
    rng = np.random.default_rng(5)
    deltas = [{layer: {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
                       for k, v in leaves.items()} for layer, leaves in params.items()}
              for _ in range(3)]
    as_torch = [{l: _torch(d) for l, d in delta.items()} for delta in deltas]
    r_payload, _ = r_comp.int8_compressor().compress(
        {l: _jax(d) for l, d in deltas[0].items()}, None)
    before = dict(p_q.launches)
    comp = p_comp.int8_compressor()
    p_payload, _ = comp.compress(as_torch[0], None)
    for layer in params:
        for k in params[layer]:
            assert np.array_equal(to_np(p_payload[layer][k]["q"]), to_np(r_payload[layer][k]["q"]))
            assert np.float32(p_payload[layer][k]["scale"]) == np.float32(r_payload[layer][k]["scale"])
    slots = [3, 0, 1]
    seq_res = [None] * 4
    plane_res = p_comp.init_residual_plane(as_torch[0], 4)
    for rnd in range(3):
        seq_out = []
        for j, slot in enumerate(slots):
            payload, seq_res[slot] = comp.compress(as_torch[j], seq_res[slot])
            seq_out.append(comp.decompress(payload))
        plane_out, plane_res = comp.compress_plane(tree_stack(as_torch), plane_res, slots)
        for j, row in enumerate(tree_unstack(plane_out)):
            for layer in row:
                for k in row[layer]:
                    assert torch.equal(seq_out[j][layer][k], row[layer][k]), (rnd, j, layer, k)
        for slot in slots:
            for layer in plane_res:
                for k in plane_res[layer]:
                    assert torch.equal(seq_res[slot][layer][k], plane_res[layer][k][slot])
    assert p_q.launches == before


def _server(compressor, *, rounds=2, batched=True):
    clients = [p_core.EdgeClient(i, dataset=s) for i, s in enumerate(SHARDS)]
    return p_core.FederatedServer(
        P_TASK, clients, p_core.fedavg(min_fit=0.5), tcp=p_tr.DEFAULT,
        chaos=p_chaos.ChaosSchedule(p_tr.LAB),
        config=p_core.ServerConfig(rounds=rounds, local_steps=2, seed=0, batched=batched),
        compressor=compressor, eval_data=EVAL,
    )


@pytest.mark.parametrize("name", ["topk", "int8", "bf16"])
def test_batched_plane_compression_matches_unstacked_loop(name):
    """The batched engine's plane path reproduces the unstacked per-client
    loop exactly (summary and eval trace equal, not close)."""
    comp = p_comp.get_compressor(name, ratio=0.1)
    plane = _server(comp).run()
    loop = _server(dataclasses.replace(comp, compress_plane=None)).run()
    assert plane.completed_rounds == 2
    assert plane.summary() == loop.summary()
    assert plane.eval_metrics == loop.eval_metrics


def test_compressed_rounds_stay_stacked():
    """The plane path never unstacks: no per-client compress calls."""
    comp = p_comp.get_compressor("topk", ratio=0.1)
    calls = []
    orig = comp.compress
    spy = dataclasses.replace(comp, compress=lambda d, r: calls.append(1) or orig(d, r))
    srv = _server(spy)
    hist = srv.run()
    assert hist.completed_rounds == 2
    assert calls == []
    assert srv._residual_plane is not None and srv._residual_plane.storage == "dense"


def test_randk_takes_the_per_client_loop():
    comp = p_comp.get_compressor("randk", ratio=0.1)
    srv = _server(comp)
    hist = srv.run()
    assert hist.completed_rounds == 2
    assert srv._residual_plane is None
    assert comp.state_get()["counter"] == sum(r.delivered for r in hist.rounds)
    assert all(c.residual is not None for c in srv.clients if c.rounds_participated)


def test_compressed_payload_flows_into_transport():
    """The compressor's wire size is what transport and byte accounting
    bill for the upload."""
    comp = p_comp.get_compressor("topk", ratio=0.01)
    srv = _server(comp)
    job = srv.begin_round(0)
    assert job.payload_bytes == comp.wire_bytes(srv.global_params)
    assert job.payload_bytes < P_TASK.update_bytes
