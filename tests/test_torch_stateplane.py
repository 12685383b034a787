"""Port parity: the StatePlane and compressed rounds. The port of the
StatePlane unit tests of ``tests/test_population_plane.py`` (slot-map
invariants, the pow-2 ladder, dense is identity, cross-storage restore),
the dense == sparse bitwise matrix over engines x compressors, and
compressed port Histories against the reference's from the same initial
params and residuals, carried across through ``repro_torch.convert``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _card_reference import assert_histories_match
from _torch_parity import one_torch_thread, ref_params_np, with_params  # noqa: F401
import repro.chaos as r_chaos
import repro.compress as r_comp
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.compress as p_comp
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.transport as p_tr
from repro_torch.convert import state_plane_from_numpy
from repro_torch.core import StatePlane
from repro_torch.utils import tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

R_TASK = r_core.mnist_cnn_task()
P_TASK = with_params(p_core.mnist_cnn_task(device="cpu"), ref_params_np(0))

TEMPLATE = {"w": torch.zeros(3, 2), "b": torch.zeros(5)}


def _rows_tree(rng, n):
    return {
        "w": torch.from_numpy(rng.normal(size=(n, 3, 2)).astype(np.float32)),
        "b": torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32)),
    }


def _row_equal(tree, i, ref_row):
    return all(torch.equal(tree[k][i], ref_row[k]) for k in tree)


def _zero_row(tree, i):
    return all(not tree[k][i].any() for k in tree)


# ---------------------------------------------------------------------------
# slot-map invariants (property-based)
# ---------------------------------------------------------------------------


@settings(deadline=None, max_examples=50)
@given(
    cohorts=st.lists(st.lists(st.integers(0, 63), min_size=1, max_size=12), min_size=1, max_size=8),
    seed=st.integers(0, 2**16),
)
def test_gather_scatter_identity(cohorts, seed):
    """Every slot gathers exactly the last rows scattered to it, untouched
    slots gather zeros, and the host map never disagrees."""
    rng = np.random.default_rng(seed)
    plane = StatePlane(TEMPLATE, 64, storage="sparse")
    ref = {}
    for cohort in cohorts:
        slots = sorted(set(cohort))  # engines never pass duplicate slots
        rows = _rows_tree(rng, len(slots))
        plane.scatter(slots, rows)
        for i, s in enumerate(slots):
            ref[s] = {k: rows[k][i] for k in rows}
    got = plane.gather(sorted(ref))
    for i, s in enumerate(sorted(ref)):
        assert _row_equal(got, i, ref[s]), s
    untouched = [s for s in range(64) if s not in ref][:4]
    if untouched:
        z = plane.gather(untouched)
        assert all(_zero_row(z, i) for i in range(len(untouched)))
    assert plane.occupancy == len(ref) + len(untouched)


@settings(deadline=None, max_examples=50)
@given(
    ops=st.lists(
        st.builds(
            lambda kind, slots: (kind, slots),
            kind=st.sampled_from(["touch", "evict"]),
            slots=st.lists(st.integers(0, 31), min_size=1, max_size=6),
        ),
        min_size=1,
        max_size=12,
    ),
    seed=st.integers(0, 2**16),
)
def test_compaction_stability(ops, seed):
    """Occupancy tracks the live slot set, capacity is a power of two >=
    occupancy, evicted slots re-gather zeros, survivors keep their values
    bit for bit."""
    rng = np.random.default_rng(seed)
    plane = StatePlane(TEMPLATE, 32, storage="sparse")
    ref = {}
    for kind, slots in ops:
        slots = sorted(set(slots))
        if kind == "touch":
            rows = _rows_tree(rng, len(slots))
            plane.scatter(slots, rows)
            for i, s in enumerate(slots):
                ref[s] = {k: rows[k][i] for k in rows}
        else:
            plane.evict(slots)
            for s in slots:
                ref.pop(s, None)
        assert plane.occupancy == len(ref)
        cap = plane.capacity
        assert cap >= plane.occupancy
        assert cap == 0 or (cap & (cap - 1)) == 0, cap
    for s in sorted(ref):
        assert _row_equal(plane.gather([s]), 0, ref[s]), s
    dead = [s for s in range(32) if s not in ref][:3]
    if dead:
        z = plane.gather(dead)
        assert all(_zero_row(z, i) for i in range(len(dead)))


def test_growth_pow2_ladder_and_free_list_reuse():
    plane = StatePlane(TEMPLATE, 1024, storage="sparse")
    caps = []
    for s in range(0, 100, 10):
        plane.rows_for([s])
        caps.append(plane.capacity)
    assert all(c and (c & (c - 1)) == 0 for c in caps)
    assert caps == sorted(caps) and caps[0] == 8
    assert plane.capacity == 16  # 10 slots -> next pow2
    assert plane.nbytes == 16 * (6 + 5) * 4
    plane.evict(list(range(0, 50, 10)))
    plane.rows_for([500, 501, 502, 503, 504])
    assert plane.capacity == 16  # free rows reused, no growth
    assert plane.occupancy == 10
    with pytest.raises(KeyError):
        plane.rows_for([7], allocate=False)
    with pytest.raises(IndexError):
        plane.rows_for([1024])


def test_dense_storage_is_identity():
    plane = StatePlane(TEMPLATE, 16, storage="dense")
    assert plane.rows_for([3, 9, 0]).tolist() == [3, 9, 0]
    assert plane.occupancy == 16 and plane.capacity == 16
    assert plane.slot_list() == list(range(16))
    assert plane.state_meta() == {"storage": "dense"}
    rows = _rows_tree(np.random.default_rng(0), 2)
    plane.scatter([5, 11], rows)
    got = plane.gather([5, 11])
    for i in range(2):
        assert _row_equal(got, i, {k: rows[k][i] for k in rows})
    plane.evict([5])
    assert _zero_row(plane.gather([5]), 0)
    assert _row_equal(plane.gather([11]), 0, {k: rows[k][1] for k in rows})


@pytest.mark.parametrize("saved,restored", [
    ("dense", "dense"), ("dense", "sparse"), ("sparse", "dense"), ("sparse", "sparse"),
])
def test_from_checkpoint_across_storages(saved, restored):
    """state_arrays/slot_list round-trip through from_checkpoint in memory
    under every storage pair: the (slot, value) mapping is the contract."""
    rows = _rows_tree(np.random.default_rng(3), 3)
    src = StatePlane(TEMPLATE, 24, storage=saved)
    slots = [2, 7, 19]
    src.scatter(slots, rows)
    plane = StatePlane.from_checkpoint(
        TEMPLATE, 24, src.state_meta(), src.state_arrays(),
        storage=restored, slots=src.slot_list(),
    )
    assert plane.storage == restored
    zeros = StatePlane.template_arrays(TEMPLATE, 24, src.state_meta(), device="cpu")
    for k, leaf in src.state_arrays().items():
        assert zeros[k].shape == leaf.shape and not zeros[k].any()
    got = plane.gather(slots)
    for i in range(3):
        assert _row_equal(got, i, {k: rows[k][i] for k in rows})
    z = plane.gather([0, 23])
    assert _zero_row(z, 0) and _zero_row(z, 1)
    if restored == "sparse":
        assert plane.occupancy <= len(slots) + 2  # dense saves keep only non-zero rows
    # the restored plane owns its buffer: writing it leaves the source alone
    plane.scatter([2], {k: torch.zeros_like(rows[k][:1]) for k in rows})
    assert _row_equal(src.gather([2]), 0, {k: rows[k][0] for k in rows})


@pytest.mark.parametrize("saved,restored", [("sparse", "dense"), ("dense", "sparse")])
def test_reference_plane_carries_across(saved, restored):
    """A reference StatePlane, carried over as numpy through
    ``convert.state_plane_from_numpy``, gathers the same values."""
    rng = np.random.default_rng(5)
    template = {"w": jnp.zeros((3, 2)), "b": jnp.zeros((5,))}
    src = r_core.StatePlane(template, 24, storage=saved)
    slots = [4, 11, 20]
    src.scatter(slots, {"w": jnp.asarray(rng.normal(size=(3, 3, 2)).astype(np.float32)),
                        "b": jnp.asarray(rng.normal(size=(3, 5)).astype(np.float32))})
    plane = state_plane_from_numpy(
        template, 24, jax.tree.map(np.asarray, src.state_arrays()), src.slot_list(),
        meta=src.state_meta(), storage=restored, device="cpu",
    )
    assert plane.storage == restored
    query = slots + [0, 23]
    want = src.gather(query)
    got = plane.gather(query)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


# ---------------------------------------------------------------------------
# dense == sparse, bitwise, engines x compressors (on the port)
# ---------------------------------------------------------------------------

SHARDS = p_data.make_federated_mnist(8, 64, seed=0)
EVAL = p_data.synthetic_mnist(200, seed=77)

ENGINES = {
    "sequential": dict(batched=False),
    "batched": dict(batched=True),
    "fused_transport": dict(batched=True, stochastic=True, engine="fused_transport"),
}
COMPRESSORS = {
    "topk": lambda pkg: pkg.topk_compressor(0.1),
    "int8": lambda pkg: pkg.int8_compressor(),
    "bf16": lambda pkg: pkg.bf16_compressor(),
}


def _run_port(comp, state_plane, **cfg_kw):
    clients = [p_core.EdgeClient(i, dataset=s) for i, s in enumerate(SHARDS)]
    srv = p_core.FederatedServer(
        P_TASK, clients, p_core.fedavg(min_fit=0.5), tcp=p_tr.DEFAULT,
        chaos=p_chaos.ChaosSchedule(p_tr.LAB),
        config=p_core.ServerConfig(
            rounds=3, local_steps=2, seed=0, clients_per_round=0.5,
            state_plane=state_plane, **cfg_kw,
        ),
        compressor=comp, eval_data=EVAL,
    )
    return srv.run(), srv


def _assert_bitwise(ha, hb):
    assert ha.summary() == hb.summary()
    assert len(ha.rounds) == len(hb.rounds)
    for ra, rb in zip(ha.rounds, hb.rounds):
        assert ra == rb  # every field, the clients' metrics included
    assert ha.eval_metrics == hb.eval_metrics


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("comp", sorted(COMPRESSORS))
def test_dense_vs_sparse_bitwise(engine, comp):
    kw = ENGINES[engine]
    h_dense, srv_dense = _run_port(COMPRESSORS[comp](p_comp), "dense", **kw)
    h_sparse, srv = _run_port(COMPRESSORS[comp](p_comp), "sparse", **kw)
    assert h_dense.completed_rounds > 0
    _assert_bitwise(h_dense, h_sparse)
    if kw["batched"]:
        plane = srv._residual_plane
        assert plane.storage == "sparse"
        assert 0 < plane.occupancy <= len(SHARDS)
        assert plane.capacity <= 8  # compacted, not O(population)-padded
        dense = srv_dense._residual_plane
        want = dense.gather(plane.slot_list())
        got = plane.gather(plane.slot_list())
        for a, b in zip(tree_leaves(want), tree_leaves(got)):
            assert torch.equal(a, b)
    else:
        assert srv._residual_plane is None  # the sequential engine keeps EdgeClient.residual


# ---------------------------------------------------------------------------
# compressed History: port == reference from the same params and residuals
# ---------------------------------------------------------------------------


def _seeded_residual_plane(rng, n_slots, slots):
    """A reference sparse plane whose ``slots`` hold small non-zero
    residuals (the state a run carries after earlier rounds)."""
    template = jax.tree.map(jnp.asarray, ref_params_np(0))
    plane = r_core.StatePlane(template, n_slots, storage="sparse")
    rows = jax.tree.map(
        lambda l: jnp.asarray((rng.standard_normal((len(slots),) + l.shape) * 1e-3)
                              .astype(np.float32)),
        template,
    )
    plane.scatter(slots, rows)
    return plane


@pytest.mark.parametrize("comp", ["int8", "bf16"])
def test_compressed_history_matches_reference(comp):
    """Batched engine, 10 clients, 3 rounds, 2 local steps, both packages
    started from the same params and the same residuals: numpy fields
    exact, accuracy and loss within 1e-3."""
    n = 10
    ref_plane = _seeded_residual_plane(np.random.default_rng(9), n, [1, 4, 6, 9])
    # carried across before the reference run moves the plane on
    arrays = jax.tree.map(np.asarray, ref_plane.state_arrays())
    slots, meta = ref_plane.slot_list(), ref_plane.state_meta()

    def run(core, data, tr, chaos, task, comp_pkg, plane):
        shards = data.make_federated_mnist(n, 64, seed=0)
        clients = [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
        sched = chaos.ChaosSchedule(tr.LAB).add(chaos.netem(1.5, 10_000.0, delay=0.4, loss=0.05))
        srv = core.FederatedServer(
            task, clients, core.fedavg(min_fit=0.3), tcp=tr.DEFAULT, chaos=sched,
            config=core.ServerConfig(rounds=3, local_steps=2, seed=0, batched=True,
                                     state_plane="sparse"),
            compressor=COMPRESSORS[comp](comp_pkg),
            eval_data=data.synthetic_mnist(2000, seed=77),
        )
        srv._residual_plane = plane
        return srv.run(), srv

    r_hist, r_srv = run(r_core, r_data, r_tr, r_chaos, R_TASK, r_comp, ref_plane)
    p_plane = state_plane_from_numpy(
        P_TASK.init_fn(None), n, arrays, slots, meta=meta, storage="sparse", device="cpu",
    )
    p_hist, p_srv = run(p_core, p_data, p_tr, p_chaos, P_TASK, p_comp, p_plane)
    assert p_hist.completed_rounds == 3
    assert_histories_match(r_hist, r_srv.clients, p_hist, p_srv.clients)
    assert p_srv._residual_plane.slot_list() == r_srv._residual_plane.slot_list()
