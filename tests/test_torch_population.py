"""Port parity: the lazy client universe (``repro_torch.core.Population``),
the counterparts of ``tests/test_population_plane.py``'s population tests.

- A lazy Population over the same shards is BITWISE equal to the list
  universe inside the port (every History field and the final params),
  with and without client-killing chaos, while materializing only touched
  clients; against the reference's Population run the numpy History fields
  are equal and accuracy and loss within 1e-3.
- The universe's mechanics: lazy materialization, the shard LRU and its
  deterministic re-materialization, ``live_ids`` (the O(1) path without
  liveness chaos, the scan with it) and iteration that raises.
- A 100,000-client population with cohort 32 runs in O(cohort) state.
"""

import tracemalloc

import numpy as np
import pytest
import torch

from _card_reference import assert_histories_match
from _torch_parity import assert_same, one_torch_thread, with_ref_init  # noqa: F401
import repro.chaos as r_chaos
import repro.compress as r_comp
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.compress as p_comp
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.experiments.common as p_experiments
import repro_torch.transport as p_tr
from repro_torch.utils import tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

P_TASK = with_ref_init(p_core.mnist_cnn_task(device="cpu"))
R_TASK = r_core.mnist_cnn_task()
SHARDS = p_data.make_federated_mnist(8, 64, seed=0)
EVAL = p_data.synthetic_mnist(200, seed=77)
PKGS = {
    "port": (p_core, p_data, p_tr, p_chaos, p_comp, P_TASK, SHARDS, EVAL),
    "ref": (r_core, r_data, r_tr, r_chaos, r_comp, R_TASK,
            r_data.make_federated_mnist(8, 64, seed=0), r_data.synthetic_mnist(200, seed=77)),
}


def _run(universe, comp, plane, *, pkg="port", chaos_rate=None, min_fit=0.5, **cfg_kw):
    core, _, tr, chaos_pkg, comp_pkg, task, _, eval_data = PKGS[pkg]
    cfg_kw.setdefault("rounds", 3)
    cfg_kw.setdefault("local_steps", 2)
    cfg_kw.setdefault("seed", 0)
    cfg_kw.setdefault("clients_per_round", 0.5)
    chaos = chaos_pkg.ChaosSchedule(tr.LAB)
    if chaos_rate is not None:
        chaos.add(chaos_pkg.client_failure_schedule(8, chaos_rate, seed=3))
    srv = core.FederatedServer(
        task, universe, core.fedavg(min_fit=min_fit), tcp=tr.DEFAULT, chaos=chaos,
        config=core.ServerConfig(state_plane=plane, **cfg_kw),
        compressor=None if comp is None else getattr(comp_pkg, f"{comp}_compressor")(),
        eval_data=eval_data,
    )
    return srv.run(), srv


def _list(pkg="port"):
    core, shards = PKGS[pkg][0], PKGS[pkg][6]
    return [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]


def _pop(pkg="port"):
    core, data, shards = PKGS[pkg][0], PKGS[pkg][1], PKGS[pkg][6]
    return core.Population(len(shards), data.shard_list_factory(shards))


def _assert_bitwise(a, b):
    assert_same(a.history, b.history, "history")
    for x, y in zip(tree_leaves(a.global_params), tree_leaves(b.global_params)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("comp,engine", [
    ("topk", dict(batched=True)),
    ("int8", dict(batched=True)),
    ("bf16", dict(batched=False)),
    (None, dict(batched=True, stochastic=True, engine="fused_transport")),
])
def test_population_universe_bitwise_vs_list(comp, engine):
    """The lazy universe over the SAME shards reproduces the list universe
    bitwise, touching only the clients its cohorts drew."""
    _, s_list = _run(_list(), comp, "dense", **engine)
    pop = _pop()
    _, s_pop = _run(pop, comp, "sparse", **engine)
    _assert_bitwise(s_list, s_pop)
    assert pop.materialized <= len(SHARDS)
    touched = {i for r in s_pop.history.rounds for i in r.selected_ids}
    assert {c.client_id for c in pop.active_clients()} == touched


def test_population_with_client_chaos_bitwise():
    """With pod-kill chaos the O(1) liveness path is off; the scan draws the
    same cohorts as the list's filter."""
    _, s_list = _run(_list(), "topk", "dense", batched=True, chaos_rate=0.25, min_fit=0.25)
    _, s_pop = _run(_pop(), "topk", "sparse", batched=True, chaos_rate=0.25, min_fit=0.25)
    _assert_bitwise(s_list, s_pop)


@pytest.mark.parametrize("chaos_rate", [None, 0.25])
def test_population_history_matches_reference(chaos_rate):
    hists = {}
    for pkg in ("ref", "port"):
        pop = _pop(pkg)
        hist, srv = _run(pop, "topk", "sparse", pkg=pkg, batched=True, chaos_rate=chaos_rate,
                         min_fit=0.25)
        hists[pkg] = (hist, [pop.peek(i) for i in range(len(pop))])
    assert hists["port"][0].completed_rounds == 3
    assert_histories_match(*hists["ref"], *hists["port"])


# ---------------------------------------------------------------------------
# the universe's mechanics
# ---------------------------------------------------------------------------


def test_population_lazy_materialization_counts():
    calls = []

    def factory(cid):
        calls.append(cid)
        return SHARDS[cid % len(SHARDS)]

    pop = p_core.Population(1000, factory)
    assert len(pop) == 1000
    c = pop.client(7)
    assert c.client_id == 7 and c.dataset is not None
    assert pop.client(7) is c
    assert calls == [7]
    assert pop.materialized == 1
    assert pop.peek(900).dataset is None
    assert calls == [7]
    with pytest.raises(IndexError):
        pop.peek(1000)
    with pytest.raises(ValueError, match="shard_factory"):
        p_core.Population(3).client(0)


def test_population_iteration_raises():
    pop = p_core.Population(10, p_data.shard_list_factory(SHARDS))
    with pytest.raises(TypeError, match="lazy"):
        list(pop)


def test_population_lru_eviction_and_redeterminism():
    """Evicted shards come back bit for bit, and the reference's factory
    makes the same shards."""
    factory = p_data.federated_mnist_factory(32, seed=5)
    pop = p_core.Population(100, factory, max_cached_shards=4)
    first = np.asarray(pop.client(0).dataset.images)
    for cid in range(1, 10):
        pop.client(cid)
    assert pop.cached_shards <= 4
    assert pop.peek(3).dataset is None  # evicted, metadata kept
    assert pop.client(0) is pop.peek(0)
    again = np.asarray(pop.client(0).dataset.images)
    assert np.array_equal(first, again)
    assert pop.shards_built >= 11
    ref = r_data.federated_mnist_factory(32, seed=5)(0)
    assert np.array_equal(ref.images, first) and np.array_equal(ref.labels, pop.client(0).dataset.labels)


def test_population_live_ids_fast_path():
    pop = p_core.Population(50, p_data.shard_list_factory(SHARDS))
    assert pop.live_ids(p_chaos.ChaosSchedule(p_tr.LAB), 0.0) is None
    chaos = p_chaos.ChaosSchedule(p_tr.LAB).add(p_chaos.client_failure_schedule(50, 0.2, seed=1))
    ids = pop.live_ids(chaos, 0.0)
    assert ids is not None and ids.dtype == np.int64
    assert ids.tolist() == [c for c in range(50) if chaos.alive(0.0, c)]


def test_population_point_in_the_harness():
    """``experiments._make_point(population=...)`` builds a lazy universe
    with nothing materialized, and refuses an O(population)
    ``client_links`` list."""
    p = p_experiments._make_point(population=1000, rounds=1, local_steps=1,
                                  clients_per_round=0.004, min_fit=0.004,
                                  state_plane="sparse", compressor="topk:0.05")
    assert isinstance(p.clients, p_core.Population) and len(p.clients) == 1000
    assert p.clients.materialized == 0
    with pytest.raises(ValueError, match="link_override_fn"):
        p_experiments._make_point(population=10, client_links=[None] * 10)


# ---------------------------------------------------------------------------
# memory: O(cohort), not O(population)
# ---------------------------------------------------------------------------

_MEM_BUDGET_BYTES = 512 * 1024 * 1024


def test_population_memory_o_cohort():
    """A 100,000-client population with cohort 32, 2 rounds: the sparse
    residual plane and the materialized clients stay O(cohort), and the
    host peak that tracemalloc sees (numpy and Python objects; torch's CPU
    allocator is not traced) stays under the reference's budget."""
    n, cohort = 100_000, 32
    pop = p_core.Population(n, p_data.federated_mnist_factory(64, seed=9),
                            max_cached_shards=4 * cohort)
    srv = p_core.FederatedServer(
        P_TASK, pop, p_core.fedavg(min_fit=cohort / n), tcp=p_tr.DEFAULT,
        chaos=p_chaos.ChaosSchedule(p_tr.LAB),
        config=p_core.ServerConfig(rounds=2, local_steps=1, seed=0, batched=True,
                                   clients_per_round=cohort / n, state_plane="sparse",
                                   eval_every=2),
        compressor=p_comp.topk_compressor(0.05), eval_data=EVAL,
    )
    tracemalloc.start()
    try:
        h = srv.run()
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert h.completed_rounds == 2
    assert all(r.delivered > 0 for r in h.rounds)
    assert peak < _MEM_BUDGET_BYTES, f"host peak {peak / 1e6:.1f} MB"
    plane = srv._residual_plane
    assert plane is not None and plane.storage == "sparse"
    assert plane.occupancy <= 2 * cohort
    assert plane.capacity <= 128
    assert pop.materialized <= 2 * cohort
    assert pop.cached_shards <= 4 * cohort
