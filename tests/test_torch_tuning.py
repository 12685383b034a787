"""Port parity: the TCP tuning layer (``repro_torch.tuning``), numpy copies
of ``repro.tuning``. Sweeps, the greedy tuner and the adaptive daemon give
EQUAL results to the reference on the same inputs, not close ones; the
reference's behavioural tests hold on the port."""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.transport.des as r_des
import repro.tuning as r_tuning
import repro.tuning.grid as r_grid
import repro_torch.transport as p_tr
import repro_torch.transport.des as p_des
import repro_torch.tuning as p_tuning
import repro_torch.tuning.grid as p_grid
from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _rows(results):
    return [dataclasses.astuple(r) for r in results]


@pytest.mark.parametrize("param", sorted(r_grid.SWEEPS))
def test_sweep_parameter_equals_reference(param):
    """Every (value x latency) cell of every sweep, at the paper's 17
    latency points and the stressed-testbed conditions: equal."""
    kw = dict(loss=0.08, local_train_time=900.0, update_bytes=300_000)
    r_res = r_grid.sweep_parameter(param, **kw)
    p_res = p_grid.sweep_parameter(param, **kw)
    assert p_grid.SWEEPS == r_grid.SWEEPS and p_grid.LATENCY_POINTS == r_grid.LATENCY_POINTS
    assert _rows(p_res) == _rows(r_res)
    assert [r.failed for r in p_res] == [r.failed for r in r_res]
    default = getattr(p_tr.TcpParams(), param)
    assert p_grid.default_suboptimal_count(p_res, default) == r_grid.default_suboptimal_count(
        r_res, default
    )
    best_p, best_r = p_grid.best_per_latency(p_res), r_grid.best_per_latency(r_res)
    assert {k: dataclasses.astuple(v) for k, v in best_p.items()} == {
        k: dataclasses.astuple(v) for k, v in best_r.items()
    }


@pytest.mark.parametrize("latencies", [[0.1, 1.0, 6.0], None])
def test_tune_three_params_equals_reference(latencies):
    kw = dict(latencies=latencies, local_train_time=600.0)
    assert dataclasses.asdict(p_tuning.tune_three_params(**kw)) == dataclasses.asdict(
        r_tuning.tune_three_params(**kw)
    )


def _telemetry(seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    return [
        dict(rtt=float(rng.uniform(0.01, 20.0)), loss=float(rng.uniform(0.0, 0.4)),
             idle_time=float(rng.uniform(10.0, 3000.0)), silently_dropped=bool(rng.random() < 0.3))
        for _ in range(n)
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_tuner_equals_reference(seed):
    """The daemon fed the same telemetry re-derives the same params every
    round, and its EWMA state is equal."""
    p_t, r_t = p_tuning.AdaptiveTuner(), r_tuning.AdaptiveTuner()
    assert dataclasses.asdict(p_t.current_params()) == dataclasses.asdict(r_t.current_params())
    for obs in _telemetry(seed):
        assert dataclasses.asdict(p_t.observe_round(**obs)) == dataclasses.asdict(
            r_t.observe_round(**obs)
        )
    assert dataclasses.asdict(p_t.stats) == dataclasses.asdict(r_t.stats)


def test_observe_events_equals_reference():
    """Event traces: SYN retries read as loss, SYN->ESTABLISHED as RTT,
    MBOX_DROP as a silent drop."""
    trace = [(0.0, "SYN"), (1.0, "SYN"), (3.0, "SYN"), (3.4, "ESTABLISHED"), (900.0, "MBOX_DROP")]
    p_s, r_s = p_tuning.ConnectionStats(), r_tuning.ConnectionStats()
    for _ in range(3):
        p_s.observe_events([p_des.Event(t, k) for t, k in trace], link_rtt_hint=0.7)
        r_s.observe_events([r_des.Event(t, k) for t, k in trace], link_rtt_hint=0.7)
    assert dataclasses.asdict(p_s) == dataclasses.asdict(r_s)
    p_t, r_t = p_tuning.AdaptiveTuner(), r_tuning.AdaptiveTuner()
    p = p_t.observe_round(events=[p_des.Event(t, k) for t, k in trace])
    r = r_t.observe_round(events=[r_des.Event(t, k) for t, k in trace])
    assert dataclasses.asdict(p) == dataclasses.asdict(r)


# the reference's behavioural tests (tests/test_tuning.py), on the port


def test_sweep_produces_full_grid():
    res = p_grid.sweep_parameter("tcp_syn_retries", values=[2, 6, 16], latencies=[0.1, 1.0, 8.0])
    assert len(res) == 9
    assert {r.value for r in res} == {2, 6, 16}


def test_syn_retries_default_loses_at_extreme_latency():
    res = p_grid.sweep_parameter(
        "tcp_syn_retries", values=[6, 16], latencies=[8.0], loss=0.0, local_train_time=300.0,
    )
    default = next(r for r in res if r.value == 6)
    tuned = next(r for r in res if r.value == 16)
    assert default.failed and not tuned.failed


def test_keepalive_default_loses_on_long_idle():
    res = p_grid.sweep_parameter(
        "tcp_keepalive_time", values=[60.0, 7200.0], latencies=[0.1], local_train_time=900.0,
    )
    assert p_grid.default_suboptimal_count(res, 7200.0) == 1


def test_greedy_tuner_only_touches_three_knobs():
    tuned = p_tuning.tune_three_params(latencies=[0.1, 1.0, 6.0], local_train_time=600.0)
    diffs = [f for f in p_tr.TcpParams.__dataclass_fields__
             if getattr(tuned, f) != getattr(p_tr.TcpParams(), f)]
    assert set(diffs) <= {"tcp_syn_retries", "tcp_keepalive_time", "tcp_keepalive_intvl"}
    link = p_tr.LAB.replace(delay=6.0)
    assert p_tr.client_round(tuned, link, update_bytes=300_000, local_train_time=600.0,
                             connected=False).p_complete > 0.9


def test_adaptive_tuner_converges_on_hostile_link():
    link = p_tr.LAB.replace(delay=7.0, loss=0.1)
    tuner = p_tuning.AdaptiveTuner()
    p0 = tuner.current_params()
    for _ in range(4):
        tuner.observe_round(rtt=p_tr.effective_rtt(link), loss=link.loss,
                            idle_time=900.0, silently_dropped=True)
    p = tuner.current_params()
    out = p_tr.client_round(p, link, update_bytes=300_000, local_train_time=900.0,
                            connected=False)
    assert out.p_complete > 0.9
    assert p.tcp_syn_retries > p0.tcp_syn_retries


@settings(max_examples=20, deadline=None)
@given(rtt=st.floats(0.01, 20.0), loss=st.floats(0.0, 0.4), idle=st.floats(10.0, 3000.0))
def test_adaptive_params_always_valid_and_equal(rtt, loss, idle):
    """Property: whatever telemetry arrives, derived params stay sane, and
    equal the reference's."""
    tuner, ref = p_tuning.AdaptiveTuner(), r_tuning.AdaptiveTuner()
    for _ in range(3):
        p = tuner.observe_round(rtt=rtt, loss=loss, idle_time=idle)
        r = ref.observe_round(rtt=rtt, loss=loss, idle_time=idle)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert 2 <= p.tcp_syn_retries <= 64
    assert p.tcp_keepalive_intvl <= p.tcp_keepalive_time
    assert p.tcp_keepalive_time >= tuner.min_keepalive
    assert p.handshake_budget >= min(tuner.rtt_margin * rtt * 0.8, 3 * p.syn_rto)


def test_stats_ewma_direction():
    s = p_tuning.ConnectionStats()
    for _ in range(10):
        s.observe_rtt(5.0)
    assert 3.0 < s.rtt <= 5.0
    for _ in range(10):
        s.observe_loss(0.3)
    assert 0.2 < s.loss <= 0.3
