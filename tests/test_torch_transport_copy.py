"""Port parity: the numpy modules ``repro_torch`` carries as copies
(transport, chaos, data) must equal ``repro``'s bitwise at fixed seeds."""

import numpy as np
import pytest

from _torch_parity import one_torch_thread, assert_same  # noqa: F401
import repro.chaos as r_chaos
import repro.data as r_data
import repro.transport as r_tr
import repro.transport.des as r_des
import repro.transport.model as r_model
import repro_torch.chaos as p_chaos
import repro_torch.data as p_data
import repro_torch.transport as p_tr
import repro_torch.transport.des as p_des
import repro_torch.transport.model as p_model

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (tcp name, profile, link fields) — the cliff, the tuned stack, lossy
# and jittery links, and the zero-RTT profile
SCENARIOS = [
    ("DEFAULT", None, dict(delay=6.0)),
    ("TUNED_EDGE", None, dict(delay=6.0)),
    ("DEFAULT", None, dict(delay=0.8, loss=0.10)),
    ("TUNED_EDGE", None, dict(delay=0.875, jitter=0.3, loss=0.2, rate_mbps=2.0)),
    ("DEFAULT", "zero_rtt", dict(delay=0.3, loss=0.3, middlebox_timeout=5.0)),
]
RETRIES = [None, dict(max_retries=2, jitter=0.5), dict(max_retries=3, resume=True)]


def _build(tr, tcp_name, profile, link_kw, retry_kw):
    tcp = getattr(tr, tcp_name)
    if profile is not None:
        tcp = tr.transport_profile(profile, base=tcp)
    retry = tr.RetryPolicy(**retry_kw) if retry_kw is not None else None
    return tcp, tr.LAB.replace(**link_kw), retry


@pytest.mark.parametrize("retry_kw", RETRIES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sim_client_round_bitwise(scenario, retry_kw):
    outs = []
    for tr, des in ((r_tr, r_des), (p_tr, p_des)):
        tcp, link, retry = _build(tr, *scenario, retry_kw)
        rng = np.random.default_rng(7)
        outs.append([
            des.sim_client_round(
                tcp, link, update_bytes=827_688, local_train_time=lt, rng=rng,
                connected=conn, download_bytes=900_000, retry=retry,
            )
            for lt, conn in ((2.0, False), (700.0, True), (30.0, True))
        ] + [rng.random()])
    assert_same(*outs)


@pytest.mark.parametrize("retry_kw", RETRIES)
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sim_cohort_round_bitwise(scenario, retry_kw):
    outs = []
    for tr, des in ((r_tr, r_des), (p_tr, p_des)):
        tcp, link, retry = _build(tr, *scenario, retry_kw)
        links = [link, link.replace(loss=min(link.loss + 0.05, 0.9)), tr.LAB]
        rng = np.random.default_rng(11)
        out = des.sim_cohort_round(
            tcp, links, update_bytes=827_688,
            local_train_times=np.array([2.0, 30.0, 700.0]), rng=rng,
            connected=np.array([False, True, True]), download_bytes=827_688,
            trace=True, retry=retry,
        )
        outs.append((out, rng.random()))
    assert_same(*outs)


@pytest.mark.parametrize("mode", ["parity", "fused"])
@pytest.mark.parametrize("retry_kw", RETRIES)
def test_sim_grid_round_bitwise(mode, retry_kw):
    outs = []
    for tr, des in ((r_tr, r_des), (p_tr, p_des)):
        built = [_build(tr, *s, retry_kw) for s in SCENARIOS[:4]]
        tcps = [b[0] for b in built]
        links = [[b[1], b[1].replace(delay=b[1].delay * 0.5), tr.LAB] for b in built]
        S, C = len(built), 3
        kw = dict(
            update_bytes=np.full((S, C), 827_688, np.int64),
            download_bytes=np.full((S, C), 827_688, np.int64),
            local_train_times=np.tile([2.0, 30.0, 700.0], (S, 1)),
            connected=np.tile([False, True, False], (S, 1)),
            trace=True, retry=built[0][2],
        )
        if mode == "parity":
            rngs = [np.random.default_rng(100 + s) for s in range(S)]
            out = des.sim_grid_round(tcps, links, rngs=rngs, **kw)
            tail = [g.random() for g in rngs]
        else:
            rng = np.random.default_rng(5)
            out = des.sim_grid_round(tcps, links, rng=rng, **kw)
            tail = [rng.random()]
        outs.append((out, tail))
    assert_same(*outs)


@pytest.mark.parametrize("t_start,deadline", [(0.0, float("inf")), (120.5, 30.0), (1.0, 0.0)])
def test_delivery_events_bitwise(t_start, deadline):
    rng = np.random.default_rng(3)
    success = rng.random(40) < 0.7
    times = np.round(rng.exponential(20.0, 40), 1)  # rounding forces ties
    assert_same(
        r_des.delivery_events(success, times, t_start=t_start, deadline=deadline),
        p_des.delivery_events(success, times, t_start=t_start, deadline=deadline),
    )


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_client_round_and_retry_round_bitwise(scenario):
    outs = []
    for tr, model in ((r_tr, r_model), (p_tr, p_model)):
        tcp, link, _ = _build(tr, *scenario, None)
        res = [
            model.client_round(
                tcp, link, update_bytes=827_688, local_train_time=lt,
                connected=conn, download_bytes=827_688,
            )
            for lt, conn in ((2.0, False), (700.0, True))
        ]
        for retry_kw in RETRIES[1:]:
            res.append(model.retry_round(
                tcp, link, tr.RetryPolicy(**retry_kw), update_bytes=827_688,
                local_train_time=30.0, connected=False, download_bytes=827_688,
            ))
        outs.append(res)
    assert_same(*outs)


def test_federated_data_bitwise():
    for iid in (True, False):
        assert_same(
            r_data.make_federated_mnist(5, 40, iid=iid, seed=2),
            p_data.make_federated_mnist(5, 40, iid=iid, seed=2),
        )
        r_make = r_data.federated_mnist_factory(30, iid=iid, seed=4)
        p_make = p_data.federated_mnist_factory(30, iid=iid, seed=4)
        assert_same([r_make(c) for c in (0, 7, 123)], [p_make(c) for c in (0, 7, 123)])
    assert_same(r_data.synthetic_mnist(64, seed=99), p_data.synthetic_mnist(64, seed=99))
    r_shard, p_shard = r_data.make_federated_mnist(1, 200, seed=0)[0], p_data.make_federated_mnist(1, 200, seed=0)[0]
    assert_same(
        r_shard.batch_indices(32, 9, rng=np.random.default_rng(1)),
        p_shard.batch_indices(32, 9, rng=np.random.default_rng(1)),
    )


def test_chaos_schedule_link_at_and_alive_bitwise():
    scheds = []
    for chaos, tr in ((r_chaos, r_tr), (p_chaos, p_tr)):
        scheds.append(chaos.ChaosSchedule(tr.LAB).add(
            chaos.netem(60.0, 10_000.0, delay=0.8, loss=0.10),
            chaos.netem(30.0, 90.0, clients=[1, 2], jitter=0.2, rate_mbps=5.0),
            chaos.client_failure_schedule(10, 0.3, t_start=120.0, seed=3),
            chaos.partition(200.0, 260.0, clients=[4]),
            chaos.server_restart(150.0, downtime=40.0),
        ))
    r_s, p_s = scheds
    for t in (0.0, 30.0, 59.9, 60.0, 89.0, 120.0, 150.0, 230.0, 5000.0):
        for c in range(10):
            assert_same(r_s.link_at(t, c), p_s.link_at(t, c))
            assert r_s.alive(t, c) == p_s.alive(t, c)
    for span in ((0.0, 150.0), (150.0, 300.0), (100.0, 149.9)):
        assert r_s.server_restart_in(*span) == p_s.server_restart_in(*span)
