"""Port parity: the device transport plane (``repro_torch.transport.plane``)
on the CPU against the port's host oracle (the numpy DES) and against the
reference's plane (``repro.transport.plane``, jax on the CPU).

- The helpers that take caller-supplied uniforms and normals get the same
  numpy inputs as the reference's: ``_exp2i`` and ``_floor_log2`` bitwise,
  ``_binomial_exact_tails`` and ``_rto_backoff`` bitwise on the tail
  branches and within 1 f32 ulp elsewhere, ``segment_sum`` within 1e-6.
- Degenerate grids (loss = 0, jitter = 0: no draw decides anything):
  success, reconnects, mask and every trace count bitwise; clocks and bytes
  within 1e-4 of the f64 host oracle and 1e-6 of the reference's f32 plane.
- Stochastic grids: the reference's own envelopes on delivery rates and
  median delivered clocks, against the host oracle and the reference.
- Streams: one key gives the same bits, another round another draw, and a
  stage's draws do not move when another stage runs more iterations.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread  # noqa: F401 (fixture)
import repro.transport as r_tr
import repro.transport.plane as r_plane
import repro_torch.transport as p_tr
import repro_torch.transport.plane as p_plane
from repro.kernels.ops import segment_sum as r_segment_sum
from repro.transport import des as r_des
from repro_torch.core.server import _TRANSPORT_STREAM, derive_rng
from repro_torch.kernels.ops import segment_sum
from repro_torch.kernels.ref import segment_sum_ref
from repro_torch.transport import des as p_des

pytestmark = pytest.mark.usefixtures("one_torch_thread")

UPD = 300_000
TT = 30.0
TRACE = p_des._TRACE_FIELDS


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _kw(S, C, *, sizes=None):
    if sizes is not None:
        return dict(
            update_bytes=np.full(S, UPD, np.int64),
            download_bytes=np.full(S, UPD, np.int64),
            local_train_times=[np.full(c, TT) for c in sizes],
            connected=[np.zeros(c, bool) for c in sizes],
        )
    return dict(
        update_bytes=np.full(S, UPD, np.int64),
        download_bytes=np.full(S, UPD, np.int64),
        local_train_times=np.full((S, C), TT),
        connected=np.zeros((S, C), bool),
    )


def _three(spec, kw, *, rnd=0, trace=True, retry=None, r_retry=None):
    """(port host oracle, port plane, reference plane) for one grid round.
    ``spec`` is [(tcp name, [link kwargs per client])] per scenario."""
    def build(tr):
        return ([getattr(tr, t) for t, _ in spec],
                [[tr.LAB.replace(**lk) for lk in row] for _, row in spec])

    p_tcps, p_links = build(p_tr)
    r_tcps, r_links = build(r_tr)
    host = p_tr.sim_grid_round(p_tcps, p_links, rng=derive_rng(0, _TRANSPORT_STREAM, rnd),
                               trace=trace, retry=retry, **kw)
    dev = p_tr.sim_grid_round_device(
        p_tcps, p_links, key=p_plane.transport_plane_key(0, _TRANSPORT_STREAM, rnd),
        trace=trace, retry=retry, device="cpu", **kw)
    ref = r_tr.sim_grid_round_device(
        r_tcps, r_links, key=r_plane.transport_plane_key(0, _TRANSPORT_STREAM, rnd),
        trace=trace, retry=r_retry, **kw)
    return host, dev, ref


def _assert_degenerate(host, dev, ref):
    for name in ("success", "reconnects"):
        got = _np(getattr(dev, name))
        np.testing.assert_array_equal(got, getattr(host, name), err_msg=name)
        np.testing.assert_array_equal(got, _np(getattr(ref, name)), err_msg=name)
    assert (host.mask is None) == (dev.mask is None) == (ref.mask is None)
    if host.mask is not None:
        np.testing.assert_array_equal(dev.mask, host.mask)
        np.testing.assert_array_equal(dev.mask, ref.mask)
    if host.trace is not None:
        for f in TRACE:
            np.testing.assert_array_equal(_np(dev.trace[f]), host.trace[f], err_msg=f)
            np.testing.assert_array_equal(_np(dev.trace[f]), _np(ref.trace[f]), err_msg=f)
    for name in ("time", "bytes_acked"):
        got = _np(getattr(dev, name)).astype(np.float64)
        np.testing.assert_allclose(got, getattr(host, name), rtol=1e-4, err_msg=name)
        np.testing.assert_allclose(got, _np(getattr(ref, name)).astype(np.float64),
                                   rtol=1e-6, err_msg=name)
    sb = _np(dev.scenario_bytes).astype(np.float64)
    np.testing.assert_allclose(sb, _np(dev.bytes_acked).astype(np.float64).sum(axis=1),
                               rtol=1e-6)
    np.testing.assert_allclose(sb, _np(ref.scenario_bytes), rtol=1e-6)


# ---------------------------------------------------------------------------
# the helpers, on the same numpy inputs
# ---------------------------------------------------------------------------


def test_exp2i_and_floor_log2_bitwise():
    v = np.concatenate([np.arange(0, 130, dtype=np.float32),
                        np.array([-3.0, -0.5, 0.5, 7.9, 119.99, 1e6], np.float32)])
    np.testing.assert_array_equal(_np(p_plane._exp2i(torch.from_numpy(v))).view(np.uint32),
                                  np.asarray(r_plane._exp2i(jnp.asarray(v))).view(np.uint32))
    rng = np.random.default_rng(3)
    x = np.concatenate([2.0 ** np.arange(0, 60), rng.uniform(1.0, 1e9, 500)]).astype(np.float32)
    np.testing.assert_array_equal(_np(p_plane._floor_log2(torch.from_numpy(x))),
                                  np.asarray(r_plane._floor_log2(jnp.asarray(x))))


def test_pad_attempts_equal():
    assert [p_plane._pad_attempts(a) for a in range(0, 70)] == [
        r_plane._pad_attempts(a) for a in range(0, 70)]


def _tail_and_interior(got, want, tail):
    np.testing.assert_array_equal(got[tail].view(np.uint32), want[tail].view(np.uint32))
    np.testing.assert_array_max_ulp(got[~tail], want[~tail], maxulp=1)


def test_binomial_exact_tails_against_the_reference():
    rng = np.random.default_rng(0)
    k = 4000
    u = rng.uniform(0.0, 1.0, k).astype(np.float32)
    z = rng.standard_normal(k).astype(np.float32)
    n = rng.integers(0, 65, k).astype(np.float32)
    p = rng.choice([0.0, 0.01, 0.1, 0.3, 0.5, 0.6, 0.9], k).astype(np.float32)
    got = _np(p_plane._binomial_exact_tails(*map(torch.from_numpy, (u, z, n, p))))
    want = np.asarray(r_plane._binomial_exact_tails(*map(jnp.asarray, (u, z, n, p))))
    tail = (want == 0) | (want == n)
    assert tail.any() and (~tail).any()
    _tail_and_interior(got, want, tail)


def test_rto_backoff_against_the_reference():
    rng = np.random.default_rng(1)
    k = 2000
    tcps = [p_tr.DEFAULT, p_tr.TUNED_EDGE, p_tr.BIG_BUFFER, p_tr.DEFAULT.replace(tcp_retries2=5)]
    pick = rng.integers(0, len(tcps), k)
    ta = p_des._TcpArrays.from_params(tcps).take(pick)
    la = p_des._LinkArrays.from_links(
        [p_tr.LAB.replace(loss=float(x)) for x in rng.choice([0.0, 0.05, 0.3, 0.6, 0.95], k)])
    u = rng.uniform(1e-6, 1.0, k).astype(np.float32)
    stalled = rng.uniform(size=k) < 0.7
    rto = rng.choice([0.2, 0.5, 1.0, 3.0, 60.0, 120.0], k).astype(np.float32)
    got = p_plane._rto_backoff(p_plane.TcpPlane.from_arrays(ta, "cpu"),
                               p_plane.LinkPlane.from_arrays(la, "cpu"),
                               torch.from_numpy(u), torch.from_numpy(stalled),
                               torch.from_numpy(rto))
    want = r_plane._rto_backoff(r_plane.TcpPlane.from_arrays(ta), r_plane.LinkPlane.from_arrays(la),
                                jnp.asarray(u), jnp.asarray(stalled), jnp.asarray(rto))
    got, want = [_np(x) for x in got], [np.asarray(x) for x in want]
    np.testing.assert_array_equal(got[0], want[0])  # dead
    # the tail branch: the run reached the breaker (or the row never stalled)
    tail = want[0] | ~stalled
    _tail_and_interior(got[1], want[1], tail)
    _tail_and_interior(got[2], want[2], tail)


def test_segment_sum_against_ref_and_the_reference():
    rng = np.random.default_rng(7)
    vals = rng.normal(size=64).astype(np.float32)
    ids = rng.integers(0, 9, size=64)
    got = _np(segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), num_segments=9))
    np.testing.assert_allclose(
        got, _np(segment_sum_ref(torch.from_numpy(vals), torch.from_numpy(ids), 9)), rtol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(r_segment_sum(jnp.asarray(vals), jnp.asarray(ids), num_segments=9)),
        rtol=1e-6)
    expect = np.zeros(9, np.float64)
    np.add.at(expect, ids, vals.astype(np.float64))
    np.testing.assert_allclose(got.astype(np.float64), expect, rtol=1e-5)


# ---------------------------------------------------------------------------
# degenerate grids: exact
# ---------------------------------------------------------------------------


def test_degenerate_grid_exact():
    C = 12
    spec = [("DEFAULT", [{}] * C), ("BIG_BUFFER", [dict(delay=0.3)] * C),
            ("TUNED_EDGE", [dict(rate_mbps=1.0)] * C),
            ("DEFAULT", [dict(delay=8.0)] * C)]  # dead scenario: SYN ladder exhausts
    host, dev, ref = _three(spec, _kw(4, C))
    _assert_degenerate(host, dev, ref)
    assert not host.success[3].any() and host.success[:3].all()


def test_degenerate_ragged_grid_exact():
    spec = [("DEFAULT", [{}] * 5), ("TUNED_EDGE", [dict(delay=0.3)] * 3)]
    host, dev, ref = _three(spec, _kw(2, None, sizes=[5, 3]))
    _assert_degenerate(host, dev, ref)


def test_scenario_bytes_alive_and_dead():
    C = 8
    spec = [("DEFAULT", [{}] * C), ("DEFAULT", [dict(delay=8.0)] * C)]
    host, dev, ref = _three(spec, _kw(2, C))
    _assert_degenerate(host, dev, ref)
    sb = _np(dev.scenario_bytes)
    assert sb[0] == C * 2.0 * UPD and sb[1] == 0.0


def test_degenerate_zero_rtt_resume_rows_exact():
    """Zero-RTT rows with a resuming retry ladder past the 8 / 12 s cliff
    and one plain row dying on its budget: ``device_sim_rows`` against the
    host's ``_sim_rows`` and the reference's plane."""
    links = [p_tr.LinkProfile(name=f"l{d}", delay=d, jitter=0.0, loss=0.0, rate_mbps=50.0)
             for d in (0.0025, 2.0, 8.0, 12.0)]
    zr = p_tr.transport_profile("zero_rtt")
    ta = p_des._TcpArrays.from_params([zr, zr, zr, p_tr.DEFAULT])
    la = p_des._LinkArrays.from_links(links)
    ra = p_des._RetryArrays.broadcast(p_tr.RetryPolicy(max_retries=2, resume=True), 4)
    r_ra = r_des._RetryArrays.broadcast(r_tr.RetryPolicy(max_retries=2, resume=True), 4)
    kw = dict(up_bytes=np.full(4, 200_000, np.int64), down_bytes=np.full(4, 400_000, np.int64),
              local_train_times=np.full(4, 5.0), connected=np.zeros(4, bool))
    h = p_des._sim_rows(ta, la, rng=derive_rng(0, 2, 0), retry=ra, **kw)
    d = p_plane.device_sim_rows(ta, la, key=p_plane.transport_plane_key(0, 2, 0), retry=ra,
                                device="cpu", **kw)
    r = r_plane.device_sim_rows(r_des._TcpArrays(**vars(ta)), r_des._LinkArrays(**vars(la)),
                                key=r_plane.transport_plane_key(0, 2, 0), retry=r_ra, **kw)
    for i in (0, 2):  # success, reconnects
        np.testing.assert_array_equal(_np(d[i]), h[i])
        np.testing.assert_array_equal(_np(d[i]), np.asarray(r[i]))
    for f in TRACE:
        np.testing.assert_array_equal(_np(d[4][f]), h[4][f], err_msg=f)
        np.testing.assert_array_equal(_np(d[4][f]), np.asarray(r[4][f]), err_msg=f)
    for i in (1, 3):  # clocks, bytes
        np.testing.assert_allclose(_np(d[i]), h[i], rtol=1e-4)
        np.testing.assert_allclose(_np(d[i]), np.asarray(r[i]), rtol=1e-6)
    assert h[0][:3].all() and not h[0][3] and h[2][3] == 3


def test_degenerate_retry_ladder_exact():
    """6 s OWD, no loss: every attempt's SYN ladder exhausts, so the retry
    ladder's clock is 10.5 + (2 + 10.5) + (4 + 10.5) + (8 + 10.5) = 56 s."""
    rp = p_tr.RetryPolicy(max_retries=3, base_backoff=2.0, backoff_factor=2.0)
    r_rp = r_tr.RetryPolicy(max_retries=3, base_backoff=2.0, backoff_factor=2.0)
    spec = [("DEFAULT", [dict(delay=6.0)] * 3)]
    kw = dict(update_bytes=np.full(1, 100_000, np.int64),
              download_bytes=np.full(1, 100_000, np.int64),
              local_train_times=np.full((1, 3), 5.0), connected=np.zeros((1, 3), bool))
    host, dev, ref = _three(spec, kw, retry=rp, r_retry=r_rp)
    _assert_degenerate(host, dev, ref)
    assert not host.success.any()
    np.testing.assert_allclose(_np(dev.time), np.full((1, 3), 56.0), rtol=1e-6)


# ---------------------------------------------------------------------------
# stochastic grids: the reference's envelopes
# ---------------------------------------------------------------------------


def _rates(spec, kw, rounds):
    """Per-scenario delivery rates pooled over ``rounds`` rounds: host,
    port plane, reference plane."""
    outs = [_three(spec, kw, rnd=r, trace=False) for r in range(rounds)]
    S = len(spec)

    def pooled(i):
        x = np.stack([_np(o[i].success) for o in outs])
        return x.transpose(1, 0, 2).reshape(S, -1).mean(axis=1)

    return pooled(0), pooled(1), pooled(2)


def _within_envelope(a, b, n, slack):
    pooled = (a + b) / 2.0
    sigma = np.sqrt(np.maximum(pooled * (1.0 - pooled), 1e-4) * 2.0 / n)
    return np.all(np.abs(a - b) <= 4.0 * sigma + slack)


def test_delivery_rates_on_the_fig4_grid():
    C, rounds = 96, 2
    spec = [(tcp, [dict(loss=loss)] * C) for tcp in ("DEFAULT", "BIG_BUFFER")
            for loss in (0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.55, 0.6)]
    host, dev, ref = _rates(spec, _kw(len(spec), C), rounds)
    assert _within_envelope(host, dev, C * rounds, 0.01), (host, dev)
    assert _within_envelope(ref, dev, C * rounds, 0.01), (ref, dev)


def test_median_clocks_on_the_fig3_grid():
    C = 96
    spec = [(tcp, [dict(delay=delay, loss=0.05)] * C) for tcp in ("DEFAULT", "TUNED_EDGE")
            for delay in (0.0, 0.1, 0.3, 1.0, 2.0)]
    spec.append(("DEFAULT", [dict(delay=0.2, jitter=0.05, loss=0.1)] * C))
    host, dev, ref = _three(spec, _kw(len(spec), C), trace=False)
    for s in range(len(spec)):
        meds = []
        for out in (host, dev, ref):
            ok, t = _np(out.success)[s], _np(out.time)[s].astype(np.float64)
            assert ok.mean() > 0.5, s  # deliverable range
            meds.append(float(np.median(t[ok])))
        h, d, r = meds
        assert abs(h - d) <= 0.20 * h and abs(r - d) <= 0.20 * r, (s, meds)


def test_resume_at_40pct_loss_against_host_and_reference():
    k = 64
    tcp = p_tr.TUNED_EDGE.replace(tcp_retries2=5)
    lossy = p_tr.LinkProfile(name="lossy", delay=0.05, jitter=0.01, loss=0.4, rate_mbps=10.0)
    ta = p_des._TcpArrays.from_params([tcp] * k)
    la = p_des._LinkArrays.from_links([lossy] * k)
    pol = dict(max_retries=4, resume=True, max_backoff=4.0)
    ra = p_des._RetryArrays.broadcast(p_tr.RetryPolicy(**pol), k)
    kw = dict(up_bytes=np.full(k, 1_000_000, np.int64), down_bytes=np.full(k, 1_000_000, np.int64),
              local_train_times=np.full(k, 1.0), connected=np.zeros(k, bool))
    h = p_des._sim_rows(ta, la, rng=derive_rng(7, 2, 0), retry=ra, **kw)
    d = p_plane.device_sim_rows(ta, la, key=p_plane.transport_plane_key(7, 2, 0), retry=ra,
                                device="cpu", **kw)
    r = r_plane.device_sim_rows(
        r_des._TcpArrays(**vars(ta)), r_des._LinkArrays(**vars(la)),
        key=r_plane.transport_plane_key(7, 2, 0),
        retry=r_des._RetryArrays.broadcast(r_tr.RetryPolicy(**pol), k), **kw)
    pd = _np(d[0]).mean()
    for other in (h[0].mean(), np.asarray(r[0]).mean()):
        sigma = math.sqrt(max(other * (1 - other), 0.25 / k) / k)
        assert abs(other - pd) <= 4 * sigma + 0.1, (other, pd)


def test_retry_budget_at_the_cliff():
    """A retry budget raises delivery at 4 s OWD and 15 % loss on every
    engine, and the engines agree (the reference's envelope: +0.05 and
    0.15). Pooled over 32 rounds of 16 clients: at the reference's 8 rounds
    the gap is a 128-sample statistic, and the port's CPU stream draws 6
    failures there (0.953 -> 1.0, +0.047); see CHANGES.md."""
    kw = dict(update_bytes=np.full(1, 200_000, np.int64),
              download_bytes=np.full(1, 200_000, np.int64),
              local_train_times=np.full((1, 16), 5.0), connected=np.zeros((1, 16), bool))
    rates = {}
    for tag, budget in (("none", 0), ("r3", 3)):
        rp = p_tr.RetryPolicy(max_retries=budget) if budget else None
        r_rp = r_tr.RetryPolicy(max_retries=budget) if budget else None
        outs = [_three([("DEFAULT", [dict(delay=4.0, loss=0.15)] * 16)], kw, rnd=r, trace=False,
                       retry=rp, r_retry=r_rp) for r in range(32)]
        rates[tag] = [np.mean([_np(o[i].success).mean() for o in outs]) for i in range(3)]
    for i in range(3):
        assert rates["r3"][i] > rates["none"][i] + 0.05, rates
    for tag in rates:
        assert abs(rates[tag][0] - rates[tag][1]) < 0.15, rates
        assert abs(rates[tag][2] - rates[tag][1]) < 0.15, rates


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------


def _lossy_grid(rnd, **kw):
    C = 24
    links = [[p_tr.LAB.replace(loss=0.2)] * C, [p_tr.LAB.replace(loss=0.4)] * C]
    return p_tr.sim_grid_round_device(
        [p_tr.DEFAULT, p_tr.BIG_BUFFER], links,
        key=p_plane.transport_plane_key(0, _TRANSPORT_STREAM, rnd), device="cpu",
        trace=True, **_kw(2, C), **kw)


def test_same_key_same_bits_other_round_other_draw():
    a, b, c = _lossy_grid(3), _lossy_grid(3), _lossy_grid(4)
    for name in ("success", "time", "reconnects", "bytes_acked"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for f in TRACE:
        assert torch.equal(a.trace[f], b.trace[f]), f
    assert not (torch.equal(a.success, c.success) and torch.equal(a.time, c.time))


def test_keys_follow_seed_stream_and_round():
    keys = {p_plane.transport_plane_key(s, st, r)
            for s in (0, 1) for st in (2, 3) for r in (0, 1, 2)}
    assert len(keys) == 12
    assert p_plane.transport_plane_key(5, 2, 7) == p_plane.transport_plane_key(5, 2, 7)


def test_stage_draws_do_not_move_with_another_stages_iterations():
    """Row 0 is the same in two rounds whose row 1 downloads 1 MB or 30 KB:
    the download loop runs more iterations in the first, and neither the
    idle nor the upload stage's draws move (a shared stream would shift
    them)."""
    link = p_tr.LAB.replace(loss=0.3, jitter=0.02)
    ta = p_des._TcpArrays.from_params([p_tr.DEFAULT] * 2)
    la = p_des._LinkArrays.from_links([link, link])
    outs = []
    for down1 in (1_000_000, 30_000):
        stats = p_plane.new_plane_stats()
        out = p_plane.device_sim_rows(
            ta, la, up_bytes=np.full(2, 300_000), down_bytes=np.array([300_000, down1]),
            local_train_times=np.full(2, 30.0), connected=np.zeros(2, bool),
            key=p_plane.transport_plane_key(0, 2, 0), device="cpu", stats=stats)
        outs.append((out, stats["transfer_iters"]))
    (a, ia), (b, ib) = outs
    assert ia != ib
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x[0], y[0])
    for f in TRACE:
        assert torch.equal(a[4][f][0], b[4][f][0]), f
