"""Discrete-event transport simulator — the stochastic oracle.

Event-granular counterpart of ``repro_torch.transport.model``: SYN attempts,
keepalive probe cycles, AIMD window-by-window transfer with SACK reorder
buffering and RTO escalation. Seeded numpy RNG; every run yields an event
trace (the paper's "systematic analysis of connection patterns during
training rounds", §I) plus the sampled outcome.

Property tests (tests/test_transport.py) assert the analytic model's
expectations match DES sample means within tolerance across random
(TcpParams, LinkProfile) draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.transport.link import LinkProfile
from repro_torch.transport.params import RetryPolicy, TcpParams


@dataclass
class Event:
    t: float
    kind: str
    detail: str = ""


@dataclass
class SimOutcome:
    success: bool
    time: float
    events: List[Event] = field(default_factory=list)
    reconnects: int = 0
    bytes_acked: int = 0


def _rtt_sample(link: LinkProfile, rng: np.random.Generator) -> float:
    j = rng.normal(0.0, link.jitter) + rng.normal(0.0, link.jitter)
    return max(2.0 * link.delay + j, 1e-5)


def sim_handshake(
    tcp: TcpParams,
    link: LinkProfile,
    rng: np.random.Generator,
    *,
    no_budget: bool = False,
) -> SimOutcome:
    """SYN retry ladder. With ``no_budget=True`` (a ``zero_rtt`` profile's
    1-RTT first contact) the ladder keeps the same retransmit spacing and
    per-attempt loss draws but is never killed by the handshake budget —
    the kernel SYN-retry death behind the paper's 5 s OWD cliff does not
    exist for a QUIC-style handshake; only losing every attempt fails it
    (reported at the budget clock, like the budgeted ladder)."""
    budget = tcp.handshake_budget
    events = [Event(0.0, "SYN", "attempt 0")]
    for k in range(tcp.tcp_syn_retries + 1):
        t_send = k * tcp.syn_rto
        if not no_budget and t_send > budget:
            break
        if k > 0:
            events.append(Event(t_send, "SYN", f"retransmit {k}"))
        rtt = _rtt_sample(link, rng)
        delivered = rng.random() >= link.loss and rng.random() >= link.loss
        if delivered and (no_budget or t_send + rtt <= budget):
            t_done = t_send + rtt
            events.append(Event(t_done, "ESTABLISHED", f"attempt {k}"))
            return SimOutcome(True, t_done, events)
    events.append(Event(budget, "ETIMEDOUT", "handshake budget exhausted"))
    return SimOutcome(False, budget, events)


def sim_idle(
    tcp: TcpParams, link: LinkProfile, idle_time: float, rng: np.random.Generator
) -> Tuple[str, List[Event]]:
    """Returns (state, events); state in {alive, detected_dead, silent_dead}."""
    events: List[Event] = []
    mbox = link.middlebox_timeout
    if tcp.tcp_keepalive_time >= idle_time:
        if idle_time > mbox:
            events.append(Event(mbox, "MBOX_DROP", "silent middlebox reap"))
            return "silent_dead", events
        return "alive", events

    t = tcp.tcp_keepalive_time
    last_refresh = 0.0
    consecutive = 0
    while t <= idle_time:
        rtt = _rtt_sample(link, rng)
        delivered = rng.random() >= link.loss and rng.random() >= link.loss
        ok = delivered and rtt <= tcp.tcp_keepalive_intvl
        events.append(Event(t, "KEEPALIVE", "ack" if ok else "lost"))
        if t - last_refresh > mbox:
            events.append(Event(t, "MBOX_DROP", "probe gap exceeded middlebox"))
            return "silent_dead", events
        if ok:
            consecutive = 0
            last_refresh = t
        else:
            consecutive += 1
            if consecutive >= tcp.tcp_keepalive_probes:
                events.append(Event(t, "CONN_DEAD", "keepalive declared dead"))
                return "detected_dead", events
        t += tcp.tcp_keepalive_intvl
    if idle_time - last_refresh > mbox:
        events.append(Event(idle_time, "MBOX_DROP", "tail idle exceeded middlebox"))
        return "silent_dead", events
    return "alive", events


def sim_transfer(
    tcp: TcpParams, link: LinkProfile, nbytes: int, rng: np.random.Generator
) -> SimOutcome:
    """AIMD window-by-window transfer with reorder-buffer accounting."""
    events: List[Event] = []
    segs_total = max(1, math.ceil(nbytes / tcp.mss))
    wnd_max = max(tcp.window_bytes // tcp.mss, 2)
    rate_segs_per_rtt_cap = None
    t = 0.0
    cwnd = 10.0
    acked = 0
    pending_retrans = 0
    rto = tcp.initial_rto
    reorder_bytes = 0
    p = link.loss

    iters = 0
    while acked < segs_total:
        iters += 1
        if iters > 200_000:
            events.append(Event(t, "ABORT", "iteration cap"))
            return SimOutcome(False, t, events, bytes_acked=acked * tcp.mss)
        rtt = _rtt_sample(link, rng)
        if link.rate_mbps > 0:
            rate_segs_per_rtt_cap = max(
                int(link.rate_mbps * 1e6 / 8.0 * rtt / tcp.mss), 1
            )
        w = int(min(cwnd, wnd_max, link.queue_limit,
                    rate_segs_per_rtt_cap or 1e18))
        w = min(max(w, 1), segs_total - acked + pending_retrans)
        lost = int(rng.binomial(w, p)) if p > 0 else 0
        delivered = w - lost
        t += rtt
        if delivered == 0:
            # Whole window lost -> RTO. Each retransmission is itself an
            # independent Bernoulli(p) loss; the *escalation* lives in the
            # exponentially backed-off timer (rto doubles per failed
            # retransmit, capped at max_rto), not in the loss probability —
            # so the stall compounds as rto, 2*rto, 4*rto, ... while the
            # per-attempt loss probability stays the link's p.
            t += rto
            consecutive_rtos = 1
            while consecutive_rtos < tcp.tcp_retries2 and rng.random() < p:
                rto = min(rto * 2, tcp.max_rto)
                t += rto
                consecutive_rtos += 1
            if consecutive_rtos >= tcp.tcp_retries2:
                events.append(Event(t, "CONN_DEAD", "tcp_retries2 exhausted"))
                return SimOutcome(False, t, events, bytes_acked=acked * tcp.mss)
            events.append(Event(t, "RTO", f"stall {rto:.2f}s"))
            cwnd = 10.0
            rto = min(rto * 2, tcp.max_rto)
            continue
        rto = tcp.initial_rto
        # SACK holes: delivered-but-unordered segments occupy the reorder buffer
        if lost > 0 and tcp.tcp_sack:
            reorder_bytes += delivered * tcp.mss
            if reorder_bytes > tcp.tcp_rmem * 48:  # rmem max = 48x default (sysctl triple)
                events.append(Event(t, "BUFFER_EXHAUSTED", f"{reorder_bytes}B held"))
                return SimOutcome(False, t, events, bytes_acked=acked * tcp.mss)
            cwnd = max(cwnd / 2.0, 2.0)
            pending_retrans = lost
        else:
            reorder_bytes = 0
            pending_retrans = 0
            cwnd = cwnd + 1.0 if cwnd >= wnd_max / 2 else cwnd * 2.0
        acked += delivered
    events.append(Event(t, "TRANSFER_DONE", f"{nbytes}B"))
    return SimOutcome(True, t, events, bytes_acked=nbytes)


def sim_client_round(
    tcp: TcpParams,
    link: LinkProfile,
    *,
    update_bytes: int,
    local_train_time: float,
    rng: np.random.Generator,
    connected: bool = True,
    download_bytes: Optional[int] = None,
    retry: Optional[RetryPolicy] = None,
) -> SimOutcome:
    """One full FL client round, event-granular.

    With ``retry=RetryPolicy(...)`` a failed round is re-attempted from
    scratch (fresh handshake + download + train window + upload) after the
    policy's backoff, until success, the retry budget, or the policy's
    ``deadline_cap`` on the accumulated round clock. Backoff consumes one
    uniform draw per re-attempt only when ``retry.jitter > 0``.

    With ``retry.resume=True`` re-attempts continue from the failed
    attempt's acked-byte frontier (download first, then upload) instead of
    restarting the exchange; a re-attempt whose frontier already covers
    the download also skips the local-train window. With a ``zero_rtt``
    TcpParams profile the round's first handshake is budget-free and every
    later handshake (idle-death reconnect, re-attempt after first contact)
    is a free 0-RTT session resumption.
    """
    out, ticket = _sim_client_attempt(
        tcp,
        link,
        update_bytes=update_bytes,
        local_train_time=local_train_time,
        rng=rng,
        connected=connected,
        download_bytes=download_bytes,
    )
    if retry is None:
        return out
    attempt = 1
    while (
        not out.success
        and attempt <= retry.max_retries
        and out.time < retry.deadline_cap
    ):
        wait = retry.backoff(attempt)
        if retry.jitter > 0:
            wait *= 1.0 + retry.jitter * rng.random()
        out.events.append(Event(out.time + wait, "RETRY", f"re-attempt {attempt}"))
        a, ticket = _sim_client_attempt(
            tcp,
            link,
            update_bytes=update_bytes,
            local_train_time=local_train_time,
            rng=rng,
            connected=False,
            download_bytes=download_bytes,
            ticket=ticket,
            progress=out.bytes_acked if retry.resume else 0,
        )
        base = out.time + wait
        out.events += [Event(e.t + base, e.kind, e.detail) for e in a.events]
        out = SimOutcome(
            a.success,
            base + a.time,
            out.events,
            out.reconnects + a.reconnects,
            a.bytes_acked,
        )
        attempt += 1
    return out


def _sim_client_attempt(
    tcp: TcpParams,
    link: LinkProfile,
    *,
    update_bytes: int,
    local_train_time: float,
    rng: np.random.Generator,
    connected: bool,
    download_bytes: Optional[int],
    ticket: bool = False,
    progress: int = 0,
) -> Tuple[SimOutcome, bool]:
    """One round attempt. ``ticket`` carries in-round 0-RTT session state
    across retry re-attempts (a ``zero_rtt`` profile reconnects for free
    once the round has made first contact); ``progress`` is the resume
    frontier in bytes — download acked first, then upload — from which a
    resumed re-attempt continues. Failure outcomes report the attempt's
    (cumulative) frontier in ``bytes_acked``; returns (outcome, ticket)."""
    download_bytes = update_bytes if download_bytes is None else download_bytes
    p0 = int(progress)
    f = p0  # acked-byte frontier this attempt advances
    t = 0.0
    events: List[Event] = []
    reconnects = 0

    def shift(evts, dt):
        return [Event(e.t + dt, e.kind, e.detail) for e in evts]

    if not connected:
        if tcp.zero_rtt and ticket:
            reconnects += 1
            events.append(Event(t, "ZRTT_RESUME", "0-RTT session resumption"))
        else:
            hs = sim_handshake(tcp, link, rng, no_budget=tcp.zero_rtt)
            events += hs.events
            t += hs.time
            reconnects += 1
            if not hs.success:
                return SimOutcome(False, t, events, reconnects, bytes_acked=f), ticket
            ticket = True
    else:
        ticket = True

    d0 = min(p0, download_bytes)
    down_rem = download_bytes - d0
    if p0 == 0 or down_rem > 0:
        down = sim_transfer(tcp, link, down_rem, rng)
        events += shift(down.events, t)
        t += down.time
        f = d0 + down.bytes_acked
        if not down.success:
            return SimOutcome(False, t, events, reconnects, bytes_acked=f), ticket
        f = download_bytes

    # a frontier past the download means a prior attempt delivered the
    # model AND ran the local-train window; the resumed attempt is just
    # the upload tail — no retraining, no idle phase to survive
    if p0 == 0 or p0 < download_bytes:
        state, idle_events = sim_idle(tcp, link, local_train_time, rng)
        events += shift(idle_events, t)
        t += local_train_time
        if state != "alive":
            if state == "silent_dead":
                stall = min(
                    sum(min(tcp.initial_rto * 2**i, tcp.max_rto) for i in range(6)), 60.0
                )
                t += stall
                events.append(Event(t, "STALL", "discovered dead connection on send"))
            if tcp.zero_rtt:
                # idle death implies first contact happened: free 0-RTT
                reconnects += 1
                events.append(Event(t, "ZRTT_RESUME", "0-RTT session resumption"))
            else:
                hs = sim_handshake(tcp, link, rng)
                events += shift(hs.events, t)
                t += hs.time
                reconnects += 1
                if not hs.success:
                    return (
                        SimOutcome(False, t, events, reconnects, bytes_acked=f),
                        ticket,
                    )

    u0 = max(p0 - download_bytes, 0)
    up_rem = update_bytes - u0
    if p0 == 0 or up_rem > 0:
        up = sim_transfer(tcp, link, up_rem, rng)
        events += shift(up.events, t)
        t += up.time
        f = download_bytes + u0 + up.bytes_acked
        if not up.success:
            return SimOutcome(False, t, events, reconnects, bytes_acked=f), ticket
    return (
        SimOutcome(
            True, t, events, reconnects,
            bytes_acked=update_bytes + download_bytes,
        ),
        ticket,
    )


# ===========================================================================
# Vectorized cohort / grid Monte Carlo
# ===========================================================================
#
# Batched-draw counterpart of the per-client event loops above: every random
# decision for a set of rows is sampled with one numpy call, and the
# stateful loops (keepalive cycles, AIMD windows, RTO backoff) run in
# lockstep across rows — loop iterations are shared, draws are [k]-shaped.
# Same mechanisms and distributions as sim_client_round, but wall time no
# longer scales with row count in Python.
#
# Rows carry PER-ROW TCP parameters (``_TcpArrays``) as well as per-row
# links, so a whole characterization grid — S scenarios x C clients, each
# scenario with its own TcpParams — can be sampled as one [S*C]-row plane
# (``sim_grid_round``). Full event traces are not produced on this path;
# instead an optional SPARSE trace (per-row event counts: SYN packets,
# keepalive probes/failures, middlebox drops, RTO stalls, retransmitted
# windows) supports the Fig 7/8 keepalive analyses at cohort scale. Use
# sim_client_round when an ordered event list is needed.


_TRACE_FIELDS = (
    "syn_attempts",  # SYN packets sent across all handshakes
    "keepalive_probes",  # probes sent during local-training idle
    "keepalive_failures",  # probes lost or over-RTT
    "mbox_drops",  # silent middlebox reaps discovered on send
    "detected_dead",  # keepalive-detected dead connections
    "rto_stalls",  # whole-window losses -> RTO backoff events
    "retrans_windows",  # windows with partial loss (SACK holes)
)


@dataclass
class CohortOutcome:
    """Per-client arrays for one cohort round (all shape [C])."""

    success: np.ndarray  # bool
    time: np.ndarray  # float seconds
    reconnects: np.ndarray  # int
    bytes_acked: np.ndarray  # int
    trace: Optional[Dict[str, np.ndarray]] = None  # sparse event counts


def delivery_events(
    success, times, *, t_start: float = 0.0, deadline: float = float("inf")
):
    """Per-flow DELIVERY EVENTS for an event-driven consumer.

    Every transport engine (sequential DES, cohort MC, host/device grid
    planes) reports per-flow ``(success, time)`` arrays; this folds one
    cohort's arrays into the event view the async server consumes: a list
    of ``(t_abs, flow_idx)`` landing events — dispatch time plus flow
    duration — for the flows that completed within ``deadline``, sorted by
    landing time with the flow index as the deterministic tie-break.
    Failed flows and stragglers past the deadline never become events:
    they are dropped at the transport seam instead of stalling a consumer
    that no longer waits out a synchronous round."""
    succ = np.asarray(success, bool).reshape(-1)
    tt = np.asarray(times, float).reshape(-1)
    events = [
        (t_start + float(t), int(j))
        for j, (s, t) in enumerate(zip(succ, tt))
        if s and float(t) <= deadline
    ]
    events.sort()
    return events


@dataclass
class GridOutcome:
    """Per-(scenario, client) arrays for one grid round (all shape [S, C]).

    For ragged grids (scenarios with unequal cohort sizes) C is the widest
    cohort; padding cells hold zeros/False and ``mask`` marks the real
    rows. ``mask`` is None for rectangular grids (every cell real)."""

    success: np.ndarray
    time: np.ndarray
    reconnects: np.ndarray
    bytes_acked: np.ndarray
    trace: Optional[Dict[str, np.ndarray]] = None
    mask: Optional[np.ndarray] = None
    # Per-scenario delivered wire bytes ([S]); populated by the device
    # transport plane (reduced on device via the kernels segment-sum
    # helper), None on the host paths.
    scenario_bytes: Optional[np.ndarray] = None


@dataclass
class _LinkArrays:
    loss: np.ndarray
    delay: np.ndarray
    jitter: np.ndarray
    rate_mbps: np.ndarray
    queue_limit: np.ndarray
    middlebox_timeout: np.ndarray

    @classmethod
    def from_links(cls, links: Sequence[LinkProfile]) -> "_LinkArrays":
        return cls(
            loss=np.array([l.loss for l in links], float),
            delay=np.array([l.delay for l in links], float),
            jitter=np.array([l.jitter for l in links], float),
            rate_mbps=np.array([l.rate_mbps for l in links], float),
            queue_limit=np.array([l.queue_limit for l in links], float),
            middlebox_timeout=np.array([l.middlebox_timeout for l in links], float),
        )

    def take(self, idx: np.ndarray) -> "_LinkArrays":
        return _LinkArrays(
            self.loss[idx], self.delay[idx], self.jitter[idx],
            self.rate_mbps[idx], self.queue_limit[idx],
            self.middlebox_timeout[idx],
        )


@dataclass
class _TcpArrays:
    """Per-row TcpParams: one row per (scenario, client) plane slot."""

    syn_rto: np.ndarray
    syn_retries: np.ndarray  # int
    handshake_budget: np.ndarray
    ka_time: np.ndarray
    ka_intvl: np.ndarray
    ka_probes: np.ndarray  # int
    retries2: np.ndarray  # int
    rmem: np.ndarray  # int
    sack: np.ndarray  # bool
    initial_rto: np.ndarray
    max_rto: np.ndarray
    mss: np.ndarray  # int
    window_bytes: np.ndarray  # int
    zero_rtt: np.ndarray  # bool — QUIC-style session-resumption profile

    @classmethod
    def from_params(cls, tcps: Sequence[TcpParams]) -> "_TcpArrays":
        return cls(
            syn_rto=np.array([t.syn_rto for t in tcps], float),
            syn_retries=np.array([t.tcp_syn_retries for t in tcps], np.int64),
            handshake_budget=np.array([t.handshake_budget for t in tcps], float),
            ka_time=np.array([t.tcp_keepalive_time for t in tcps], float),
            ka_intvl=np.array([t.tcp_keepalive_intvl for t in tcps], float),
            ka_probes=np.array([t.tcp_keepalive_probes for t in tcps], np.int64),
            retries2=np.array([t.tcp_retries2 for t in tcps], np.int64),
            rmem=np.array([t.tcp_rmem for t in tcps], np.int64),
            sack=np.array([t.tcp_sack for t in tcps], bool),
            initial_rto=np.array([t.initial_rto for t in tcps], float),
            max_rto=np.array([t.max_rto for t in tcps], float),
            mss=np.array([t.mss for t in tcps], np.int64),
            window_bytes=np.array([t.window_bytes for t in tcps], np.int64),
            zero_rtt=np.array([t.zero_rtt for t in tcps], bool),
        )

    @classmethod
    def broadcast(cls, tcp: TcpParams, k: int) -> "_TcpArrays":
        return cls.from_params([tcp]).take(np.zeros(k, np.int64))

    def take(self, idx: np.ndarray) -> "_TcpArrays":
        return _TcpArrays(
            self.syn_rto[idx], self.syn_retries[idx], self.handshake_budget[idx],
            self.ka_time[idx], self.ka_intvl[idx], self.ka_probes[idx],
            self.retries2[idx], self.rmem[idx], self.sack[idx],
            self.initial_rto[idx], self.max_rto[idx], self.mss[idx],
            self.window_bytes[idx], self.zero_rtt[idx],
        )


_NO_RETRY = RetryPolicy(max_retries=0)


@dataclass
class _RetryArrays:
    """Per-row RetryPolicy constants; ``None`` rows become zero-retry."""

    max_retries: np.ndarray  # int
    base: np.ndarray
    factor: np.ndarray
    max_backoff: np.ndarray
    jitter: np.ndarray
    deadline_cap: np.ndarray
    resume: np.ndarray  # bool — re-attempts continue from the acked frontier

    @classmethod
    def from_policies(cls, policies: Sequence[Optional[RetryPolicy]]) -> "_RetryArrays":
        ps = [p if p is not None else _NO_RETRY for p in policies]
        return cls(
            max_retries=np.array([p.max_retries for p in ps], np.int64),
            base=np.array([p.base_backoff for p in ps], float),
            factor=np.array([p.backoff_factor for p in ps], float),
            max_backoff=np.array([p.max_backoff for p in ps], float),
            jitter=np.array([p.jitter for p in ps], float),
            deadline_cap=np.array([p.deadline_cap for p in ps], float),
            resume=np.array([p.resume for p in ps], bool),
        )

    @classmethod
    def broadcast(cls, policy: Optional[RetryPolicy], k: int) -> "_RetryArrays":
        return cls.from_policies([policy]).take(np.zeros(k, np.int64))

    def take(self, idx: np.ndarray) -> "_RetryArrays":
        return _RetryArrays(
            self.max_retries[idx], self.base[idx], self.factor[idx],
            self.max_backoff[idx], self.jitter[idx], self.deadline_cap[idx],
            self.resume[idx],
        )


def _rtt_samples(la: _LinkArrays, rng: np.random.Generator, extra_shape=()) -> np.ndarray:
    shape = extra_shape + la.delay.shape
    j = (rng.normal(0.0, 1.0, shape) + rng.normal(0.0, 1.0, shape)) * la.jitter
    return np.maximum(2.0 * la.delay + j, 1e-5)


def _bern_ok(la: _LinkArrays, rng: np.random.Generator, extra_shape=()) -> np.ndarray:
    """Both directions survive loss (SYN/probe out + ACK back)."""
    shape = extra_shape + la.loss.shape
    return (rng.random(shape) >= la.loss) & (rng.random(shape) >= la.loss)


def _grid_handshake(
    ta: _TcpArrays, la: _LinkArrays, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (success [k], time [k], syn_attempts [k]); all SYN attempts
    sampled at once. Rows with fewer allowed retries are masked, so mixed
    TcpParams share one lockstep pass. ``zero_rtt`` rows run the same
    ladder mechanics without the budget kill (first-contact 1-RTT
    handshake of the QUIC-style profile); failures still report at the
    budget clock."""
    k = la.loss.shape[0]
    attempts = int(ta.syn_retries.max()) + 1
    a_grid = np.arange(attempts)
    t_send = a_grid[None, :] * ta.syn_rto[:, None]  # [k, A]
    rtt = _rtt_samples(la, rng, (attempts,)).T  # [k, A]
    delivered = _bern_ok(la, rng, (attempts,)).T  # [k, A]
    budget = ta.handshake_budget[:, None]
    no_budget = ta.zero_rtt[:, None]
    allowed = (a_grid[None, :] <= ta.syn_retries[:, None]) & (
        no_budget | (t_send <= budget)
    )
    ok = delivered & allowed & (no_budget | (t_send + rtt <= budget))
    success = ok.any(axis=1)
    first = np.argmax(ok, axis=1)
    rows = np.arange(k)
    time = np.where(
        success, t_send[rows, first] + rtt[rows, first], ta.handshake_budget
    )
    syn_attempts = np.where(success, first + 1, allowed.sum(axis=1))
    return success, time, syn_attempts


def _grid_idle(
    ta: _TcpArrays, la: _LinkArrays, idle_time: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Keepalive/middlebox outcome per row: 0 alive, 1 detected_dead,
    2 silent_dead, plus (probes, probe_failures) counts. Probe cycles run
    in lockstep; each row follows its own probe schedule (per-row
    keepalive_time/intvl)."""
    k = la.loss.shape[0]
    state = np.zeros(k, np.int8)
    probes = np.zeros(k, np.int64)
    probe_fails = np.zeros(k, np.int64)
    mbox = la.middlebox_timeout
    no_probe = ta.ka_time >= idle_time
    state[no_probe & (idle_time > mbox)] = 2

    undecided = ~no_probe
    if not undecided.any():
        return state, probes, probe_fails
    last_refresh = np.zeros(k)
    consecutive = np.zeros(k, np.int64)
    t = ta.ka_time.astype(float).copy()
    while True:
        active = undecided & (t <= idle_time)
        if not active.any():
            break
        rtt = _rtt_samples(la, rng)
        ok = _bern_ok(la, rng) & (rtt <= ta.ka_intvl)
        gap_drop = active & (t - last_refresh > mbox)
        state[gap_drop] = 2
        undecided &= ~gap_drop
        active &= ~gap_drop
        probes += active
        refreshed = active & ok
        last_refresh[refreshed] = t[refreshed]
        consecutive[refreshed] = 0
        failed = active & ~ok
        probe_fails += failed
        consecutive[failed] += 1
        dead = failed & (consecutive >= ta.ka_probes)
        state[dead] = 1
        undecided &= ~dead
        t = t + ta.ka_intvl
    tail = undecided & (idle_time - last_refresh > mbox)
    state[tail] = 2
    return state, probes, probe_fails


def _grid_transfer(
    ta: _TcpArrays, la: _LinkArrays, nbytes: np.ndarray, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Lockstep AIMD over the rows; returns (success, time, rto_stalls,
    retrans_windows, acked_bytes), all [k] — ``acked_bytes`` is the
    durable acked frontier (``nbytes`` on success, the partial frontier a
    resumed re-attempt continues from on failure).

    Mirrors sim_transfer's per-window mechanics (window sizing, binomial
    loss, SACK reorder accounting, RTO backoff with constant per-attempt
    loss probability) with one [k]-shaped draw per shared loop iteration
    and per-row TCP constants.
    """
    k = la.loss.shape[0]
    nbytes = np.broadcast_to(np.asarray(nbytes, np.int64), (k,))
    segs_total = np.maximum((nbytes + ta.mss - 1) // ta.mss, 1)
    wnd_max = np.maximum(ta.window_bytes // ta.mss, 2)
    t = np.zeros(k)
    cwnd = np.full(k, 10.0)
    acked = np.zeros(k, np.int64)
    pending = np.zeros(k, np.int64)
    rto = ta.initial_rto.astype(float).copy()
    reorder = np.zeros(k)
    active = np.ones(k, bool)
    success = np.zeros(k, bool)
    rto_stalls = np.zeros(k, np.int64)
    retrans_windows = np.zeros(k, np.int64)
    p = la.loss

    iters = 0
    while active.any():
        iters += 1
        if iters > 200_000:
            break  # iteration cap: survivors count as failed (as sequential)
        rtt = _rtt_samples(la, rng)
        rate_cap = np.where(
            la.rate_mbps > 0,
            np.maximum((la.rate_mbps * 1e6 / 8.0 * rtt / ta.mss).astype(np.int64), 1),
            np.int64(2**60),
        )
        w = np.minimum(
            np.minimum(cwnd.astype(np.int64), wnd_max),
            np.minimum(la.queue_limit.astype(np.int64), rate_cap),
        )
        remaining = np.maximum(segs_total - acked + pending, 0)
        w = np.minimum(np.maximum(w, 1), remaining)
        w = np.where(active, w, 0)  # finished/failed rows draw nothing
        lost = rng.binomial(w, p)
        delivered = w - lost
        t = np.where(active, t + rtt, t)

        # --- whole-window loss -> RTO backoff (lockstep over the stalled) ---
        stalled = active & (delivered == 0)
        if stalled.any():
            t[stalled] += rto[stalled]
            rto_stalls += stalled
            consecutive = np.where(stalled, 1, 0)
            still = stalled.copy()
            while still.any():
                lost_again = rng.random(k) < p
                cont = still & (consecutive < ta.retries2) & lost_again
                dead_now = still & (consecutive >= ta.retries2)
                still = cont
                rto[cont] = np.minimum(rto[cont] * 2.0, ta.max_rto[cont])
                t[cont] += rto[cont]
                consecutive[cont] += 1
                active &= ~dead_now
            surv = stalled & active
            cwnd[surv] = 10.0
            rto[surv] = np.minimum(rto[surv] * 2.0, ta.max_rto[surv])

        # --- progress: ack, SACK holes, cwnd evolution ---
        prog = active & (delivered > 0)
        rto[prog] = ta.initial_rto[prog]
        holed = prog & (lost > 0) & ta.sack
        retrans_windows += holed
        reorder[holed] += delivered[holed] * ta.mss[holed]
        buf_dead = holed & (reorder > ta.rmem * 48)
        active &= ~buf_dead
        holed &= ~buf_dead
        cwnd[holed] = np.maximum(cwnd[holed] / 2.0, 2.0)
        pending[holed] = lost[holed]
        clean = prog & ~holed & active
        reorder[clean] = 0.0
        pending[clean] = 0
        cwnd[clean] = np.where(
            cwnd[clean] >= wnd_max[clean] / 2.0, cwnd[clean] + 1.0, cwnd[clean] * 2.0
        )
        acked = np.where(prog & active, acked + delivered, acked)
        done = active & (acked >= segs_total)
        success |= done
        active &= ~done
    acked_bytes = np.where(success, nbytes, np.minimum(acked * ta.mss, nbytes))
    return success, t, rto_stalls, retrans_windows, acked_bytes


def _sim_rows(
    ta: _TcpArrays,
    la: _LinkArrays,
    *,
    up_bytes: np.ndarray,
    down_bytes: np.ndarray,
    local_train_times: np.ndarray,
    rng: np.random.Generator,
    connected: np.ndarray,
    retry=None,
):
    """One FL round for a plane of rows with batched draws, plus the
    optional application-level retry ladder.

    ``retry`` is None, a RetryPolicy (broadcast to all rows), or a
    ``_RetryArrays`` with per-row policies. Failed rows re-run the whole
    attempt pipeline (``_sim_rows_once``) after their backoff wait —
    reconnecting from scratch by default, or continuing from the acked
    frontier on ``resume`` rows (ticket and progress registers thread
    through the ladder). Jitter rows consume one uniform draw per
    re-attempt, jitter-free rows consume none — so the degenerate
    (loss=0, jitter=0) path stays draw-free and exactly comparable to the
    device plane. Returns (success, time, reconnects, bytes_acked,
    counts)."""
    alive, t, reconnects, bytes_acked, counts, ticket = _sim_rows_once(
        ta,
        la,
        up_bytes=up_bytes,
        down_bytes=down_bytes,
        local_train_times=local_train_times,
        rng=rng,
        connected=connected,
    )
    if retry is None:
        return alive, t, reconnects, bytes_acked, counts
    k = la.loss.shape[0]
    ra = retry if isinstance(retry, _RetryArrays) else _RetryArrays.broadcast(retry, k)
    max_r = int(ra.max_retries.max()) if k else 0
    up_bytes = np.asarray(up_bytes)
    down_bytes = np.asarray(down_bytes)
    local_train_times = np.asarray(local_train_times)
    for attempt in range(1, max_r + 1):
        failed = np.where(
            ~alive & (attempt <= ra.max_retries) & (t < ra.deadline_cap)
        )[0]
        if failed.size == 0:
            break
        wait = np.minimum(
            ra.base[failed] * ra.factor[failed] ** (attempt - 1),
            ra.max_backoff[failed],
        )
        jit = ra.jitter[failed]
        jrows = np.where(jit > 0)[0]
        if jrows.size:
            wait[jrows] *= 1.0 + jit[jrows] * rng.random(jrows.size)
        a2, t2, rc2, ba2, c2, tk2 = _sim_rows_once(
            ta.take(failed),
            la.take(failed),
            up_bytes=up_bytes[failed],
            down_bytes=down_bytes[failed],
            local_train_times=local_train_times[failed],
            rng=rng,
            connected=np.zeros(failed.size, bool),
            ticket=ticket[failed],
            progress=np.where(ra.resume[failed], bytes_acked[failed], 0),
        )
        t[failed] += wait + t2
        reconnects[failed] += rc2
        bytes_acked[failed] = ba2
        alive[failed] = a2
        ticket[failed] = tk2
        for f in _TRACE_FIELDS:
            counts[f][failed] += c2[f]
    return alive, t, reconnects, bytes_acked, counts


def _sim_rows_once(
    ta: _TcpArrays,
    la: _LinkArrays,
    *,
    up_bytes: np.ndarray,
    down_bytes: np.ndarray,
    local_train_times: np.ndarray,
    rng: np.random.Generator,
    connected: np.ndarray,
    ticket: Optional[np.ndarray] = None,
    progress: Optional[np.ndarray] = None,
):
    """One FL round ATTEMPT for a plane of rows with batched draws:
    handshake-if-needed -> download -> idle (keepalive/middlebox) ->
    reconnect-if-dead -> upload, each stage sampled for every row at once.

    ``ticket`` [k] bool marks rows holding a 0-RTT session ticket from an
    earlier attempt this round (``zero_rtt`` rows reconnect for free);
    ``progress`` [k] int64 is the resume frontier in bytes (download acked
    first, then upload) a resumed re-attempt continues from. Both default
    to the fresh-attempt state (no ticket, zero frontier), under which the
    stage masks and draw order are identical to the pre-reliability
    pipeline. Returns (success, time, reconnects, bytes_acked, counts,
    ticket_out) — ``bytes_acked`` is the cumulative frontier (full payload
    on success, partial progress on failure)."""
    k = la.loss.shape[0]
    t = np.zeros(k)
    reconnects = np.zeros(k, np.int64)
    alive = np.ones(k, bool)
    counts = {name: np.zeros(k, np.int64) for name in _TRACE_FIELDS}
    if ticket is None:
        ticket = np.zeros(k, bool)
    p0 = np.zeros(k, np.int64) if progress is None else np.asarray(progress, np.int64)
    frontier = p0.copy()

    # 0-RTT resumption: zero_rtt rows holding a ticket reconnect for free
    free = ~connected & ta.zero_rtt & ticket
    reconnects[free] += 1
    idx = np.where(~connected & ~free)[0]
    if idx.size:
        ok, ht, att = _grid_handshake(ta.take(idx), la.take(idx), rng)
        t[idx] += ht
        reconnects[idx] += 1
        alive[idx] &= ok
        counts["syn_attempts"][idx] += att
    # first contact made (connected rows, or a successful handshake):
    # the round now holds a session ticket
    ticket = ticket | alive

    d0 = np.minimum(p0, down_bytes)
    down_rem = (down_bytes - d0).astype(np.int64)
    idx = np.where(alive & ((p0 == 0) | (down_rem > 0)))[0]
    if idx.size:
        ok, dt, stalls, rwnd, ba = _grid_transfer(
            ta.take(idx), la.take(idx), down_rem[idx], rng
        )
        t[idx] += dt
        alive[idx] &= ok
        counts["rto_stalls"][idx] += stalls
        counts["retrans_windows"][idx] += rwnd
        frontier[idx] = d0[idx] + ba

    # rows whose frontier already covers the download trained in a prior
    # attempt: the resumed attempt is the upload tail only
    pay_train = alive & ((p0 == 0) | (p0 < down_bytes))
    idx = np.where(pay_train)[0]
    if idx.size:
        state, probes, pfails = _grid_idle(
            ta.take(idx), la.take(idx), local_train_times[idx], rng
        )
        t[idx] += local_train_times[idx]
        counts["keepalive_probes"][idx] += probes
        counts["keepalive_failures"][idx] += pfails
        silent = idx[state == 2]
        counts["mbox_drops"][silent] += 1
        counts["detected_dead"][idx[state == 1]] += 1
        if silent.size:
            ta_s = ta.take(silent)
            stall = np.minimum(
                sum(
                    np.minimum(ta_s.initial_rto * 2**i, ta_s.max_rto)
                    for i in range(6)
                ),
                60.0,
            )
            t[silent] += stall
        need_hs = idx[state != 0]
        if need_hs.size:
            # idle death implies first contact happened: zero_rtt rows
            # reconnect via free 0-RTT resumption, no ladder draw
            zr = ta.zero_rtt[need_hs]
            reconnects[need_hs[zr]] += 1
            need_hs = need_hs[~zr]
        if need_hs.size:
            ok, ht, att = _grid_handshake(ta.take(need_hs), la.take(need_hs), rng)
            t[need_hs] += ht
            reconnects[need_hs] += 1
            alive[need_hs] &= ok
            counts["syn_attempts"][need_hs] += att

    u0 = np.maximum(p0 - down_bytes, 0)
    up_rem = (up_bytes - u0).astype(np.int64)
    idx = np.where(alive & ((p0 == 0) | (up_rem > 0)))[0]
    if idx.size:
        ok, ut, stalls, rwnd, ba = _grid_transfer(
            ta.take(idx), la.take(idx), up_rem[idx], rng
        )
        t[idx] += ut
        alive[idx] &= ok
        counts["rto_stalls"][idx] += stalls
        counts["retrans_windows"][idx] += rwnd
        frontier[idx] = down_bytes[idx] + u0[idx] + ba

    bytes_acked = np.where(alive, up_bytes + down_bytes, frontier).astype(np.int64)
    return alive, t, reconnects, bytes_acked, counts, ticket


def sim_cohort_round(
    tcp: TcpParams,
    links: Sequence[LinkProfile],
    *,
    update_bytes: int,
    local_train_times: np.ndarray,
    rng: np.random.Generator,
    connected: np.ndarray,
    download_bytes: Optional[int] = None,
    trace: bool = False,
    retry: Optional[RetryPolicy] = None,
) -> CohortOutcome:
    """One FL round for a whole cohort with batched draws.

    Vector twin of ``sim_client_round``: every stage sampled for all
    clients at once. ``connected`` and ``local_train_times`` are
    [C]-shaped. ``update_bytes``/``download_bytes`` are scalars or [C]
    arrays — per-row payload sizes that flow into the per-row transfer
    mechanics. The billing convention is ASYMMETRIC: ``update_bytes``
    carries the (possibly compressed) upload wire size, ``download_bytes``
    the full-model download; omitting ``download_bytes`` falls back to
    symmetric billing. With ``trace=True`` the outcome carries sparse
    per-client event counts (see _TRACE_FIELDS) instead of an ordered
    event list. ``retry`` applies the application-level retry ladder to
    every row (see ``_sim_rows``).
    """
    download_bytes = update_bytes if download_bytes is None else download_bytes
    k = len(links)
    alive, t, reconnects, bytes_acked, counts = _sim_rows(
        _TcpArrays.broadcast(tcp, k),
        _LinkArrays.from_links(links),
        up_bytes=np.broadcast_to(np.asarray(update_bytes, np.int64), (k,)),
        down_bytes=np.broadcast_to(np.asarray(download_bytes, np.int64), (k,)),
        local_train_times=np.asarray(local_train_times, float),
        rng=rng,
        connected=np.asarray(connected, bool),
        retry=retry,
    )
    return CohortOutcome(alive, t, reconnects, bytes_acked, counts if trace else None)


def _per_scenario_rows(x, sizes, dtype):
    """Normalize a scalar / length-S sequence (of scalars or [C_s] arrays)
    into a list of per-scenario [C_s] arrays for the ragged grid path."""
    if np.isscalar(x) or (isinstance(x, np.ndarray) and x.ndim == 0):
        return [np.full(c, x, dtype) for c in sizes]
    out = []
    for s, c in enumerate(sizes):
        xs = np.asarray(x[s], dtype)
        out.append(np.full(c, xs, dtype) if xs.ndim == 0 else xs.reshape(c))
    return out


def _sim_grid_round_ragged(
    tcp_list, links, up_s, down_s, ltt_s, conn_s, rng, rngs, trace, retry_list
) -> GridOutcome:
    """Ragged grid round: scenarios keep their true cohort widths. Parity
    mode loops scenarios on their own generators (exact widths, exact
    draws); fused mode concatenates every real row into one flat plane —
    no padding rows ever consume shared-stream draws. Outputs are padded
    to the widest cohort with ``mask`` marking real cells."""
    S = len(links)
    sizes = [len(row) for row in links]
    C = max(sizes) if S else 0
    success = np.zeros((S, C), bool)
    time_ = np.zeros((S, C), float)
    recon = np.zeros((S, C), np.int64)
    acked = np.zeros((S, C), np.int64)
    counts = {f: np.zeros((S, C), np.int64) for f in _TRACE_FIELDS} if trace else None
    mask = np.zeros((S, C), bool)
    for s, c in enumerate(sizes):
        mask[s, :c] = True

    if rngs is not None:
        for s in range(S):
            o = sim_cohort_round(
                tcp_list[s],
                links[s],
                update_bytes=up_s[s],
                local_train_times=ltt_s[s],
                rng=rngs[s],
                connected=conn_s[s],
                download_bytes=down_s[s],
                trace=trace,
                retry=retry_list[s],
            )
            c = sizes[s]
            success[s, :c] = o.success
            time_[s, :c] = o.time
            recon[s, :c] = o.reconnects
            acked[s, :c] = o.bytes_acked
            if trace:
                for f in _TRACE_FIELDS:
                    counts[f][s, :c] = o.trace[f]
    else:
        scen = np.repeat(np.arange(S), sizes)
        ta = _TcpArrays.from_params(tcp_list).take(scen)
        la = _LinkArrays.from_links([l for row in links for l in row])
        alive, t, rc, ba, cnt = _sim_rows(
            ta,
            la,
            up_bytes=np.concatenate(up_s) if S else np.zeros(0, np.int64),
            down_bytes=np.concatenate(down_s) if S else np.zeros(0, np.int64),
            local_train_times=np.concatenate(ltt_s) if S else np.zeros(0),
            rng=rng,
            connected=np.concatenate(conn_s) if S else np.zeros(0, bool),
            retry=(
                _RetryArrays.from_policies(retry_list).take(scen)
                if any(p is not None for p in retry_list)
                else None
            ),
        )
        # boolean scatter is row-major: rows land scenario by scenario in
        # exactly the concatenation order
        success[mask] = alive
        time_[mask] = t
        recon[mask] = rc
        acked[mask] = ba
        if trace:
            for f in _TRACE_FIELDS:
                counts[f][mask] = cnt[f]
    return GridOutcome(success, time_, recon, acked, counts, mask)


def sim_grid_round(
    tcps,
    links,
    *,
    update_bytes,
    local_train_times: np.ndarray,
    connected: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    rngs: Optional[Sequence[np.random.Generator]] = None,
    download_bytes=None,
    trace: bool = False,
    retry=None,
) -> GridOutcome:
    """One FL round for a whole characterization grid: S scenarios x C
    clients, each scenario with its own TcpParams and per-client links.

    This is the grid engine's per-round transport plane: ``run_fl_grid``
    (transport="parity"/"fused") issues exactly one call per sweep round
    covering every point's cohort.

    Two sampling modes:

    - ``rngs=[gen_0..gen_{S-1}]`` (parity mode): each scenario's draws come
      from its OWN generator, consumed exactly as a per-scenario
      ``sim_cohort_round`` call would — grid outcomes are bit-identical to
      per-point runs at equal seeds. Stages still vectorize over C.
    - ``rng=gen`` (fused mode): the whole [S*C] plane is sampled in one
      lockstep pass per stage with per-row TCP arrays — fastest at scale,
      same distributions, but a single shared draw order (use for
      throughput, not for per-point reproduction).

    ``tcps`` is one TcpParams or a length-S sequence; ``links`` is [S][C];
    ``update_bytes``/``download_bytes`` are scalars, length-S, or [S, C]
    (per-row payload sizes; the convention is ASYMMETRIC billing —
    ``update_bytes`` carries the compressed upload wire size,
    ``download_bytes`` the full-model download; ``download_bytes=None``
    falls back to symmetric billing);
    ``local_train_times``/``connected`` are [S, C]. All outputs are [S, C].

    Scenarios may have UNEQUAL cohort sizes (``links`` ragged): pass the
    per-row arguments as length-S sequences of per-scenario scalars or
    [C_s] arrays. Outputs are then padded to the widest cohort and
    ``GridOutcome.mask`` marks real cells; fused mode concatenates real
    rows only, so padding never consumes shared-stream draws.

    ``retry`` is None, one RetryPolicy for every scenario, or a length-S
    sequence of per-scenario ``Optional[RetryPolicy]`` — the grid engine
    passes per-point policies so one plane can mix retry budgets.
    """
    S = len(links)
    tcp_list = [tcps] * S if isinstance(tcps, TcpParams) else list(tcps)
    retry_list = (
        [retry] * S
        if retry is None or isinstance(retry, RetryPolicy)
        else list(retry)
    )
    if (rng is None) == (rngs is None):
        raise ValueError("pass exactly one of rng= (fused) or rngs= (per-scenario)")

    sizes = [len(row) for row in links]
    if S and any(c != sizes[0] for c in sizes):
        up_s = _per_scenario_rows(update_bytes, sizes, np.int64)
        down_s = (
            up_s
            if download_bytes is None
            else _per_scenario_rows(download_bytes, sizes, np.int64)
        )
        return _sim_grid_round_ragged(
            tcp_list,
            links,
            up_s,
            down_s,
            _per_scenario_rows(local_train_times, sizes, float),
            _per_scenario_rows(connected, sizes, bool),
            rng,
            rngs,
            trace,
            retry_list,
        )
    C = sizes[0] if S else 0

    def _bytes_grid(b):
        b = np.asarray(b, np.int64)
        if b.ndim == 2:
            return b.reshape(S, C)
        return np.broadcast_to(b.reshape(-1, 1) if b.ndim == 1 else b, (S, C))

    up = _bytes_grid(update_bytes)
    down = up if download_bytes is None else _bytes_grid(download_bytes)
    local_train_times = np.asarray(local_train_times, float).reshape(S, C)
    connected = np.asarray(connected, bool).reshape(S, C)

    if rngs is not None:
        outs = [
            sim_cohort_round(
                tcp_list[s],
                links[s],
                update_bytes=up[s],
                local_train_times=local_train_times[s],
                rng=rngs[s],
                connected=connected[s],
                download_bytes=down[s],
                trace=trace,
                retry=retry_list[s],
            )
            for s in range(S)
        ]
        return GridOutcome(
            np.stack([o.success for o in outs]),
            np.stack([o.time for o in outs]),
            np.stack([o.reconnects for o in outs]),
            np.stack([o.bytes_acked for o in outs]),
            (
                {f: np.stack([o.trace[f] for o in outs]) for f in _TRACE_FIELDS}
                if trace
                else None
            ),
        )

    flat_links = [l for row in links for l in row]
    ta = _TcpArrays.from_params(tcp_list).take(np.repeat(np.arange(S), C))
    alive, t, reconnects, bytes_acked, counts = _sim_rows(
        ta,
        _LinkArrays.from_links(flat_links),
        up_bytes=up.reshape(-1),
        down_bytes=down.reshape(-1),
        local_train_times=local_train_times.reshape(-1),
        rng=rng,
        connected=connected.reshape(-1),
        retry=(
            _RetryArrays.from_policies(retry_list).take(np.repeat(np.arange(S), C))
            if any(p is not None for p in retry_list)
            else None
        ),
    )
    return GridOutcome(
        alive.reshape(S, C),
        t.reshape(S, C),
        reconnects.reshape(S, C),
        bytes_acked.reshape(S, C),
        (
            {f: counts[f].reshape(S, C) for f in _TRACE_FIELDS}
            if trace
            else None
        ),
    )
