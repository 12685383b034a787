"""Analytic transport model: FL-over-TCP outcome prediction.

Closed-form expectations/probabilities for the three mechanisms the paper
identifies (§IV-B, §V):

1. **Handshake** — SYN retransmit schedule vs RTT under a finite budget
   (``(tcp_syn_retries+1) * syn_rto``). Reproduces the 5 s one-way-delay
   catastrophic cliff and the Fig-6 syn_retries sweeps.
2. **Idle-phase liveness** — FL's burst-idle pattern: local training keeps
   the connection silent; middleboxes silently reap idle connections;
   keepalive probes (keepalive_time/intvl/probes) either keep the
   connection alive, detect death early, or (defaults) let the next round
   discover a dead connection the expensive way. Reproduces Fig 7/8.
3. **Transfer** — Mathis-model goodput under loss, window/rate/queue caps,
   retransmission overhead, and reorder-buffer exhaustion (the >50 % loss
   failure, Rec #2).

Everything is deterministic (expectations); `repro_torch.transport.des` is the
event-granular stochastic oracle used to validate these formulas in tests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.transport.link import LinkProfile
from repro_torch.transport.params import RetryPolicy, TcpParams

# Calibration constants (DESIGN §8.1): characteristic FL burst window for
# reorder-pressure, and RTO-stall escalation under heavy loss.
REORDER_BASE_WND = 131072  # bytes
RTO_STALL_ESCALATION = 2.0  # mean stall per RTO event, x initial_rto
SLOW_START_RTTS = 4.0  # ramp-up cost of a fresh connection's congestion window


@dataclass(frozen=True)
class HandshakeResult:
    success_prob: float
    expected_time: float  # conditional on success (s)
    attempts_viable: int
    budget: float


@dataclass(frozen=True)
class IdleResult:
    p_alive: float  # connection survives the idle phase
    p_detected_dead: float  # keepalive detected death -> cheap reconnect
    p_silent_dead: float  # silent middlebox drop -> stall + reconnect
    probes_sent: int
    detect_stall: float  # expected extra stall when silently dead (s)


@dataclass(frozen=True)
class TransferResult:
    success_prob: float
    expected_time: float  # conditional on success (s)
    goodput_bps: float
    buffer_required: float  # reorder-buffer demand (bytes)
    buffer_ok: bool


def effective_rtt(link: LinkProfile) -> float:
    # jitter adds one-sided expected delay on each direction
    return 2.0 * (link.delay + 0.5 * link.jitter)


# ---------------------------------------------------------------------------
# 1. Handshake
# ---------------------------------------------------------------------------


def handshake(tcp: TcpParams, link: LinkProfile) -> HandshakeResult:
    rtt = effective_rtt(link)
    budget = tcp.handshake_budget
    q = (1.0 - link.loss) ** 2  # SYN out + SYN-ACK back (ACK piggybacks)

    # attempt k is sent at k*syn_rto; viable iff its SYN-ACK can return
    # within the budget window. A zero_rtt profile keeps the ladder but
    # has no kernel budget death (QUIC-style 1-RTT handshake): every
    # attempt is viable regardless of RTT — the 5 s OWD cliff vanishes.
    viable = [
        k
        for k in range(tcp.tcp_syn_retries + 1)
        if tcp.zero_rtt or k * tcp.syn_rto + rtt <= budget
    ]
    if not viable or q <= 0.0:
        return HandshakeResult(0.0, math.inf, 0, budget)

    p_success = 1.0 - (1.0 - q) ** len(viable)
    # expected completion time conditional on success
    t_sum, p_mass = 0.0, 0.0
    for i, k in enumerate(viable):
        p_k = q * (1.0 - q) ** i
        t_sum += p_k * (k * tcp.syn_rto + rtt)
        p_mass += p_k
    exp_time = t_sum / p_mass if p_mass > 0 else math.inf
    return HandshakeResult(p_success, exp_time, len(viable), budget)


# ---------------------------------------------------------------------------
# 2. Idle-phase liveness (the burst-idle mismatch)
# ---------------------------------------------------------------------------


def idle_phase(tcp: TcpParams, link: LinkProfile, idle_time: float) -> IdleResult:
    rtt = effective_rtt(link)
    mbox = link.middlebox_timeout

    detect_stall = min(
        sum(min(tcp.initial_rto * 2**i, tcp.max_rto) for i in range(6)),
        60.0,
    )  # RTO escalation before the app gives up on the dead socket

    if tcp.tcp_keepalive_time >= idle_time:
        # no probes fire during this idle phase
        if idle_time > mbox:
            return IdleResult(0.0, 0.0, 1.0, 0, detect_stall)
        return IdleResult(1.0, 0.0, 0.0, 0, detect_stall)

    # probes fire at keepalive_time, then every intvl
    n_probes = 1 + int((idle_time - tcp.tcp_keepalive_time) / max(tcp.tcp_keepalive_intvl, 1e-9))
    probe_gap = max(tcp.tcp_keepalive_time, tcp.tcp_keepalive_intvl)

    if probe_gap > mbox:
        # probes too sparse to refresh the middlebox: still silently dropped
        return IdleResult(0.0, 0.0, 1.0, n_probes, detect_stall)

    # a probe cycle fails if the probe or its ACK is lost, or the ACK cannot
    # return within the probe interval
    ack_in_time = 1.0 if rtt <= tcp.tcp_keepalive_intvl else 0.0
    p_probe_fail = 1.0 - ((1.0 - link.loss) ** 2) * ack_in_time

    # declared dead after `tcp_keepalive_probes` consecutive failures
    K = tcp.tcp_keepalive_probes
    if n_probes < K:
        p_declared = 0.0
    else:
        # approximation: probability of >= K consecutive failures in n trials
        # via the standard run bound: 1-(1-p^K)^(n-K+1)
        p_declared = 1.0 - (1.0 - p_probe_fail**K) ** (n_probes - K + 1)
    p_alive = 1.0 - p_declared
    return IdleResult(p_alive, p_declared, 0.0, n_probes, detect_stall)


# ---------------------------------------------------------------------------
# 3. Transfer
# ---------------------------------------------------------------------------


def goodput_bps(tcp: TcpParams, link: LinkProfile) -> float:
    rtt = max(effective_rtt(link), 1e-4)
    caps = [link.rate_mbps * 1e6 / 8.0]  # link rate in bytes/s... see below
    # NOTE: internally we compute in bytes/s then convert on return.
    wnd_cap = tcp.window_bytes / rtt
    caps.append(wnd_cap)
    if link.loss > 0:
        mathis = (tcp.mss / rtt) * math.sqrt(1.5 / link.loss)
        caps.append(mathis)
    if link.delay > 0:
        queue_cap = link.queue_limit * tcp.mss / (2.0 * link.delay)
        caps.append(queue_cap)
    return min(caps) * 8.0  # bits/s


def transfer(tcp: TcpParams, link: LinkProfile, nbytes: int) -> TransferResult:
    rtt = max(effective_rtt(link), 1e-4)
    p = link.loss
    bps = goodput_bps(tcp, link)
    Bps = bps / 8.0

    # reorder-buffer pressure: SACK holes hold out-of-order data in rmem
    odds = p / max(1.0 - p, 1e-9)
    required = REORDER_BASE_WND * odds * odds
    buffer_ok = required <= tcp.tcp_rmem

    # retransmission overhead + RTO stalls
    segs = max(1, math.ceil(nbytes / tcp.mss))
    base = nbytes / max(Bps, 1.0)
    retrans = base * (p / max(1.0 - p, 1e-9))
    rto_events = segs * p * p  # a retransmitted segment lost again
    stalls = rto_events * tcp.initial_rto * RTO_STALL_ESCALATION
    t = rtt * SLOW_START_RTTS + base + retrans + stalls

    # a transfer can also die outright: one segment exhausting tcp_retries2
    p_seg_dead = p ** max(tcp.tcp_retries2, 1)
    p_alive = (1.0 - p_seg_dead) ** segs if p_seg_dead > 0 else 1.0
    success = (p_alive if buffer_ok else 0.0)
    return TransferResult(success, t if success > 0 else math.inf, bps, required, buffer_ok)


# ---------------------------------------------------------------------------
# Composite: one FL client round
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ClientRoundOutcome:
    p_complete: float
    expected_time: float  # conditional on completion
    reconnects: float  # expected reconnect events
    detail: dict


def client_round(
    tcp: TcpParams,
    link: LinkProfile,
    *,
    update_bytes: int,
    local_train_time: float,
    connected: bool = True,
    download_bytes: Optional[int] = None,
) -> ClientRoundOutcome:
    """One FL round for one client: (reconnect?) -> download global model ->
    local training (idle on the wire) -> upload update.
    """
    download_bytes = update_bytes if download_bytes is None else download_bytes
    t = 0.0
    p_ok = 1.0
    reconnects = 0.0
    detail = {}

    if not connected:
        hs = handshake(tcp, link)
        p_ok *= hs.success_prob
        t += hs.expected_time
        reconnects += 1.0
        detail["handshake"] = hs

    down = transfer(tcp, link, download_bytes)
    p_ok *= down.success_prob
    t += down.expected_time if down.success_prob else math.inf
    detail["download"] = down

    # local training: the wire goes idle (the paper's burst-idle pattern)
    idle = idle_phase(tcp, link, local_train_time)
    t += local_train_time
    detail["idle"] = idle
    # silent death: pay the detection stall + a re-handshake before upload.
    # A zero_rtt profile reconnects off the session ticket for free (the
    # detection stall is still paid — silent drops are discovered on send).
    p_reconnect_needed = idle.p_silent_dead + idle.p_detected_dead
    if tcp.zero_rtt:
        extra = idle.p_silent_dead * idle.detect_stall
        p_ok *= idle.p_alive + p_reconnect_needed
    else:
        hs2 = handshake(tcp, link)
        extra = (
            idle.p_silent_dead * (idle.detect_stall + hs2.expected_time)
            + idle.p_detected_dead * hs2.expected_time
        )
        p_ok *= idle.p_alive + p_reconnect_needed * hs2.success_prob
    t += extra
    reconnects += p_reconnect_needed

    up = transfer(tcp, link, update_bytes)
    p_ok *= up.success_prob
    t += up.expected_time if up.success_prob else math.inf
    detail["upload"] = up

    if p_ok <= 0.0 or math.isinf(t):
        return ClientRoundOutcome(0.0, math.inf, reconnects, detail)
    return ClientRoundOutcome(p_ok, t, reconnects, detail)


def retry_round(
    tcp: TcpParams,
    link: LinkProfile,
    retry: RetryPolicy,
    *,
    update_bytes: int,
    local_train_time: float,
    connected: bool = True,
    download_bytes: Optional[int] = None,
) -> ClientRoundOutcome:
    """Closed-form composite of ``client_round`` under a ``RetryPolicy``:
    a failed exchange re-attempts the ENTIRE round (fresh handshake —
    the failure killed the connection — plus download/train/upload) after
    the policy's backoff, up to ``max_retries`` times or until the
    accumulated clock passes ``deadline_cap``.

    Mirrors the truncated-geometric structure of the DES wrapper in
    ``repro_torch.transport.des.sim_client_round``: with per-attempt success
    probability p (p0 for the first attempt, which may start connected;
    p1 for re-attempts, which never do),

        p_complete = 1 - (1-p0) * (1-p1)^R_eff
        E[time | success] = sum_k P(succeed on attempt k) * E[t_k] / p_complete

    where attempt k's expected clock includes every prior attempt's
    failure time (approximated by its conditional completion time) plus
    the mean backoff ``retry.backoff(k) * (1 + jitter/2)``. Deterministic
    expectations only — the DES remains the stochastic oracle.

    Reliability variants: a ``zero_rtt`` profile makes re-attempts
    resume the round's session ticket for free (modeled as starting
    connected). ``retry.resume`` models the resumed re-attempt with the
    ½-frontier approximation: a (re)handshake plus half the exchange's
    transfer time on average and NO local-train window (a failed attempt
    is uniformly likely to die anywhere along the byte frontier, and a
    frontier past the download has already trained)."""
    first = client_round(
        tcp, link, update_bytes=update_bytes,
        local_train_time=local_train_time, connected=connected,
        download_bytes=download_bytes,
    )
    if retry.resume:
        db = update_bytes if download_bytes is None else download_bytes
        dn = transfer(tcp, link, db)
        upx = transfer(tcp, link, update_bytes)
        if tcp.zero_rtt:
            hs_p, hs_t = 1.0, 0.0  # free 0-RTT resumption off the ticket
        else:
            hs = handshake(tcp, link)
            hs_p, hs_t = hs.success_prob, hs.expected_time
        p_re = hs_p * dn.success_prob * upx.success_prob
        t_re = (hs_t if math.isfinite(hs_t) else 0.0) + 0.5 * (
            (dn.expected_time if math.isfinite(dn.expected_time) else 0.0)
            + (upx.expected_time if math.isfinite(upx.expected_time) else 0.0)
        )
        rea = ClientRoundOutcome(
            p_re, t_re if p_re > 0 else math.inf, 1.0, {}
        )
    else:
        rea = client_round(
            tcp, link, update_bytes=update_bytes,
            local_train_time=local_train_time, connected=tcp.zero_rtt,
            download_bytes=download_bytes,
        )
    attempt_t = rea.expected_time if math.isfinite(rea.expected_time) else 0.0
    first_t = first.expected_time if math.isfinite(first.expected_time) else 0.0
    mean_jit = 1.0 + 0.5 * retry.jitter

    # walk the ladder: attempt 0 is the base round; attempt k >= 1 starts
    # at clock t_k = t_{k-1} + backoff(k); viable iff t_k < deadline_cap
    t_sum, p_mass, fail_p, clock, recon = 0.0, 0.0, 1.0, 0.0, 0.0
    for k in range(retry.max_retries + 1):
        out, t_att = (first, first_t) if k == 0 else (rea, attempt_t)
        if k > 0:
            clock += retry.backoff(k) * mean_jit
            if clock >= retry.deadline_cap:
                break
        p_k = fail_p * out.p_complete
        t_sum += p_k * (clock + t_att)
        p_mass += p_k
        recon += fail_p * out.reconnects
        fail_p *= 1.0 - out.p_complete
        clock += t_att  # failed attempts burn roughly a full round's clock
    if p_mass <= 0.0:
        return ClientRoundOutcome(0.0, math.inf, recon, {"first": first, "retry": rea})
    return ClientRoundOutcome(
        p_mass, t_sum / p_mass, recon, {"first": first, "retry": rea}
    )


def classify(tcp: TcpParams, link: LinkProfile, *, update_bytes: int = 300_000,
             local_train_time: float = 30.0) -> str:
    """Paper Table III: acceptable / tolerable / failure for a condition."""
    out = client_round(
        tcp, link, update_bytes=update_bytes, local_train_time=local_train_time,
        connected=False,
    )
    baseline = client_round(
        TcpParams(), LinkProfile(), update_bytes=update_bytes,
        local_train_time=local_train_time, connected=False,
    )
    if out.p_complete < 0.1:
        return "failure"
    slowdown = out.expected_time / max(baseline.expected_time, 1e-9)
    if out.p_complete > 0.9 and slowdown < 1.5:
        return "acceptable"
    return "tolerable"
