"""Device-resident transport plane (the port of ``repro/transport/plane.py``).

Torch twin of the vectorized Monte-Carlo sampler in
``repro_torch.transport.des``: the per-flow loops (``_grid_handshake``'s SYN
ladder, ``_grid_idle``'s keepalive scan, ``_grid_transfer``'s AIMD/RTO
windows) run as lockstep loops over stacked ``[k]`` row tensors (cwnd,
acked segments, RTO backoff, clock, active mask) on one device. One FL
transport round for an ``S x C`` characterization grid is one call of
``device_sim_rows``. Each loop is a Python ``while`` on the reference's
condition, paying one host sync to read it; on CUDA the transfer loop runs
``_BLOCK`` iterations per CUDA graph replay and reads it once per block,
with the same outcome bit for bit (the step is inert on finished rows).

Every tensor is float32, as the reference's plane is (it runs with JAX's
64-bit mode off): ``_exp2i`` and ``_floor_log2`` are the f32 bit tricks.

The numpy plane stays the PARITY ORACLE:

- **Exact where no draw matters.** On degenerate rows (loss=0 and
  jitter=0) every delivery is certain and every RTT is exactly 2*delay, so
  host and device agree exactly on the delivered set, reconnects, byte
  accounting and every sparse event count, and on the clock to f32
  tolerance (the host oracle is float64).
- **Distributional elsewhere.** The streams differ (numpy's sequential
  draws against one torch generator per stage), so outcomes agree as
  statistics. The reference's three reformulations are kept: RTT jitter as
  one normal scaled by sqrt(2)*jitter, two-way survival as one uniform
  against (1-loss)^2, and window loss as an exact-tail binomial with the
  RTO escalation in closed form.

Streams: ``transport_plane_key(seed, stream, rnd)`` keys a round as
``repro_torch.core.server.derive_rng`` keys a host stream. Each stage of
each attempt (handshake, download, idle, reconnect, upload, and each
retry's jitter) draws from its OWN ``torch.Generator`` on the plane's
device, seeded from (key, attempt, stage), so how many iterations one loop
ran never moves another stage's draws, and the global generator is never
used. CPU generators (mt19937) and CUDA generators (Philox) give different
bits, so a stochastic row's outcome depends on the device; degenerate rows
do not.

**Delivery-event contract.** Both planes end in the same per-flow triple
``(success [k], time [k], reconnects [k])``, the whole transport interface
the async engine consumes (``des.delivery_events``), so async points ride
either backend with no transport path of their own.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.ops import segment_sum
from repro_torch.transport.des import (
    _TRACE_FIELDS,
    GridOutcome,
    _LinkArrays,
    _per_scenario_rows,
    _RetryArrays,
    _TcpArrays,
)
from repro_torch.transport.params import RetryPolicy, TcpParams
from repro_torch.utils.device import resolve_device

_MAX_ITERS = 200_000  # host loop's runaway cap, mirrored
_F32 = torch.float32
# spawn-key tag of the device key family (decorrelates it from the host
# streams that derive_rng draws from the same (seed, stream, round))
_PLANE_TAG = 0x706C616E
# stage tags of an attempt's generators
_HANDSHAKE, _DOWNLOAD, _IDLE, _RECONNECT, _UPLOAD, _JITTER = range(6)


def _f32(x, device) -> torch.Tensor:
    """float64 values rounded to float32 (to nearest), as the reference's
    ``jnp.asarray`` rounds them with 64-bit mode off."""
    return torch.from_numpy(np.asarray(x, np.float64).astype(np.float32)).to(device)


def _i32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int32)).to(device)


def _bool(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(bool)).to(device)


class TcpPlane(NamedTuple):
    """Per-row TcpParams as device tensors (the twin of _TcpArrays)."""

    syn_rto: torch.Tensor
    syn_retries: torch.Tensor
    handshake_budget: torch.Tensor
    ka_time: torch.Tensor
    ka_intvl: torch.Tensor
    ka_probes: torch.Tensor
    retries2: torch.Tensor
    rmem_max: torch.Tensor  # reorder-buffer cap: rmem * 48 (sysctl max)
    sack: torch.Tensor
    initial_rto: torch.Tensor
    max_rto: torch.Tensor
    mss: torch.Tensor
    wnd_max: torch.Tensor  # window_bytes // mss segments, >= 2
    zero_rtt: torch.Tensor  # bool — QUIC-style session-resumption profile

    @classmethod
    def from_arrays(cls, ta: _TcpArrays, device) -> "TcpPlane":
        return cls(
            syn_rto=_f32(ta.syn_rto, device),
            syn_retries=_i32(ta.syn_retries, device),
            handshake_budget=_f32(ta.handshake_budget, device),
            ka_time=_f32(ta.ka_time, device),
            ka_intvl=_f32(ta.ka_intvl, device),
            ka_probes=_i32(ta.ka_probes, device),
            retries2=_i32(ta.retries2, device),
            rmem_max=_f32(ta.rmem * 48, device),
            sack=_bool(ta.sack, device),
            initial_rto=_f32(ta.initial_rto, device),
            max_rto=_f32(ta.max_rto, device),
            mss=_f32(ta.mss, device),
            wnd_max=_f32(np.maximum(ta.window_bytes // ta.mss, 2), device),
            zero_rtt=_bool(ta.zero_rtt, device),
        )


class LinkPlane(NamedTuple):
    """Per-row LinkProfile as device tensors (the twin of _LinkArrays)."""

    loss: torch.Tensor
    surv2: torch.Tensor  # (1-loss)^2: both directions survive
    delay: torch.Tensor
    jitter2: torch.Tensor  # sqrt(2)*jitter: std of the summed two-way jitter
    rate_mbps: torch.Tensor
    queue_limit: torch.Tensor
    middlebox_timeout: torch.Tensor

    @classmethod
    def from_arrays(cls, la: _LinkArrays, device) -> "LinkPlane":
        return cls(
            loss=_f32(la.loss, device),
            surv2=_f32((1.0 - la.loss) ** 2, device),
            delay=_f32(la.delay, device),
            jitter2=_f32(np.sqrt(2.0) * la.jitter, device),
            rate_mbps=_f32(la.rate_mbps, device),
            queue_limit=_f32(la.queue_limit, device),
            middlebox_timeout=_f32(la.middlebox_timeout, device),
        )


class RetryPlane(NamedTuple):
    """Per-row RetryPolicy as device tensors (the twin of _RetryArrays)."""

    max_retries: torch.Tensor  # int32
    base: torch.Tensor
    factor: torch.Tensor
    max_backoff: torch.Tensor
    jitter: torch.Tensor
    deadline_cap: torch.Tensor
    resume: torch.Tensor  # bool — re-attempts continue from the acked frontier

    @classmethod
    def from_arrays(cls, ra: _RetryArrays, device) -> "RetryPlane":
        return cls(
            max_retries=_i32(ra.max_retries, device),
            base=_f32(ra.base, device),
            factor=_f32(ra.factor, device),
            max_backoff=_f32(ra.max_backoff, device),
            jitter=_f32(ra.jitter, device),
            deadline_cap=_f32(ra.deadline_cap, device),
            resume=_bool(ra.resume, device),
        )


def _pad_attempts(a: int) -> int:
    """Pad the SYN-ladder width to a power-of-two bucket (min 4), as the
    reference does: ``_plane_handshake``'s ``allowed`` mask makes the padded
    attempts inert (a > syn_retries can never deliver), so padding changes
    only how many unused draws each row discards."""
    b = 4
    while b < a:
        b *= 2
    return b


def transport_plane_key(seed: int, stream: int, rnd: int) -> int:
    """The device plane's key per (seed, stream tag, round): the analog of
    ``repro_torch.core.server.derive_rng`` for the device plane."""
    ss = np.random.SeedSequence(entropy=seed, spawn_key=(stream, rnd, _PLANE_TAG))
    return int(ss.generate_state(1, np.uint64)[0])


def _stage_generator(key: int, attempt: int, stage: int, device) -> torch.Generator:
    """The generator of one stage of one attempt on ``device``."""
    ss = np.random.SeedSequence(entropy=key, spawn_key=(attempt, stage))
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    return g


def _uniform(shape, g: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device, dtype=_F32)


def _rtt(lp: LinkPlane, g: torch.Generator, attempts: int = 0) -> torch.Tensor:
    """RTT sample: 2*delay + N(0, sqrt(2)*jitter), floored like the host;
    ``[k, attempts]`` when ``attempts`` is given, else ``[k]``."""
    if attempts:
        z = torch.randn(lp.delay.shape + (attempts,), generator=g, device=g.device, dtype=_F32)
        z = z * lp.jitter2[:, None] + 2.0 * lp.delay[:, None]
    else:
        z = torch.randn(lp.delay.shape, generator=g, device=g.device, dtype=_F32)
        z = z * lp.jitter2 + 2.0 * lp.delay
    return z.clamp_min(1e-5)


def _exp2i(v: torch.Tensor) -> torch.Tensor:
    """2**v for small non-negative integer-valued f32, via exponent-bit
    construction (the RTO ladder's power-of-two steps)."""
    return ((v.clamp(0.0, 120.0).to(torch.int32) + 127) << 23).view(_F32)


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for f32 x >= 1, via exponent-bit extraction."""
    return ((x.view(torch.int32) >> 23) - 127).to(x.dtype)


def _normal_pair(u1: torch.Tensor, u2: torch.Tensor):
    """Box–Muller: two independent standard normals from two uniforms."""
    r = torch.sqrt(-2.0 * torch.log(u1.clamp_min(1e-12)))
    theta = (2.0 * math.pi) * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _binomial_exact_tails(u, z, n, p):
    """lost ~ Bin(n, p) with EXACT boundary masses and a clipped-normal
    interior, driven by a caller-supplied uniform ``u`` and standard normal
    ``z``: P(lost=0) = (1-p)^n and P(lost=n) = p^n exactly (the clean-window
    and whole-window-stall branches the mechanics take), the interior as
    round(N(np, np(1-p))) clipped to [1, n-1]. n is float and may be 0
    (masked rows; returns 0)."""
    logp = torch.log(p.clamp(1e-30, 1.0))
    log_q = torch.log1p(-p.clamp(0.0, 1.0 - 1e-7))
    p_zero = torch.exp(n * log_q)
    p_all = torch.exp(n * logp)
    std = torch.sqrt((n * p * (1.0 - p)).clamp_min(1e-12))
    interior = torch.minimum(
        torch.round(n * p + z * std).clamp_min(1.0), (n - 1.0).clamp_min(1.0)
    )
    lost = torch.where(u < p_zero, 0.0, torch.where(u >= 1.0 - p_all, n, interior))
    return torch.where(n <= 0, 0.0, lost)


def _rto_backoff(tp: TcpPlane, lp: LinkPlane, u, stalled, rto):
    """The host's draw-by-draw RTO escalation in closed form: the run of
    consecutive retransmission losses is a truncated geometric, sampled by
    inversion (G = floor(log u / log p)), and the summed stall is
    sum_{j=1..D} min(rto * 2^j, max_rto). ``u`` is a caller-supplied
    uniform. Returns (dead, stall_time, rto_out)."""
    logp = torch.log(lp.loss.clamp(1e-12, 1.0 - 1e-12))
    g = torch.floor(torch.log(u.clamp_min(1e-38)) / logp)
    dmax = (tp.retries2 - 1).to(rto.dtype)
    dead = stalled & (g >= dmax)
    d = torch.minimum(g, dmax)
    # number of doublings before the timer saturates at max_rto
    l_cap = _floor_log2((tp.max_rto / rto).clamp_min(1.0))
    m = torch.minimum(l_cap.clamp_min(0.0), d)
    stall = rto * (_exp2i(m + 1.0) - 2.0) + (d - m) * tp.max_rto
    rto_out = torch.minimum(rto * _exp2i(d), tp.max_rto)
    return dead, torch.where(stalled, stall, 0.0), torch.where(stalled, rto_out, rto)


def _plane_handshake(tp: TcpPlane, lp: LinkPlane, g: torch.Generator, attempts: int):
    """SYN ladder, all attempts drawn at once ([k, A], the RTT normals then
    the survival uniforms). Returns (success, time, syn_attempts) for every
    row; callers mask by need. ``zero_rtt`` rows keep the same ladder draws
    but are never killed by the handshake budget."""
    a = torch.arange(attempts, dtype=_F32, device=tp.syn_rto.device)[None, :]
    t_send = a * tp.syn_rto[:, None]
    rtt = _rtt(lp, g, attempts)
    delivered = _uniform(rtt.shape, g) < lp.surv2[:, None]
    budget = tp.handshake_budget[:, None]
    no_budget = tp.zero_rtt[:, None]
    allowed = (a <= tp.syn_retries[:, None].to(_F32)) & (no_budget | (t_send <= budget))
    ok = delivered & allowed & (no_budget | (t_send + rtt <= budget))
    success = ok.any(dim=1)
    first = torch.argmax(ok.to(torch.uint8), dim=1)  # the first True
    t_first = torch.take_along_dim(t_send + rtt, first[:, None], dim=1)[:, 0]
    time = torch.where(success, t_first, tp.handshake_budget)
    syn_attempts = torch.where(success, first + 1, allowed.sum(dim=1)).to(torch.int32)
    return success, time, syn_attempts


def _plane_idle(tp: TcpPlane, lp: LinkPlane, idle_time, g: torch.Generator, need, stats):
    """Keepalive/middlebox scan as a lockstep loop, one ``[k]`` RTT normal
    and one ``[k]`` uniform per probe. Returns (state [k] int32: 0 alive /
    1 detected_dead / 2 silent_dead, probes, probe_fails); rows outside
    ``need`` stay 0/alive. The body only advances ``t`` (not an output) on
    rows that have finished."""
    zero_i = torch.zeros_like(tp.ka_probes)
    mbox = lp.middlebox_timeout
    no_probe = tp.ka_time >= idle_time
    state = torch.where(need & no_probe & (idle_time > mbox), 2, 0).to(torch.int32)
    undecided = need & ~no_probe
    t = tp.ka_time
    last_refresh = torch.zeros_like(tp.ka_time)
    consecutive, probes, probe_fails = zero_i, zero_i, zero_i
    while True:
        active = undecided & (t <= idle_time)
        stats["syncs"] += 1
        if not bool(active.any()):
            break
        stats["idle_iters"] += 1
        rtt = _rtt(lp, g)
        ok = (_uniform(rtt.shape, g) < lp.surv2) & (rtt <= tp.ka_intvl)
        gap = active & (t - last_refresh > mbox)
        state = torch.where(gap, 2, state)
        undecided = undecided & ~gap
        active = active & ~gap
        refreshed = active & ok
        failed = active & ~ok
        consecutive = torch.where(
            failed, consecutive + 1, torch.where(refreshed, 0, consecutive)
        )
        dead = failed & (consecutive >= tp.ka_probes)
        last_refresh = torch.where(refreshed, t, last_refresh)
        t = t + tp.ka_intvl
        state = torch.where(dead, 1, state)
        undecided = undecided & ~dead
        probes = probes + active
        probe_fails = probe_fails + failed
    tail = undecided & (idle_time - last_refresh > mbox)
    return torch.where(tail, 2, state), probes, probe_fails


class _TransferConsts(NamedTuple):
    """The transfer loop's per-row invariants."""

    segs_total: torch.Tensor
    two_delay: torch.Tensor
    has_rate: torch.Tensor
    rate_bytes: torch.Tensor  # rate_mbps * 1e6 / 8
    half_wnd: torch.Tensor


_TRANSFER_STATE = ("t", "cwnd", "acked", "pending", "rto", "reorder", "active", "success",
                   "rto_stalls", "retrans")


def _transfer_step(tp: TcpPlane, lp: LinkPlane, c: _TransferConsts, s: dict, u) -> dict:
    """One window of the transfer loop for every row, driven by the
    iteration's ``[4, k]`` uniforms ``u``: state dict in, state dict out.
    Inert on rows that are no longer active."""
    active, rto = s["active"], s["rto"]
    z_rtt, z_bin = _normal_pair(u[0], u[1])
    rtt = (z_rtt * lp.jitter2 + c.two_delay).clamp_min(1e-5)
    rate_cap = torch.where(
        c.has_rate, torch.floor(c.rate_bytes * rtt / tp.mss).clamp_min(1.0), 1e18
    )
    w = torch.minimum(
        torch.minimum(torch.floor(s["cwnd"]), tp.wnd_max),
        torch.minimum(lp.queue_limit, rate_cap),
    )
    remaining = (c.segs_total - s["acked"] + s["pending"]).clamp_min(0.0)
    w = torch.where(active, torch.minimum(w.clamp_min(1.0), remaining), 0.0)
    lost = _binomial_exact_tails(u[2], z_bin, w, lp.loss)
    delivered = w - lost
    t = torch.where(active, s["t"] + rtt, s["t"])

    # --- whole-window loss -> RTO backoff, collapsed to closed form ---
    stalled = active & (delivered == 0)
    t = t + torch.where(stalled, rto, 0.0)
    dead, stall_t, rto = _rto_backoff(tp, lp, u[3], stalled, rto)
    t = t + stall_t
    active = active & ~dead
    surv = stalled & active
    cwnd = torch.where(surv, 10.0, s["cwnd"])
    rto = torch.where(surv, torch.minimum(rto * 2.0, tp.max_rto), rto)

    # --- progress: ack, SACK holes, cwnd evolution ---
    prog = active & (delivered > 0)
    rto = torch.where(prog, tp.initial_rto, rto)
    holed = prog & (lost > 0) & tp.sack
    holed_count = holed  # counted before the buffer-death filter, like the host
    reorder = torch.where(holed, s["reorder"] + delivered * tp.mss, s["reorder"])
    buf_dead = holed & (reorder > tp.rmem_max)
    active = active & ~buf_dead
    holed = holed & ~buf_dead
    cwnd = torch.where(holed, (cwnd / 2.0).clamp_min(2.0), cwnd)
    pending = torch.where(holed, lost, s["pending"])
    clean = prog & ~holed & active
    reorder = torch.where(clean, 0.0, reorder)
    pending = torch.where(clean, 0.0, pending)
    cwnd = torch.where(clean, torch.where(cwnd >= c.half_wnd, cwnd + 1.0, cwnd * 2.0), cwnd)
    acked = torch.where(prog & active, s["acked"] + delivered, s["acked"])
    done = active & (acked >= c.segs_total)
    return {
        "t": t, "cwnd": cwnd, "acked": acked, "pending": pending, "rto": rto,
        "reorder": reorder, "active": active & ~done, "success": s["success"] | done,
        "rto_stalls": s["rto_stalls"] + stalled, "retrans": s["retrans"] + holed_count,
    }


def _transfer_iters(tp, lp, c, s, g: torch.Generator, stats) -> dict:
    """The transfer loop as the reference writes it: while any row is
    active (one host sync to read it), one ``[4, k]`` draw and one step."""
    iters = 0
    while iters < _MAX_ITERS:
        stats["syncs"] += 1
        if not bool(s["active"].any()):
            break
        s = _transfer_step(tp, lp, c, s, _uniform((4,) + lp.loss.shape, g))
        iters += 1
    stats["transfer_iters"] += iters
    return s


# transfer iterations per CUDA graph replay (a divisor of _MAX_ITERS)
_BLOCK = 8


def _transfer_blocks(tp, lp, c, s, g: torch.Generator, stats) -> dict:
    """The transfer loop on CUDA: ``_BLOCK`` steps captured once as a CUDA
    graph, replayed until no row is active, with one host sync per replay
    instead of one per iteration. Before each replay the block's ``[4, k]``
    draws are made by the same calls, in the same order, as
    ``_transfer_iters`` makes them (into the graph's static buffer), and the
    step is inert on rows that have finished, so the outcome is
    ``_transfer_iters``'s bit for bit; a loop ends up to ``_BLOCK - 1``
    inert iterations late."""
    stats["syncs"] += 1
    if not bool(s["active"].any()):
        return s
    dev = lp.loss.device
    u = torch.full((_BLOCK, 4) + lp.loss.shape, 0.5, dtype=_F32, device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    s = {name: x.clone() for name, x in s.items()}  # the graph's static state
    # load every kernel of the step before the capture (on copies, no draws)
    _transfer_step(tp, lp, c, {name: x.clone() for name, x in s.items()}, u[0])
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        graph.capture_begin()
        out = s
        for i in range(_BLOCK):
            out = _transfer_step(tp, lp, c, out, u[i])
        for name in _TRANSFER_STATE:
            s[name].copy_(out[name])
        flag.copy_(s["active"].any())
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    iters = 0
    while iters < _MAX_ITERS:
        for i in range(_BLOCK):
            u[i].uniform_(generator=g)
        graph.replay()
        iters += _BLOCK
        stats["syncs"] += 1
        if not bool(flag):
            break
    stats["transfer_iters"] += iters
    return s


def _plane_transfer(tp: TcpPlane, lp: LinkPlane, nbytes, g: torch.Generator, need, stats):
    """AIMD window-by-window transfer as one lockstep loop (the twin of
    ``_grid_transfer``), one ``[4, k]`` uniform per iteration: a Box–Muller
    pair (RTT jitter and the binomial interior) and two plain uniforms (the
    binomial tail selector and the RTO-backoff geometric). Returns
    (success, time, rto_stalls, retrans_windows, acked_bytes); rows outside
    ``need`` return zeros. ``acked_bytes`` is the cumulatively-acked
    frontier: ``nbytes`` on success, the surviving in-order bytes on
    failure. On CUDA the loop runs as CUDA graph blocks
    (``_transfer_blocks``), elsewhere one iteration at a time."""
    c = _TransferConsts(
        segs_total=torch.ceil(nbytes.clamp_min(1.0) / tp.mss).clamp_min(1.0),
        two_delay=2.0 * lp.delay,
        has_rate=lp.rate_mbps > 0,
        rate_bytes=lp.rate_mbps * 1e6 / 8.0,
        half_wnd=tp.wnd_max / 2.0,
    )
    zero = torch.zeros_like(tp.initial_rto)
    s = {"t": zero, "cwnd": torch.full_like(zero, 10.0), "acked": zero, "pending": zero,
         "rto": tp.initial_rto, "reorder": zero, "active": need,
         "success": torch.zeros_like(need), "rto_stalls": torch.zeros_like(tp.retries2),
         "retrans": torch.zeros_like(tp.retries2)}
    run = _transfer_blocks if nbytes.is_cuda else _transfer_iters
    s = run(tp, lp, c, s, g, stats)
    acked_bytes = torch.where(s["success"], nbytes, torch.minimum(s["acked"] * tp.mss, nbytes))
    acked_bytes = torch.where(need, acked_bytes, 0.0)
    return s["success"], s["t"], s["rto_stalls"], s["retrans"], acked_bytes


def _device_attempt(
    tp: TcpPlane, lp: LinkPlane, up, down, ltt, connected, key, attempt, attempts,
    participate, ticket, progress, stats,
):
    """One round ATTEMPT for a [k] row plane: handshake-if-needed ->
    download -> idle (keepalive/middlebox) -> reconnect-if-dead -> upload.
    Rows outside ``participate`` stay inert (the stage ``need`` masks keep
    them out of every loop's active set).

    Reliability registers: ``ticket`` — rows holding a session ticket; a
    ``zero_rtt`` row with a ticket (re-)connects for free (reconnect
    counted, no ladder time). ``progress`` — the acked-byte frontier of a
    prior resumed attempt (0.0 restarts from zero): a frontier into the
    download shortens it, one past the download skips the local-train
    window. Returns (alive, t, reconnects, bytes_acked, counts, ticket)."""
    dev = tp.syn_rto.device
    gen = lambda stage: _stage_generator(key, attempt, stage, dev)  # noqa: E731
    zero_i = torch.zeros_like(tp.retries2)
    t = torch.zeros_like(tp.initial_rto)
    counts = {name: zero_i for name in _TRACE_FIELDS}
    p0 = progress
    fresh = p0 == 0.0

    # a ticketed zero_rtt row resumes its session for free; the handshake
    # below still draws its ladder for every row
    free = participate & ~connected & tp.zero_rtt & ticket
    need = participate & ~connected & ~free
    ok, ht, att = _plane_handshake(tp, lp, gen(_HANDSHAKE), attempts)
    t = t + torch.where(need, ht, 0.0)
    reconnects = (need | free).to(torch.int32)
    alive = participate & (ok | ~need)
    counts["syn_attempts"] = torch.where(need, att, 0)
    ticket = ticket | alive  # first contact made -> round holds a ticket

    d0 = torch.minimum(p0, down)
    down_rem = down - d0
    need_dl = alive & (fresh | (down_rem > 0.0))
    ok, dt, stalls, rwnd, ba = _plane_transfer(tp, lp, down_rem, gen(_DOWNLOAD), need_dl, stats)
    t = t + dt
    counts["rto_stalls"] = counts["rto_stalls"] + stalls
    counts["retrans_windows"] = counts["retrans_windows"] + rwnd
    alive = alive & (ok | ~need_dl)
    frontier = torch.where(need_dl, d0 + ba, p0)

    # frontier past the download => the prior attempt already trained;
    # this attempt is handshake + upload tail only
    pay_train = alive & (fresh | (p0 < down))
    state, probes, pfails = _plane_idle(tp, lp, ltt, gen(_IDLE), pay_train, stats)
    t = t + torch.where(pay_train, ltt, 0.0)
    counts["keepalive_probes"] = probes
    counts["keepalive_failures"] = pfails
    silent = alive & (state == 2)
    counts["mbox_drops"] = silent.to(torch.int32)
    counts["detected_dead"] = (alive & (state == 1)).to(torch.int32)
    # silent drops are discovered on send: deterministic escalating stall
    stall = sum(torch.minimum(tp.initial_rto * (2.0**i), tp.max_rto) for i in range(6))
    t = t + torch.where(silent, stall.clamp_max(60.0), 0.0)
    dead_conn = alive & (state != 0)
    free_re = dead_conn & tp.zero_rtt  # 0-RTT resumption off the ticket
    need_hs = dead_conn & ~tp.zero_rtt
    ok, ht, att = _plane_handshake(tp, lp, gen(_RECONNECT), attempts)
    t = t + torch.where(need_hs, ht, 0.0)
    reconnects = reconnects + need_hs + free_re
    alive = alive & (ok | ~need_hs)
    counts["syn_attempts"] = counts["syn_attempts"] + torch.where(need_hs, att, 0)

    u0 = (p0 - down).clamp_min(0.0)
    up_rem = up - u0
    need_ul = alive & (fresh | (up_rem > 0.0))
    ok, ut, stalls, rwnd, ba = _plane_transfer(tp, lp, up_rem, gen(_UPLOAD), need_ul, stats)
    t = t + ut
    counts["rto_stalls"] = counts["rto_stalls"] + stalls
    counts["retrans_windows"] = counts["retrans_windows"] + rwnd
    alive = alive & (ok | ~need_ul)
    frontier = torch.where(need_ul, down + u0 + ba, frontier)

    bytes_acked = torch.where(alive, up + down, frontier)
    return alive, t, reconnects, bytes_acked, counts, ticket


def _device_round(
    tp: TcpPlane, lp: LinkPlane, rp: RetryPlane, up, down, ltt, connected, key,
    attempts, n_retries, stats,
):
    """One full FL transport round for a [k] row plane, the twin of
    ``des._sim_rows`` with its retry ladder. The first attempt covers every
    row; each of the ``n_retries`` re-attempts re-runs the pipeline masked
    to the rows still failed under their per-row policy (budget not
    exhausted, clock under ``deadline_cap``). The backoff wait is the policy
    ladder scaled by a masked uniform jitter draw (jitter=0 rows multiply by
    exactly 1). ``ticket`` survives across attempts, and ``rp.resume`` rows
    feed the failed attempt's acked frontier back in as the next attempt's
    ``progress``."""
    alive, t, reconnects, bytes_acked, counts, ticket = _device_attempt(
        tp, lp, up, down, ltt, connected, key, 0, attempts,
        torch.ones_like(connected), torch.zeros_like(connected), torch.zeros_like(up), stats,
    )
    for a in range(1, n_retries + 1):
        failed = ~alive & (a <= rp.max_retries) & (t < rp.deadline_cap)
        wait = torch.minimum(rp.base * rp.factor ** (a - 1.0), rp.max_backoff)
        u = _uniform(wait.shape, _stage_generator(key, a, _JITTER, wait.device))
        wait = wait * (1.0 + rp.jitter * u)
        prog = torch.where(failed & rp.resume, bytes_acked, 0.0)
        a2, t2, rc2, ba2, c2, tk2 = _device_attempt(
            tp, lp, up, down, ltt, torch.zeros_like(connected), key, a, attempts,
            failed, ticket, prog, stats,
        )
        t = torch.where(failed, t + wait + t2, t)
        reconnects = reconnects + torch.where(failed, rc2, 0)
        bytes_acked = torch.where(failed, ba2, bytes_acked)
        alive = torch.where(failed, a2, alive)
        ticket = tk2
        counts = {f: counts[f] + torch.where(failed, c2[f], 0) for f in _TRACE_FIELDS}
    return alive, t, reconnects, bytes_acked, counts


def new_plane_stats() -> dict:
    """Loop telemetry of the plane's calls: transfer and keepalive loop
    iterations, and host syncs (one per loop-condition read)."""
    return {"transfer_iters": 0, "idle_iters": 0, "syncs": 0}


def device_sim_rows(
    ta: _TcpArrays,
    la: _LinkArrays,
    *,
    up_bytes,
    down_bytes,
    local_train_times,
    connected,
    key: int,
    retry=None,
    device=None,
    stats=None,
):
    """One FL round for a flat row plane on ``device`` (CUDA unless given;
    raises without CUDA and without a device). Returns device tensors
    (success, time, reconnects, bytes_acked, counts). The SYN-ladder width
    is padded to a power-of-two bucket (``_pad_attempts``). ``retry`` is
    None, one RetryPolicy for all rows, or a per-row ``_RetryArrays``; the
    ladder runs max(max_retries) re-attempts. ``stats`` (from
    ``new_plane_stats``) accumulates loop iterations and host syncs."""
    device = resolve_device(device)
    stats = new_plane_stats() if stats is None else stats
    tp = TcpPlane.from_arrays(ta, device)
    lp = LinkPlane.from_arrays(la, device)
    attempts = int(ta.syn_retries.max()) + 1 if ta.syn_retries.size else 1
    attempts = _pad_attempts(attempts)
    k = la.loss.shape[0]
    ra = retry if retry is None or isinstance(retry, _RetryArrays) else _RetryArrays.broadcast(retry, k)
    if ra is None:
        ra = _RetryArrays.broadcast(None, k)
    n_retries = int(ra.max_retries.max()) if k else 0
    rp = RetryPlane.from_arrays(ra, device)
    up = _f32(np.broadcast_to(np.asarray(up_bytes, np.float64), (k,)), device)
    down = _f32(np.broadcast_to(np.asarray(down_bytes, np.float64), (k,)), device)
    ltt = _f32(local_train_times, device)
    conn = _bool(connected, device)
    return _device_round(tp, lp, rp, up, down, ltt, conn, key, attempts, n_retries, stats)


def sim_grid_round_device(
    tcps,
    links,
    *,
    update_bytes,
    local_train_times,
    connected,
    key: int,
    download_bytes=None,
    trace: bool = False,
    retry=None,
    device=None,
    stats=None,
) -> GridOutcome:
    """Device twin of ``des.sim_grid_round``'s fused mode: the whole S x C
    grid round sampled on one key (see ``transport_plane_key``) on
    ``device``. Arguments follow ``sim_grid_round`` (scalar / length-S /
    [S, C] payload bytes, ragged ``links`` supported). Outputs are a
    ``GridOutcome`` of DEVICE tensors (``mask`` stays numpy) — callers that
    bookkeep on the host should copy each field once — plus
    ``scenario_bytes``: per-scenario delivered wire bytes, reduced on the
    device by ``segment_sum``. ``retry`` is None, one RetryPolicy for every
    scenario, or a length-S sequence of per-scenario
    ``Optional[RetryPolicy]``."""
    device = resolve_device(device)
    S = len(links)
    tcp_list = [tcps] * S if isinstance(tcps, TcpParams) else list(tcps)
    retry_list = [retry] * S if retry is None or isinstance(retry, RetryPolicy) else list(retry)
    sizes = [len(row) for row in links]
    ragged = S > 0 and any(c != sizes[0] for c in sizes)

    if ragged:
        up_s = _per_scenario_rows(update_bytes, sizes, np.int64)
        down_s = (
            up_s if download_bytes is None else _per_scenario_rows(download_bytes, sizes, np.int64)
        )
        scen = np.repeat(np.arange(S), sizes)
        up, down = np.concatenate(up_s), np.concatenate(down_s)
        ltt = np.concatenate(_per_scenario_rows(local_train_times, sizes, float))
        conn = np.concatenate(_per_scenario_rows(connected, sizes, bool))
    else:
        C = sizes[0] if S else 0

        def _bytes_grid(b):
            b = np.asarray(b, np.int64)
            if b.ndim == 2:
                return b.reshape(S, C)
            return np.broadcast_to(b.reshape(-1, 1) if b.ndim == 1 else b, (S, C))

        up = _bytes_grid(update_bytes).reshape(-1)
        down = up if download_bytes is None else _bytes_grid(download_bytes).reshape(-1)
        ltt = np.asarray(local_train_times, float).reshape(-1)
        conn = np.asarray(connected, bool).reshape(-1)
        scen = np.repeat(np.arange(S), C)
    ta = _TcpArrays.from_params(tcp_list).take(scen)
    la = _LinkArrays.from_links([lk for row in links for lk in row])

    alive, t, reconnects, bytes_acked, counts = device_sim_rows(
        ta,
        la,
        up_bytes=up,
        down_bytes=down,
        local_train_times=ltt,
        connected=conn,
        key=key,
        retry=(
            _RetryArrays.from_policies(retry_list).take(scen)
            if any(p is not None for p in retry_list)
            else None
        ),
        device=device,
        stats=stats,
    )
    scen_t = torch.as_tensor(scen, device=device)
    scenario_bytes = segment_sum(bytes_acked, scen_t, num_segments=S)

    if not ragged:
        shape = (S, sizes[0] if S else 0)
        return GridOutcome(
            alive.reshape(shape),
            t.reshape(shape),
            reconnects.reshape(shape),
            bytes_acked.reshape(shape),
            {f: counts[f].reshape(shape) for f in _TRACE_FIELDS} if trace else None,
            scenario_bytes=scenario_bytes,
        )

    C = max(sizes)
    mask = np.zeros((S, C), bool)
    for s, c in enumerate(sizes):
        mask[s, :c] = True
    cols_t = torch.as_tensor(np.concatenate([np.arange(c) for c in sizes]), device=device)

    def scatter(flat):
        out = torch.zeros((S, C), dtype=flat.dtype, device=device)
        return out.index_put_((scen_t, cols_t), flat)

    return GridOutcome(
        scatter(alive),
        scatter(t),
        scatter(reconnects),
        scatter(bytes_acked),
        {f: scatter(counts[f]) for f in _TRACE_FIELDS} if trace else None,
        mask=mask,
        scenario_bytes=scenario_bytes,
    )
