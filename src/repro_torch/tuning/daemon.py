"""Adaptive TCP tuning daemon (the paper's §VI future work, built): a
numpy copy of ``repro/tuning/daemon.py``.

"We propose the design of an adaptive connection management daemon that
would monitor comprehensive connection state metrics to dynamically
optimize TCP parameters based on real-time network conditions."

The daemon keeps EWMA estimates of RTT, loss, and idle-phase survival from
per-round connection telemetry (the event traces the DES/round engine
produce), and re-derives the three validated knobs each round:

- ``tcp_syn_retries``: sized so the handshake budget covers k_margin x the
  observed RTT (the Fig-3 cliff is exactly handshake_budget < RTT).
- ``tcp_keepalive_time``: sized to probe *during* local-training idle and
  refresh middleboxes: min(idle_estimate/2, observed middlebox bound).
- ``tcp_keepalive_intvl``: sized so a probe's ACK fits inside the interval
  (RTT-aware) while keeping detection latency low under loss.

This is the beyond-paper feature: ``repro_torch.experiments.adaptive_daemon``
shows it matching or beating the best static configuration across shifting
links.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import math

from repro_torch.transport import TcpParams
from repro_torch.transport.des import Event


@dataclass
class ConnectionStats:
    """EWMA telemetry over observed connection behaviour."""

    rtt: float = 0.005
    loss: float = 0.0
    idle_time: float = 60.0
    silent_drops: float = 0.0  # EWMA of silent-death indicator
    alpha: float = 0.3

    def observe_rtt(self, rtt: float):
        self.rtt = (1 - self.alpha) * self.rtt + self.alpha * max(rtt, 1e-5)

    def observe_loss(self, loss: float):
        self.loss = (1 - self.alpha) * self.loss + self.alpha * min(max(loss, 0.0), 1.0)

    def observe_idle(self, idle: float, silently_dropped: bool):
        self.idle_time = (1 - self.alpha) * self.idle_time + self.alpha * idle
        self.silent_drops = (1 - self.alpha) * self.silent_drops + self.alpha * (
            1.0 if silently_dropped else 0.0
        )

    def observe_events(self, events: List[Event], link_rtt_hint: Optional[float] = None):
        """Digest a DES event trace (SYN retries ~ loss; MBOX_DROP ~ silent)."""
        syn_attempts = sum(1 for e in events if e.kind == "SYN")
        if syn_attempts > 1:
            # each extra SYN ~ one lost round trip
            self.observe_loss(1.0 - 1.0 / syn_attempts)
        est = next((e.t for e in events if e.kind == "ESTABLISHED"), None)
        if est is not None and syn_attempts >= 1:
            # time from last SYN to ESTABLISHED approximates RTT
            last_syn = max(e.t for e in events if e.kind == "SYN")
            self.observe_rtt(max(est - last_syn, 1e-5))
        if any(e.kind == "MBOX_DROP" for e in events):
            self.observe_idle(self.idle_time, True)
        if link_rtt_hint is not None:
            self.observe_rtt(link_rtt_hint)


@dataclass
class AdaptiveTuner:
    base: TcpParams = field(default_factory=TcpParams)
    stats: ConnectionStats = field(default_factory=ConnectionStats)
    rtt_margin: float = 2.5  # handshake budget >= margin x RTT
    min_keepalive: float = 15.0
    middlebox_guess: float = 600.0

    def current_params(self) -> TcpParams:
        s = self.stats
        # 1) syn_retries from the RTT cliff
        budget_needed = max(self.rtt_margin * s.rtt, 3 * self.base.syn_rto)
        # extra headroom under loss: expected attempts 1/(1-p)^2
        if s.loss > 0:
            budget_needed *= 1.0 / max((1.0 - s.loss) ** 2, 0.1)
        retries = max(int(math.ceil(budget_needed / self.base.syn_rto)) - 1, 2)
        retries = min(retries, 64)

        # 2) keepalive_time: probe well inside both the idle phase and the
        # middlebox window (silent drops observed => be more aggressive)
        mbox = self.middlebox_guess
        ka_time = min(s.idle_time / 2.0, mbox / 2.0)
        if s.silent_drops > 0.25:
            ka_time = min(ka_time, mbox / 4.0)
        ka_time = max(ka_time, self.min_keepalive)

        # 3) keepalive_intvl: ACK must fit in the interval, detection stays fast
        intvl = max(2.0 * s.rtt, 5.0)
        intvl = min(intvl, ka_time)

        return self.base.replace(
            tcp_syn_retries=retries,
            tcp_keepalive_time=float(ka_time),
            tcp_keepalive_intvl=float(intvl),
        )

    def observe_round(
        self,
        *,
        rtt: Optional[float] = None,
        loss: Optional[float] = None,
        idle_time: Optional[float] = None,
        silently_dropped: bool = False,
        events: Optional[List[Event]] = None,
    ) -> TcpParams:
        """Feed telemetry from one round; returns the re-tuned params."""
        if rtt is not None:
            self.stats.observe_rtt(rtt)
        if loss is not None:
            self.stats.observe_loss(loss)
        if idle_time is not None:
            self.stats.observe_idle(idle_time, silently_dropped)
        if events:
            self.stats.observe_events(events)
        return self.current_params()
