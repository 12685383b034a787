"""Chaos-engineering fault injection (NetEm + Chaos-Mesh, as a library).

The paper's testbed injects network impairments with Linux NetEm at the
server interface and kills client pods with Chaos-Mesh. Here the same
experiments are deterministic, seeded schedules applied to the transport
simulator and the FL round engine:

- ``netem(...)``       — latency/jitter/loss/rate override for a time span
- ``partition(...)``   — total packet loss for a span (network partition)
- ``internet_shutdown``— all clients partitioned (the paper's §II scenario)
- ``client_failure_schedule`` — kill a sampled fraction of clients per span
  (Chaos-Mesh pod-kill equivalent; deterministic per seed)
- ``server_restart(t)``— the SERVER process dies at t: the round in flight
  is lost (state reverts to the round boundary, the in-memory equivalent
  of resuming from a ``checkpoint_dir`` checkpoint), every client
  connection drops, and training resumes after ``downtime`` seconds

``ChaosSchedule.link_at(t, client)`` resolves the effective LinkProfile and
``alive(t, client)`` resolves pod liveness at simulated time t.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.transport.link import LinkProfile


@dataclass(frozen=True)
class ChaosEvent:
    t_start: float
    t_end: float  # inf = until the end of the experiment
    kind: str  # "netem" | "partition" | "pod_kill" | "server_restart"
    clients: Optional[Tuple[int, ...]] = None  # None = all clients
    link_override: Optional[Dict] = None  # fields to replace on the base link
    downtime: float = 0.0  # server_restart only: seconds the server is down

    def active(self, t: float) -> bool:
        return self.t_start <= t < self.t_end

    def targets(self, client: int) -> bool:
        return self.clients is None or client in self.clients


def netem(
    t_start: float,
    t_end: float,
    *,
    clients: Optional[Sequence[int]] = None,
    delay: Optional[float] = None,
    jitter: Optional[float] = None,
    loss: Optional[float] = None,
    rate_mbps: Optional[float] = None,
    queue_limit: Optional[int] = None,
) -> ChaosEvent:
    override = {
        k: v
        for k, v in dict(
            delay=delay, jitter=jitter, loss=loss, rate_mbps=rate_mbps,
            queue_limit=queue_limit,
        ).items()
        if v is not None
    }
    return ChaosEvent(
        t_start, t_end, "netem",
        tuple(clients) if clients is not None else None, override,
    )


def partition(t_start: float, t_end: float, clients: Optional[Sequence[int]] = None) -> ChaosEvent:
    return ChaosEvent(
        t_start, t_end, "partition",
        tuple(clients) if clients is not None else None, {"loss": 1.0},
    )


def internet_shutdown(t_start: float, t_end: float) -> ChaosEvent:
    """State-wide shutdown: every client partitioned (paper §II, [12])."""
    return partition(t_start, t_end, clients=None)


def client_failure_schedule(
    n_clients: int,
    failure_rate: float,
    *,
    t_start: float = 0.0,
    t_end: float = float("inf"),
    seed: int = 0,
) -> ChaosEvent:
    """Chaos-Mesh pod-kill: a seeded sample of round(n*rate) clients dies."""
    rng = np.random.default_rng(seed)
    n_kill = int(round(n_clients * failure_rate))
    victims = tuple(sorted(rng.choice(n_clients, size=n_kill, replace=False).tolist()))
    return ChaosEvent(t_start, t_end, "pod_kill", victims, None)


def server_restart(t: float, *, downtime: float = 0.0) -> ChaosEvent:
    """Simulated server crash at time t (strictly after the run starts).

    The FL engine treats a crash inside a round's span as losing that
    round: in-flight contributions are discarded, global state stays at
    the round boundary (exactly what a ``run_fl_grid(checkpoint_dir=...)``
    resume would restore), all clients disconnect, and the clock jumps to
    ``t + downtime``. ``link_at``/``alive`` ignore this kind — it is a
    server-side fault, not a link impairment."""
    return ChaosEvent(t, t, "server_restart", None, None, downtime)


@dataclass
class ChaosSchedule:
    base_link: LinkProfile
    events: List[ChaosEvent] = field(default_factory=list)

    def add(self, *events: ChaosEvent) -> "ChaosSchedule":
        self.events.extend(events)
        return self

    def link_at(self, t: float, client: int) -> LinkProfile:
        link = self.base_link
        for ev in self.events:
            if ev.kind in ("netem", "partition") and ev.active(t) and ev.targets(client):
                link = link.replace(**ev.link_override)
        return link

    def alive(self, t: float, client: int) -> bool:
        for ev in self.events:
            if ev.kind == "pod_kill" and ev.active(t) and ev.targets(client):
                return False
            if ev.kind == "partition" and ev.active(t) and ev.targets(client):
                # a fully partitioned client is effectively unavailable
                if ev.link_override and ev.link_override.get("loss", 0) >= 1.0:
                    return False
        return True

    def liveness_events(self) -> bool:
        """True when any event can ever make ``alive()`` return False.

        Population-scale engines use this to skip the O(population)
        liveness scan: with no pod_kill and no full-loss partition on
        the schedule, every client is alive at every t, so a cohort can
        be drawn directly against the population size.  Conservative by
        construction — it ignores time windows and target sets, so a
        True answer only means "scan", never a wrong liveness result.
        """
        return any(
            ev.kind == "pod_kill"
            or (
                ev.kind == "partition"
                and ev.link_override is not None
                and ev.link_override.get("loss", 0) >= 1.0
            )
            for ev in self.events
        )

    def failed_fraction(self, t: float, n_clients: int) -> float:
        return sum(0 if self.alive(t, c) else 1 for c in range(n_clients)) / max(n_clients, 1)

    def server_restart_in(self, t0: float, t1: float) -> Optional[Tuple[float, float]]:
        """Earliest server_restart event with t0 < t_start <= t1, as
        (crash_time, downtime); None when the span is crash-free. Round
        spans tile the timeline half-open on the left, so each crash event
        lands in exactly one round."""
        best = None
        for ev in self.events:
            if ev.kind == "server_restart" and t0 < ev.t_start <= t1:
                if best is None or ev.t_start < best[0]:
                    best = (ev.t_start, ev.downtime)
        return best
