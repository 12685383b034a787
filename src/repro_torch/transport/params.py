"""TCP connection-management parameters (paper Table IV).

``TcpParams`` merges the kernel sysctls the paper explored with the
gRPC-level behaviors that sit on top of them in Flower-like stacks (the
paper's §V treats them as one tunable surface; so do we — see DESIGN §8.2).

Calibration note (DESIGN §8.1): the effective SYN retransmit spacing
``syn_rto`` defaults to 1.5 s (kernel initial RTO + containerized gRPC
overhead as observed in the paper's testbed). With the default
``tcp_syn_retries = 6`` this yields a handshake budget of
(6+1) x 1.5 = 10.5 s — reproducing the paper's empirical cliff: training
still completes at 5 s one-way delay (RTT 10 s <= 10.5 s) and
catastrophically fails above it ("latency greater than 5,000 ms results in
no training", §IV-B).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class RetryPolicy:
    """Application-level within-round retry (FedComm-style resilience).

    The paper's stack has no recovery above TCP: a client whose round
    fails (handshake cliff, transfer collapse, deadline) is simply lost
    for that round, which is what makes the 5 s-latency cliff *permanent*.
    A ``RetryPolicy`` on ``ServerConfig`` lets a failed client re-attempt
    the whole round exchange (fresh handshake + download + local train
    window + upload — the Flower semantics of restarting the round task)
    up to ``max_retries`` times, waiting

        ``min(base_backoff * backoff_factor**(attempt-1), max_backoff)``

    before re-attempt ``attempt`` (1-based), optionally inflated by a
    uniform jitter factor in ``[1, 1+jitter]``. Re-attempts stop once the
    client's accumulated round clock passes ``deadline_cap`` (the server
    additionally caps this at its own ``round_deadline``; arrivals past
    the deadline are dropped regardless).

    Retry is a property of the *stochastic* transport engines (host DES
    and device plane); the analytic model composes it in closed form via
    :func:`repro_torch.transport.model.retry_round`. When ``jitter == 0`` the
    host DES consumes **no** extra RNG draws for backoff, which keeps the
    degenerate (loss=0, jitter=0) host/device parity path exact.
    """

    max_retries: int = 2
    base_backoff: float = 1.0  # s before the first re-attempt
    backoff_factor: float = 2.0
    max_backoff: float = 60.0  # s cap on any single wait
    jitter: float = 0.0  # uniform multiplicative spread on each wait
    deadline_cap: float = math.inf  # stop re-attempting past this round clock
    # Resumable transfers: when True, a re-attempt continues the exchange
    # from the failed attempt's acked-byte frontier (download first, then
    # upload) instead of restarting from byte zero — application-level
    # chunked transfer with durable chunk acks. A re-attempt whose
    # frontier already covers the download also skips the local-train
    # window (the model was fully received and trained on; only the
    # upload tail is outstanding). ``resume=False`` reproduces the
    # restart-from-zero ladder draw-for-draw.
    resume: bool = False

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.base_backoff < 0 or self.max_backoff < 0 or self.jitter < 0:
            raise ValueError("backoff parameters must be non-negative")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")
        if self.deadline_cap < 0:
            raise ValueError("deadline_cap must be non-negative")

    def backoff(self, attempt: int) -> float:
        """Deterministic wait before re-attempt ``attempt`` (1-based)."""
        return float(
            min(self.base_backoff * self.backoff_factor ** (attempt - 1), self.max_backoff)
        )

    def replace(self, **kw) -> "RetryPolicy":
        return dataclasses.replace(self, **kw)


# Transport profiles a TcpParams can carry (§VI "advanced reliability
# techniques"): "tcp_default"/"tcp_tuned" are plain TCP (the name only
# documents provenance — behavior is entirely the sysctl fields);
# "zero_rtt" models QUIC-style session resumption: the FIRST handshake a
# round needs runs the same SYN-ladder mechanics but is never killed by
# the handshake budget (a 1-RTT QUIC handshake has no kernel SYN-retry
# death), and every LATER handshake in the same round (idle-death
# reconnect, retry re-attempt after first contact) is a free 0-RTT
# resumption off the session ticket.
TRANSPORT_PROFILES = ("tcp_default", "tcp_tuned", "zero_rtt")


@dataclass(frozen=True)
class TcpParams:
    # --- the three parameters the paper tunes (§V) ---
    tcp_syn_retries: int = 6  # max initial SYN retransmits
    tcp_keepalive_time: float = 7200.0  # s idle before probes start
    tcp_keepalive_intvl: float = 75.0  # s between keepalive probes
    # --- the rest of Table IV ---
    tcp_synack_retries: int = 5
    tcp_keepalive_probes: int = 9
    tcp_retries2: int = 15  # established-connection retransmit limit
    tcp_rmem: int = 131072  # receive buffer (bytes; middle value of the triple)
    tcp_wmem: int = 131072
    tcp_max_syn_backlog: int = 128
    tcp_sack: bool = True
    tcp_window_scaling: bool = True
    # --- merged kernel/gRPC timing constants (calibrated; DESIGN §8) ---
    syn_rto: float = 1.5  # effective SYN retransmit spacing (s)
    initial_rto: float = 1.0  # established-connection initial RTO (s)
    min_rto: float = 0.2
    max_rto: float = 120.0
    mss: int = 1460  # bytes per segment
    # --- reliability profile (see TRANSPORT_PROFILES) ---
    profile: str = "tcp_default"

    def __post_init__(self):
        if self.profile not in TRANSPORT_PROFILES:
            raise ValueError(
                f"unknown transport profile {self.profile!r}; "
                f"expected one of {TRANSPORT_PROFILES}"
            )
        if self.mss <= 0:
            raise ValueError("mss must be > 0")
        if self.window_bytes < self.mss:
            raise ValueError(
                f"window_bytes ({self.window_bytes}) must be >= mss "
                f"({self.mss}): the AIMD window needs at least one segment"
            )
        for f in (
            "tcp_keepalive_time", "tcp_keepalive_intvl", "syn_rto",
            "initial_rto", "min_rto", "max_rto",
        ):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be non-negative")
        for f in (
            "tcp_syn_retries", "tcp_synack_retries", "tcp_keepalive_probes",
            "tcp_retries2",
        ):
            if getattr(self, f) < 0:
                raise ValueError(f"{f} must be non-negative")
        if self.max_rto < self.min_rto:
            raise ValueError("max_rto must be >= min_rto")

    @property
    def zero_rtt(self) -> bool:
        """True when this profile models QUIC-style session resumption."""
        return self.profile == "zero_rtt"

    @property
    def handshake_budget(self) -> float:
        """Total time the stack keeps trying to connect (s)."""
        return (self.tcp_syn_retries + 1) * self.syn_rto

    @property
    def window_bytes(self) -> int:
        """Effective max send window."""
        wnd = min(self.tcp_rmem, self.tcp_wmem)
        if not self.tcp_window_scaling:
            wnd = min(wnd, 65535)
        return wnd

    def replace(self, **kw) -> "TcpParams":
        return dataclasses.replace(self, **kw)

    def sysctl_dict(self) -> dict:
        """Render as /proc/sys/net/ipv4-style settings (for launch scripts)."""
        return {
            "net.ipv4.tcp_syn_retries": self.tcp_syn_retries,
            "net.ipv4.tcp_synack_retries": self.tcp_synack_retries,
            "net.ipv4.tcp_keepalive_time": int(self.tcp_keepalive_time),
            "net.ipv4.tcp_keepalive_intvl": int(self.tcp_keepalive_intvl),
            "net.ipv4.tcp_keepalive_probes": self.tcp_keepalive_probes,
            "net.ipv4.tcp_retries2": self.tcp_retries2,
            "net.ipv4.tcp_rmem": f"4096 {self.tcp_rmem} {self.tcp_rmem * 48}",
            "net.ipv4.tcp_wmem": f"4096 {self.tcp_wmem} {self.tcp_wmem * 48}",
            "net.ipv4.tcp_max_syn_backlog": self.tcp_max_syn_backlog,
            "net.ipv4.tcp_sack": int(self.tcp_sack),
            "net.ipv4.tcp_window_scaling": int(self.tcp_window_scaling),
        }


DEFAULT = TcpParams()

# The paper's validated operating point: three knobs moved off defaults
# (§V: "adjusting just three TCP connection management parameters ...
# restores training capability where default configurations fail").
# Values chosen from our fig6-8 sweeps (benchmarks/fig6..8) — the best
# overall settings across the latency range, matching the paper's trends.
TUNED_EDGE = TcpParams(
    tcp_syn_retries=16,  # handshake budget (16+1)*1.5 = 25.5 s -> OWD <= 12 s
    tcp_keepalive_time=60.0,  # probe during local-training idle (burst-idle fix)
    tcp_keepalive_intvl=15.0,  # detect dead peers quickly under loss
)

# Rec #2: buffer-heavy variant for extreme loss regimes.
BIG_BUFFER = TcpParams(
    tcp_rmem=4 * 1024 * 1024,
    tcp_wmem=4 * 1024 * 1024,
)


def transport_profile(name: str, *, base: TcpParams | None = None) -> TcpParams:
    """Resolve a profile name to a ``TcpParams``.

    ``"tcp_default"`` / ``"tcp_tuned"`` return ``base`` (or the canonical
    ``DEFAULT`` / ``TUNED_EDGE``) tagged with the profile name — plain TCP
    either way. ``"zero_rtt"`` tags ``base`` (default: ``DEFAULT``) with
    QUIC-style session resumption semantics; all sysctl-derived transfer
    mechanics (AIMD, RTO, buffers) are kept from ``base`` — 0-RTT changes
    only the (re)connection story, which is exactly the paper's 5 s OWD
    cliff surface.
    """
    if name not in TRANSPORT_PROFILES:
        raise ValueError(
            f"unknown transport profile {name!r}; "
            f"expected one of {TRANSPORT_PROFILES}"
        )
    if base is None:
        base = TUNED_EDGE if name == "tcp_tuned" else DEFAULT
    return base.replace(profile=name)
