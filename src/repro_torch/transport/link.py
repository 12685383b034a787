"""Network link profiles (paper Tables I & II) + NetEm-style impairments.

A ``LinkProfile`` is everything the testbed injected with Linux NetEm plus
the environment constants the failure analysis needs (queue limit — the
paper fixed NetEm's limit to 200 packets; middlebox idle timeout — the
k8s/conntrack-style silent connection reaper that makes keepalive_time
matter for FL's burst-idle pattern).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class LinkProfile:
    name: str = "lab"
    delay: float = 0.0025  # one-way delay, seconds (paper testbed: <5 ms RTT)
    jitter: float = 0.0  # one-way jitter stddev, seconds
    loss: float = 0.0  # packet loss fraction [0, 1)
    rate_mbps: float = 100.0  # link bandwidth cap
    queue_limit: int = 200  # NetEm queue size in packets (paper footnote 2)
    middlebox_timeout: float = 600.0  # idle seconds before silent conn drop

    @property
    def rtt(self) -> float:
        return 2.0 * self.delay

    def replace(self, **kw) -> "LinkProfile":
        return dataclasses.replace(self, **kw)


# --- paper Table I: average latencies across continents ---
AFRICA = LinkProfile("africa", delay=0.140, loss=0.02)  # 280 ms RTT
N_AMERICA = LinkProfile("n_america", delay=0.0225, loss=0.002)  # 45 ms
EUROPE = LinkProfile("europe", delay=0.015, loss=0.001)  # 30 ms
ASIA = LinkProfile("asia", delay=0.030, loss=0.002)  # 60 ms
AUSTRALIA = LinkProfile("australia", delay=0.025, loss=0.002)  # 50 ms

# --- paper Table II: Africa urban/rural vs global ---
AFRICA_URBAN = LinkProfile("africa_urban", delay=0.100, jitter=0.030, loss=0.075, rate_mbps=20.0)
AFRICA_RURAL = LinkProfile("africa_rural", delay=0.875, jitter=0.300, loss=0.20, rate_mbps=2.0)
GLOBAL_AVG = LinkProfile("global_avg", delay=0.0375, jitter=0.005, loss=0.005, rate_mbps=50.0)

LAB = LinkProfile("lab")

PROFILES = {
    p.name: p
    for p in (LAB, AFRICA, N_AMERICA, EUROPE, ASIA, AUSTRALIA, AFRICA_URBAN, AFRICA_RURAL, GLOBAL_AVG)
}
