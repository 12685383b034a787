"""TCP parameter grid search (paper §V): a numpy copy of
``repro/tuning/grid.py``.

"We modified our experimental testbed to include scripts that explore
unique values set for each parameter, testing ranges that spanned the lower
and upper bounds of the default values." — same thing, against the
transport model: sweep one parameter x a latency range, score by expected
FL round time (the paper's training-time metric), mark failures.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

from repro_torch.transport import LinkProfile, TcpParams, client_round

# the paper's Fig 6-8 use 17 latency data points; same spacing here (one-way s)
LATENCY_POINTS = [
    0.0, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 7.5, 10.0,
]

SWEEPS: Dict[str, List] = {
    "tcp_syn_retries": [1, 2, 3, 4, 6, 8, 12, 16, 24, 32],
    "tcp_keepalive_time": [15.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1800.0, 7200.0],
    "tcp_keepalive_intvl": [5.0, 10.0, 15.0, 30.0, 45.0, 60.0, 75.0, 120.0],
    "tcp_retries2": [3, 5, 8, 10, 15, 20],
    "tcp_rmem": [65536, 131072, 524288, 1048576, 4194304],
}


@dataclass
class GridResult:
    param: str
    value: object
    latency: float
    round_time: float  # inf = failure
    p_complete: float

    @property
    def failed(self) -> bool:
        return not math.isfinite(self.round_time) or self.p_complete < 0.5


def sweep_parameter(
    param: str,
    values: Sequence = None,
    *,
    base: TcpParams = None,
    link: LinkProfile = None,
    latencies: Sequence[float] = None,
    update_bytes: int = 300_000,
    local_train_time: float = 300.0,
    loss: float = 0.02,
) -> List[GridResult]:
    base = base or TcpParams()
    link = link or LinkProfile()
    values = values if values is not None else SWEEPS[param]
    latencies = latencies if latencies is not None else LATENCY_POINTS
    out = []
    for v in values:
        tcp = base.replace(**{param: v})
        for lat in latencies:
            l = link.replace(delay=lat, loss=loss, name=f"lat{lat}")
            r = client_round(
                tcp, l, update_bytes=update_bytes,
                local_train_time=local_train_time, connected=False,
            )
            t = r.expected_time if r.p_complete > 0 else math.inf
            out.append(GridResult(param, v, lat, t, r.p_complete))
    return out


def best_per_latency(results: List[GridResult]) -> Dict[float, GridResult]:
    best: Dict[float, GridResult] = {}
    for r in results:
        cur = best.get(r.latency)
        if cur is None or (r.round_time, -r.p_complete) < (cur.round_time, -cur.p_complete):
            best[r.latency] = r
    return best


def default_suboptimal_count(results: List[GridResult], default_value) -> int:
    """Paper metric: at how many latency points does the default lose?"""
    best = best_per_latency(results)
    n = 0
    for lat, b in best.items():
        default_r = next(
            r for r in results if r.latency == lat and r.value == default_value
        )
        if default_r.round_time > b.round_time * 1.001:  # strictly worse
            n += 1
    return n


def tune_three_params(
    *,
    link: LinkProfile = None,
    latencies: Sequence[float] = None,
    update_bytes: int = 300_000,
    local_train_time: float = 300.0,
) -> TcpParams:
    """Greedy coordinate descent over the paper's three validated knobs."""
    link = link or LinkProfile()
    latencies = latencies if latencies is not None else LATENCY_POINTS
    tcp = TcpParams()
    for param in ("tcp_syn_retries", "tcp_keepalive_time", "tcp_keepalive_intvl"):
        best_v, best_key = getattr(tcp, param), (math.inf, math.inf)
        for v in SWEEPS[param]:
            cand = tcp.replace(**{param: v})
            score, fails = 0.0, 0
            for lat in latencies:
                l = link.replace(delay=lat, name=f"lat{lat}")
                r = client_round(
                    cand, l, update_bytes=update_bytes,
                    local_train_time=local_train_time, connected=False,
                )
                if r.p_complete < 0.5 or not math.isfinite(r.expected_time):
                    fails += 1
                    score += 10 * local_train_time
                else:
                    score += r.expected_time / max(r.p_complete, 1e-6)
            key = (fails, score)  # lexicographic: no-failure first, then time
            if key < best_key:
                best_v, best_key = v, key
        tcp = tcp.replace(**{param: best_v})
    return tcp
