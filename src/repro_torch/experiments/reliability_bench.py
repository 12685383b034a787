"""Reliability benchmark: when does reliability become NECESSARY? (the port
of ``benchmarks/reliability_bench.py``).

The paper's transport characterization says vanilla TCP dies twice on edge
links — once on the SYN-ladder handshake budget (long one-way delays) and
once on mid-transfer loss (RTO-run / breaker death). Three sections, one
BENCH json line:

- ``owd_frontier``  deterministic (loss=0/jitter=0) one-way-delay ladder
  across the three protocol profiles. Gates: the default stack has a
  handshake cliff just past 5 s OWD; at that cliff the ``zero_rtt``
  profile still delivers (> 0.9), the tuned profile survives it too, and
  per-profile delivery is monotone non-increasing in OWD.
- ``loss_frontier`` resumable transfers against restart-from-scratch on a
  lossy 10 Mbps link with 4 MB exchanges and a short breaker
  (``tcp_retries2=5``). Gates: resume's delivery weakly dominates restart
  everywhere and strictly at >= 35 % loss; resume's time-to-delivery never
  loses and is strictly faster (capped mean) wherever any attempt failed;
  the dominance gap is monotone non-decreasing in loss.
- ``degenerate_parity`` host DES against the device transport plane on the
  deterministic path for the reliability configs (zero_rtt profile +
  resuming retry ladder): discrete fields exact, clocks/bytes to 1e-4.

The first two sections are host numpy, equal to the reference's; the third
runs the plane on CUDA unless given ``device=``. A gate failure exits
non-zero (``main``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np

from repro_torch.core.server import derive_rng
from repro_torch.experiments.common import emit_csv
from repro_torch.transport import (
    DEFAULT,
    TUNED_EDGE,
    LinkProfile,
    RetryPolicy,
    sim_client_round,
    sim_cohort_round,
    transport_profile,
)
from repro_torch.transport.des import _LinkArrays, _RetryArrays, _TcpArrays, _sim_rows
from repro_torch.transport.plane import device_sim_rows, transport_plane_key


def owd_frontier_section(*, fast: bool = False):
    """Deterministic delay ladder: loss=0/jitter=0 makes every outcome a
    closed-form 0/1, so the cliffs are exact, not sampled."""
    owds = [2.0, 6.0, 12.0, 16.0] if fast else [0.5, 2.0, 4.0, 6.0, 8.0, 12.0, 16.0]
    profiles = {
        "tcp_default": transport_profile("tcp_default"),
        "tcp_tuned": transport_profile("tcp_tuned"),
        "zero_rtt": transport_profile("zero_rtt"),  # DEFAULT stack + 0-RTT ticket
    }
    rows = []
    delivered = {name: [] for name in profiles}
    for owd in owds:
        link = LinkProfile(name=f"owd{owd}", delay=owd, jitter=0.0, loss=0.0, rate_mbps=50.0)
        for name, tcp in profiles.items():
            out = sim_client_round(
                tcp, link, update_bytes=100_000, download_bytes=200_000,
                local_train_time=5.0, rng=np.random.default_rng(0), connected=False,
            )
            d = 1.0 if out.success else 0.0
            delivered[name].append(d)
            rows.append([owd, name, d, round(float(out.time), 4) if out.success else ""])
    emit_csv("reliability_owd_frontier", ["owd_s", "profile", "delivered", "time_s"], rows)

    # the default stack's handshake cliff: first OWD where delivery dies
    dead = [i for i, d in enumerate(delivered["tcp_default"]) if d == 0.0]
    cliff_idx = dead[0] if dead else None
    gates = {
        # a cliff exists, and it sits just past the paper's 5 s OWD point
        "default_has_cliff": cliff_idx is not None and owds[cliff_idx] <= 6.0,
        # 0-RTT delivers at the cliff and at every point beyond it
        "zero_rtt_delivers_past_cliff": cliff_idx is not None
        and all(d > 0.9 for d in delivered["zero_rtt"][cliff_idx:]),
        # the tuned profile's bigger budget survives the default cliff
        "tuned_survives_default_cliff": cliff_idx is not None
        and delivered["tcp_tuned"][cliff_idx] == 1.0,
        # delivery is monotone non-increasing in OWD for every profile
        "monotone": all(all(a >= b for a, b in zip(ds, ds[1:])) for ds in delivered.values()),
    }
    return {
        "owds_s": owds,
        "delivered": delivered,
        "default_cliff_owd_s": None if cliff_idx is None else owds[cliff_idx],
        "gates": gates,
        "parity": all(gates.values()),
    }


# time-to-delivery cap for the mean statistic: an undelivered round is
# billed this many seconds (well past every delivered time in the sweep)
_TTD_CAP_S = 3600.0


def _loss_point(tcp, loss, retry, *, n, seed):
    link = LinkProfile(name=f"loss{loss}", delay=0.05, jitter=0.01, loss=loss, rate_mbps=10.0)
    out = sim_cohort_round(
        tcp, [link] * n, update_bytes=4_000_000, download_bytes=4_000_000,
        local_train_times=np.full(n, 2.0), rng=np.random.default_rng(seed),
        connected=np.zeros(n, bool), retry=retry,
    )
    ok = np.asarray(out.success, bool)
    t = np.asarray(out.time, float)
    delivery = float(ok.mean())
    # failed rounds never deliver: median time-to-delivery counts them +inf
    med = float(np.median(np.where(ok, t, np.inf)))
    # capped mean for the STRICT dominance gate: unlike the median it moves
    # whenever ANY row's delivery time moves (failures -> cap)
    mean_c = float(np.minimum(np.where(ok, t, np.inf), _TTD_CAP_S).mean())
    failed_acked = float(out.bytes_acked[~ok].sum())
    return delivery, med, mean_c, failed_acked, ok, t


def loss_frontier_section(*, fast: bool = False):
    """Resume against restart under loss: 4 MB exchanges on a 10 Mbps link
    with a short RTO-run breaker (tcp_retries2=5) make mid-transfer deaths
    common at >= 30 % loss, exactly where re-attempting from the acked
    frontier must dominate restarting from byte zero."""
    tcp = TUNED_EDGE.replace(tcp_retries2=5)
    losses = [0.30, 0.40] if fast else [0.30, 0.35, 0.40]
    n = 8 if fast else 24
    restart = RetryPolicy(max_retries=8, max_backoff=4.0)
    resume = dataclasses.replace(restart, resume=True)
    rows, stats, diverged = [], {"restart": [], "resume": []}, []
    for i, loss in enumerate(losses):
        samples = {}
        for name, pol in (("restart", restart), ("resume", resume)):
            delivery, med, mean_c, wasted, ok, t = _loss_point(tcp, loss, pol, n=n, seed=1000 + i)
            stats[name].append((delivery, med, mean_c))
            samples[name] = (ok, t)
            rows.append([
                loss, name, round(delivery, 4),
                round(med, 2) if math.isfinite(med) else "inf",
                round(mean_c, 2), round(wasted / 1e6, 3),
            ])
        # did resume engage? with zero attempt failures both policies run
        # identically and strictness is vacuous
        diverged.append(not (
            np.array_equal(samples["restart"][0], samples["resume"][0])
            and np.array_equal(samples["restart"][1], samples["resume"][1])
        ))
    emit_csv(
        "reliability_loss_frontier",
        ["loss", "policy", "delivery", "median_ttd_s", "mean_ttd_capped_s", "wasted_mb_failed"],
        rows,
    )

    rs, rm = stats["restart"], stats["resume"]
    gap = [b[0] - a[0] for a, b in zip(rs, rm)]
    gates = {
        "delivery_dominates": all(b[0] >= a[0] for a, b in zip(rs, rm)),
        "delivery_strict_at_high_loss": all(
            b[0] > a[0] for lo, a, b in zip(losses, rs, rm) if lo >= 0.35
        ),
        "ttd_dominates": all(b[1] <= a[1] and b[2] <= a[2] for a, b in zip(rs, rm)),
        "ttd_strict_where_engaged": all(b[2] < a[2] for a, b, dv in zip(rs, rm, diverged) if dv),
        # "when reliability becomes necessary": the gap only grows
        "gap_monotone": all(a <= b + 1e-9 for a, b in zip(gap, gap[1:])),
    }
    return {
        "losses": losses,
        "n_seeds": n,
        "restart": [[round(d, 4), round(m, 2) if math.isfinite(m) else None, round(mc, 2)]
                    for d, m, mc in rs],
        "resume": [[round(d, 4), round(m, 2) if math.isfinite(m) else None, round(mc, 2)]
                   for d, m, mc in rm],
        "delivery_gap": [round(g, 4) for g in gap],
        "engaged": diverged,
        "gates": gates,
        "parity": all(gates.values()),
    }


def degenerate_parity_section(*, device=None):
    """loss=0/jitter=0 rows mixing the zero_rtt profile with a resuming
    retry ladder: host DES and device plane agree exactly on the discrete
    fields and to 1e-4 on clocks/bytes."""
    zr = transport_profile("zero_rtt")
    links = [
        LinkProfile(name=f"l{d}", delay=d, jitter=0.0, loss=0.0, rate_mbps=50.0)
        for d in (0.0025, 2.0, 8.0, 12.0)
    ]
    ta = _TcpArrays.from_params([zr, zr, zr, DEFAULT])
    la = _LinkArrays.from_links(links)
    ra = _RetryArrays.broadcast(RetryPolicy(max_retries=2, resume=True), 4)
    kw = dict(
        up_bytes=np.full(4, 200_000, np.int64),
        down_bytes=np.full(4, 400_000, np.int64),
        local_train_times=np.full(4, 5.0),
        connected=np.zeros(4, bool),
    )
    h = _sim_rows(ta, la, rng=derive_rng(0, 2, 0), retry=ra, **kw)
    d = [x.cpu().numpy() for x in device_sim_rows(
        ta, la, key=transport_plane_key(0, 2, 0), retry=ra, device=device, **kw)[:4]]
    parity = (
        bool(np.array_equal(h[0], d[0]))
        and bool(np.array_equal(h[2], d[2]))
        and bool(np.allclose(d[1], h[1], rtol=1e-4))
        and bool(np.allclose(d[3], h[3], rtol=1e-4))
        # the reliability mechanics fired: 0-RTT rows survive the 8/12 s
        # cliff, the plain row dies with its ladder exhausted
        and bool(h[0][:3].all())
        and not bool(h[0][3])
        and int(h[2][3]) == 3
    )
    return {
        "host_success": [bool(x) for x in h[0]],
        "host_times_s": [float(x) for x in h[1]],
        "device_times_s": [float(x) for x in d[1]],
        "parity": parity,
    }


def run_bench(*, fast: bool = False, device=None):
    owd = owd_frontier_section(fast=fast)
    loss = loss_frontier_section(fast=fast)
    degenerate = degenerate_parity_section(device=device)
    result = {
        "bench": "reliability",
        "config": {"fast": fast},
        "owd_frontier": owd,
        "loss_frontier": loss,
        "degenerate_parity": degenerate,
        "parity": owd["parity"] and loss["parity"] and degenerate["parity"],
    }
    print("BENCH " + json.dumps(result))
    return result


def main(fast: bool = False, device=None):
    result = run_bench(fast=fast, device=device)
    if not result["parity"]:
        print("reliability_bench: RELIABILITY GATE FAILURE", file=sys.stderr)
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    main(fast=args.fast, device=args.device)
