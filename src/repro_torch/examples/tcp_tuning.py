"""TCP-parameter exploration (paper §V) + the adaptive daemon (§VI) (the
port of ``examples/tcp_tuning.py``; numpy only, no tensor work).

1. Sweeps the three validated knobs across the paper's latency range and
   prints the per-latency winners (Figs 6-8 in miniature).
2. Runs the greedy 3-parameter tuner and shows the operating envelope it
   restores.
3. Demonstrates the adaptive daemon converging onto a hostile link.

  PYTHONPATH=src python -m repro_torch.examples.tcp_tuning
"""

import math

from repro_torch.transport import DEFAULT, LAB, client_round, effective_rtt
from repro_torch.tuning import AdaptiveTuner, tune_three_params
from repro_torch.tuning.grid import best_per_latency, sweep_parameter


def main():
    print("== per-parameter sweeps (paper Figs 6-8) ==")
    for param in ("tcp_syn_retries", "tcp_keepalive_time", "tcp_keepalive_intvl"):
        results = sweep_parameter(param, loss=0.08, local_train_time=900.0)
        best = best_per_latency(results)
        default = getattr(DEFAULT, param)
        losses = sum(
            1 for lat, b in best.items()
            if next(r for r in results if r.latency == lat and r.value == default).round_time
            > b.round_time * 1.001
        )
        print(f"  {param:22s}: default={default} suboptimal at {losses}/{len(best)} latencies")

    print("\n== greedy 3-knob tuning ==")
    tuned = tune_three_params(local_train_time=900.0)
    print(f"  tuned: syn_retries={tuned.tcp_syn_retries} "
          f"keepalive_time={tuned.tcp_keepalive_time:.0f} "
          f"keepalive_intvl={tuned.tcp_keepalive_intvl:.0f}")
    for owd in (0.3, 3.0, 6.0, 10.0):
        link = LAB.replace(delay=owd)
        d = client_round(DEFAULT, link, update_bytes=300_000, local_train_time=900.0, connected=False)
        t = client_round(tuned, link, update_bytes=300_000, local_train_time=900.0, connected=False)
        print(f"  owd={owd:5.1f}s  default p={d.p_complete:.2f}  tuned p={t.p_complete:.2f}"
              + (f"  ({t.expected_time:.0f}s/round)" if t.p_complete else ""))

    print("\n== adaptive daemon on a hostile link (owd=7s, loss=12%) ==")
    link = LAB.replace(delay=7.0, loss=0.12)
    tuner = AdaptiveTuner()
    for rnd in range(6):
        tcp = tuner.current_params()
        out = client_round(tcp, link, update_bytes=300_000, local_train_time=900.0, connected=False)
        ok = out.p_complete > 0.5 and math.isfinite(out.expected_time)
        print(f"  round {rnd}: syn={tcp.tcp_syn_retries:3d} "
              f"ka={tcp.tcp_keepalive_time:6.0f}/{tcp.tcp_keepalive_intvl:4.0f} "
              f"-> {'ok' if ok else 'FAILED'}")
        tuner.observe_round(
            rtt=effective_rtt(link), loss=link.loss, idle_time=900.0,
            silently_dropped=not ok,
        )


if __name__ == "__main__":
    main()
