"""Sweep runner: every paper table / figure sweep and engine bench of the
port, one after another (the port of ``benchmarks/run.py``).

    python -m repro_torch.experiments.run                 full sweeps on CUDA
    python -m repro_torch.experiments.run --fast          thinned sweeps
    python -m repro_torch.experiments.run --only a,b      the named ones
    python -m repro_torch.experiments.run --device cpu    on the CPU

Prints each bench's output, then a ``name,seconds,status`` summary; exits 1
when any bench fails (an exception, a parity gate's ``SystemExit`` or the
``--max-seconds`` budget) and 2 on an unknown name. The list is the
reference's in its order, less ``kernel_bench``: ``chip_smoke.py``'s kernel
phases hold every kernel against its plain version on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import inspect
import signal
import sys
import time
import traceback

# each a module of this package with a main(), in the reference's order
BENCHES = [
    "env_profiles",  # Tables I & II
    "fig3_latency",  # Fig 3
    "fig4_loss",  # Fig 4
    "fig5_client_failure",  # Fig 5
    "fig678_tcp_params",  # Figs 6-8 + Table IV
    "table3_boundaries",  # Table III
    "tuned_vs_default",  # Sec V validation
    "adaptive_daemon",  # beyond the paper (Sec VI)
    "round_engine_bench",
    "sweep_bench",
    "compress_bench",
    "transport_plane_bench",
    "resilience_bench",
    "reliability_bench",  # Sec VI reliability frontier
    "async_bench",
    "population_bench",  # million-client plane
]
KERNEL_BENCH = ("kernel_bench is not ported: chip_smoke.py's kernel, quant_kernels and "
                "lm_kernels phases time every kernel against its plain version on the card")


@contextlib.contextmanager
def _wall_clock_budget(seconds):
    """Per-bench wall-clock budget via SIGALRM: a bench over budget raises
    TimeoutError and is reported as a FAIL. No-op when ``seconds`` is None
    or SIGALRM is unavailable."""
    if seconds is None or not hasattr(signal, "SIGALRM"):
        yield
        return

    def _on_alarm(signum, frame):
        raise TimeoutError(f"benchmark exceeded --max-seconds={seconds}")

    prev = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(int(seconds))
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def _call(fn, fast: bool, device):
    """``fn`` with the arguments it takes of (fast, device)."""
    params = inspect.signature(fn).parameters
    kw = {}
    if "fast" in params:
        kw["fast"] = fast
    if "device" in params:
        kw["device"] = device
    return fn(**kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="thinned sweeps")
    ap.add_argument("--only", default=None, help="run selected benchmarks (comma-separated)")
    ap.add_argument("--max-seconds", type=int, default=None,
                    help="per-benchmark wall-clock budget; exceeding it fails that bench")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None

    if only is not None:
        if "kernel_bench" in only:
            print(KERNEL_BENCH, file=sys.stderr)
        unknown = only - set(BENCHES) - {"kernel_bench"}
        if unknown:
            # a typo would silently skip a bench and its parity gate
            print(f"unknown benchmark(s): {sorted(unknown)}; valid names: {', '.join(BENCHES)}",
                  file=sys.stderr)
        if unknown or "kernel_bench" in only:
            return 2

    summary = []
    failed = 0
    for name in BENCHES:
        if only is not None and name not in only:
            continue
        print(f"\n##### {name} #####", flush=True)
        t0 = time.time()
        try:
            with _wall_clock_budget(args.max_seconds):
                fn = importlib.import_module(f"repro_torch.experiments.{name}").main
                _call(fn, args.fast, args.device)
            status = "ok"
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            status = f"FAIL:{type(e).__name__}"
            failed += 1
        except SystemExit as e:
            # parity gates exit via SystemExit; the other benches still run
            status = f"FAIL:exit{e.code}"
            failed += 1
        summary.append((name, round(time.time() - t0, 1), status))

    print("\n##### summary #####")
    print("name,seconds,status")
    for name, dt, status in summary:
        print(f"{name},{dt},{status}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
