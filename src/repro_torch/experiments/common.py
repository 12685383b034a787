"""Shared sweep harness: FL experiment runner + CSV emission (the port of
``benchmarks/common.py``).

Every paper figure/table sweep runs the SAME experiment shape the paper
used — 10 clients, MNIST CNN, FedAvg, fixed round budget — under swept
network conditions, and reports (accuracy, training time, completion).

Two execution engines share one configuration surface:

- ``run_fl_experiment(**point)``      — one sweep point, per-point server
- ``run_fl_grid_experiments(points)`` — a whole characterization grid as
  one scenario-parallel plane (``repro_torch.core.grid``), bit-identical
  to calling run_fl_experiment per point at the same seeds.

Shards and the eval set are built once and shared across points: the grid
engine coalesces identical training rows by dataset identity and memoizes
eval by parameter provenance. One task per device is shared too. Every
entry point runs on CUDA unless given ``device=`` (``"cpu"`` for the CPU).
"""

from __future__ import annotations

import io
import math
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.chaos import ChaosSchedule
from repro_torch.compress import get_compressor
from repro_torch.core import (
    EdgeClient,
    FederatedServer,
    GridPoint,
    Population,
    ServerConfig,
    fedavg,
    mnist_cnn_task,
    run_fl_grid,
)
from repro_torch.data import federated_mnist_factory, make_federated_mnist, synthetic_mnist
from repro_torch.transport import DEFAULT, LAB, LinkProfile, RetryPolicy, TcpParams
from repro_torch.utils import resolve_device

N_CLIENTS = 10
ROUNDS = 8
LOCAL_STEPS = 4
EXAMPLES_PER_CLIENT = 200

_TASKS: Dict[str, object] = {}
_SHARDS: Dict[int, list] = {}
_EVAL_DATA = None
_COMPRESSORS: Dict[str, object] = {}
last_grid_stats = None  # GridStats of the most recent grid sweep (bench telemetry)


def _shared_task(device=None):
    """One task instance per device for the whole sweep: the grid engine's
    provenance keys hold the task's identity, so every point of a grid and
    its per-point twins must share it."""
    device = resolve_device(device)
    key = str(device)
    if key not in _TASKS:
        _TASKS[key] = mnist_cnn_task(device=device)
    return _TASKS[key]


def _shared_shards(seed: int):
    """Shard list per seed, shared across sweep points (the grid engine
    keys row coalescing on dataset identity; contents are seed-determined
    either way)."""
    if seed not in _SHARDS:
        _SHARDS[seed] = make_federated_mnist(N_CLIENTS, EXAMPLES_PER_CLIENT, seed=seed)
    return _SHARDS[seed]


def _shared_eval_data():
    global _EVAL_DATA
    if _EVAL_DATA is None:
        _EVAL_DATA = synthetic_mnist(400, seed=4242)
    return _EVAL_DATA


def _shared_compressor(spec):
    """Compressor per spec string ("topk:0.05", "int8", ...), shared across
    sweep points: the grid engine's residual digests share best when every
    point references one fingerprint-equal object."""
    if spec is None or not isinstance(spec, str):
        return spec  # already a Compressor (or None)
    name, _, arg = spec.partition(":")
    kw = {"ratio": float(arg)} if arg else {}
    if name == "randk":
        # stateful (rotating selection counter): a shared instance would
        # leak draw state across points/runs and break fixed-seed
        # reproducibility — every point gets a fresh one
        return get_compressor(name, **kw)
    if spec not in _COMPRESSORS:
        _COMPRESSORS[spec] = get_compressor(name, **kw)
    return _COMPRESSORS[spec]


def spawn_point_seeds(n: int, *, root: int = 0) -> List[int]:
    """``n`` statistically independent per-point seeds from one root, via
    ``np.random.SeedSequence`` spawning: every point gets its own
    decorrelated stream family. Deterministic in (n, root)."""
    return [int(ss.generate_state(1)[0]) for ss in np.random.SeedSequence(root).spawn(n)]


def stochastic_fig4_points(fast: bool = False) -> List[dict]:
    """The fig4 (loss x tcp) grid with event-granular DES transport on
    split RNG streams — the configuration whose transport the grid engine
    can hoist into one plane pass per round. Every point gets its own
    SeedSequence-spawned stream seed (one shared shard set via
    ``data_seed``), so per-point transport streams are decorrelated."""
    from repro_torch.experiments import fig4_loss

    _, points = fig4_loss.sweep_points(fast)
    seeds = spawn_point_seeds(len(points))
    return [
        dict(kw, stochastic=True, rng_streams="split", seed=s, data_seed=0)
        for kw, s in zip(points, seeds)
    ]


def _make_point(
    *,
    tcp: TcpParams = DEFAULT,
    link: LinkProfile = LAB,
    chaos: Optional[ChaosSchedule] = None,
    min_fit: float = 0.5,
    rounds: int = ROUNDS,
    seed: int = 0,
    data_seed: Optional[int] = None,
    local_steps: int = LOCAL_STEPS,
    batched: bool = True,
    compressor=None,
    stochastic: bool = False,
    rng_streams: str = "single",
    engine: str = "default",
    transport_backend: str = "host",
    retry: Optional[RetryPolicy] = None,
    client_links: Optional[List[Optional[LinkProfile]]] = None,
    round_deadline: float = 600.0,
    max_consecutive_failures: int = 5,
    async_mode: bool = False,
    async_buffer_k: int = 1,
    async_concurrency: Optional[int] = None,
    staleness_alpha: float = 0.5,
    population: Optional[int] = None,
    population_factory=None,
    max_cached_shards: Optional[int] = None,
    state_plane: str = "dense",
    clients_per_round: float = 1.0,
) -> GridPoint:
    # data_seed decouples shard contents from the RNG-stream seed: grids
    # with spawned per-point seeds keep ONE shared shard set (dataset
    # identity is what the grid engine coalesces training rows on)
    dseed = seed if data_seed is None else data_seed
    if population is not None:
        # population-scale point: a lazy client universe, nothing
        # materializes until a cohort is drawn. The default factory makes
        # shard c from its own SeedSequence((dseed, c)) stream.
        # client_links is an O(population) list, so it is refused here:
        # use Population(link_override_fn=...) instead.
        if client_links is not None:
            raise ValueError(
                "population points take link overrides via "
                "Population(link_override_fn=...), not client_links"
            )
        clients = Population(
            population,
            population_factory or federated_mnist_factory(EXAMPLES_PER_CLIENT, seed=dseed),
            max_cached_shards=max_cached_shards or 256,
        )
    else:
        # client_links: per-client LinkProfile overrides (None = base link)
        shards = _shared_shards(dseed)
        clients = [
            EdgeClient(
                i, dataset=shards[i],
                link_override=None if client_links is None else client_links[i],
            )
            for i in range(N_CLIENTS)
        ]
    return GridPoint(
        clients=clients,
        strategy=fedavg(min_fit=min_fit),
        tcp=tcp,
        chaos=chaos or ChaosSchedule(link),
        config=ServerConfig(
            rounds=rounds, local_steps=local_steps, seed=seed, batched=batched,
            stochastic=stochastic, rng_streams=rng_streams, engine=engine,
            transport_backend=transport_backend, retry=retry,
            round_deadline=round_deadline,
            max_consecutive_failures=max_consecutive_failures,
            async_mode=async_mode, async_buffer_k=async_buffer_k,
            async_concurrency=async_concurrency,
            staleness_alpha=staleness_alpha,
            state_plane=state_plane, clients_per_round=clients_per_round,
        ),
        compressor=_shared_compressor(compressor),
    )


def _summarize(s: Dict[str, float], rounds: int) -> Dict[str, float]:
    return {
        "completed_rounds": s["completed_rounds"],
        "training_time_s": round(s["total_time_s"], 1),
        "accuracy": (
            float("nan")
            if math.isnan(s["final_accuracy"])
            else round(s["final_accuracy"], 4)
        ),
        "trained": 1.0 if s["completed_rounds"] >= rounds * 0.5 else 0.0,
        "mean_reconnects": round(s["mean_reconnects"], 2),
    }


def run_fl_experiment(*, device=None, **point) -> Dict[str, float]:
    p = _make_point(**point)
    server = FederatedServer(
        _shared_task(device),
        p.clients,
        p.strategy,
        tcp=p.tcp,
        chaos=p.chaos,
        config=p.config,
        compressor=p.compressor,
        eval_data=_shared_eval_data(),
    )
    return _summarize(server.run().summary(), p.config.rounds)


def run_fl_grid_experiments(
    points: List[dict], *, return_stats: bool = False, transport: str = "per_point",
    device=None,
):
    """Evaluate many ``run_fl_experiment`` configurations as ONE grid.

    Each entry of ``points`` is a kwargs dict for run_fl_experiment;
    results come back in order, bit-identical to per-point runs.
    ``transport`` forwards to ``run_fl_grid``: "per_point" (each point
    samples its own transport), "parity" (one sim_grid_round per round on
    per-point streams — still bit-identical), or "fused" (one shared-rng
    lockstep plane per round — distribution-equivalent)."""
    global last_grid_stats
    gpoints = [_make_point(**kw) for kw in points]
    res = run_fl_grid(
        _shared_task(device), gpoints, eval_data=_shared_eval_data(), transport=transport
    )
    last_grid_stats = res.stats
    out = [
        _summarize(h.summary(), p.config.rounds)
        for h, p in zip(res.histories, gpoints)
    ]
    return (out, res.stats) if return_stats else out


def run_points(
    points: List[dict], engine: str = "grid", transport: str = "per_point", device=None,
) -> List[Dict[str, float]]:
    """Run a sweep through the selected engine: ``grid`` (scenario-parallel
    plane, with ``transport`` selecting where stochastic transport is
    sampled) or ``per_point`` (one server per point)."""
    if engine == "grid":
        return run_fl_grid_experiments(points, transport=transport, device=device)
    if engine == "per_point":
        return [run_fl_experiment(device=device, **kw) for kw in points]
    raise ValueError(f"unknown engine {engine!r}")


def wall_s(device, fn):
    """(``fn()``, its wall seconds), a CUDA ``device`` synchronized on both
    sides so the time holds the card's work."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def emit_csv(name: str, header: List[str], rows: List[List]) -> str:
    buf = io.StringIO()
    print(f"# {name}", file=buf)
    print(",".join(header), file=buf)
    for row in rows:
        print(",".join(str(x) for x in row), file=buf)
    out = buf.getvalue()
    sys.stdout.write(out)
    sys.stdout.flush()
    return out
