"""The federated round engine: Flower's FL loop rebuilt transport-aware
(the port of the synchronous engines of ``repro/core/server.py``).

Each simulated round:

1. liveness: the chaos schedule decides which pods are up;
2. cohort selection: sample ``clients_per_round`` of the live clients;
3. per-client transport: handshake-if-needed -> download -> local training
   (wire idle; keepalive mechanics apply) -> upload, through the analytic
   transport model (or the DES when ``stochastic=True``) under the client's
   effective link;
4. aggregation: deltas from clients that delivered before the deadline,
   weighted by example counts; rounds below quorum are *failed rounds*;
5. bookkeeping: simulated wall clock, per-client connection state, history.

Local training is real PyTorch training; only the network is simulated.
Every draw that shapes a round — selection, transport, batch plans — comes
from numpy generators, so a port run and a reference run with equal seeds
agree exactly on every numpy-computed field.

The round is a state machine with drivable halves: ``select_cohort`` ->
``run_transport`` -> ``finish_transport`` -> ``execute_fit`` ->
``finish_round``. The port covers the sequential and batched engines,
``engine="fused_transport"``, every compressor with error feedback in a
dense or sparse ``StatePlane``, the event-driven async engine
(``ServerConfig.async_mode``), lazy client universes (``Population``) and
the round-boundary checkpoint protocol (``run(checkpoint_dir=...)``, in the
reference's on-disk format). Stochastic transport is sampled by the host
DES or, with ``transport_backend="device"``, by the device transport plane
(``repro_torch.transport.plane``) on the device of the global params.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.chaos import ChaosSchedule
from repro_torch.checkpoint.store import CheckpointManager, load_tree
from repro_torch.compress import Compressor, none_compressor
from repro_torch.core.client import EdgeClient, LocalTask
from repro_torch.core.population import Population
from repro_torch.core.stateplane import StatePlane
from repro_torch.core.strategy import Strategy
from repro_torch.transport import LinkProfile, TcpParams, client_round as analytic_round
from repro_torch.transport.des import (
    delivery_events,
    sim_client_round,
    sim_cohort_round,
    sim_grid_round,
)
from repro_torch.transport.params import RetryPolicy
from repro_torch.transport.plane import sim_grid_round_device, transport_plane_key
from repro_torch.utils import tree_leaves, tree_map, tree_stack, tree_unstack


@dataclass
class RoundRecord:
    round_idx: int
    t_start: float
    t_end: float
    selected: int
    delivered: int
    failed_round: bool
    reconnects: float
    metrics: Dict[str, float] = field(default_factory=dict)
    events: List[Any] = field(default_factory=list)
    # selected client ids in cohort (selection-draw) order
    selected_ids: List[int] = field(default_factory=list)
    # failed rounds carry why: "no_live_quorum" | "quorum" |
    # "server_restart" | a quarantine cause ("non_finite_loss" /
    # "non_finite_delta"); empty for successful rounds
    cause: str = ""
    # total acked wire bytes across the cohort's exchanges this round, and
    # the subset acked by exchanges that ultimately FAILED
    bytes_acked: float = 0.0
    wasted_bytes: float = 0.0


@dataclass
class History:
    rounds: List[RoundRecord] = field(default_factory=list)
    eval_metrics: List[Dict[str, float]] = field(default_factory=list)
    # "healthy" until the run is quarantined ("diverged") or declared dead
    # ("failed", max_consecutive_failures); ``cause`` carries the trigger
    status: str = "healthy"
    cause: str = ""

    @property
    def total_time(self) -> float:
        return self.rounds[-1].t_end if self.rounds else 0.0

    @property
    def completed_rounds(self) -> int:
        return sum(0 if r.failed_round else 1 for r in self.rounds)

    def final_accuracy(self) -> Optional[float]:
        for m in reversed(self.eval_metrics):
            if "accuracy" in m:
                return m["accuracy"]
        return None

    def summary(self) -> Dict[str, float]:
        return {
            "rounds": len(self.rounds),
            "completed_rounds": self.completed_rounds,
            "total_time_s": self.total_time,
            "final_accuracy": self.final_accuracy() or float("nan"),
            "mean_reconnects": float(
                np.mean([r.reconnects for r in self.rounds]) if self.rounds else 0.0
            ),
            "status": self.status,
            "cause": self.cause,
        }


@dataclass
class FitJob:
    """Work order for one round's local training, produced by
    ``finish_transport`` and consumed by ``execute_fit``/``finish_round``."""

    rnd: int
    record: RoundRecord
    clients: List[EdgeClient]  # delivering clients, delivery order
    arrivals: List[float]
    payload_bytes: int  # UPLOAD wire size (byte accounting)
    steps: int
    prox_mu: float


@dataclass
class PendingRound:
    """Selected cohort awaiting transport: the output of ``select_cohort``
    and the input ``finish_transport`` consumes alongside sampled outcomes.
    ``upload_bytes`` is the compressor's wire size for the current global
    params, ``download_bytes`` the full model (``LocalTask.update_bytes``)."""

    rnd: int
    record: RoundRecord
    cohort: List[EdgeClient]  # selection order
    links: List[LinkProfile]  # effective link per cohort member
    local_times: np.ndarray  # [k] wire-idle local-training seconds
    connected: np.ndarray  # [k] pre-round connection state
    upload_bytes: int
    download_bytes: int


@dataclass
class ServerConfig:
    """Every field of the reference's config (see
    ``repro.core.server.ServerConfig`` for the full semantics of each
    field)."""

    rounds: int = 20
    clients_per_round: float = 1.0  # fraction of live clients selected
    local_steps: int = 10
    round_deadline: float = 600.0  # s; stragglers beyond this are dropped
    base_step_cost: float = 0.5  # s per local step on the 0.5 vCPU Pi class
    eval_every: int = 1
    stochastic: bool = False  # True => event-granular DES per client
    seed: int = 0
    # consecutive failed rounds before the run is declared dead
    max_consecutive_failures: int = 5
    # straggler mitigation: over-select and close at the first fraction
    over_provision: float = 1.0
    quorum_close_fraction: float = 1.0
    # event-driven asynchronous engine: rounds become dispatch TICKS. Each
    # tick dispatches fresh clients against the current model, pushes their
    # (delivery time, update) events onto a priority queue, then lands
    # queued events in delivery order into a FedBuff-style buffer; at
    # ``async_buffer_k`` updates the whole buffer aggregates in one stacked
    # pass, each update weighted by (1 + staleness)^-alpha (staleness =
    # buffer flushes since its dispatch). A tick landing nothing is the
    # async failed round.
    async_mode: bool = False
    staleness_alpha: float = 0.5
    # buffer-flush threshold (FedBuff's K); robust strategies need >= 2
    async_buffer_k: int = 1
    # cap on concurrently in-flight clients (None = the cohort fraction)
    async_concurrency: Optional[int] = None
    # batched cohort engine: vectorized transport sampling, one stacked
    # local-training program for the whole cohort, kernel-backed
    # stacked-delta aggregation
    batched: bool = False
    # "fused_transport" routes the cohort through sim_grid_round's
    # shared-rng plane (stochastic mode; implies rng_streams="split")
    engine: str = "default"
    # "single": one generator drives selection, transport and batch plans
    # in interleaved order; "split": a cohort stream and a transport
    # stream, both re-derived per (seed, stream, round)
    rng_streams: str = "single"
    # where stochastic transport is sampled: "host" (the numpy DES, the
    # parity oracle) or "device" (the torch transport plane on the device of
    # the global params; keyed per (seed, stream, round), so it implies
    # split streams)
    transport_backend: str = "host"
    # within-round retry of failed exchanges (stochastic engines only)
    retry: Optional[RetryPolicy] = None
    # reliability profile re-tagging the TcpParams at construction
    transport_profile: Optional[str] = None
    # reject a round with a non-finite loss/delta and retire the run
    quarantine: bool = True
    # per-client state storage ("dense" | "sparse"; bitwise equal on every
    # History observable); matters only with a compressor on the stacked
    # engines
    state_plane: str = "dense"

    def __post_init__(self):
        if self.state_plane not in ("dense", "sparse"):
            raise ValueError(f"unknown state_plane {self.state_plane!r}")
        if self.engine not in ("default", "fused_transport"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.rng_streams not in ("single", "split"):
            raise ValueError(f"unknown rng_streams {self.rng_streams!r}")
        if self.transport_backend not in ("host", "device"):
            raise ValueError(f"unknown transport_backend {self.transport_backend!r}")
        if self.transport_backend == "device" and not (self.stochastic and self.batched):
            raise ValueError(
                "transport_backend='device' requires stochastic=True and "
                "batched=True (the device plane is a Monte-Carlo cohort "
                "sampler; there is no analytic or sequential device path)"
            )
        if self.retry is not None and not self.stochastic:
            raise ValueError(
                "retry= requires stochastic=True: the retry ladder is a "
                "property of the event-granular engines; for the analytic "
                "model use repro_torch.transport.model.retry_round"
            )
        if self.transport_profile is not None:
            from repro_torch.transport.params import TRANSPORT_PROFILES

            if self.transport_profile not in TRANSPORT_PROFILES:
                raise ValueError(
                    f"unknown transport_profile {self.transport_profile!r}; "
                    f"expected one of {TRANSPORT_PROFILES} (or None)"
                )
        if self.async_buffer_k < 1:
            raise ValueError("async_buffer_k must be >= 1")
        if self.async_concurrency is not None and self.async_concurrency < 1:
            raise ValueError("async_concurrency must be >= 1 (or None)")


# stream tags for the split-rng discipline (spawn_key components).
# _GRID_STREAM seeds the grid engine's SHARED fused-transport stream — a
# distinct tag so it never collides bitwise with any point's private
# transport stream (points and grids commonly share seed 0).
_COHORT_STREAM = 1
_TRANSPORT_STREAM = 2
_GRID_STREAM = 3
# The grid's fused host pass for RELIABILITY points (zero_rtt profile or
# resume= retry): their stage masks consume the shared numpy stream in a
# different order, so they get their own tag — pure-TCP restart-from-zero
# points keep consuming _GRID_STREAM exactly as before the reliability
# layer existed. (The device plane needs no such split: its draws are
# unconditional and where-gated, so co-scheduled reliability rows cannot
# shift a plain row's stream.)
_GRID_ZR_STREAM = 4


def derive_rng(seed: int, stream: int, rnd: int) -> np.random.Generator:
    """Fold-in-keyed generator: an independent, reproducible stream per
    (seed, stream tag, round)."""
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(stream, rnd))
    )


class FederatedServer:
    def __init__(
        self,
        task: LocalTask,
        clients: List[EdgeClient],
        strategy: Strategy,
        *,
        tcp: TcpParams,
        chaos: ChaosSchedule,
        config: ServerConfig,
        compressor: Optional[Compressor] = None,
        eval_data: Optional[Dict[str, np.ndarray]] = None,
        eval_fn: Optional[Any] = None,
    ):
        self.task = task
        self.clients = clients
        self.strategy = strategy
        if config.transport_profile is not None:
            from repro_torch.transport.params import transport_profile

            tcp = transport_profile(config.transport_profile, base=tcp)
        self.tcp = tcp
        self.chaos = chaos
        self.config = config
        self.compressor = compressor or none_compressor()
        self.eval_data = eval_data
        self._evaluate = eval_fn or task.evaluate
        self.rng = np.random.default_rng(config.seed)
        # split-stream discipline: select_cohort re-derives self.rng (the
        # cohort stream) and this transport stream at each round boundary
        self._transport_rng = None
        if config.async_mode and strategy.robust and config.async_buffer_k < 2:
            raise ValueError(
                f"async_buffer_k={config.async_buffer_k} with robust "
                f"strategy {strategy.name!r}: order-statistic aggregation "
                "over a buffer of one silently degenerates to identity "
                "(the single update IS its own trimmed mean/median/krum "
                "pick); use async_buffer_k >= 2 or a weighted-mean strategy"
            )
        self.global_params = task.init_fn(torch.Generator().manual_seed(config.seed))
        self.history = History()
        self.sim_time = 0.0
        self.consecutive_failures = 0
        self.terminated = False
        # --- event-driven async engine state (config.async_mode) ---
        # heap of (t_land_abs, seq, event) over in-flight updates; seq is
        # the dispatch sequence number, unique, so events never compare
        # their dicts
        self._event_queue: List[Any] = []
        self._event_seq = 0
        # landed-but-unflushed updates (the FedBuff buffer), land order
        self._async_buffer: List[Dict[str, Any]] = []
        # client_ids with an update still in the queue (never re-dispatched)
        self._in_flight: set = set()
        # staleness clock: number of buffer flushes applied so far
        self.model_version = 0
        # per-tick outputs for the grid engine: provenance tokens of the
        # tick's dispatched rows (set by the grid before finish_round) and
        # the flush descriptor of the last tick (None without a flush)
        self._plane_row_keys: Optional[tuple] = None
        self._last_flush: Optional[Dict[str, Any]] = None
        # grid hook, called (self, rnd) right after a tick's flush and
        # before eval, so the memoized eval keys on the post-flush params
        self._async_prov_hook = None
        # plane-resident error feedback: a StatePlane of per-client f32
        # residual rows (dense or sparse per config.state_plane), allocated
        # on the first compressed stacked round. The sequential engine keeps
        # per-client EdgeClient.residual.
        self._residual_plane: Optional[StatePlane] = None
        # lazy population universe: client ids ARE state slots, and the
        # O(population) id-keyed slot map is skipped
        self._population: Optional[Population] = (
            clients if isinstance(clients, Population) else None
        )
        if self._population is not None and config.async_mode:
            raise ValueError(
                "Population requires the synchronous engines: the async "
                "tick loop tracks per-client in-flight state by slot map; "
                "pass a materialized client list for async_mode"
            )
        self._client_slot = (
            None
            if self._population is not None
            else {id(c): i for i, c in enumerate(self.clients)}
        )

    # ------------------------------------------------------------------
    @property
    def split_streams(self) -> bool:
        """True when selection/plan draws and transport draws come from the
        two derived per-round streams (see ServerConfig.rng_streams)."""
        return (
            self.config.rng_streams == "split"
            or self.config.engine == "fused_transport"
            or self.config.transport_backend == "device"
        )

    def _round_transport_rng(self) -> np.random.Generator:
        return self._transport_rng if self.split_streams else self.rng

    def _effective_retry(self) -> Optional[RetryPolicy]:
        """The configured RetryPolicy with its deadline cap resolved
        against round_deadline; None when retry is off."""
        r = self.config.retry
        if r is None or r.max_retries <= 0:
            return None
        cap = min(r.deadline_cap, self.config.round_deadline)
        return r if cap == r.deadline_cap else r.replace(deadline_cap=cap)

    # ------------------------------------------------------------------
    def _client_transport(self, client, link, local_time, upload_bytes, download_bytes):
        """Sequential per-client transport. Returns (completed, time,
        reconnects, bytes_acked)."""
        rng = self._round_transport_rng()
        if self.config.stochastic:
            out = sim_client_round(
                self.tcp,
                link,
                update_bytes=upload_bytes,
                local_train_time=local_time,
                rng=rng,
                connected=client.connected,
                download_bytes=download_bytes,
                retry=self._effective_retry(),
            )
            return out.success, out.time, out.reconnects, float(out.bytes_acked)
        out = analytic_round(
            self.tcp,
            link,
            update_bytes=upload_bytes,
            local_train_time=local_time,
            connected=client.connected,
            download_bytes=download_bytes,
        )
        completed = rng.random() < out.p_complete
        t = out.expected_time if math.isfinite(out.expected_time) else self.config.round_deadline
        ba = float(upload_bytes + download_bytes) if completed else 0.0
        return completed, t, out.reconnects, ba

    def _cohort_transport(self, pending: PendingRound):
        """Vectorized transport for the whole cohort. Returns (completed
        [k], time [k], reconnects [k], bytes_acked [k]); in analytic mode
        the completion draws are one ``rng.random(k)``, the same stream as
        k scalar draws of the sequential loop."""
        cfg = self.config
        cohort, links = pending.cohort, pending.links
        local_times = pending.local_times
        rng = self._round_transport_rng()
        if cfg.stochastic:
            connected = pending.connected
            if cfg.transport_backend == "device":
                # the S=1 case of the grid's device plane, keyed on this
                # round's transport stream, on the device of the params
                out = sim_grid_round_device(
                    self.tcp,
                    [links],
                    update_bytes=np.full((1, len(cohort)), pending.upload_bytes, np.int64),
                    download_bytes=np.full((1, len(cohort)), pending.download_bytes, np.int64),
                    local_train_times=local_times[None],
                    connected=connected[None],
                    key=transport_plane_key(cfg.seed, _TRANSPORT_STREAM, pending.rnd),
                    retry=self._effective_retry(),
                    device=self._device(),
                )
                return (
                    out.success[0].cpu().numpy(),
                    out.time[0].cpu().numpy().astype(float),
                    out.reconnects[0].cpu().numpy().astype(float),
                    out.bytes_acked[0].cpu().numpy().astype(float),
                )
            if cfg.engine == "fused_transport":
                out = sim_grid_round(
                    self.tcp,
                    [links],
                    update_bytes=np.full((1, len(cohort)), pending.upload_bytes, np.int64),
                    download_bytes=np.full((1, len(cohort)), pending.download_bytes, np.int64),
                    local_train_times=local_times[None],
                    rng=rng,
                    connected=connected[None],
                    retry=self._effective_retry(),
                )
                return (
                    out.success[0],
                    out.time[0],
                    out.reconnects[0].astype(float),
                    out.bytes_acked[0].astype(float),
                )
            out = sim_cohort_round(
                self.tcp,
                links,
                update_bytes=pending.upload_bytes,
                local_train_times=local_times,
                rng=rng,
                connected=connected,
                download_bytes=pending.download_bytes,
                retry=self._effective_retry(),
            )
            return (
                out.success,
                out.time,
                out.reconnects.astype(float),
                out.bytes_acked.astype(float),
            )
        outs = [
            analytic_round(
                self.tcp,
                link,
                update_bytes=pending.upload_bytes,
                local_train_time=lt,
                connected=c.connected,
                download_bytes=pending.download_bytes,
            )
            for c, link, lt in zip(cohort, links, local_times)
        ]
        p = np.array([o.p_complete for o in outs])
        completed = rng.random(len(cohort)) < p
        times = np.array(
            [
                o.expected_time if math.isfinite(o.expected_time) else cfg.round_deadline
                for o in outs
            ]
        )
        wire = float(pending.upload_bytes + pending.download_bytes)
        return (
            completed,
            times,
            np.array([o.reconnects for o in outs]),
            np.where(completed, wire, 0.0),
        )

    # ------------------------------------------------------------------
    def _end_round_failed(self, record: RoundRecord) -> None:
        record.t_end = self.sim_time
        record.failed_round = True
        self.history.rounds.append(record)
        self.consecutive_failures += 1
        if self.consecutive_failures >= self.config.max_consecutive_failures:
            self.terminated = True
            self.history.status = "failed"
            self.history.cause = "max_consecutive_failures"

    def _fail_round(self, record: RoundRecord, cause: str = "quorum") -> None:
        self.sim_time += self.config.round_deadline
        record.cause = cause
        crash = self.chaos.server_restart_in(record.t_start, self.sim_time)
        if crash is not None:
            # the server also died while waiting out this failed round
            for c in self._state_clients():
                c.connected = False
            self.sim_time = max(self.sim_time, crash[0] + crash[1])
        self._end_round_failed(record)

    def _abort_round_server_restart(self, record: RoundRecord, crash) -> None:
        """A ``server_restart`` chaos event landed inside this round's span:
        every in-flight contribution is lost, params stay at the round
        boundary, all connections drop, and the clock jumps to
        crash + downtime. Consumes no RNG."""
        t_crash, downtime = crash
        record.cause = "server_restart"
        for c in self._state_clients():
            c.connected = False
        self.sim_time = t_crash + downtime
        self._end_round_failed(record)

    def _divergence_cause(self, stacked, deltas, per_metrics) -> Optional[str]:
        """Quarantine trigger scan, read-only: a non-finite client loss or a
        non-finite delta sum. Returns the cause string or None."""
        for m in per_metrics:
            v = m.get("loss")
            if v is not None and not math.isfinite(float(v)):
                return "non_finite_loss"
        if stacked is not None:
            leaves = tree_leaves(stacked)
        else:
            leaves = [leaf for d in deltas for leaf in tree_leaves(d)]
        if leaves:
            total = float(torch.stack([leaf.sum() for leaf in leaves]).sum())
            if not math.isfinite(total):
                return "non_finite_delta"
        return None

    def _quarantine_round(self, job: FitJob, cause: str) -> None:
        """Reject the round's update and retire the run: params stay at the
        round boundary and the history ends with status "diverged"."""
        record = job.record
        record.failed_round = True
        record.cause = cause
        self.sim_time += min(max(job.arrivals), self.config.round_deadline)
        record.t_end = self.sim_time
        self.history.rounds.append(record)
        self.terminated = True
        self.history.status = "diverged"
        self.history.cause = cause

    def select_cohort(self, rnd: int) -> Optional[PendingRound]:
        """Liveness, cohort selection, and the round's effective links and
        payloads. Returns None when the round already failed for lack of
        live clients (recorded). Under the split-stream discipline this is
        also where both per-round streams are re-derived."""
        cfg = self.config
        if self.split_streams:
            self.rng = derive_rng(cfg.seed, _COHORT_STREAM, rnd)
            self._transport_rng = derive_rng(cfg.seed, _TRANSPORT_STREAM, rnd)
        t = self.sim_time
        if cfg.async_mode:
            return self._select_cohort_async(rnd, t)
        n_total = len(self.clients)
        if self._population is not None:
            # lazy universe: live ids without materializing clients;
            # live_ids=None is the O(1) path (no client-killing chaos: all
            # ids live, in id order), the same draw as the list's
            live = None
            live_ids = self._population.live_ids(self.chaos, t)
            n_live = n_total if live_ids is None else len(live_ids)
        else:
            live = [c for c in self.clients if self.chaos.alive(t, c.client_id)]
            n_live = len(live)
        quorum = self.strategy.quorum(n_total)
        record = RoundRecord(rnd, t, t, 0, 0, False, 0.0)
        if n_live < quorum:
            # Flower blocks until min_fit clients are available; account
            # the wait as a failed round of deadline length
            self._fail_round(record, cause="no_live_quorum")
            return None
        k = max(quorum, int(round(cfg.clients_per_round * n_live)))
        k = min(int(round(k * max(cfg.over_provision, 1.0))), n_live)
        idx = self.rng.choice(n_live, size=k, replace=False)
        if live is None:
            ids = idx if live_ids is None else live_ids[idx]
            cohort = [self._population.client(int(cid)) for cid in ids]
        else:
            cohort = [live[i] for i in idx]
        record.selected = k
        record.selected_ids = [c.client_id for c in cohort]
        links = [
            c.link_override if c.link_override is not None
            else self.chaos.link_at(t, c.client_id)
            for c in cohort
        ]
        local_times = np.array(
            [cfg.local_steps * c.step_time(cfg.base_step_cost) for c in cohort]
        )
        return PendingRound(
            rnd=rnd,
            record=record,
            cohort=cohort,
            links=links,
            local_times=local_times,
            connected=np.array([c.connected for c in cohort], bool),
            upload_bytes=self.compressor.wire_bytes(self.global_params),
            download_bytes=self.task.update_bytes,
        )

    def _select_cohort_async(self, rnd: int, t: float) -> PendingRound:
        """Async dispatch half of a tick: fresh clients to dispatch against
        the CURRENT model. Candidates are live clients without an update in
        flight; ``async_concurrency`` caps the total in flight. No quorum
        gate and no failed round here: a tick with nothing to dispatch
        still drains the event queue (its PendingRound has an empty
        cohort)."""
        cfg = self.config
        record = RoundRecord(rnd, t, t, 0, 0, False, 0.0)
        live = [
            c
            for c in self.clients
            if self.chaos.alive(t, c.client_id) and c.client_id not in self._in_flight
        ]
        budget = len(live)
        if cfg.async_concurrency is not None:
            budget = max(cfg.async_concurrency - len(self._in_flight), 0)
        k = 0
        if live and budget > 0:
            k = max(1, int(round(cfg.clients_per_round * len(live))))
            k = min(k, budget, len(live))
        if k > 0:
            idx = self.rng.choice(len(live), size=k, replace=False)
            cohort = [live[i] for i in idx]
        else:
            cohort = []
        record.selected = k
        record.selected_ids = [c.client_id for c in cohort]
        links = [
            c.link_override if c.link_override is not None
            else self.chaos.link_at(t, c.client_id)
            for c in cohort
        ]
        local_times = np.array(
            [cfg.local_steps * c.step_time(cfg.base_step_cost) for c in cohort]
        )
        return PendingRound(
            rnd=rnd,
            record=record,
            cohort=cohort,
            links=links,
            local_times=local_times,
            connected=np.array([c.connected for c in cohort], bool),
            upload_bytes=self.compressor.wire_bytes(self.global_params),
            download_bytes=self.task.update_bytes,
        )

    def run_transport(self, pending: PendingRound):
        """Sample the pending round's transport on this server's streams:
        the batched cohort draw or the sequential per-client loop. Returns
        (completed [k], times [k], reconnects [k], bytes_acked [k])."""
        if len(pending.cohort) == 0:  # async drain-only tick
            z = np.zeros(0, float)
            return np.zeros(0, bool), z, z, z
        if self.config.batched:
            return self._cohort_transport(pending)
        outs = [
            self._client_transport(
                client, link, float(lt), pending.upload_bytes, pending.download_bytes
            )
            for client, link, lt in zip(pending.cohort, pending.links, pending.local_times)
        ]
        comp, times, recon, acked = zip(*outs)
        return (
            np.array(comp, bool),
            np.array(times, float),
            np.array(recon, float),
            np.array(acked, float),
        )

    def _record_bytes(self, record: RoundRecord, completed, bytes_acked) -> None:
        """Fold partial-progress telemetry into the round record."""
        if bytes_acked is None:
            return
        ba = np.asarray(bytes_acked, float)
        if ba.size == 0:
            return
        record.bytes_acked += float(ba.sum())
        record.wasted_bytes += float(ba[~np.asarray(completed, bool)].sum())

    def finish_transport(
        self, pending: PendingRound, completed, times, reconnects, bytes_acked=None,
    ) -> Optional[FitJob]:
        """Apply sampled outcomes — connection state, deliveries under the
        deadline, straggler close, quorum — and emit the round's FitJob (or
        record a failed round and return None)."""
        cfg = self.config
        if cfg.async_mode:
            return self._finish_transport_async(pending, completed, times, reconnects, bytes_acked)
        record = pending.record
        quorum = self.strategy.quorum(len(self.clients))
        record.reconnects += float(np.sum(np.asarray(reconnects, float)))
        self._record_bytes(record, completed, bytes_acked)
        deliveries = []
        for client, done, ct in zip(pending.cohort, completed, times):
            client.connected = bool(done)  # failed exchange leaves conn dead
            if done and ct <= cfg.round_deadline:
                deliveries.append((client, float(ct)))

        # straggler mitigation: close the round once the fastest
        # quorum_close_fraction of the over-provisioned cohort arrived
        if cfg.quorum_close_fraction < 1.0 and len(deliveries) > quorum:
            deliveries.sort(key=lambda d: d[1])
            keep = max(quorum, int(len(deliveries) * cfg.quorum_close_fraction))
            deliveries = deliveries[:keep]

        record.delivered = len(deliveries)
        if len(deliveries) < quorum:
            self._fail_round(record, cause="quorum")
            return None
        self.consecutive_failures = 0
        return FitJob(
            rnd=pending.rnd,
            record=record,
            clients=[client for client, _ in deliveries],
            arrivals=[ct for _, ct in deliveries],
            payload_bytes=pending.upload_bytes,
            steps=cfg.local_steps,
            prox_mu=self.strategy.prox_mu,
        )

    def _finish_transport_async(
        self, pending: PendingRound, completed, times, reconnects, bytes_acked=None,
    ) -> FitJob:
        """Async post-transport half: fold the tick's sampled flows into
        delivery EVENTS. Failed flows and stragglers past the deadline are
        dropped here and never enter the event queue. Always returns a
        FitJob (possibly with no clients: the drain still runs); clients
        are listed in LAND order, their deltas computed against the
        CURRENT global params (the model downloaded at dispatch)."""
        cfg = self.config
        record = pending.record
        record.reconnects += float(np.sum(np.asarray(reconnects, float)))
        self._record_bytes(record, completed, bytes_acked)
        for client, done in zip(pending.cohort, completed):
            client.connected = bool(done)  # failed exchange leaves conn dead
        events = delivery_events(completed, times, t_start=0.0, deadline=cfg.round_deadline)
        return FitJob(
            rnd=pending.rnd,
            record=record,
            clients=[pending.cohort[j] for _, j in events],
            arrivals=[t for t, _ in events],
            payload_bytes=pending.upload_bytes,
            steps=cfg.local_steps,
            prox_mu=self.strategy.prox_mu,
        )

    def begin_round(self, rnd: int) -> Optional[FitJob]:
        """``select_cohort`` -> ``run_transport`` -> ``finish_transport``."""
        pending = self.select_cohort(rnd)
        if pending is None:
            return None
        return self.finish_transport(pending, *self.run_transport(pending))

    def execute_fit(self, job: FitJob):
        """Local training for one FitJob: one plane program for the cohort
        (batched) or the sequential per-client loop. Returns (stacked
        [C,...] or None, deltas list, weights, per_metrics). Batch plans
        draw from ``self.rng``, the cohort stream."""
        cfg = self.config
        if not job.clients:  # async drain-only tick: nothing to train
            return None, [], [], []
        if cfg.batched and self.task.batched_local_fit is not None:
            stacked, weights, per_metrics = self.task.batched_local_fit(
                self.global_params, job.clients, job.steps, self.rng, job.prox_mu
            )
            return stacked, [], list(weights), per_metrics
        deltas, weights, per_metrics = [], [], []
        for client in job.clients:
            delta, n_ex, m = self.task.local_fit(
                self.global_params, client, job.steps, self.rng, job.prox_mu
            )
            deltas.append(delta)
            weights.append(n_ex)
            per_metrics.append(m)
        return None, deltas, weights, per_metrics

    def _ensure_residual_plane(self) -> StatePlane:
        """The per-client residual StatePlane (dense or sparse per
        ``config.state_plane``), allocated on the first compressed stacked
        round on the device of the global params."""
        if self._residual_plane is None:
            self._residual_plane = StatePlane(
                self.global_params,
                len(self.clients),
                storage=self.config.state_plane,
            )
        return self._residual_plane

    def client_slots(self, clients: List[EdgeClient]) -> List[int]:
        """Population-wide state slots for a list of (delivering) clients:
        list universes key them by list position, lazy populations by
        client id. They are what grid compression provenance keys on;
        ``StatePlane.rows_for`` maps them to physical buffer rows."""
        if self._client_slot is None:
            return [c.client_id for c in clients]
        return [self._client_slot[id(c)] for c in clients]

    def _state_clients(self) -> List[EdgeClient]:
        """Clients that may hold non-default state: the whole list, or the
        population's materialized clients (untouched lazy clients are
        disconnected with zero counters by construction)."""
        if self._population is not None:
            return self._population.active_clients()
        return self.clients

    def _client_at(self, slot: int) -> EdgeClient:
        """The client occupying a state slot (checkpoint restore path)."""
        if self._population is not None:
            return self._population.peek(slot)
        return self.clients[slot]

    def _slotted_state_clients(self):
        """(slot, client) pairs for clients that may hold per-client state:
        the checkpoint protocol's iteration surface, O(active) for
        populations."""
        if self._population is not None:
            return [(c.client_id, c) for c in self._population.active_clients()]
        return list(enumerate(self.clients))

    def finish_round(
        self, job: FitJob, stacked, deltas, weights, per_metrics,
        precompressed: bool = False, fault_checked: bool = False,
    ) -> None:
        """Fault checks, compression, bookkeeping, aggregation, clock
        advance, eval. A quarantined round is rejected before compression,
        so the residuals never ingest a non-finite delta. Byte accounting
        credits ``job.payload_bytes``, the compressed upload size. Consumes
        no RNG.

        The grid engine hands in two keywords. ``fault_checked=True``: it
        already ran the crash and quarantine checks, which must come before
        its shared compression pass. ``precompressed=True``: it already ran
        the plane compression (possibly shared across sweep points with
        equal compression provenance), so ``stacked`` holds decompressed
        deltas and this server's residual plane is already advanced."""
        cfg = self.config
        rnd = job.rnd
        record = job.record
        # fault domain, checked before any state mutates: a server crash
        # inside the round span loses the round outright; a non-finite
        # loss/delta rejects it. An async tick's crash window is the full
        # deadline horizon (every event the tick can land falls in it), and
        # a crash there voids the queue and the buffer too.
        if cfg.async_mode:
            if not fault_checked:
                crash = self.chaos.server_restart_in(
                    record.t_start, record.t_start + cfg.round_deadline
                )
                if crash is not None:
                    self._abort_tick_server_restart(record, crash)
                    return
                if cfg.quarantine and job.clients:
                    cause = self._divergence_cause(stacked, deltas, per_metrics)
                    if cause is not None:
                        self._quarantine_round(job, cause)
                        return
        else:
            round_time = min(max(job.arrivals), cfg.round_deadline)
            if not fault_checked:
                crash = self.chaos.server_restart_in(record.t_start, record.t_start + round_time)
                if crash is not None:
                    self._abort_round_server_restart(record, crash)
                    return
                if cfg.quarantine:
                    cause = self._divergence_cause(stacked, deltas, per_metrics)
                    if cause is not None:
                        self._quarantine_round(job, cause)
                        return

        # compression: the plane path keeps the cohort stacked (the
        # delivering rows' residuals are gathered from the StatePlane,
        # compressed and scattered back, bitwise equal to the per-client
        # loop); compressors without a plane twin (randk) and unstacked
        # deltas take the per-client loop
        if self.compressor.name != "none" and not precompressed:
            plane_fn = self.compressor.compress_plane
            if stacked is not None and plane_fn is not None:
                plane = self._ensure_residual_plane()
                # physical buffer rows for the cohort's slots (identity
                # under dense storage; compacted rows under sparse)
                rows = plane.rows_for(self.client_slots(job.clients))
                stacked, plane.buffer = plane_fn(stacked, plane.buffer, rows)
            else:
                if stacked is not None:
                    deltas = tree_unstack(stacked)
                    stacked = None
                compressed = []
                for client, delta in zip(job.clients, deltas):
                    payload, client.residual = self.compressor.compress(
                        delta, client.residual
                    )
                    compressed.append(self.compressor.decompress(payload))
                deltas = compressed

        for client, m in zip(job.clients, per_metrics):
            client.rounds_participated += 1
            client.bytes_sent += job.payload_bytes
            record.metrics.update({f"client_{client.client_id}_{k}": v for k, v in m.items()})

        if cfg.async_mode:
            flushed = self._async_tick(job, stacked, deltas, weights, rnd)
            if self._async_prov_hook is not None:
                self._async_prov_hook(self, rnd)
            if flushed and self.eval_data is not None and (rnd + 1) % cfg.eval_every == 0:
                m = self._evaluate(self.global_params, self.eval_data)
                m["round"] = rnd
                m["t"] = self.sim_time
                self.history.eval_metrics.append(m)
            return
        if cfg.batched:
            # stacked-delta fast path: kernel-backed reduction
            if stacked is None:
                stacked = tree_stack(deltas)
            self.global_params = self.strategy.aggregate_stacked(
                self.global_params, stacked, weights, rnd
            )
        else:
            self.global_params = self.strategy.aggregate(
                self.global_params, deltas, weights, rnd
            )

        self.sim_time += round_time
        record.t_end = self.sim_time
        self.history.rounds.append(record)

        if self.eval_data is not None and (rnd + 1) % cfg.eval_every == 0:
            m = self._evaluate(self.global_params, self.eval_data)
            m["round"] = rnd
            m["t"] = self.sim_time
            self.history.eval_metrics.append(m)


    # ------------------------------------------------------------------
    # event-driven async engine (config.async_mode)
    # ------------------------------------------------------------------
    def _abort_tick_server_restart(self, record: RoundRecord, crash) -> None:
        """Async twin of ``_abort_round_server_restart``: the crash also
        loses every in-flight update and the landed-but-unflushed buffer
        (they live in server memory)."""
        self._event_queue.clear()
        self._async_buffer.clear()
        self._in_flight.clear()
        self._abort_round_server_restart(record, crash)

    def _async_tick(self, job: FitJob, stacked, deltas, weights, rnd: int) -> bool:
        """Enqueue the tick's dispatched updates, then land queued events in
        delivery order until the buffer flushes (or the queue drains).
        Returns True when a flush advanced the model.

        - *Enqueue.* Each deliverable dispatch becomes a heap event at its
          absolute land time, carrying its delta, the model version current
          at dispatch (its staleness clock) and, in a grid, the provenance
          token the grid staged in ``_plane_row_keys``.
        - *Land.* Events pop in (t_land, seq) order; chaos ``alive()`` is
          checked again at LAND time, and a client dead by then drops its
          update.
        - *Flush.* At ``async_buffer_k`` buffered updates each is weighted
          by (1 + staleness)^-alpha, a Python float applied as ``d * w``
          (skipped where every weight is 1.0, which keeps degenerate async
          bitwise equal to sync), and the WHOLE buffer aggregates in one
          stacked pass: one ``fedavg_reduce`` launch per flush on the card.
          At most one flush per tick.
        - *Clock/breaker.* The clock advances to the last landed event; a
          tick landing nothing is a failed tick of deadline length and
          counts toward ``max_consecutive_failures``."""
        cfg = self.config
        record = job.record
        prov = self._plane_row_keys
        self._plane_row_keys = None
        if job.clients:
            if stacked is not None:
                deltas = tree_unstack(stacked)
            for j, (client, dt) in enumerate(zip(job.clients, job.arrivals)):
                ev = {
                    "client_id": client.client_id,
                    "slot": self._client_slot[id(client)],
                    "delta": deltas[j],
                    "weight": weights[j],
                    "version": self.model_version,
                    "prov": None if prov is None else prov[j],
                }
                heapq.heappush(self._event_queue, (record.t_start + float(dt), self._event_seq, ev))
                self._event_seq += 1
                self._in_flight.add(client.client_id)

        landed = 0
        dropped_dead = 0
        last_land: Optional[float] = None
        flush_time: Optional[float] = None
        while self._event_queue:
            t_land, _, ev = heapq.heappop(self._event_queue)
            self._in_flight.discard(ev["client_id"])
            last_land = t_land
            if not self.chaos.alive(t_land, ev["client_id"]):
                # mid-flight death: dispatched (and billed) but gone at land
                dropped_dead += 1
                continue
            ev["t_land"] = t_land
            self._async_buffer.append(ev)
            landed += 1
            if len(self._async_buffer) >= cfg.async_buffer_k:
                flush_time = t_land
                break
        record.delivered = landed
        if dropped_dead:
            record.metrics["async_dropped_dead"] = float(dropped_dead)

        self._last_flush = None
        if flush_time is not None:
            buf = self._async_buffer
            self._async_buffer = []
            stales = [self.model_version - e["version"] for e in buf]
            ws = [(1.0 + s) ** (-cfg.staleness_alpha) for s in stales]
            if any(w != 1.0 for w in ws):
                scaled = [tree_map(lambda d, _w=w: d * _w, e["delta"]) for e, w in zip(buf, ws)]
            else:
                scaled = [e["delta"] for e in buf]  # w == 1.0: skip the multiply
            bw = [e["weight"] for e in buf]
            if cfg.batched:
                self.global_params = self.strategy.aggregate_stacked(
                    self.global_params, tree_stack(scaled), bw, rnd
                )
            else:
                self.global_params = self.strategy.aggregate(self.global_params, scaled, bw, rnd)
            self.model_version += 1
            record.metrics["async_flush_size"] = float(len(buf))
            self._last_flush = {
                "version": self.model_version,
                "opaque": any(e["prov"] is None for e in buf),
                # flush identity for grid provenance: which updates, how
                # stale, at what weight
                "events": tuple((e["prov"], int(s), float(w)) for e, s, w in zip(buf, stales, bw)),
            }

        if landed > 0:
            self.sim_time = max(
                self.sim_time, flush_time if flush_time is not None else last_land
            )
            self.consecutive_failures = 0
            record.t_end = self.sim_time
            self.history.rounds.append(record)
        else:
            self._fail_round(record, cause="no_updates")
        return flush_time is not None

    def run(
        self,
        *,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        checkpoint_keep: int = 3,
        stop_after_round: Optional[int] = None,
    ) -> History:
        """Drive the configured number of rounds (sync) or ticks (async).

        ``checkpoint_dir`` makes the run crash-consistent: every
        ``checkpoint_every`` rounds the full boundary state persists
        (params, residual plane, RNG cursors, history, client state,
        compressor draw counters and, async, the event queue, buffer and
        staleness clocks), and a re-invocation with the same directory
        resumes at the first unfinished round, bitwise equal to the
        uninterrupted run. ``stop_after_round=k`` exits cleanly once round
        k completes."""
        mgr: Optional[CheckpointManager] = None
        start_round = 0
        if checkpoint_dir is not None:
            self._check_checkpointable()
            mgr = CheckpointManager(checkpoint_dir, keep=checkpoint_keep)
            start_round = self._restore_checkpoint(mgr)
        end_round = (
            self.config.rounds
            if stop_after_round is None
            else min(self.config.rounds, stop_after_round)
        )
        for rnd in range(start_round, end_round):
            if self.terminated:
                break
            job = self.begin_round(rnd)
            if job is not None:
                self.finish_round(job, *self.execute_fit(job))
            if mgr is not None and (rnd + 1) % checkpoint_every == 0:
                self._save_checkpoint(mgr, rnd + 1)
        return self.history

    # ------------------------------------------------------------------
    # round-boundary checkpoint protocol (per point; the grid engine
    # composes the same building blocks across points)
    # ------------------------------------------------------------------
    def _check_checkpointable(self) -> None:
        comp = self.compressor
        if (
            comp.name != "none"
            and not comp.fingerprint
            and (comp.state_get is None or comp.state_set is None)
        ):
            raise ValueError(
                f"checkpoint_dir: compressor {comp.name!r} carries "
                "Python-side state (empty fingerprint) without state_get/"
                "state_set accessors, so the round-boundary checkpoint "
                "cannot capture it"
            )

    def _checkpoint_fingerprint(self) -> Dict[str, Any]:
        cfg = self.config
        return {
            "kind": "point",
            "seed": int(cfg.seed),
            "rounds": int(cfg.rounds),
            "n_clients": len(self.clients),
            "async_mode": bool(cfg.async_mode),
            "async_buffer_k": int(cfg.async_buffer_k),
            "strategy": self.strategy.name,
            "compressor": self.compressor.name,
        }

    def _device(self) -> torch.device:
        return tree_leaves(self.global_params)[0].device

    def checkpoint_arrays(self) -> Dict[str, Any]:
        """The boundary state that lives in tensors: params, the residual
        plane, per-client sequential residuals and, async, the delta trees
        riding in the event queue and the flush buffer."""
        node: Dict[str, Any] = {"params": self.global_params}
        if self._residual_plane is not None:
            # dense: the full buffer; sparse: occupied rows compacted in
            # row order (their slots ride the manifest's slot_maps entry)
            node["residual"] = self._residual_plane.state_arrays()
        if self.strategy.server_state is not None:
            node["server_state"] = self.strategy.server_state
        cres = {
            f"c{j}": c.residual for j, c in self._slotted_state_clients() if c.residual is not None
        }
        if cres:
            node["cres"] = cres
        if self._event_queue:
            node["evq"] = {f"e{n}": ev["delta"] for n, (_, _, ev) in enumerate(self._event_queue)}
        if self._async_buffer:
            node["evb"] = {f"b{n}": ev["delta"] for n, ev in enumerate(self._async_buffer)}
        return node

    def checkpoint_meta(self) -> Dict[str, Any]:
        """JSON-safe boundary state: clocks, RNG cursors, history, client
        state, compressor draw counters, and the async queue/buffer
        descriptors (their delta trees live in ``checkpoint_arrays``).
        Every number is a Python float or int, so a restore is bitwise."""
        h = self.history

        def _ev_meta(t_land, seq, ev):
            return {
                "t_land": float(t_land),
                "seq": int(seq),
                "client_id": int(ev["client_id"]),
                "slot": int(ev["slot"]),
                "weight": _jsonable(ev["weight"]),
                "version": int(ev["version"]),
                "prov": ev["prov"],
            }

        def _client_meta(c):
            return {
                "connected": bool(c.connected),
                "rounds_participated": int(c.rounds_participated),
                "bytes_sent": int(c.bytes_sent),
            }

        comp_state = self.compressor.state_get() if self.compressor.state_get is not None else None
        lazy = self._population is not None
        return {
            "sim_time": float(self.sim_time),
            "consecutive_failures": int(self.consecutive_failures),
            "terminated": bool(self.terminated),
            "status": h.status,
            "cause": h.cause,
            "rng_state": _jsonable(self.rng.bit_generator.state),
            "transport_rng_state": (
                _jsonable(self._transport_rng.bit_generator.state)
                if self._transport_rng is not None
                else None
            ),
            # list universes save every client; lazy populations only the
            # touched ones, keyed by slot
            "clients": None if lazy else [_client_meta(c) for c in self.clients],
            "clients_sparse": (
                {str(j): _client_meta(c) for j, c in self._slotted_state_clients()}
                if lazy
                else None
            ),
            "rounds": [_jsonable(dataclasses.asdict(r)) for r in h.rounds],
            "eval_metrics": [_jsonable(m) for m in h.eval_metrics],
            "has_residual": self._residual_plane is not None,
            "residual_plane": (
                self._residual_plane.state_meta() if self._residual_plane is not None else None
            ),
            "has_server_state": self.strategy.server_state is not None,
            "residual_clients": [
                j for j, c in self._slotted_state_clients() if c.residual is not None
            ],
            "compressor_state": _jsonable(comp_state),
            # async: the staleness clock, the dispatch sequence cursor, and
            # the queue/buffer in HEAP-LIST order (the same list restores
            # the same heap)
            "model_version": int(self.model_version),
            "event_seq": int(self._event_seq),
            "queue": [_ev_meta(t, s, ev) for t, s, ev in self._event_queue],
            "buffer": [_ev_meta(ev["t_land"], -1, ev) for ev in self._async_buffer],
        }

    def checkpoint_template(self, mp: Dict[str, Any]) -> Dict[str, Any]:
        """Array-tree template matching ``checkpoint_arrays`` for a fresh
        server, shaped from the saved metadata."""
        device = self._device()
        node: Dict[str, Any] = {"params": self.global_params}
        if mp["has_residual"]:
            node["residual"] = StatePlane.template_arrays(
                self.global_params, len(self.clients), mp.get("residual_plane"), device=device
            )
        if mp["has_server_state"]:
            # init makes the state on the params' device, so load_tree
            # brings the saved leaves onto the server's device
            node["server_state"] = self.strategy.server_opt.init(self.global_params)
        if mp.get("residual_clients"):
            f32 = tree_map(
                lambda l: torch.zeros(l.shape, dtype=torch.float32, device=device),
                self.global_params,
            )
            node["cres"] = {f"c{j}": f32 for j in mp["residual_clients"]}
        zeros = tree_map(torch.zeros_like, self.global_params)
        if mp.get("queue"):
            node["evq"] = {f"e{n}": zeros for n in range(len(mp["queue"]))}
        if mp.get("buffer"):
            node["evb"] = {f"b{n}": zeros for n in range(len(mp["buffer"]))}
        return node

    def apply_checkpoint(
        self,
        mp: Dict[str, Any],
        tree: Dict[str, Any],
        slot_maps: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Restore the boundary state captured by ``checkpoint_arrays`` +
        ``checkpoint_meta`` onto this (freshly constructed) server.

        ``slot_maps`` carries the manifest's slot-map entry: for sparse
        planes, the slot each saved row belongs to. The restore is
        storage-agnostic, so dense checkpoints resume into sparse runs and
        vice versa, bitwise on every History observable. Arrays come back
        onto the server's device."""
        device = self._device()

        def on_device(t):
            return tree_map(lambda l: torch.as_tensor(l).to(device), t)

        self.global_params = on_device(tree["params"])
        if mp["has_residual"]:
            self._residual_plane = StatePlane.from_checkpoint(
                self.global_params,
                len(self.clients),
                mp.get("residual_plane"),
                tree["residual"],
                storage=self.config.state_plane,
                slots=(slot_maps or {}).get("residual"),
                device=device,
            )
        if mp["has_server_state"]:
            self.strategy.server_state = on_device(tree["server_state"])
        for j in mp.get("residual_clients", []):
            self._client_at(j).residual = on_device(tree["cres"][f"c{j}"])
        self.sim_time = float(mp["sim_time"])
        self.consecutive_failures = int(mp["consecutive_failures"])
        self.terminated = bool(mp["terminated"])
        self.history.status = mp["status"]
        self.history.cause = mp["cause"]
        self.history.rounds = [RoundRecord(**r) for r in mp["rounds"]]
        self.history.eval_metrics = [dict(m) for m in mp["eval_metrics"]]
        self.rng.bit_generator.state = mp["rng_state"]
        if mp["transport_rng_state"] is not None:
            self._transport_rng = np.random.default_rng()
            self._transport_rng.bit_generator.state = mp["transport_rng_state"]
        if mp.get("clients") is not None:
            for c, cs in zip(self.clients, mp["clients"]):
                c.connected = bool(cs["connected"])
                c.rounds_participated = int(cs["rounds_participated"])
                c.bytes_sent = int(cs["bytes_sent"])
        for j, cs in (mp.get("clients_sparse") or {}).items():
            c = self._client_at(int(j))
            c.connected = bool(cs["connected"])
            c.rounds_participated = int(cs["rounds_participated"])
            c.bytes_sent = int(cs["bytes_sent"])
        if mp.get("compressor_state") is not None and self.compressor.state_set is not None:
            self.compressor.state_set(mp["compressor_state"])
        # async engine state
        self.model_version = int(mp.get("model_version", 0))
        self._event_seq = int(mp.get("event_seq", 0))

        def _ev(em, delta):
            return {
                "client_id": int(em["client_id"]),
                "slot": int(em["slot"]),
                "delta": delta,
                "weight": em["weight"],
                "version": int(em["version"]),
                "prov": em["prov"],
            }

        self._event_queue = [
            (float(em["t_land"]), int(em["seq"]), _ev(em, on_device(tree["evq"][f"e{n}"])))
            for n, em in enumerate(mp.get("queue", []))
        ]
        self._async_buffer = []
        for n, em in enumerate(mp.get("buffer", [])):
            ev = _ev(em, on_device(tree["evb"][f"b{n}"]))
            ev["t_land"] = float(em["t_land"])
            self._async_buffer.append(ev)
        self._in_flight = {ev["client_id"] for _, _, ev in self._event_queue}

    def checkpoint_slot_maps(self) -> Dict[str, Any]:
        """Manifest ``slot_maps`` entry: per-plane slot lists naming the slot
        of each saved row, in ``state_arrays`` row order. Dense planes save
        nothing (row i IS slot i)."""
        if self._residual_plane is not None and self._residual_plane.storage == "sparse":
            return {"residual": self._residual_plane.slot_list()}
        return {}

    def _save_checkpoint(self, mgr: CheckpointManager, next_round: int) -> None:
        mgr.save(
            next_round,
            self.checkpoint_arrays(),
            metadata={
                "next_round": int(next_round),
                "fingerprint": self._checkpoint_fingerprint(),
                "point": self.checkpoint_meta(),
            },
            slot_maps=self.checkpoint_slot_maps(),
        )

    def _restore_checkpoint(self, mgr: CheckpointManager) -> int:
        step = mgr.latest_step()
        if step is None:
            return 0
        meta = mgr.metadata(step)
        if meta["fingerprint"] != self._checkpoint_fingerprint():
            raise ValueError(
                "checkpoint_dir holds a checkpoint from a DIFFERENT run "
                f"(saved {meta['fingerprint']!r} vs this server "
                f"{self._checkpoint_fingerprint()!r}); refusing to mix"
            )
        mp = meta["point"]
        tree, _ = load_tree(mgr._step_dir(step), self.checkpoint_template(mp))
        self.apply_checkpoint(mp, tree, slot_maps=mgr.slot_maps(step))
        return int(meta["next_round"])


def _jsonable(v):
    """numpy and torch scalars -> Python numbers, tuples -> lists,
    recursively: round-boundary metadata must survive a JSON round trip
    bit-exactly (floats are IEEE-exact through json)."""
    if isinstance(v, torch.Tensor):
        return _jsonable(v.item())
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v
