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
``engine="fused_transport"`` and every compressor, with error feedback in
a dense or sparse ``StatePlane``; configurations it does not cover raise
``NotImplementedError``, naming the ROADMAP item.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.chaos import ChaosSchedule
from repro_torch.compress import Compressor, none_compressor
from repro_torch.core.client import EdgeClient, LocalTask
from repro_torch.core.stateplane import StatePlane
from repro_torch.core.strategy import Strategy
from repro_torch.transport import LinkProfile, TcpParams, client_round as analytic_round
from repro_torch.transport.des import sim_client_round, sim_cohort_round, sim_grid_round
from repro_torch.transport.params import RetryPolicy
from repro_torch.utils import tree_leaves, tree_stack, tree_unstack


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
    """Every field of the reference's config. The port runs the synchronous
    engines; ``async_mode`` and ``transport_backend="device"`` raise
    ``NotImplementedError`` (see ``repro.core.server.ServerConfig`` for the
    full semantics of each field)."""

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
    # event-driven asynchronous engine (not ported yet)
    async_mode: bool = False
    staleness_alpha: float = 0.5
    async_buffer_k: int = 1
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
    # where stochastic transport is sampled: "host" (numpy); "device" is
    # not ported yet
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
        if self.async_mode:
            raise NotImplementedError(
                "async_mode is not ported yet (ROADMAP Queue 1, item 11)"
            )
        if self.transport_backend == "device":
            raise NotImplementedError(
                "transport_backend='device' is not ported yet (ROADMAP Queue 1, item 13)"
            )


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
# layer existed.
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
        if not isinstance(clients, list):
            raise NotImplementedError(
                "lazy client populations are not ported yet (ROADMAP Queue 1, "
                "item 12); pass a list of EdgeClient"
            )
        if strategy.server_opt is not None:
            raise NotImplementedError(
                f"strategy {strategy.name!r} uses a server-side optimizer, "
                "which is not ported yet (ROADMAP Queue 1, item 5)"
            )
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
        self.global_params = task.init_fn(torch.Generator().manual_seed(config.seed))
        # plane-resident error feedback: a StatePlane of per-client f32
        # residual rows (dense or sparse per config.state_plane), allocated
        # on the first compressed stacked round. The sequential engine keeps
        # per-client EdgeClient.residual.
        self._residual_plane: Optional[StatePlane] = None
        self.history = History()
        self.sim_time = 0.0
        self.consecutive_failures = 0
        self.terminated = False

    # ------------------------------------------------------------------
    @property
    def split_streams(self) -> bool:
        """True when selection/plan draws and transport draws come from the
        two derived per-round streams (see ServerConfig.rng_streams)."""
        return self.config.rng_streams == "split" or self.config.engine == "fused_transport"

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
            for c in self.clients:
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
        for c in self.clients:
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
        n_total = len(self.clients)
        live = [c for c in self.clients if self.chaos.alive(t, c.client_id)]
        quorum = self.strategy.quorum(n_total)
        record = RoundRecord(rnd, t, t, 0, 0, False, 0.0)
        if len(live) < quorum:
            # Flower blocks until min_fit clients are available; account
            # the wait as a failed round of deadline length
            self._fail_round(record, cause="no_live_quorum")
            return None
        k = max(quorum, int(round(cfg.clients_per_round * len(live))))
        k = min(int(round(k * max(cfg.over_provision, 1.0))), len(live))
        idx = self.rng.choice(len(live), size=k, replace=False)
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

    def run_transport(self, pending: PendingRound):
        """Sample the pending round's transport on this server's streams:
        the batched cohort draw or the sequential per-client loop. Returns
        (completed [k], times [k], reconnects [k], bytes_acked [k])."""
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
        list universes key them by ``client_id``. ``StatePlane.rows_for``
        maps them to physical buffer rows."""
        return [c.client_id for c in clients]

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
        round_time = min(max(job.arrivals), cfg.round_deadline)
        # fault domain, checked before any state mutates: a server crash
        # inside the round span loses the round outright; a non-finite
        # loss/delta rejects it
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

    def run(self, *, checkpoint_dir: Optional[str] = None,
            stop_after_round: Optional[int] = None) -> History:
        """Drive the configured number of rounds; ``stop_after_round=k``
        exits cleanly once round k completes."""
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint_dir is not ported yet (ROADMAP Queue 1, item 10)"
            )
        end_round = (
            self.config.rounds
            if stop_after_round is None
            else min(self.config.rounds, stop_after_round)
        )
        for rnd in range(end_round):
            if self.terminated:
                break
            job = self.begin_round(rnd)
            if job is not None:
                self.finish_round(job, *self.execute_fit(job))
        return self.history
