"""Scenario-parallel sweep engine: whole characterization grids as one
plane (the port of ``repro/core/grid.py``).

The paper's contribution is a *characterization methodology* — grids over
one-way delay, packet loss, and client dropout (Fig. 3-5, Table III).
``run_fl_grid`` evaluates every sweep point of such a grid concurrently:
per round, each point's cohort selection and transport sampling run on the
point's OWN seeded RNG stream (exactly as a per-point ``FederatedServer``
run would consume it), then the union of all points' local-training rows
— one row per (global params, client, batch plan) — executes as one plane
dispatch through ``LocalTask.fit_rows``.

Two properties make grid results exactly reproduce per-point runs at a
fixed seed:

1. *Row independence.* A row's delta is the same bits whatever the
   dispatch width and wherever the row sits: the plane program reduces
   nothing across rows and runs every dispatch as fixed-width row chunks,
   so each library call sees one shape (``repro_torch.core.client``,
   ``_ROW_CHUNK``).
2. *Stream discipline.* The grid engine drives each point through the same
   ``select_cohort``/``finish_transport``/``finish_round`` code the
   per-point engine runs, with a per-point ``np.random.Generator``; only
   the local-fit execution is hoisted into the shared plane.

On top of exactness, the engine exploits the defining redundancy of
characterization sweeps: at a fixed seed, many points share identical
training trajectories (a latency grid changes the *clock*, not the
*gradients*, wherever every client still delivers). Rows are therefore
COALESCED by a parameter-provenance key — (anchor provenance, batch-plan
digest, steps, mu) — so shared trajectories are computed once per round,
and eval is memoized on the same provenance. Points diverge (different
deliveries, different aggregation) and their rows stop coalescing;
correctness never depends on the sweep's structure.

Compressed points share too: plane-capable compressors (``fingerprint`` +
``compress_plane``) evolve a RESIDUAL provenance key alongside the params
key, and points whose compression provenance coincides share one
``compress_rows`` pass per round. Only the stateful randk forces opacity.

Anchor transfer is O(unique anchors), not O(rows): each dispatch stacks
the distinct anchor trees its rows reference, and rows gather their
anchor on the device (``fit_rows(anchor_idx=...)``).

Async points join the same plane: each dispatched row gets a provenance
token that rides the event queue, and a point's params key advances when a
buffer flush applies its events (``_async_prov_hook``). ``checkpoint_dir``
makes a sweep crash-consistent with the per-point checkpoint protocol of
``FederatedServer`` plus the provenance keys. Device-backend points share
one device transport plane pass per round in ``fused`` mode.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.chaos import ChaosSchedule
from repro_torch.checkpoint.store import CheckpointManager, load_tree
from repro_torch.core.client import EdgeClient, LocalTask
from repro_torch.core.server import (
    _GRID_STREAM,
    _GRID_ZR_STREAM,
    FederatedServer,
    History,
    PendingRound,
    ServerConfig,
    _jsonable,
    derive_rng,
)
from repro_torch.core.strategy import Strategy
from repro_torch.transport import TcpParams
from repro_torch.transport.des import sim_grid_round
from repro_torch.transport.plane import sim_grid_round_device, transport_plane_key
from repro_torch.utils import tree_leaves, tree_map


@dataclass
class GridPoint:
    """One sweep point: the arguments a per-point FederatedServer takes.

    ``clients`` must be fresh EdgeClient objects per point (connection and
    participation state is per-point), but their ``dataset`` objects should
    be SHARED across points wherever the underlying shards are identical —
    row coalescing keys on dataset identity."""

    clients: List[EdgeClient]
    strategy: Strategy
    tcp: TcpParams
    chaos: ChaosSchedule
    config: ServerConfig
    compressor: Optional[Any] = None
    name: str = ""


@dataclass
class GridStats:
    """Plane/coalescing telemetry for one grid run (every field of the
    reference's)."""

    rounds: int = 0  # lockstep rounds with at least one plane row
    fit_rows_total: int = 0  # rows requested across all points
    fit_rows_unique: int = 0  # rows actually dispatched (pre-padding)
    plane_dispatches: int = 0
    anchor_rows_stacked: int = 0  # unique anchors stacked across dispatches
    evals_requested: int = 0
    evals_computed: int = 0
    compress_requested: int = 0  # compressed point-rounds
    compress_computed: int = 0  # heavy compress_rows programs actually run
    transport_dispatches: int = 0  # hoisted host sim_grid_round calls
    transport_device_dispatches: int = 0  # hoisted device-plane programs
    transport_rows: int = 0  # (point, client) rows sampled through them
    async_flushes: int = 0  # async buffer flushes across all points
    quarantined: int = 0  # points ending with status "diverged"
    server_restarts: int = 0  # rounds lost to server_restart events
    checkpoints_saved: int = 0
    resumed_round: int = 0  # first round this run executed (0 = fresh)


@dataclass
class GridResult:
    histories: List[History]
    stats: GridStats
    servers: List[FederatedServer]  # post-run per-point state (inspection)


def _gather_rows(planes, chunk: int, idxs: List[int]):
    """Collect plane rows ``idxs`` (global row numbers, delivery order)
    from per-chunk plane outputs. Returns (stacked [D,...], n_ex, metrics).

    Row order is preserved exactly: aggregation reduces over the client
    axis, so the stacked deltas must line up with the per-point engine's
    delivery order for bit-identical weighted means. Each segment is one
    ``index_select`` per leaf with one index tensor, copied to the device
    without waiting for it."""
    segments: List[List[int]] = [[idxs[0]]]
    for k in idxs[1:]:
        if k // chunk == segments[-1][-1] // chunk:
            segments[-1].append(k)
        else:
            segments.append([k])
    trees, n_out, m_out = [], [], []
    for seg in segments:
        ci = seg[0] // chunk
        plane, n_ex, mets = planes[ci]
        lis = [k - ci * chunk for k in seg]
        device = tree_leaves(plane)[0].device
        sel = torch.as_tensor(lis, dtype=torch.int64).to(device, non_blocking=True)
        trees.append(tree_map(lambda l: l.index_select(0, sel), plane))
        n_out += [n_ex[li] for li in lis]
        m_out += [mets[li] for li in lis]
    if len(trees) == 1:
        return trees[0], n_out, m_out
    stacked = tree_map(lambda *ls: torch.cat(ls, dim=0), *trees)
    return stacked, n_out, m_out


def _plane_transport(
    waiting: List[Tuple[int, PendingRound]],
    servers: List[FederatedServer],
    mode: str,
    transport_seed: int,
    rnd: int,
    stats: GridStats,
):
    """Sample every waiting point's cohort transport as ONE plane pass per
    partition: rows are (point, cohort member) pairs, each row carrying its
    point's TcpParams, effective link, and asymmetric payload bytes
    (compressed upload, full-model download). Cohort sizes may differ
    across points — the plane is ragged-aware.

    ``mode="parity"`` hands each scenario its point's OWN derived
    per-round transport stream (``FederatedServer._transport_rng``), so
    outcomes are bitwise identical to each point sampling its transport
    standalone (host-backend points only: a device-backend point's
    per-point reference is the device plane, so ``_hoistable`` leaves it on
    its own path). ``mode="fused"`` drives the whole plane from one shared
    stream derived from (transport_seed, round) — one lockstep pass, same
    mechanisms and distributions, a single shared draw order. Fused mode
    partitions points by ``transport_backend``: host points share one numpy
    ``sim_grid_round`` pass, device points one ``sim_grid_round_device``
    pass on the points' device, whose outcomes come to the host in one copy
    per field. The fused HOST pass is further partitioned by reliability
    kind: points whose profile is ``zero_rtt`` or whose retry resumes from
    the acked frontier take a separate pass on their own stream tag
    (``_GRID_ZR_STREAM``) — their stage masks consume the shared stream in
    a different subset order, and the split keeps plain restart-from-zero
    TCP points' fused outcomes unchanged by their presence. The device
    plane needs no such split.

    Returns per-point (success [k], time [k], reconnects [k],
    bytes_acked [k]) tuples in ``waiting`` order, ready for
    ``finish_transport``."""

    def _reliability(srv: FederatedServer) -> bool:
        r = srv._effective_retry()
        return bool(srv.tcp.zero_rtt or (r is not None and r.resume))

    def _sample(sub: List[Tuple[int, PendingRound]], backend: str, stream: int):
        tcps = [servers[i].tcp for i, _ in sub]
        links = [pr.links for _, pr in sub]
        up = [np.full(len(pr.cohort), pr.upload_bytes, np.int64) for _, pr in sub]
        down = [np.full(len(pr.cohort), pr.download_bytes, np.int64) for _, pr in sub]
        ltt = [pr.local_times for _, pr in sub]
        conn = [pr.connected for _, pr in sub]
        # per-scenario retry ladder: each point's own policy (deadline-cap
        # resolved), exactly what its standalone transport would apply
        retry = [servers[i]._effective_retry() for i, _ in sub]
        if backend == "device":
            out = sim_grid_round_device(
                tcps,
                links,
                update_bytes=up,
                download_bytes=down,
                local_train_times=ltt,
                connected=conn,
                # _GRID_STREAM on the device key family: decorrelated from
                # every point's private per-round device stream by tag
                key=transport_plane_key(transport_seed, _GRID_STREAM, rnd),
                retry=retry,
                device=servers[sub[0][0]]._device(),
            )
            stats.transport_device_dispatches += 1
            # one copy per field for the round's host bookkeeping
            return (
                out.success.cpu().numpy(),
                out.time.cpu().numpy().astype(float),
                out.reconnects.cpu().numpy(),
                out.bytes_acked.cpu().numpy().astype(float),
            )
        if mode == "parity":
            rng_kw = dict(rngs=[servers[i]._transport_rng for i, _ in sub])
        else:
            # _GRID_STREAM/_GRID_ZR_STREAM, not _TRANSPORT_STREAM: the
            # shared plane stream must be decorrelated from every point's
            # private transport stream even when transport_seed equals
            # the points' seeds
            rng_kw = dict(rng=derive_rng(transport_seed, stream, rnd))
        out = sim_grid_round(
            tcps,
            links,
            update_bytes=up,
            download_bytes=down,
            local_train_times=ltt,
            connected=conn,
            retry=retry,
            **rng_kw,
        )
        stats.transport_dispatches += 1
        return out.success, out.time, out.reconnects, out.bytes_acked

    res: List[Optional[tuple]] = [None] * len(waiting)
    if mode == "fused":
        partitions = [("host", _GRID_STREAM, lambda srv: not _reliability(srv)),
                      ("host", _GRID_ZR_STREAM, _reliability)]
    else:
        # parity mode hands every scenario its point's own rng — no shared
        # stream to protect, one pass covers all kinds
        partitions = [("host", _GRID_STREAM, lambda srv: True)]
    partitions.append(("device", _GRID_STREAM, lambda srv: True))
    for backend, stream, member in partitions:
        sub = [
            (pos, iw)
            for pos, iw in enumerate(waiting)
            if servers[iw[0]].config.transport_backend == backend and member(servers[iw[0]])
        ]
        if not sub:
            continue
        succ, tt, rc, ba = _sample([iw for _, iw in sub], backend, stream)
        for s, (pos, (_, pr)) in enumerate(sub):
            k = len(pr.cohort)
            res[pos] = (
                succ[s][:k],
                tt[s][:k],
                rc[s][:k].astype(float),
                np.asarray(ba[s][:k], float),
            )
    return res


def _check_checkpointable(servers: List[FederatedServer]) -> None:
    # stateful compressors are fine as long as they expose state accessors
    # (randk's rotating counter); the per-point check decides
    for i, srv in enumerate(servers):
        try:
            srv._check_checkpointable()
        except ValueError as e:
            raise ValueError(f"point {i}: {e}") from None


def run_fl_grid(
    task: LocalTask,
    points: Sequence[GridPoint],
    *,
    eval_data: Optional[Dict[str, np.ndarray]] = None,
    coalesce: bool = True,
    max_plane_rows: int = 64,
    transport: str = "per_point",
    transport_seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    checkpoint_keep: int = 3,
    stop_after_round: Optional[int] = None,
) -> GridResult:
    """Run every sweep point of a characterization grid in lockstep.

    Returns per-point ``History`` objects identical (bitwise, at a fixed
    seed) to running each point through ``FederatedServer.run`` with
    ``batched=True``. ``max_plane_rows`` caps one dispatch's row count.

    ``transport`` selects where stochastic transport is sampled:

    - ``"per_point"`` (default): each point samples its own transport
      inside ``begin_round``.
    - ``"parity"``: eligible points (``stochastic=True``, ``batched=True``,
      split RNG streams) defer transport; the engine samples all of them
      as one ``sim_grid_round(rngs=...)`` call per round, each scenario on
      its point's own derived stream — bitwise identical to "per_point".
    - ``"fused"``: same hoist, but the whole (point x client) plane runs
      one lockstep pass on a single stream derived from
      ``(transport_seed, round)``: distribution-equivalent, not
      draw-for-draw. Selection streams are unaffected either way.

    Ineligible points fall back to "per_point" transparently in both
    hoisted modes.

    **Crash consistency.** ``checkpoint_dir`` makes the sweep resumable:
    every ``checkpoint_every`` rounds the engine persists each point's
    round-boundary state (``FederatedServer.checkpoint_arrays`` /
    ``checkpoint_meta``, async queue and buffer included) plus the
    provenance keys and ``GridStats``, and a re-invocation with the same
    directory resumes at the first unfinished round, bitwise equal to the
    uninterrupted run. A checkpoint written by a different grid raises.
    ``stop_after_round=k`` exits cleanly once round k has completed (and
    checkpointed)."""
    if transport not in ("per_point", "parity", "fused"):
        raise ValueError(f"unknown transport mode {transport!r}")
    stats = GridStats()
    nonce = itertools.count()
    interned: Dict[Any, int] = {}

    def intern(key) -> int:
        v = interned.get(key)
        if v is None:
            v = len(interned)
            interned[key] = v
        return v

    # params provenance per point: equal keys => bitwise-equal global
    # params (same init, same aggregation chain over the same rows).
    # res_keys mirrors it for the compression error-feedback plane: equal
    # keys => bitwise-equal residual state (same compressor, same chain of
    # (rows, delivering slots) updates from zeros).
    params_keys: List[int] = []
    res_keys: List[int] = []
    eval_cache: Dict[Tuple[int, int], Dict[str, float]] = {}
    servers: List[FederatedServer] = []

    def make_eval(i: int):
        def _eval(params, data):
            stats.evals_requested += 1
            key = (params_keys[i], id(data))
            hit = eval_cache.get(key)
            if hit is None:
                hit = task.evaluate(params, data)
                eval_cache[key] = hit
                stats.evals_computed += 1
            return dict(hit)  # finish_round annotates the dict in place

        return _eval

    for i, p in enumerate(points):
        servers.append(
            FederatedServer(
                task,
                p.clients,
                p.strategy,
                tcp=p.tcp,
                chaos=p.chaos,
                config=p.config,
                compressor=p.compressor,
                eval_data=eval_data,
                eval_fn=make_eval(i),
            )
        )
        params_keys.append(intern(("init", id(task), p.config.seed)))
        res_keys.append(intern(("res0", servers[-1].compressor.fingerprint)))

    def _async_prov_hook(i: int):
        """Advance point i's params provenance at buffer-flush time.

        ``finish_round`` calls it right after ``_async_tick`` and before the
        memoized eval. No flush: the key stands. A flush whose events all
        carry provenance tokens digests to ("agg-async", prior key,
        aggregation identity, the (token, staleness, weight) events, alpha,
        round), so twin async points keep bitwise-equal params and share
        eval."""

        def hook(srv: FederatedServer, rnd: int) -> None:
            fl = srv._last_flush
            if fl is None:
                return
            stats.async_flushes += 1
            if fl["opaque"]:
                params_keys[i] = intern(("opaque", next(nonce)))
            else:
                params_keys[i] = intern((
                    "agg-async",
                    params_keys[i],
                    srv.strategy.agg_fingerprint,
                    fl["events"],
                    float(srv.config.staleness_alpha),
                    rnd,
                    bool(srv.config.batched),
                ))

        return hook

    for i, srv in enumerate(servers):
        if srv.config.async_mode:
            srv._async_prov_hook = _async_prov_hook(i)

    plane_ok = (
        task.plan_fit is not None
        and task.fit_rows is not None
        and task.plan_digest is not None
    )
    max_rounds = max((p.config.rounds for p in points), default=0)
    hoist = transport in ("parity", "fused")

    def _hoistable(srv: FederatedServer) -> bool:
        # the hoist reproduces the BATCHED cohort draw discipline, and a
        # point's selection stream only survives it under the split-rng
        # contract; everything else keeps sampling inside begin_round.
        # Parity mode is defined as bitwise per-point reproduction, and a
        # device-backend point's per-point reference is the device plane
        # keyed on its own (seed, stream, round) — a hoisted pass on the
        # grid's key cannot reproduce it, so such points stay on their own
        # path.
        if transport == "parity" and srv.config.transport_backend == "device":
            return False
        return srv.config.stochastic and srv.config.batched and srv.split_streams

    def _round(rnd: int) -> None:
        # --- per-point pre phase: selection on the point's own RNG stream;
        # transport inline (per_point) or deferred to the shared plane ------
        jobs = []  # (point_idx, FitJob)
        waiting = []  # (point_idx, PendingRound) awaiting plane transport
        for i, srv in enumerate(servers):
            if srv.terminated or rnd >= srv.config.rounds:
                continue
            if hoist and _hoistable(srv):
                pr = srv.select_cohort(rnd)
                if pr is not None:
                    if len(pr.cohort) == 0:
                        # async drain-only tick: nothing to sample; the tick
                        # still drains its event queue through finish_round
                        z = np.zeros(0)
                        job = srv.finish_transport(pr, np.zeros(0, bool), z, z, z)
                        if job is not None:
                            jobs.append((i, job))
                    else:
                        waiting.append((i, pr))
                continue
            job = srv.begin_round(rnd)
            if job is not None:
                jobs.append((i, job))

        # --- transport plane: ONE stochastic sim_grid_round for the round --
        if waiting:
            outcomes = _plane_transport(
                waiting, servers, transport, transport_seed, rnd, stats
            )
            stats.transport_rows += sum(len(pr.cohort) for _, pr in waiting)
            for (i, pr), (succ, tt, rc, ba) in zip(waiting, outcomes):
                job = servers[i].finish_transport(pr, succ, tt, rc, ba)
                if job is not None:
                    jobs.append((i, job))
            jobs.sort(key=lambda ij: ij[0])  # point order, deterministic

        pending = []  # (point_idx, FitJob, plans)
        for i, job in jobs:
            srv = servers[i]
            if not (plane_ok and srv.config.batched):
                # no plane path for this point/task: run it standalone
                stacked, deltas, weights, per_metrics = srv.execute_fit(job)
                params_keys[i] = intern(("opaque", next(nonce)))
                res_keys[i] = intern(("opaque", next(nonce)))
                srv.finish_round(job, stacked, deltas, weights, per_metrics)
                continue
            plans = task.plan_fit(job.clients, job.steps, srv.rng)
            pending.append((i, job, plans))
        if not pending:
            return
        stats.rounds += 1 if any(p[1].clients for p in pending) else 0

        # --- row table: coalesce identical rows across points ---------------
        # groups keyed by the plane program's static axes (steps, use_prox)
        groups: Dict[tuple, dict] = {}
        placements = []  # (point_idx, job, group_key, row idxs, row keys)
        for i, job, plans in pending:
            if not job.clients:
                # async drain-only tick (or a tick whose every flow failed):
                # no rows to place, the post phase still runs it
                placements.append((i, job, None, [], []))
                continue
            mu = float(job.prox_mu)
            gkey = (job.steps, mu > 0)
            g = groups.setdefault(
                gkey,
                {"index": {}, "aindex": {}, "anchors": [], "aidx": [],
                 "rows": [], "mus": []},
            )
            idxs, row_keys = [], []
            for client, plan in zip(job.clients, plans):
                stats.fit_rows_total += 1
                if coalesce:
                    rkey = (
                        params_keys[i],
                        task.plan_digest(client, plan),
                        job.steps,
                        mu,
                    )
                else:
                    rkey = ("row", next(nonce))
                j = g["index"].get(rkey)
                if j is None:
                    j = len(g["rows"])
                    g["index"][rkey] = j
                    # anchors dedupe on params provenance (equal keys =>
                    # bitwise-equal params); rows carry a gather index
                    ai = g["aindex"].get(params_keys[i])
                    if ai is None:
                        ai = len(g["anchors"])
                        g["aindex"][params_keys[i]] = ai
                        g["anchors"].append(servers[i].global_params)
                    g["aidx"].append(ai)
                    g["rows"].append((client, plan))
                    g["mus"].append(mu)
                idxs.append(j)
                row_keys.append(intern(rkey))
            placements.append((i, job, gkey, idxs, row_keys))

        # --- plane dispatch: one program per group chunk --------------------
        for gkey, g in groups.items():
            steps, use_prox = gkey
            rows = g["rows"]
            stats.fit_rows_unique += len(rows)
            planes = []
            for s in range(0, len(rows), max_plane_rows):
                sub = slice(s, s + max_plane_rows)
                # chunk-local anchor table: stack only the anchors this
                # chunk's rows reference
                local: Dict[int, int] = {}
                anchors_sub: List[Any] = []
                aidx_sub: List[int] = []
                for a in g["aidx"][sub]:
                    la = local.get(a)
                    if la is None:
                        la = len(anchors_sub)
                        local[a] = la
                        anchors_sub.append(g["anchors"][a])
                    aidx_sub.append(la)
                stats.anchor_rows_stacked += len(anchors_sub)
                plane, n_ex, mets = task.fit_rows(
                    anchors_sub, rows[sub], steps, g["mus"][sub], use_prox,
                    anchor_idx=aidx_sub,
                )
                planes.append((plane, n_ex, mets))
                stats.plane_dispatches += 1
            g["planes"] = planes

        # --- per-point post phase: scatter, aggregate, advance provenance ---
        # round-scoped memo for the heavy compress_rows program: points
        # whose compression provenance coincides (same compressor, same
        # residual chain, same rows on the same client slots) share ONE
        # top-k/quantize pass; each point still scatters its own residual
        # plane
        comp_memo: Dict[tuple, Any] = {}
        for i, job, gkey, idxs, row_keys in placements:
            srv = servers[i]
            if idxs:
                stacked, weights, per_metrics = _gather_rows(
                    groups[gkey]["planes"], max_plane_rows, idxs
                )
            else:  # async drain-only tick: no rows were placed
                stacked, weights, per_metrics = None, [], []
            # fault domain first, BEFORE the shared compression pass can
            # mutate this point's residual plane or provenance: a server
            # crash inside the round span loses the round (params and
            # residuals stay at the round boundary — params_keys/res_keys
            # unchanged); a quarantine trigger retires only this row of
            # the sweep, leaving every other point's dispatch untouched.
            # Async ticks use the deadline-horizon crash window, and the
            # async abort also voids the event queue and buffer.
            if srv.config.async_mode:
                crash = srv.chaos.server_restart_in(
                    job.record.t_start, job.record.t_start + srv.config.round_deadline
                )
                if crash is not None:
                    srv._abort_tick_server_restart(job.record, crash)
                    continue
                if srv.config.quarantine and job.clients:
                    cause = srv._divergence_cause(stacked, None, per_metrics)
                    if cause is not None:
                        srv._quarantine_round(job, cause)
                        continue
            else:
                round_time = min(max(job.arrivals), srv.config.round_deadline)
                crash = srv.chaos.server_restart_in(
                    job.record.t_start, job.record.t_start + round_time
                )
                if crash is not None:
                    srv._abort_round_server_restart(job.record, crash)
                    continue
                if srv.config.quarantine:
                    cause = srv._divergence_cause(stacked, None, per_metrics)
                    if cause is not None:
                        srv._quarantine_round(job, cause)
                        continue
            comp = srv.compressor
            # a compressor is provenance-shareable when its transform is a
            # deterministic function of (delta, residual) — fingerprinted
            # and plane-capable, so finish_round takes the stacked path
            comp_ok = comp.name == "none" or (
                bool(comp.fingerprint) and comp.compress_plane is not None
            )
            sharable = coalesce and comp_ok and bool(srv.strategy.agg_fingerprint)
            precompressed = False
            if sharable:
                comp_term = None
                if comp.name != "none" and job.clients:
                    # residual-digest term: the decompressed deltas (and
                    # the post-round residual plane) are determined by
                    # (compressor, prior residual provenance, the rows'
                    # content, which client slots they land on)
                    slots = tuple(srv.client_slots(job.clients))
                    ckey = (comp.fingerprint, res_keys[i], tuple(row_keys), slots)
                    stats.compress_requested += 1
                    plane_fn = comp.compress_plane
                    plane = srv._ensure_residual_plane()
                    # provenance (ckey) is keyed on SLOTS — stable client
                    # identities — while gather/scatter take physical
                    # buffer rows (identity under dense storage, compacted
                    # under sparse; values are slot-determined either way,
                    # so memo hits stay bitwise-safe)
                    rows_j = torch.as_tensor(
                        np.asarray(plane.rows_for(slots), np.int64),
                        device=tree_leaves(plane.buffer)[0].device,
                    )
                    hit = comp_memo.get(ckey)
                    if hit is None:
                        residual_rows = plane_fn.gather_rows(plane.buffer, rows_j)
                        hit = plane_fn.compress_rows(stacked, residual_rows)
                        comp_memo[ckey] = hit
                        stats.compress_computed += 1
                    x2_t, deq_t = hit
                    plane.buffer = plane_fn.scatter_rows(x2_t, deq_t, plane.buffer, rows_j)
                    stacked = plane_fn.finalize(stacked, deq_t)
                    precompressed = True
                    comp_term = ("comp", comp.fingerprint, res_keys[i], slots)
                    res_keys[i] = intern(
                        ("res", res_keys[i], comp.fingerprint, tuple(row_keys), slots)
                    )
                if srv.config.async_mode:
                    # async provenance is event-granular: each dispatched
                    # row gets a token identifying its delta bitwise (row
                    # content, compression applied at dispatch); the params
                    # key advances only when a flush applies them
                    srv._plane_row_keys = tuple(
                        intern(("prov", rk, comp_term)) for rk in row_keys
                    )
                else:
                    params_keys[i] = intern((
                        "agg",
                        params_keys[i],
                        srv.strategy.agg_fingerprint,
                        tuple(row_keys),
                        tuple(weights),
                        rnd,
                        bool(srv.config.batched),
                        comp_term,
                    ))
            else:
                if srv.config.async_mode:
                    srv._plane_row_keys = None  # events carry opaque prov
                else:
                    params_keys[i] = intern(("opaque", next(nonce)))
                res_keys[i] = intern(("opaque", next(nonce)))
            srv.finish_round(
                job, stacked, None, weights, per_metrics,
                precompressed=precompressed, fault_checked=True,
            )

    # --- crash consistency: round-boundary checkpoint save/restore --------
    fingerprint = {
        "n_points": len(points),
        "seeds": [int(p.config.seed) for p in points],
        "rounds": [int(p.config.rounds) for p in points],
        "names": [p.name for p in points],
        "transport": transport,
        "transport_seed": int(transport_seed),
        "coalesce": bool(coalesce),
        # async knobs change what the queue/buffer state MEANS
        "async": [[bool(p.config.async_mode), int(p.config.async_buffer_k)] for p in points],
    }

    def _save_checkpoint(mgr: CheckpointManager, next_round: int) -> None:
        # per-point boundary state from the server's own protocol, plus the
        # grid's provenance keys and slot maps, point-prefixed
        arrays: Dict[str, Any] = {}
        meta_points = []
        slot_maps: Dict[str, Any] = {}
        for i, srv in enumerate(servers):
            arrays[f"p{i:04d}"] = srv.checkpoint_arrays()
            mp = srv.checkpoint_meta()
            # only the equivalence classes of provenance keys matter, so the
            # saved ints round-trip as opaque tokens
            mp["params_key"] = int(params_keys[i])
            mp["res_key"] = int(res_keys[i])
            meta_points.append(mp)
            for k, v in srv.checkpoint_slot_maps().items():
                slot_maps[f"p{i:04d}/{k}"] = v
        mgr.save(
            next_round,
            arrays,
            metadata={
                "next_round": int(next_round),
                "grid": fingerprint,
                "stats": _jsonable(dataclasses.asdict(stats)),
                "points": meta_points,
            },
            slot_maps=slot_maps,
        )

    def _restore_checkpoint(mgr: CheckpointManager) -> int:
        step = mgr.latest_step()
        if step is None:
            return 0
        meta = mgr.metadata(step)
        if meta["grid"] != fingerprint:
            raise ValueError(
                "checkpoint_dir holds a checkpoint from a DIFFERENT grid "
                f"(saved {meta['grid']!r} vs this run {fingerprint!r}); "
                "refusing to mix sweeps"
            )
        template = {
            f"p{i:04d}": srv.checkpoint_template(meta["points"][i])
            for i, srv in enumerate(servers)
        }
        tree, _ = load_tree(mgr._step_dir(step), template)
        all_slot_maps = mgr.slot_maps(step)
        for i, srv in enumerate(servers):
            mp = meta["points"][i]
            prefix = f"p{i:04d}/"
            srv.apply_checkpoint(
                mp,
                tree[f"p{i:04d}"],
                slot_maps={
                    k[len(prefix):]: v for k, v in all_slot_maps.items() if k.startswith(prefix)
                },
            )
            # equal saved keys across points => equal restored tokens, so
            # trajectory sharing survives the resume (params provenance,
            # residual provenance and the per-event dispatch tokens still in
            # the async queue and buffer); the eval cache starts cold and
            # recomputes identical values
            for _, _, ev in srv._event_queue:
                if ev["prov"] is not None:
                    ev["prov"] = intern(("ckpt-prov", ev["prov"]))
            for ev in srv._async_buffer:
                if ev["prov"] is not None:
                    ev["prov"] = intern(("ckpt-prov", ev["prov"]))
            params_keys[i] = intern(("ckpt", mp["params_key"]))
            res_keys[i] = intern(("ckpt-res", mp["res_key"]))
        for k, v in meta["stats"].items():
            if hasattr(stats, k):
                setattr(stats, k, v)
        return int(meta["next_round"])

    mgr: Optional[CheckpointManager] = None
    start_round = 0
    if checkpoint_dir is not None:
        _check_checkpointable(servers)
        mgr = CheckpointManager(checkpoint_dir, keep=checkpoint_keep)
        start_round = _restore_checkpoint(mgr)
    stats.resumed_round = start_round

    end_round = max_rounds if stop_after_round is None else min(max_rounds, stop_after_round)
    for rnd in range(start_round, end_round):
        _round(rnd)
        if mgr is not None and (rnd + 1) % checkpoint_every == 0:
            _save_checkpoint(mgr, rnd + 1)
            stats.checkpoints_saved += 1

    stats.quarantined = sum(1 for s in servers if s.history.status == "diverged")
    stats.server_restarts = sum(
        1 for s in servers for r in s.history.rounds if r.cause == "server_restart"
    )
    return GridResult([s.history for s in servers], stats, servers)
