"""Edge client model: local training payload + resource/connection state
(the port of ``repro/core/client.py``).

A client owns a data shard, a compute profile (``compute_rate`` over the
measured step cost of the paper's 0.5 vCPU Pi-class allocation) and a
transport connection state. ``LocalTask`` abstracts the payload.

The cohort hot path is the *plane* formulation: local SGD for a set of
(anchor params, client, batch plan) rows runs as one stacked tensor program
with a leading row axis. Rows are independent — every cross-row operation
is batch-mapped, never reduced, and every dispatch runs as fixed-width row
chunks (``_ROW_CHUNK``) — so a row's result does not depend on how rows are
grouped. Local steps are a Python loop; the reference's
unroll-versus-chunk split is an artefact of its ``jit`` and has no
counterpart here.

Batch plans come from numpy (``ClientDataset.batch_indices`` and the
``batches`` iterator), so both engines, and the reference, draw the same
plans from the same stream.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.data import ClientDataset
from repro_torch.models.cnn import cnn_apply, cnn_init, cnn_loss, cnn_loss_stacked
from repro_torch.optim import (
    apply_updates,
    clip_by_global_norm,
    clip_by_global_norm_stacked,
    sgd,
)
from repro_torch.utils import (
    f32_math,
    resolve_device,
    tree_leaves,
    tree_map,
    tree_stack,
    tree_sub,
    tree_unflatten,
)


@dataclass
class LocalTask:
    """Payload: init + one local-training run on a client shard."""

    name: str
    init_fn: Callable  # torch.Generator -> params
    local_fit: Callable  # (params, client, steps, rng, prox_mu) -> (delta, n_examples, metrics)
    evaluate: Callable  # (params, data) -> metrics
    update_bytes: int  # uncompressed wire size of one update
    # Cohort-batched twin of local_fit: (params, clients, steps, rng,
    # prox_mu) -> (stacked_delta [C,...], n_examples [C], metrics [C]).
    # Consumes ``rng`` draw-for-draw like local_fit on each client in
    # order. None => the server runs the sequential per-client loop.
    batched_local_fit: Optional[Callable] = None
    # plan_fit(clients, steps, rng) -> per-client batch plans, consuming
    # ``rng`` exactly like batched_local_fit's drawing phase.
    plan_fit: Optional[Callable] = None
    # plan_digest(client, plan) -> hashable fingerprint of a row's inputs.
    plan_digest: Optional[Callable] = None
    # fit_rows(anchors, rows, steps, mus, use_prox, anchor_idx=None) ->
    #     (plane_delta [Rb,...], n_examples [R], metrics [R]); rows are R
    # (client, plan) pairs, Rb is R padded up to its bucket width, and
    # ``anchor_idx`` maps each row to one of the UNIQUE ``anchors``
    # (None: anchors is per-row).
    fit_rows: Optional[Callable] = None

    def plane_dispatch_widths(self) -> List[int]:
        """Padded row widths of every plane dispatch so far."""
        runner = getattr(self.fit_rows, "runner", None)
        return list(runner.dispatch_widths) if runner is not None else []

    def plane_anchor_widths(self) -> List[int]:
        """Padded unique-anchor widths of every plane dispatch so far."""
        runner = getattr(self.fit_rows, "runner", None)
        return list(runner.anchor_widths) if runner is not None else []


# Row-bucket ladder: plane dispatches pad their row count up to the next
# bucket, so the reference's compile cache holds O(buckets) programs; the
# port keeps the same widths so its planes match the reference's row for
# row. Padding rows repeat row 0 and are discarded.
_ROW_BUCKETS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)


def bucket_rows(n: int) -> int:
    """Smallest bucket width >= n (multiples of 64 past the ladder)."""
    for b in _ROW_BUCKETS:
        if n <= b:
            return b
    return -(-n // 64) * 64


# Every library call of the plane program runs on exactly this many rows.
# A batched GEMM or a reduction may pick another algorithm, and so another
# summation order, for another batch count: on the CPU a batch of one takes
# a different GEMM path than a batch of two. So a dispatch of any width runs
# as whole chunks of _ROW_CHUNK rows (the last padded with its own first
# row), and a row's delta is the same bits at every dispatch width and
# position. 12 is the per-point engine's bucket for the paper's 10 clients,
# so its dispatches stay one chunk.
_ROW_CHUNK = 12


def _prox_term(params, anchor, dims):
    """sum over leaves (sorted-key order) of ||p - a||^2, reduced over dims."""
    return sum(
        torch.sum(torch.square(p.float() - a.float()), dim=dims(p))
        for p, a in zip(tree_leaves(params), tree_leaves(anchor))
    )


def _plane_sgd_runner(cohort_loss_fn, lr: float):
    """Plane runner: R independent local-SGD trajectories as stacked tensor
    programs, one Python loop over steps, no per-row loop.

    ``cohort_loss_fn(stacked_params, batch)`` returns per-row losses [R]
    plus per-row metrics, every leaf carrying a leading row axis. Summing
    the per-row losses before differentiation yields each row's own
    gradient in its slice (rows share no parameters). Anchors arrive as a
    stack of UNIQUE params trees [U, ...] plus a per-row gather index [R];
    ``mu`` is a per-row prox coefficient. Clipping is per row; the momentum
    update is leaf-wise and vectorizes over the row axis unchanged. The rows
    run as chunks of ``_ROW_CHUNK`` (see there)."""
    opt = sgd(lr, momentum=0.9)

    def run_chunk(uanchor, aidx, batches, mu, use_prox):
        steps = tree_leaves(batches)[0].shape[1]
        anchor = tree_map(lambda l: l.index_select(0, aidx), uanchor)
        stacked = anchor
        opt_state = opt.init(stacked)
        metrics: Dict[str, torch.Tensor] = {}
        for s in range(steps):
            batch = tree_map(lambda l, _s=s: l[:, _s], batches)
            ps = tree_map(lambda l: l.detach().requires_grad_(True), stacked)
            losses, metrics = cohort_loss_fn(ps, batch)
            if use_prox:
                prox = _prox_term(ps, anchor, lambda l: tuple(range(1, l.ndim)))
                losses = losses + 0.5 * mu * prox
            grads = tree_unflatten(ps, torch.autograd.grad(losses.sum(), tree_leaves(ps)))
            grads, _ = clip_by_global_norm_stacked(grads, 1.0)
            updates, opt_state = opt.update(grads, opt_state, stacked, 0)
            stacked = apply_updates(stacked, updates)
        delta = tree_sub(stacked, anchor)
        return delta, {k: v.detach() for k, v in metrics.items()}

    def run_rows(uanchor, aidx, batches, mu, use_prox):
        # uanchor leaves [U, ...]; aidx [R]; batches leaves [R, steps, ...]
        r = tree_leaves(batches)[0].shape[0]
        run_rows.dispatch_widths.append(int(r))
        run_rows.anchor_widths.append(int(tree_leaves(uanchor)[0].shape[0]))
        rows = torch.arange(r, device=aidx.device)
        deltas, metrics = [], []
        for s in range(0, r, _ROW_CHUNK):
            sel = rows[s:s + _ROW_CHUNK]
            n = sel.shape[0]
            sel = torch.cat([sel, sel[:1].expand(_ROW_CHUNK - n)])  # pad: the chunk's first row
            delta, mets = run_chunk(
                uanchor, aidx[sel], tree_map(lambda l: l[sel], batches), mu[sel], use_prox
            )
            deltas.append(tree_map(lambda l: l[:n], delta))
            metrics.append({k: v[:n] for k, v in mets.items()})
        return (
            tree_map(lambda *ls: torch.cat(ls, dim=0), *deltas),
            {k: torch.cat([m[k] for m in metrics]) for k in metrics[0]},
        )

    run_rows.dispatch_widths = []
    run_rows.anchor_widths = []
    return run_rows


def _unstack_metrics(stacked: Dict[str, Any], n: int) -> List[Dict[str, float]]:
    host = {k: v.cpu().numpy() for k, v in stacked.items()}  # one sync per metric
    return [{k: float(v[i]) for k, v in host.items()} for i in range(n)]


def _pad_rows(rows: Sequence[Any], mus: Sequence[float], aidx: Sequence[int]):
    """Pad a row list up to its bucket width by repeating row 0."""
    r = len(rows)
    pad = bucket_rows(r) - r
    return (
        list(rows) + [rows[0]] * pad,
        list(mus) + [float(mus[0])] * pad,
        list(aidx) + [int(aidx[0])] * pad,
    )


def _pad_anchors(anchors: Sequence[Any]):
    """Pad the unique-anchor list up to its bucket width (anchor 0
    repeated); padding anchors are never gathered by real rows."""
    u = len(anchors)
    return list(anchors) + [anchors[0]] * (bucket_rows(u) - u)


def _anchor_args(anchors: Sequence[Any], anchor_idx, r: int):
    """anchor_idx=None means anchors is per-row (identity mapping)."""
    if anchor_idx is None:
        anchor_idx = list(range(r))
    return _pad_anchors(anchors), list(anchor_idx)


def _sgd_local_fit(loss_fn, lr: float, batch_size: int, device: torch.device):
    opt = sgd(lr, momentum=0.9)

    def step(params, opt_state, batch, anchor, mu):
        ps = tree_map(lambda l: l.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(ps, batch)
        if mu is not None:
            loss = loss + 0.5 * mu * _prox_term(ps, anchor, lambda l: tuple(range(l.ndim)))
        grads = tree_unflatten(ps, torch.autograd.grad(loss, tree_leaves(ps)))
        grads, _ = clip_by_global_norm(grads, 1.0)
        updates, opt_state = opt.update(grads, opt_state, params, 0)
        return apply_updates(params, updates), opt_state, {k: v.detach() for k, v in metrics.items()}

    def fit(params, client: "EdgeClient", steps: int, rng: np.random.Generator, prox_mu: float):
        anchor = params
        opt_state = opt.init(params)
        metrics = {}
        n_used = 0
        it = client.dataset.batches(batch_size, rng=rng, epochs=1000)
        for _ in range(steps):
            batch = {k: torch.as_tensor(v, device=device) for k, v in next(it).items()}
            params, opt_state, metrics = step(
                params, opt_state, batch, anchor, prox_mu if prox_mu > 0 else None
            )
            n_used += batch_size
        delta = tree_sub(params, anchor)
        return delta, n_used, {k: float(v) for k, v in metrics.items()}

    return fit


def _sgd_plane_fns(cohort_loss_fn, lr: float, batch_size: int, device: torch.device):
    """MNIST-style plane fns: batch plans are index arrays into the
    client's shard; rows gather their step batches from dataset arrays."""
    runner = _plane_sgd_runner(cohort_loss_fn, lr)

    def plan_fit(clients: List["EdgeClient"], steps: int, rng: np.random.Generator):
        # plans drawn per client IN ORDER: same rng stream as the
        # sequential path pulling `steps` batches per client
        return [c.dataset.batch_indices(batch_size, steps, rng=rng) for c in clients]

    def plan_digest(client: "EdgeClient", plan: np.ndarray):
        return (id(client.dataset), plan.tobytes())

    def fit_rows(anchors, rows, steps, mus, use_prox, anchor_idx=None):
        r = len(rows)
        anchors_p, aidx = _anchor_args(anchors, anchor_idx, r)
        rows_p, mus_p, aidx_p = _pad_rows(rows, mus, aidx)
        batches = {
            "images": torch.as_tensor(
                np.stack([c.dataset.images[p] for c, p in rows_p]), device=device
            ),
            "labels": torch.as_tensor(
                np.stack([c.dataset.labels[p] for c, p in rows_p]), device=device
            ),
        }
        plane, last = runner(
            tree_stack(anchors_p),
            torch.as_tensor(np.asarray(aidx_p, np.int64), device=device),
            batches,
            torch.as_tensor(np.asarray(mus_p, np.float32), device=device),
            use_prox,
        )
        return plane, [steps * batch_size] * r, _unstack_metrics(last, r)

    fit_rows.runner = runner
    return plan_fit, plan_digest, fit_rows


def _plane_batched_local_fit(plan_fit, fit_rows):
    """Cohort-batched fit on the plane API: every row shares the cohort's
    single anchor; the plane is sliced back to cohort width."""

    def fit_cohort(params, clients, steps, rng, prox_mu):
        plans = plan_fit(clients, steps, rng)
        rows = list(zip(clients, plans))
        plane, n_examples, metrics = fit_rows(
            [params], rows, steps, [prox_mu] * len(rows), prox_mu > 0,
            anchor_idx=[0] * len(rows),
        )
        stacked = tree_map(lambda l: l[: len(rows)], plane)
        return stacked, n_examples, metrics

    return fit_cohort


def _in_f32(fn, device: torch.device):
    """``fn`` run under ``f32_math(device)`` (attributes carried over)."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with f32_math(device):
            return fn(*args, **kwargs)

    return call


def mnist_cnn_task(lr: float = 0.05, batch_size: int = 32, device=None) -> LocalTask:
    """The paper's workload: MNIST CNN, ~0.83 MB of f32 params per update.

    Runs on ``device`` (default CUDA; raises without it). ``init_fn`` takes
    a ``torch.Generator``. Training and evaluation compute in full f32 on
    the card, as the reference does (TF32 off in their scope only)."""
    device = resolve_device(device)
    nbytes = 4 * sum(l.numel() for l in tree_leaves(cnn_init(torch.Generator())))

    def evaluate(params, data: Dict[str, np.ndarray]):
        with f32_math(device), torch.no_grad():
            logits = cnn_apply(params, torch.as_tensor(data["images"], device=device))
            labels = torch.as_tensor(data["labels"], device=device).long()
            acc = (torch.argmax(logits, -1) == labels).float().mean()
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, labels[:, None]).mean()
        return {"accuracy": float(acc), "loss": float(nll)}

    plan_fit, plan_digest, fit_rows = _sgd_plane_fns(cnn_loss_stacked, lr, batch_size, device)
    fit_rows = _in_f32(fit_rows, device)
    return LocalTask(
        "mnist_cnn",
        init_fn=lambda generator: cnn_init(generator, device=device),
        local_fit=_in_f32(_sgd_local_fit(cnn_loss, lr, batch_size, device), device),
        evaluate=evaluate,
        update_bytes=nbytes,
        batched_local_fit=_plane_batched_local_fit(plan_fit, fit_rows),
        plan_fit=plan_fit,
        plan_digest=plan_digest,
        fit_rows=fit_rows,
    )


@dataclass
class EdgeClient:
    client_id: int
    dataset: Optional[ClientDataset] = None
    compute_rate: float = 1.0  # 1.0 = the paper's 0.5 vCPU Pi-class baseline
    link_override: Optional[Any] = None  # LinkProfile or None (use base)
    connected: bool = False
    residual: Optional[Any] = None  # compression error feedback
    rounds_participated: int = 0
    bytes_sent: int = 0

    def step_time(self, base_step_cost: float) -> float:
        return base_step_cost / max(self.compute_rate, 1e-6)
