"""Update compression for the constrained link (the port of
``repro/compress/compressors.py``).

Each compressor is (compress, decompress, error feedback) over a tree of
deltas. Compression is lossy and error-fed-back: what compression drops is
kept as a per-client residual and added to the next round's delta, so the
long-run bias vanishes.

The hot path is the plane formulation (``compress_plane``): deltas arrive
stacked ``[R, ...]`` (one row per delivering client), the residuals live
in a ``[K, ...]`` buffer on the device (a ``StatePlane``), and one call
gathers the delivering rows' residuals, compresses every leaf as an
``[R, n]`` row block and scatters the new residuals back, with no
per-client loop. The sequential API (``compress``/``decompress``) is built
from the same row primitives with R = 1, so the two paths are bitwise
equal at equal inputs.

Row math: top-k is ``torch.topk`` over flattened rows; int8 and bf16 go
through the ``kernels/quantize.py`` wrappers (the hand-written kernels on
the card, their plain versions on the CPU), each with every leaf in one
call. int8 rounding is deterministic round-half-up, as in the reference.

``wire_bytes`` is the exact per-leaf upload size the transport bills;
``fingerprint`` is the hashable identity of the compression semantics
(empty for the stateful randk, which marks it opaque).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.utils import tree_leaves, tree_map, tree_size, tree_unflatten


@dataclass(frozen=True)
class Compressor:
    """One update-compression scheme.

    ``wire_bytes(tree)`` is the EXACT upload wire size of one compressed
    update shaped like ``tree``: what every transport engine bills for the
    client->server direction (downloads bill the full model,
    ``LocalTask.update_bytes``)."""

    name: str
    compress: Callable  # (delta, residual) -> (payload, new_residual)
    decompress: Callable  # payload -> delta (same tree structure as input)
    wire_bytes: Callable  # (tree_template) -> int
    # Plane twin: (stacked_delta [R,...], residual_buffer [K,...], rows [R])
    #   -> (decompressed stacked [R,...], residual_buffer). ``rows`` are
    # physical buffer rows (``StatePlane.rows_for``); the buffer is updated
    # in place and returned. None => the server takes the per-client loop.
    compress_plane: Optional[Callable] = None
    # hashable semantics identity for provenance coalescing; () => opaque
    fingerprint: tuple = ()
    # host-side state for the round-boundary checkpoint protocol:
    # state_get() -> JSON-safe snapshot, state_set(snapshot) -> None; both
    # None => the compressor keeps no host state
    state_get: Optional[Callable] = None
    state_set: Optional[Callable] = None


def init_residual_plane(template, n: int):
    """Zero residual plane: one f32 row per client, template-shaped leaves
    on the template's device (the dense layout ``StatePlane`` wraps)."""
    return tree_map(
        lambda l: torch.zeros((n,) + tuple(l.shape), dtype=torch.float32, device=l.device),
        template,
    )


def _leafwise(delta, residual, one):
    """Apply ``one(d, r) -> (payload_leaf, new_residual_leaf)`` leaf-wise."""
    leaves_d = tree_leaves(delta)
    leaves_r = tree_leaves(residual) if residual is not None else [None] * len(leaves_d)
    pairs = [one(d, r) for d, r in zip(leaves_d, leaves_r)]
    return (
        tree_unflatten(delta, [p[0] for p in pairs]),
        tree_unflatten(delta, [p[1] for p in pairs]),
    )


def _payload_map(fn, payload, marker: str):
    """Map ``fn`` over the payload leaves of a tree: dicts holding key
    ``marker`` (a payload leaf is itself a dict)."""
    if isinstance(payload, dict) and marker in payload:
        return fn(payload)
    return {k: _payload_map(fn, v, marker) for k, v in payload.items()}


def _with_residual(d, r):
    """The delta leaf in f32 plus its residual (0.0 when there is none)."""
    return d.float() + (r.float() if r is not None else 0.0)


def _plane_compress_fn(rows_fn):
    """Lift a row transform over every leaf,
    ``rows_fn([x2 [R, n_l] per leaf]) -> [deq2 [R, n_l] per leaf]``, into
    the plane compressor. Every leaf's x2 is computed before ``rows_fn``
    runs, so a kernel can take all leaves in one launch.

    The reference splits this into three jitted programs so that XLA cannot
    fuse the dequantize multiply into ``x2 - deq2`` as an FMA. Here every
    step is its own eager torch op, so ``deq2`` is rounded before the
    subtraction reads it. In place of the reference's donated scatter, the
    residual buffer's leaves are updated in place (``index_copy_``). The
    pieces are exposed as attributes (``gather_rows`` / ``compress_rows`` /
    ``scatter_rows`` / ``finalize``) as in the reference."""

    def gather_rows(residual_plane, rows):
        return tree_map(lambda res: res.index_select(0, rows), residual_plane)

    def compress_rows(stacked, residual_rows):
        x2s = [
            d.float().reshape(d.shape[0], -1) + res.reshape(d.shape[0], -1)
            for d, res in zip(tree_leaves(stacked), tree_leaves(residual_rows))
        ]
        return tree_unflatten(stacked, x2s), tree_unflatten(stacked, rows_fn(x2s))

    def scatter_rows(x2_tree, deq_tree, residual_plane, rows):
        def one(x2, deq2, res):
            new_rows = (x2 - deq2).reshape((x2.shape[0],) + tuple(res.shape[1:]))
            return res.index_copy_(0, rows, new_rows)

        return tree_map(one, x2_tree, deq_tree, residual_plane)

    def finalize(stacked, deq_tree):
        return tree_map(lambda d, q2: q2.reshape(d.shape).to(d.dtype), stacked, deq_tree)

    def compress_plane(stacked, residual_plane, rows):
        device = tree_leaves(residual_plane)[0].device
        rows = torch.as_tensor(np.asarray(rows, np.int64), device=device)
        res_rows = gather_rows(residual_plane, rows)
        x2_tree, deq_tree = compress_rows(stacked, res_rows)
        new_res = scatter_rows(x2_tree, deq_tree, residual_plane, rows)
        return finalize(stacked, deq_tree), new_res

    compress_plane.gather_rows = gather_rows
    compress_plane.compress_rows = compress_rows
    compress_plane.scatter_rows = scatter_rows
    compress_plane.finalize = finalize
    return compress_plane


def _sparse_wire_bytes(ratio: float):
    """Exact sparse wire size: 4 B index + 4 B value per kept coordinate,
    per leaf (each leaf keeps max(n * ratio, 1), the k the row math uses)."""

    def wire_bytes(t):
        return int(
            sum(
                8 * max(int(np.prod(tuple(l.shape), dtype=np.int64) * ratio), 1)
                for l in tree_leaves(t)
            )
        )

    return wire_bytes


def _sparse_decompress(payload):
    def one(p):
        n = int(np.prod(p["shape"], dtype=np.int64))
        out = torch.zeros(n, dtype=torch.float32, device=p["vals"].device)
        return out.index_copy_(0, p["idx"], p["vals"]).reshape(p["shape"])

    return _payload_map(one, payload, "idx")


# ---------------------------------------------------------------------------
# row primitives (shared by the sequential R = 1 and plane [R, n] paths)
# ---------------------------------------------------------------------------


def _topk_rows(x2, ratio: float):
    """Magnitude top-k per row: returns (sparse [R, n], idx [R, k], kept).
    A library call, as ``lax.top_k`` is in the reference; the two may pick
    different indices only on exact ties in |x|."""
    n = x2.shape[-1]
    k = max(int(n * ratio), 1)
    _, idx = torch.topk(x2.abs(), k, dim=-1)
    kept = torch.gather(x2, -1, idx)
    sparse = torch.zeros_like(x2).scatter_(-1, idx, kept)
    return sparse, idx, kept


def _int8_rows(x2s):
    """Symmetric per-row int8 over a list of [R, n_l] blocks, one kernel
    launch for all of them: returns [(deq2 [R, n_l], q int8, scale [R])].

    The scale is max(amax|x_r|, 1e-12) / 127 in f32, divided by a tensor
    filled on the device: on CUDA, PyTorch divides by a Python number as a
    multiply by its reciprocal, which can differ from the quotient in the
    last bit, and a scalar copied from the host would stall the stream.
    ``deq2`` is its own torch op, so no FMA folds it into a later
    subtraction."""
    scales = []
    for x2 in x2s:
        amax = torch.clamp(torch.amax(x2.abs(), dim=-1), min=1e-12)
        scales.append(amax / torch.full_like(amax, 127.0))
    qs = kernel_ops.quantize_rows_leaves(x2s, scales)
    return [(q.float() * scale[:, None], q, scale) for q, scale in zip(qs, scales)]


def _bf16_rows(x2s):
    """bf16 downcast over a list of [R, n_l] blocks, one kernel launch for
    all of them: returns [(deq2 [R, n_l] f32, b bf16)]."""
    return [(b.float(), b) for b in kernel_ops.downcast_bf16_rows_leaves(x2s)]


def _grouped_compress(delta, residual, rows_fn, payload_of):
    """Sequential compress (R = 1) through a grouped row primitive: every
    leaf's x2 first, then one ``rows_fn(x2s) -> [(deq2, ...)]`` call over
    all of them (one launch, as the plane does); ``payload_of(d, row)``
    builds a leaf's payload from its ``rows_fn`` entry."""
    ds = tree_leaves(delta)
    rs = tree_leaves(residual) if residual is not None else [None] * len(ds)
    x2s = [_with_residual(d, r).reshape(1, -1) for d, r in zip(ds, rs)]
    rows = rows_fn(x2s)
    return (
        tree_unflatten(delta, [payload_of(d, row) for d, row in zip(ds, rows)]),
        tree_unflatten(delta, [(x2 - row[0]).reshape(d.shape)
                               for d, x2, row in zip(ds, x2s, rows)]),
    )


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------


def none_compressor() -> Compressor:
    return Compressor(
        "none",
        lambda d, r: (d, r),
        lambda p: p,
        lambda t: 4 * tree_size(t),
        fingerprint=("none",),
    )


def topk_compressor(ratio: float = 0.01) -> Compressor:
    """Per-leaf magnitude top-k with error feedback."""

    def compress(delta, residual):
        def one(d, r):
            x2 = _with_residual(d, r).reshape(1, -1)
            sparse, idx, kept = _topk_rows(x2, ratio)
            new_r = (x2 - sparse).reshape(d.shape)
            return {"idx": idx[0], "vals": kept[0], "shape": tuple(d.shape)}, new_r

        return _leafwise(delta, residual, one)

    return Compressor(
        f"topk{ratio}",
        compress,
        _sparse_decompress,
        _sparse_wire_bytes(ratio),
        compress_plane=_plane_compress_fn(lambda x2s: [_topk_rows(x2, ratio)[0] for x2 in x2s]),
        fingerprint=("topk", float(ratio)),
    )


def randk_compressor(ratio: float = 0.01, seed: int = 0) -> Compressor:
    """Random-k sparsification with error feedback.

    The selection rotates every call (otherwise the same coordinates are
    sent forever and the residual on the rest never drains); each leaf
    draws from a ``torch.Generator`` seeded from (seed, call counter, leaf
    index). The reference draws with ``jax.random``, so the two agree in
    distribution only. Kept values are sent unscaled: error feedback
    supplies the missing mass over rounds.

    The rotating counter is host-side state, so randk has no plane twin
    and an empty fingerprint (the server takes the per-client loop); the
    counter is exposed through ``state_get``/``state_set``."""
    counter = [0]

    def compress(delta, residual):
        call = counter[0]
        counter[0] += 1
        leaf_ids = itertools.count()

        def one(d, r):
            leaf_idx = next(leaf_ids)
            flat = _with_residual(d, r).reshape(-1)
            n = flat.shape[0]
            k = max(int(n * ratio), 1)
            key = np.random.SeedSequence(entropy=seed, spawn_key=(call, leaf_idx))
            gen = torch.Generator().manual_seed(int(key.generate_state(1, np.uint64)[0] >> 1))
            idx = torch.randperm(n, generator=gen)[:k].to(flat.device)
            kept = flat[idx]
            sparse = torch.zeros_like(flat).index_copy_(0, idx, kept)
            return {"idx": idx, "vals": kept, "shape": tuple(d.shape)}, (flat - sparse).reshape(d.shape)

        return _leafwise(delta, residual, one)

    return Compressor(
        f"randk{ratio}",
        compress,
        _sparse_decompress,
        _sparse_wire_bytes(ratio),
        state_get=lambda: {"counter": counter[0]},
        state_set=lambda s: counter.__setitem__(0, int(s["counter"])),
    )


def int8_compressor() -> Compressor:
    """Per-leaf symmetric int8 quantization with error feedback;
    deterministic round-half-up, bitwise equal to the reference's codes."""

    def compress(delta, residual):
        return _grouped_compress(
            delta, residual, _int8_rows,
            lambda d, row: {"q": row[1][0].reshape(d.shape), "scale": row[2][0]},
        )

    def decompress(payload):
        return _payload_map(lambda p: p["q"].float() * p["scale"], payload, "q")

    def wire_bytes(t):
        return tree_size(t) + 4 * len(tree_leaves(t))  # 1 B/elem + scale

    return Compressor(
        "int8",
        compress,
        decompress,
        wire_bytes,
        compress_plane=_plane_compress_fn(lambda x2s: [deq2 for deq2, _, _ in _int8_rows(x2s)]),
        fingerprint=("int8",),
    )


def bf16_compressor() -> Compressor:
    """bf16 truncation (2 B/element, no index overhead) with error feedback
    soaking up the dropped mantissa bits."""

    def compress(delta, residual):
        return _grouped_compress(delta, residual, _bf16_rows,
                                 lambda d, row: {"bf16": row[1][0].reshape(d.shape)})

    def decompress(payload):
        return _payload_map(lambda p: p["bf16"].float(), payload, "bf16")

    return Compressor(
        "bf16",
        compress,
        decompress,
        lambda t: 2 * tree_size(t),
        compress_plane=_plane_compress_fn(lambda x2s: [deq2 for deq2, _ in _bf16_rows(x2s)]),
        fingerprint=("bf16",),
    )


def get_compressor(name: str, **kw) -> Compressor:
    if name == "none":
        return none_compressor()
    if name == "topk":
        return topk_compressor(kw.get("ratio", 0.01))
    if name == "randk":
        return randk_compressor(kw.get("ratio", 0.01), kw.get("seed", 0))
    if name == "int8":
        return int8_compressor()
    if name == "bf16":
        return bf16_compressor()
    raise ValueError(f"unknown compressor {name}")


def compressed_bytes(comp: Compressor, tree) -> int:
    return comp.wire_bytes(tree)
