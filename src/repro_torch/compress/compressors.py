"""Update compression for the constrained link (the port of the slice's
part of ``repro/compress/compressors.py``).

Only the identity compressor is ported: the paper's runs are
uncompressed. top-k, rand-k, int8 and bf16 and the plane formulation
come with the per-client state plane (ROADMAP Queue 1, item 7).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.utils import tree_size


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
    # hashable semantics identity for provenance coalescing; () => opaque
    fingerprint: tuple = ()


def none_compressor() -> Compressor:
    return Compressor(
        "none",
        lambda d, r: (d, r),
        lambda p: p,
        lambda t: 4 * tree_size(t),
        fingerprint=("none",),
    )
