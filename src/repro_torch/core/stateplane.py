"""Sparse, slot-keyed per-client state plane (the port of
``repro/core/stateplane.py``).

Per-client persistent state (error-feedback residuals today) is a tree of
``[rows, ...]`` f32 buffers on one device plus a host map from *client
slot* (a stable population-wide id) to *buffer row*. Two storage modes
share one API:

- ``dense``: one row per population slot, slot == row; ``rows_for`` is
  the identity.
- ``sparse``: a compacted buffer sized O(touched clients), not
  O(population). Rows are assigned on first touch from a free list,
  capacity grows along a power-of-two ladder, and evicted rows are zeroed
  so a re-touched slot gathers fresh zeros, the value an untouched dense
  row holds.

Compressor planes consume row *values*, never row *positions*, so a sparse
plane that gathers the same values as the dense plane gives a
bit-identical ``History``.

Unlike the reference's immutable buffers, ``scatter`` and ``evict`` update
the buffer's leaves in place (``index_copy_`` / ``index_fill_``).

Checkpoint protocol: ``state_arrays()`` is the occupied rows compacted in
row-assignment order, ``slot_list()`` the slot of each saved row, and
``from_checkpoint`` rebuilds under either storage: the slot -> value
mapping, not the physical layout, is the contract.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.utils import resolve_device, tree_leaves, tree_map

__all__ = ["StatePlane"]

_MIN_CAPACITY = 8

_STORAGES = ("dense", "sparse")


def _next_pow2(n: int) -> int:
    cap = _MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


def _zeros_rows(template: Any, rows: int, device: torch.device) -> Any:
    return tree_map(
        lambda leaf: torch.zeros((rows,) + tuple(leaf.shape), dtype=torch.float32, device=device),
        template,
    )


def _as_f32(leaf: Any, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a fresh f32 tensor on ``device``."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(device=device, dtype=torch.float32, copy=True)
    return torch.tensor(np.asarray(leaf, np.float32), device=device)


def _index(rows, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows, np.int64), device=device)


class StatePlane:
    """Slot-keyed per-client state buffer with dense and sparse storage.

    ``device`` takes the place of the reference's ``sharding`` (one card);
    None means the device of the template's leaves."""

    def __init__(
        self,
        template: Any,
        n_slots: int,
        *,
        storage: str = "dense",
        device: Any = None,
    ):
        if storage not in _STORAGES:
            raise ValueError(f"storage must be one of {_STORAGES}, got {storage!r}")
        if device is None:
            first = tree_leaves(template)[0]
            device = first.device if isinstance(first, torch.Tensor) else resolve_device(None)
        self.template = template
        self.n_slots = int(n_slots)
        self.storage = storage
        self.device = torch.device(device)
        if storage == "dense":
            self.capacity = self.n_slots
            self.buffer = _zeros_rows(template, self.n_slots, self.device)
            self._slot_to_row: Optional[Dict[int, int]] = None
            self._row_slots: List[int] = []
            self._free: List[int] = []
        else:
            self.capacity = 0
            self.buffer: Any = None
            self._slot_to_row = {}
            self._row_slots = []  # row -> slot, -1 for free rows
            self._free = []

    # -- row management ----------------------------------------------------

    @property
    def occupancy(self) -> int:
        """Number of slots holding materialized state."""
        if self.storage == "dense":
            return self.n_slots
        return len(self._slot_to_row)

    @property
    def nbytes(self) -> int:
        """Device bytes held by the backing buffer."""
        if self.buffer is None:
            return 0
        return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(self.buffer))

    def _grow(self, needed: int) -> None:
        new_cap = _next_pow2(needed)
        fresh = _zeros_rows(self.template, new_cap, self.device)
        if self.buffer is not None:
            tree_map(lambda z, o: z[: o.shape[0]].copy_(o), fresh, self.buffer)
        self.buffer = fresh
        self.capacity = new_cap

    def rows_for(self, slots: Sequence[int], *, allocate: bool = True) -> np.ndarray:
        """Map client slots to buffer rows (int32).

        Dense storage is the identity. Sparse storage assigns rows on first
        touch (``allocate=True``) from the free list, growing the buffer
        along the power-of-two ladder when full. With ``allocate=False`` an
        unmapped slot raises ``KeyError``."""
        slots = np.asarray(slots, np.int64)
        if slots.size and (slots.min() < 0 or slots.max() >= self.n_slots):
            raise IndexError(f"slot out of range [0, {self.n_slots})")
        if self.storage == "dense":
            return slots.astype(np.int32)
        rows = np.empty(slots.shape, np.int32)
        for i, s in enumerate(slots.tolist()):
            row = self._slot_to_row.get(s)
            if row is None:
                if not allocate:
                    raise KeyError(f"slot {s} has no materialized state")
                if self._free:
                    row = self._free.pop()
                    self._row_slots[row] = s
                else:
                    row = len(self._row_slots)
                    if row >= self.capacity:
                        self._grow(row + 1)
                    self._row_slots.append(s)
                self._slot_to_row[s] = row
            rows[i] = row
        return rows

    # -- gather / scatter --------------------------------------------------

    def gather(self, slots: Sequence[int]) -> Any:
        """Stacked ``[len(slots), ...]`` state for the given slots.

        Untouched sparse slots gather zeros (a row is allocated for them),
        matching the zero-initialized dense plane bitwise."""
        rows = _index(self.rows_for(slots), self.device)
        return tree_map(lambda leaf: leaf.index_select(0, rows), self.buffer)

    def scatter(self, slots: Sequence[int], rows_tree: Any) -> None:
        """Write stacked per-slot state back into the buffer (in place)."""
        rows = _index(self.rows_for(slots), self.device)
        if not rows.numel():
            return
        tree_map(
            lambda buf, new: buf.index_copy_(0, rows, _as_f32(new, self.device)),
            self.buffer,
            rows_tree,
        )

    def evict(self, slots: Sequence[int]) -> None:
        """Drop materialized state for the given slots.

        Freed rows are zeroed (a later gather of the same slot reads zeros,
        like a never-touched slot) and recycled through the free list.
        Dense storage zeroes in place. Unknown sparse slots are ignored."""
        if self.storage == "dense":
            rows = np.asarray(slots, np.int64)
        else:
            hit = [s for s in np.asarray(slots, np.int64).tolist() if s in self._slot_to_row]
            rows = np.empty(len(hit), np.int64)
            for i, s in enumerate(hit):
                row = self._slot_to_row.pop(s)
                self._row_slots[row] = -1
                self._free.append(row)
                rows[i] = row
        if rows.size:
            idx = _index(rows, self.device)
            tree_map(lambda buf: buf.index_fill_(0, idx, 0.0), self.buffer)

    # -- checkpoint protocol ----------------------------------------------

    def slot_list(self) -> List[int]:
        """Slots of the saved rows, in ``state_arrays`` row order."""
        if self.storage == "dense":
            return list(range(self.n_slots))
        return [s for s in self._row_slots if s >= 0]

    def state_arrays(self) -> Any:
        """Array tree for a checkpoint: a copy of the full buffer (dense)
        or of the occupied rows compacted in row order (sparse; freed rows
        are not saved)."""
        if self.storage == "dense":
            return tree_map(torch.clone, self.buffer)
        if self.buffer is None:
            return _zeros_rows(self.template, 0, self.device)
        occupied = [r for r, s in enumerate(self._row_slots) if s >= 0]
        rows = _index(occupied, self.device)
        return tree_map(lambda leaf: leaf.index_select(0, rows), self.buffer)

    def state_meta(self) -> Dict[str, Any]:
        """JSON-able plane descriptor for checkpoint metadata."""
        if self.storage == "dense":
            return {"storage": "dense"}
        return {"storage": "sparse", "rows": len(self.slot_list())}

    @staticmethod
    def template_arrays(
        template: Any, n_slots: int, meta: Optional[Dict[str, Any]], device: Any = None
    ) -> Any:
        """Zero tree shaped like ``state_arrays``."""
        meta = meta or {"storage": "dense"}
        device = resolve_device(device)
        if meta.get("storage", "dense") == "dense":
            return _zeros_rows(template, int(n_slots), device)
        return _zeros_rows(template, int(meta["rows"]), device)

    @classmethod
    def from_checkpoint(
        cls,
        template: Any,
        n_slots: int,
        meta: Optional[Dict[str, Any]],
        arrays: Any,
        *,
        storage: str = "dense",
        slots: Optional[Sequence[int]] = None,
        device: Any = None,
    ) -> "StatePlane":
        """Rebuild a plane from saved rows (tensors or numpy arrays).

        Storage-agnostic: the saved (slot, value) pairs are scattered into
        a plane of the requested storage, so a dense save restores into a
        sparse plane and vice versa. ``slots`` names the slot of each saved
        row; None means the dense layout where row i is slot i. Restoring
        a dense save into sparse storage keeps only rows with any non-zero
        state: zero rows are implicit."""
        meta = meta or {"storage": "dense"}
        saved_dense = meta.get("storage", "dense") == "dense"
        plane = cls(template, n_slots, storage=storage, device=device)
        if saved_dense and storage == "dense":
            plane.buffer = tree_map(lambda leaf: _as_f32(leaf, plane.device), arrays)
            return plane
        if slots is None:
            if not saved_dense:
                raise ValueError("sparse checkpoint requires its slot list")
            slots = list(range(n_slots))
        slots = [int(s) for s in slots]
        rows_tree = tree_map(lambda leaf: _as_f32(leaf, plane.device), arrays)
        if saved_dense and storage == "sparse":
            # keep only rows carrying state; all-zero rows stay implicit
            n = len(slots)
            nonzero = torch.zeros(n, dtype=torch.bool, device=plane.device)
            for leaf in tree_leaves(rows_tree):
                nonzero |= leaf.reshape(n, -1).ne(0).any(dim=1)
            keep = torch.nonzero(nonzero).flatten().tolist()
            if keep:
                idx = _index(keep, plane.device)
                plane.scatter(
                    [slots[i] for i in keep],
                    tree_map(lambda leaf: leaf.index_select(0, idx), rows_tree),
                )
            return plane
        if slots:
            plane.scatter(slots, rows_tree)
        return plane
