"""Lazy client universe for population-scale federated runs (the port of
``repro/core/population.py``).

``FederatedServer`` historically took a materialized ``List[EdgeClient]``
— O(population) host memory in client objects and datasets before the
first round runs.  ``Population`` presents the same universe lazily: a
client count plus a per-client shard factory.  ``EdgeClient`` objects
(and their datasets) materialize only when a cohort touches them, and
materialized state persists across rounds, so participation counters,
residuals, and connected flags behave exactly as they do with a list.

Contracts the server relies on:

- ``len(pop)`` is the population size; client ids are ``0..n-1`` and
  double as the client's state-plane *slot* (``client_slots`` returns
  ``client_id`` for population runs — stable, population-wide ids).
- ``live_ids(chaos, t)`` returns ``None`` when no chaos event can take
  a client down (``ChaosSchedule.liveness_events()``), meaning *all n
  clients are live in id order* — the cohort draw
  ``rng.choice(n, k, replace=False)`` is then draw-identical to the
  dense engine's filter-then-choice, with zero O(population) work per
  round.  With client-killing chaos it falls back to the O(population)
  liveness scan (same ids, same order → same draws as the list path).
- ``active_clients()`` iterates only materialized clients — the
  disconnect sweeps and checkpoint protocol touch O(active), never
  O(population).  Untouched clients hold default state by construction
  (disconnected, zero counters, no residual), so skipping them is
  exact.
- Plain iteration raises: any ``for c in population`` loop would
  silently materialize the universe, which is precisely the bug this
  class exists to prevent.

Datasets ride a bounded LRU: at most ``max_cached_shards`` materialized
shards, evicted clients keep their metadata but drop ``dataset`` (the
factory re-materializes deterministically on the next touch).  Size the
cache above the largest cohort — rows in flight must keep their data.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.client import EdgeClient

__all__ = ["Population"]


class Population:
    """Lazy ``EdgeClient`` universe keyed by client id (== state slot)."""

    def __init__(
        self,
        n_clients: int,
        shard_factory: Optional[Callable[[int], object]] = None,
        *,
        compute_rate_fn: Optional[Callable[[int], float]] = None,
        link_override_fn: Optional[Callable[[int], object]] = None,
        max_cached_shards: int = 256,
    ):
        if n_clients <= 0:
            raise ValueError("n_clients must be positive")
        if max_cached_shards < 1:
            raise ValueError("max_cached_shards must be >= 1")
        self.n_clients = int(n_clients)
        self.shard_factory = shard_factory
        self.compute_rate_fn = compute_rate_fn
        self.link_override_fn = link_override_fn
        self.max_cached_shards = int(max_cached_shards)
        self._clients: Dict[int, EdgeClient] = {}
        self._shard_lru: "OrderedDict[int, None]" = OrderedDict()
        self.shards_built = 0  # factory invocations (telemetry / tests)

    def __len__(self) -> int:
        return self.n_clients

    def __iter__(self):
        raise TypeError(
            "Population is lazy; iterating would materialize every client. "
            "Use .active_clients() for touched clients or .client(cid)."
        )

    # -- materialization ---------------------------------------------------

    def peek(self, client_id: int) -> EdgeClient:
        """The client's persistent object, without forcing its dataset."""
        cid = int(client_id)
        if not 0 <= cid < self.n_clients:
            raise IndexError(f"client id {cid} out of range [0, {self.n_clients})")
        c = self._clients.get(cid)
        if c is None:
            c = EdgeClient(
                cid,
                dataset=None,
                compute_rate=(
                    self.compute_rate_fn(cid) if self.compute_rate_fn else 1.0
                ),
                link_override=(
                    self.link_override_fn(cid) if self.link_override_fn else None
                ),
            )
            self._clients[cid] = c
        return c

    def client(self, client_id: int) -> EdgeClient:
        """The client with its dataset materialized (LRU-cached)."""
        c = self.peek(client_id)
        cid = c.client_id
        if c.dataset is None:
            if self.shard_factory is None:
                raise ValueError(
                    f"client {cid} needs data but Population has no shard_factory"
                )
            c.dataset = self.shard_factory(cid)
            self.shards_built += 1
        self._shard_lru[cid] = None
        self._shard_lru.move_to_end(cid)
        while len(self._shard_lru) > self.max_cached_shards:
            evicted, _ = self._shard_lru.popitem(last=False)
            self._clients[evicted].dataset = None
        return c

    def active_clients(self) -> List[EdgeClient]:
        """Every client materialized so far (O(active), id-insertion order)."""
        return list(self._clients.values())

    @property
    def materialized(self) -> int:
        return len(self._clients)

    @property
    def cached_shards(self) -> int:
        return len(self._shard_lru)

    # -- liveness ----------------------------------------------------------

    def live_ids(self, chaos, t: float) -> Optional[np.ndarray]:
        """Ids of clients alive at ``t``; ``None`` ⇒ all alive, id order.

        The fast path costs O(1): when the chaos schedule carries no
        client-killing events, every id is live and the caller can draw
        cohort indices directly against ``len(self)``.  Otherwise the
        O(population) scan runs — same filter, same order as the dense
        engine's list comprehension, so cohort draws stay identical.
        """
        if not chaos.liveness_events():
            return None
        return np.asarray(
            [cid for cid in range(self.n_clients) if chaos.alive(t, cid)],
            np.int64,
        )
