"""Federated data pipeline: synthetic MNIST + IID/non-IID partitioning.

The paper trains MNIST over 10 Flower clients. Offline here, so we generate
a *structured* synthetic MNIST: class-conditional digit prototypes (coarse
7x7 strokes upsampled) + noise. It is learnable (a CNN reaches >90 % in a
few hundred steps) and classes are genuinely distinct, which makes the
non-IID Dirichlet partition meaningful — exactly what the paper's client
heterogeneity discussion needs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class ClientDataset:
    client_id: int
    images: np.ndarray  # [N, 28, 28, 1] float32
    labels: np.ndarray  # [N] int32

    def num_examples(self) -> int:
        return int(self.labels.shape[0])

    def batches(self, batch_size: int, *, rng: np.random.Generator, epochs: int = 1):
        n = self.num_examples()
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                idx = order[i : i + batch_size]
                yield {"images": self.images[idx], "labels": self.labels[idx]}

    def batch_indices(
        self, batch_size: int, steps: int, *, rng: np.random.Generator
    ) -> np.ndarray:
        """Materialize the index plan for ``steps`` batches as [steps, B].

        Consumes ``rng`` draw-for-draw identically to pulling ``steps``
        batches from :meth:`batches` (one ``rng.permutation`` per epoch
        entered, nothing else) — the batched cohort engine relies on this to
        reproduce the sequential engine's RNG stream exactly.
        """
        n = self.num_examples()
        if n < batch_size:
            raise ValueError(
                f"client {self.client_id}: shard of {n} examples cannot fill "
                f"batches of {batch_size}"
            )
        out: List[np.ndarray] = []
        while len(out) < steps:
            order = rng.permutation(n)
            for i in range(0, n - batch_size + 1, batch_size):
                out.append(order[i : i + batch_size])
                if len(out) == steps:
                    break
        return np.stack(out, axis=0)


_PROTO_CACHE: Dict[int, np.ndarray] = {}


def _prototypes(seed: int = 1234) -> np.ndarray:
    """10 class prototypes: random coarse 7x7 masks upsampled to 28x28."""
    if seed in _PROTO_CACHE:
        return _PROTO_CACHE[seed]
    rng = np.random.default_rng(seed)
    coarse = (rng.random((10, 7, 7)) > 0.55).astype(np.float32)
    protos = coarse.repeat(4, axis=1).repeat(4, axis=2)  # [10,28,28]
    _PROTO_CACHE[seed] = protos
    return protos


def synthetic_mnist(n: int, *, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    protos = _prototypes()
    scale = rng.uniform(0.35, 0.75, (n, 1, 1)).astype(np.float32)  # intensity variation
    images = protos[labels] * scale + rng.normal(0, 0.45, (n, 28, 28)).astype(np.float32)
    images = np.clip(images, 0.0, 1.0)[..., None].astype(np.float32)
    return {"images": images, "labels": labels}


def iid_partition(data: Dict[str, np.ndarray], n_clients: int, *, seed: int = 0) -> List[ClientDataset]:
    n = data["labels"].shape[0]
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    shards = np.array_split(order, n_clients)
    return [
        ClientDataset(c, data["images"][idx], data["labels"][idx])
        for c, idx in enumerate(shards)
    ]


def dirichlet_partition(
    data: Dict[str, np.ndarray], n_clients: int, *, alpha: float = 0.5, seed: int = 0
) -> List[ClientDataset]:
    """Non-IID label-skew partition (Li et al., ICDE'22 — paper ref [15])."""
    rng = np.random.default_rng(seed)
    labels = data["labels"]
    idx_by_class = [np.where(labels == k)[0] for k in range(10)]
    client_indices: List[List[int]] = [[] for _ in range(n_clients)]
    for k_idx in idx_by_class:
        rng.shuffle(k_idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(k_idx)).astype(int)[:-1]
        for c, part in enumerate(np.split(k_idx, cuts)):
            client_indices[c].extend(part.tolist())
    out = []
    for c, idx in enumerate(client_indices):
        idx = np.array(sorted(idx), dtype=np.int64)
        if len(idx) == 0:  # guarantee non-empty shards
            idx = np.array([rng.integers(0, len(labels))])
        out.append(ClientDataset(c, data["images"][idx], data["labels"][idx]))
    return out


def make_federated_mnist(
    n_clients: int = 10,
    examples_per_client: int = 600,
    *,
    iid: bool = True,
    alpha: float = 0.5,
    seed: int = 0,
) -> List[ClientDataset]:
    data = synthetic_mnist(n_clients * examples_per_client, seed=seed)
    if iid:
        return iid_partition(data, n_clients, seed=seed)
    return dirichlet_partition(data, n_clients, alpha=alpha, seed=seed)


def _client_rng(seed: int, client_id: int) -> np.random.Generator:
    """Independent per-client stream: SeedSequence spawn keys give each
    client a decorrelated generator addressable in O(1) — no global
    stream position to advance through."""
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(int(client_id),))
    )


def federated_mnist_factory(
    examples_per_client: int,
    *,
    iid: bool = True,
    alpha: float = 0.5,
    seed: int = 0,
):
    """Lazy per-client shard factory for population-scale runs.

    Returns ``make(client_id) -> ClientDataset``: client c's shard is
    generated on demand from its own ``SeedSequence((seed, c))`` stream —
    O(examples_per_client) work and memory per call, zero
    O(population) setup. Deterministic: the same (seed, client_id)
    always yields the same shard, which is what lets ``Population``'s
    LRU drop and re-materialize shards freely and what makes
    kill-and-resume runs bitwise reproducible.

    ``iid=False`` draws each client's label distribution from a
    per-client Dirichlet(alpha) — label skew without a global pool.
    Note the shards are distributionally, not sample-wise, equal to
    ``make_federated_mnist``'s (which permutes ONE global pool and is
    inherently O(population)); dense-vs-sparse parity gates compare
    engines on identical data, not the two generators on each other.
    """
    examples_per_client = int(examples_per_client)
    protos = _prototypes()

    def make(client_id: int) -> ClientDataset:
        rng = _client_rng(seed, client_id)
        n = examples_per_client
        if iid:
            labels = rng.integers(0, 10, size=n).astype(np.int32)
        else:
            props = rng.dirichlet([alpha] * 10)
            labels = rng.choice(10, size=n, p=props).astype(np.int32)
        scale = rng.uniform(0.35, 0.75, (n, 1, 1)).astype(np.float32)
        images = protos[labels] * scale + rng.normal(
            0, 0.45, (n, 28, 28)
        ).astype(np.float32)
        images = np.clip(images, 0.0, 1.0)[..., None].astype(np.float32)
        return ClientDataset(int(client_id), images, labels)

    return make


def shard_list_factory(shards: List[ClientDataset]):
    """Adapt a materialized shard list into the factory protocol —
    small sweeps hand ``Population`` (or point builders) the exact same
    ``ClientDataset`` objects a list-universe run would see, keeping
    dense-vs-sparse comparisons on identical data."""

    def make(client_id: int) -> ClientDataset:
        return shards[int(client_id)]

    return make
