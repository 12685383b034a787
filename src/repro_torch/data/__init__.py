from repro_torch.data.federated import (
    ClientDataset,
    dirichlet_partition,
    federated_mnist_factory,
    iid_partition,
    make_federated_mnist,
    shard_list_factory,
    synthetic_mnist,
)
from repro_torch.data.tokens import synthetic_token_batches, token_batch_for

__all__ = [
    "ClientDataset",
    "iid_partition",
    "dirichlet_partition",
    "synthetic_mnist",
    "make_federated_mnist",
    "federated_mnist_factory",
    "shard_list_factory",
    "synthetic_token_batches",
    "token_batch_for",
]
