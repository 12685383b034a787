"""Transport-aware federated learning: the synchronous round engine, the
scenario-parallel grid engine, their strategies and the edge-client
model."""

from repro_torch.core.client import EdgeClient, LocalTask, bucket_rows, mnist_cnn_task
from repro_torch.core.grid import GridPoint, GridResult, GridStats, run_fl_grid
from repro_torch.core.server import (
    FederatedServer,
    FitJob,
    History,
    PendingRound,
    RoundRecord,
    ServerConfig,
    derive_rng,
)
from repro_torch.core.stateplane import StatePlane
from repro_torch.core.strategy import STRATEGIES, Strategy, fedavg, fedprox

__all__ = [
    "EdgeClient",
    "LocalTask",
    "bucket_rows",
    "mnist_cnn_task",
    "FederatedServer",
    "FitJob",
    "GridPoint",
    "GridResult",
    "GridStats",
    "run_fl_grid",
    "PendingRound",
    "derive_rng",
    "ServerConfig",
    "StatePlane",
    "History",
    "RoundRecord",
    "Strategy",
    "STRATEGIES",
    "fedavg",
    "fedprox",
]
