"""Transport-aware federated learning: the synchronous and async round
engines, the scenario-parallel grid engine, their strategies, the
edge-client model and the lazy client population."""

from repro_torch.core.client import EdgeClient, LocalTask, bucket_rows, lm_task, mnist_cnn_task
from repro_torch.core.grid import GridPoint, GridResult, GridStats, run_fl_grid
from repro_torch.core.population import Population
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
from repro_torch.core.strategy import (
    STRATEGIES,
    Strategy,
    diloco,
    fedavg,
    fedopt,
    fedprox,
    krum,
    median,
    trimmed_mean,
)

__all__ = [
    "EdgeClient",
    "LocalTask",
    "bucket_rows",
    "mnist_cnn_task",
    "lm_task",
    "FederatedServer",
    "FitJob",
    "GridPoint",
    "GridResult",
    "GridStats",
    "run_fl_grid",
    "Population",
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
    "fedopt",
    "diloco",
    "trimmed_mean",
    "median",
    "krum",
]
