from repro_torch.chaos.schedule import (
    ChaosEvent,
    ChaosSchedule,
    client_failure_schedule,
    internet_shutdown,
    netem,
    partition,
    server_restart,
)

__all__ = [
    "ChaosEvent",
    "ChaosSchedule",
    "netem",
    "partition",
    "internet_shutdown",
    "client_failure_schedule",
    "server_restart",
]
