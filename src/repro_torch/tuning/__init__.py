"""TCP tuning: the paper's parameter sweeps (Figs. 6-8, Table IV) and the
adaptive daemon, numpy copies of ``repro/tuning``."""

from repro_torch.tuning.grid import GridResult, sweep_parameter, tune_three_params
from repro_torch.tuning.daemon import AdaptiveTuner, ConnectionStats

__all__ = [
    "sweep_parameter",
    "tune_three_params",
    "GridResult",
    "AdaptiveTuner",
    "ConnectionStats",
]
