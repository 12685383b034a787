"""Launch drivers (the port of ``repro/launch``): the serving driver, the
step builders (one device, and sharded on a ``DeviceMesh``), the trainer
(``repro_torch.launch.train``) and the dry-run (``launch.dryrun``, with
``launch.hlo_analysis``'s per-rank counts and ``launch.roofline``), neither
imported here so that ``python -m`` runs each cleanly, and the meshes
(``launch.mesh``)."""

from repro_torch.launch.serve import Request, Server
from repro_torch.launch.steps import build_train_step, make_optimizer

__all__ = ["Request", "Server", "build_train_step", "make_optimizer"]
