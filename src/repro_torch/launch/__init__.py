"""Launch drivers (the port of ``repro/launch``): the serving driver, the
step builders (one device, and sharded on a ``DeviceMesh``), the trainer
(``repro_torch.launch.train``, not imported here so that ``python -m``
runs it cleanly), and the meshes (``launch.mesh``). The dry-run, HLO
analysis and the roofline are not ported yet (ROADMAP Queue 1, item 16)."""

from repro_torch.launch.serve import Request, Server
from repro_torch.launch.steps import build_train_step, make_optimizer

__all__ = ["Request", "Server", "build_train_step", "make_optimizer"]
