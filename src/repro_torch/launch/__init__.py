"""Serving driver (the port of ``repro/launch/serve.py``). Mesh, sharded
step builders, the dry-run and the training driver are not ported yet
(ROADMAP Queue 1, item 16)."""

from repro_torch.launch.serve import Request, Server

__all__ = ["Request", "Server"]
