#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone, on one CUDA card.

Usage: ``python tools/smoke_phases.py PHASE [PHASE ...]`` from the repo
root, e.g. ``python tools/smoke_phases.py rwkv_train hybrid_train``. It
builds the kernels, calls each ``chip_smoke.phase_<PHASE>(torch)`` (the
phases that take nothing but ``torch``) and prints the JSON lines they
emit, then ``{"phase": "smoke_phases", ...}`` with the card, the allocator
setting and each phase's seconds. Unlike ``chip_smoke.py`` it leaves
``PYTORCH_CUDA_ALLOC_CONF`` as the caller set it, so that runs in turns
compare allocator settings on one card.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(names) -> int:
    import torch

    if not names or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels.build import build_all

    build_all()
    seconds = {}
    for name in names:
        t = time.perf_counter()
        getattr(cs, "phase_" + name)(torch)
        seconds[name] = time.perf_counter() - t
    cs.emit("smoke_phases", nvidia_smi=cs.nvidia_smi(),
            alloc_conf=os.environ.get("PYTORCH_CUDA_ALLOC_CONF", ""), seconds=seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
