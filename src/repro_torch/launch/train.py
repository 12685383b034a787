"""End-to-end trainer: local-update (FL-across-pods) training with
fault-tolerant checkpointing and elastic restart (the port of
``repro/launch/train.py``).

- The full config (``--full``) or the reduced one (the default), real
  optimization on synthetic token data (``data.tokens``).
- Every step is ``launch.steps``' built step on a ``DeviceMesh`` over the
  world's ranks: ``mesh_kind="host"`` lays them out as data x model (one
  process: 1 x 1); ``"prod"`` as ``make_production_mesh``'s 16 x 16, or
  2 x 16 x 16 with pods when ``inner_steps > 1``, and raises
  ``ValueError`` naming the 256 or 512 ranks it needs in a smaller world.
- ``inner_steps > 1`` is the local-SGD mode. With a "pod" axis every pod
  trains its own replica on its share of the batch (``mode="local_sgd"``)
  and every ``inner_steps`` steps ``build_outer_sync`` averages the pods'
  deltas from the anchor (int8 on the wire with
  ``outer_compression="int8"``) into the outer optimizer
  (``optim.nesterov_outer``) and resets every pod to the new anchor.
  Without pods the one replica's delta goes through the outer optimizer
  directly, as the reference's host mode does.
- Checkpoints (``checkpoint.CheckpointManager``, the reference's on-disk
  format) hold ``{params, opt, step}`` gathered whole (``full_tree``); a
  run restarts from LATEST and the step's in specs split the restored state
  again, so a restart may use another mesh (the reference's elastic
  restart).

It runs on CUDA unless ``device="cpu"`` is passed, and raises without
CUDA. ``optimizer`` is the ``TrainConfig``'s ("adamw" or "adafactor": at
full width AdamW's f32 moments alone outgrow the card for Mixtral), and
``n_layers`` cuts the depth of a model that does not fit on the card
whole. The result carries each step's loss and router aux loss (pods:
their mean). The weights come from a seeded ``torch.Generator``, so they
are not the reference's (threefry) draws.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --steps 50 --inner-steps 5 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b --full
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config, get_reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.tokens import token_batch_for
from repro_torch.launch.mesh import MeshShape, make_device_mesh, make_production_mesh
from repro_torch.launch.steps import build_outer_sync, build_train_step, make_optimizer, run_built
from repro_torch.models import Model
from repro_torch.optim import nesterov_outer
from repro_torch.sharding.rules import full_tree, mesh_sizes
from repro_torch.utils import resolve_device, tree_map, tree_sub


def train_mesh(mesh_kind: str, inner_steps: int, device):
    """The DeviceMesh of ``mesh_kind`` over the world's ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh_kind == "prod":
        shape = make_production_mesh(multi_pod=inner_steps > 1)
        if world != shape.size:
            raise ValueError(f"mesh_kind='prod' lays {shape.axis_names} x {shape.shape} over "
                             f"{shape.size} ranks; this world has {world}")
    elif mesh_kind == "host":
        shape = MeshShape(("data", "model"), (world, 1))
    else:
        raise ValueError(f"unknown mesh_kind {mesh_kind!r}; expected 'host' or 'prod'")
    return make_device_mesh(shape, device=device)


def train(
    arch: str,
    *,
    reduced: bool = True,
    steps: int = 50,
    inner_steps: int = 1,
    batch: int = 8,
    seq: int = 64,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 10,
    mesh_kind: str = "host",
    seed: int = 0,
    log_every: int = 10,
    outer_compression: str = "none",
    learning_rate: float = 2e-3,
    optimizer: str = "adamw",
    n_layers: Optional[int] = None,
    device=None,
):
    device = resolve_device(device)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    if n_layers is not None:  # a depth cut, for a model that does not fit on the card whole
        cfg = cfg.replace(n_layers=n_layers)
    tcfg = TrainConfig(
        optimizer=optimizer,
        learning_rate=learning_rate,
        total_steps=steps,
        warmup_steps=max(steps // 10, 1),
        inner_steps=inner_steps,
        compression=outer_compression,
    )
    mesh = train_mesh(mesh_kind, inner_steps, device)
    n_pod = mesh_sizes(mesh).get("pod", 0)
    built = build_train_step(cfg, tcfg, ShapeSpec("custom", "train", seq, batch), mesh,
                             mode="local_sgd" if n_pod else "sync")
    model = Model(cfg)
    opt = make_optimizer(tcfg)

    params = model.init(torch.Generator(device=device).manual_seed(seed))
    state = {
        "params": params,
        "opt": opt.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if n_pod:  # one replica per pod, all from the same draw
        state = tree_map(lambda t: t.expand((n_pod,) + tuple(t.shape)).clone(), state)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr is not None:
        restored = mgr.restore_latest(state)
        if restored is not None:
            state, meta = restored
            start_step = int(meta.get("step", 0))
            print(f"[train] resumed from checkpoint at step {start_step}")

    # local-SGD outer state (anchor = last synced params, a copy: the train
    # step updates the params in place). Only the local-SGD mode reads it,
    # so only that mode holds it: at full width the copy and the outer
    # momentum are 3x the params' bytes (the reference makes both always)
    if inner_steps > 1:
        anchor = tree_map(lambda t: (t[0] if n_pod else t).clone(), full_tree(state["params"]))
        outer = nesterov_outer(tcfg.outer_lr, tcfg.outer_momentum)
        outer_state = outer.init(anchor)
        sync = build_outer_sync(cfg, tcfg, mesh) if n_pod else None

    losses, auxes = [], []
    t0 = time.time()
    for it in range(start_step, steps):
        np_batch = token_batch_for(cfg, batch=batch, seq=seq, seed=seed + it)
        tbatch = {k: torch.as_tensor(v, device=device) for k, v in np_batch.items()}
        if n_pod:  # each pod its share of the batch
            tbatch = {k: v.reshape((n_pod, batch // n_pod) + v.shape[1:]) for k, v in tbatch.items()}
        state, metrics = run_built(built, mesh, state, tbatch)
        metrics = full_tree(metrics)
        losses.append(float(metrics["loss"].float().mean()))
        auxes.append(float(metrics["aux"].float().mean()))

        if inner_steps > 1 and (it + 1) % inner_steps == 0:
            if n_pod:  # the FedAvg burst across pods; every pod reset to the anchor
                step_t = torch.full((), it, dtype=torch.int32, device=device)
                params_s, anchor, outer_state = run_built(sync, mesh, state["params"], anchor,
                                                          outer_state, step_t)
                state = dict(state, params=params_s)
            else:  # one replica: its delta straight into the outer optimizer
                delta = tree_sub(full_tree(state["params"]), anchor)
                upd, outer_state = outer.update(delta, outer_state, anchor, it)
                new_anchor = tree_map(lambda a, u: (a.float() + u).to(a.dtype), anchor, upd)
                anchor = tree_map(torch.clone, new_anchor)
                state = dict(state, params=new_anchor)

        if mgr is not None and (it + 1) % ckpt_every == 0:
            mgr.save(it + 1, full_tree(state), metadata={"arch": arch, "loss": losses[-1]})
        if (it + 1) % log_every == 0:
            dt = time.time() - t0
            print(
                f"[train] step {it+1}/{steps} loss={losses[-1]:.4f} "
                f"({dt / (it + 1 - start_step):.2f}s/step)"
            )

    return {"losses": losses, "aux": auxes,
            "final_loss": losses[-1] if losses else float("nan")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--inner-steps", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--mesh", default="host", choices=["host", "prod"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args()
    out = train(
        args.arch,
        reduced=args.reduced,
        steps=args.steps,
        inner_steps=args.inner_steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        mesh_kind=args.mesh,
        seed=args.seed,
        device=args.device,
    )
    print(f"[train] done: final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
