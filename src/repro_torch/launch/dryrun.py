"""Multi-pod dry-run: show that every (arch x shape x mesh) cell of the port
builds and traces on the production mesh, and what one rank would do and
hold there, without the cards (the port of ``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.json

The reference lowers and compiles each cell on 512 fake XLA host devices.
Here the 16 x 16 (or 2 x 16 x 16) mesh is a ``DeviceMesh`` of "cuda" on
torch's fake process group (backend ``"fake"``: one process plays rank 0
of all of them; a collective sends nothing). The cell's ``BuiltStep``
(``launch.steps.build_step``, the step the card runs) is traced once from
rank 0's shards, ``meta`` tensors of each input's local shape, by
``launch.hlo_analysis``: FLOPs, bytes and collective bytes per rank, and
the peak of live bytes, which ``fits_hbm`` compares with one card's 80 GB
(``launch.mesh.H100_SXM``). The peak counts each storage the traced step
makes on rank 0, from the op that makes it to its last use, with the
inputs and outputs held throughout: the shards of the params and the
optimizer state, the activations the backward keeps, and every temporary
(the loss's f32 logits shard [b, chunk, V / model] a chunk among them); not
the caching allocator's slack, nor what runs outside the trace.
``launch.roofline.derive`` turns the counts into roofline terms. The
step's scalar step count enters as a Python int (0): the optimizer reads
it on the host. Records append to a JSON file
(resumable). Nothing runs on a card and no kernel is launched.

The default process group is global to a process, so the dry-run runs in
a process of its own (as the reference's does, for its 512 host devices):
it refuses to start where a process group of another backend exists.

The cell rules are the reference's: remat "full" for train shapes, the
config's ``skip_shapes``, a tokens-per-chip budget per microbatch (tighter
for wide, hybrid and MoE models) and the optimizer and its state dtype by
param count.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import GRID_ARCHS, SHAPES_BY_NAME, TrainConfig, get_config
from repro_torch.launch.hlo_analysis import BYTES_NOTE, analyze_graph, trace
from repro_torch.launch.mesh import H100_SXM, MeshShape, make_production_mesh
from repro_torch.launch.roofline import derive
from repro_torch.launch.steps import build_outer_sync, build_step

MEMORY_NOTE = ("peak_memory_in_bytes: the most bytes of storages alive at once in rank 0's "
               "traced step, inputs included (a storage lives from the op that makes it to "
               "its last use); argument_size_in_bytes: rank 0's input shards")


def fake_mesh(shape: MeshShape):
    """A "cuda" ``DeviceMesh`` of ``shape`` over a fake process group of
    ``shape.size`` ranks, this process rank 0. Starts (or resizes) the fake
    world; refuses where the process holds a real group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry-run runs in a process of its own: this one holds a "
                f"{dist.get_backend()} process group of {dist.get_world_size()} ranks")
        if dist.get_world_size() != shape.size:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=shape.size)
    ranks = torch.arange(shape.size).reshape(shape.shape)
    return DeviceMesh("cuda", ranks, mesh_dim_names=shape.axis_names)


def _leaves(tree, specs, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], specs[k], path + (k,))
    else:
        yield path, tree, specs


def _rebuild(tree, values, path=()):
    """``tree``'s structure with each leaf at ``path`` replaced by ``values[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values, path + (k,)) for k in tree}
    return values[path]


def _traced_step(built, mesh):
    """(fn over rank 0's local shards, those shards as meta tensors, their
    bytes): ``fn`` wraps the shards as DTensors, runs the step and lays its
    outputs out by the out specs, returning their local shards."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.sharding.rules import placements_on

    slots, shards = [], []
    for i, (arg, spec) in enumerate(zip(built.abstract_args, built.in_shardings)):
        for path, leaf, leaf_spec in _leaves(arg, spec, (i,)):
            if leaf.ndim == 0 and not leaf.is_floating_point():  # the step count
                slots.append((path, None))
                continue
            pl = placements_on(leaf_spec, mesh)
            local, _ = compute_local_shape_and_global_offset(leaf.shape, mesh, pl)
            slots.append((path, (pl, tuple(leaf.shape), leaf.stride())))
            shards.append(torch.empty(local, dtype=leaf.dtype, device="meta"))

    def fn(*locals_):
        values, it = {}, iter(locals_)
        for path, layout in slots:
            if layout is None:
                values[path] = 0
                continue
            pl, shape, stride = layout  # read outside the trace: no whole-leaf allocation in it
            values[path] = DTensor.from_local(next(it), mesh, pl, run_check=False, shape=shape,
                                              stride=stride)
        args = [_rebuild(a, values, (i,)) for i, a in enumerate(built.abstract_args)]
        outs = built.fn(*args)
        flat = []
        for out, spec in zip(outs, built.out_shardings):
            for _, leaf, leaf_spec in _leaves(out, spec):
                if isinstance(leaf, DTensor):
                    leaf = leaf.redistribute(mesh, placements_on(leaf_spec, mesh))._local_tensor
                if isinstance(leaf, torch.Tensor):
                    flat.append(leaf)
        return flat

    return fn, shards, float(sum(t.numel() * t.element_size() for t in shards))


def _trace_cost(built, mesh):
    fn, shards, arg_bytes = _traced_step(built, mesh)
    t0 = time.time()
    gm = trace(fn, *shards)
    t_trace = time.time() - t0
    cost = analyze_graph(gm)
    memory = {"peak_memory_in_bytes": cost.peak_bytes, "argument_size_in_bytes": arg_bytes,
              "how": MEMORY_NOTE}
    return cost, memory, t_trace


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    mode: str = "sync",
    overrides: Optional[Dict] = None,
    microbatches: Optional[int] = None,
) -> Dict:
    """Build and trace one cell; returns the result record."""
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    if shape.kind == "train":
        # remat "full" with gradient accumulation is the reference's
        # fitting baseline for these workloads
        cfg = cfg.replace(remat="full")
    if overrides:
        cfg = cfg.replace(**overrides)
    record: Dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "mode": mode,
        "status": "skipped",
    }
    if shape_name in cfg.skip_shapes:
        record["skip_reason"] = cfg.skip_reason
        return record

    mesh_shape = make_production_mesh(multi_pod=multi_pod)
    chips = mesh_shape.size
    sizes = dict(zip(mesh_shape.axis_names, mesh_shape.shape))
    batch_ways = sizes.get("data", 1) * (sizes.get("pod", 1) if mode == "sync" else 1)
    tokens_per_chip = shape.global_batch * shape.seq_len // max(batch_ways, 1)
    micro = 1
    if shape.kind == "train":
        # activation-memory heuristic: a token budget per chip per
        # microbatch, tighter for wide (>10B) and hybrid models, tightest
        # for MoE and the 236B tier (dispatch buffers scale with tokens)
        n = cfg.param_count()
        target = 32768
        if n > 1e10 or cfg.hybrid is not None:
            target = 16384
        if n > 1e11 or (cfg.moe is not None and cfg.moe.num_experts):
            target = 8192
        while (tokens_per_chip // micro > target
               and shape.global_batch % (micro * 2 * batch_ways) == 0):
            micro *= 2
    if microbatches is not None:
        micro = microbatches
    tcfg = TrainConfig(
        opt_state_dtype="bfloat16" if cfg.param_count() > 3e10 else "float32",
        optimizer="adafactor" if cfg.param_count() > 1e11 else "adamw",
        microbatches=micro,
    )
    t0 = time.time()
    try:
        mesh = fake_mesh(mesh_shape)
        built = build_step(cfg, tcfg, shape, mesh, mode=mode)
        t_build = time.time() - t0
        cost, memory, t_trace = _trace_cost(built, mesh)
        terms = derive(
            cfg,
            shape,
            mesh_name=record["mesh"],
            chips=chips,
            flops_per_chip=cost.flops,
            bytes_per_chip=cost.bytes,
            collective_bytes=cost.collective_bytes,
            notes=BYTES_NOTE,
        )
        record.update(
            status="ok",
            step_name=built.name,
            microbatches=micro,
            build_s=round(t_build, 1),
            trace_s=round(t_trace, 1),
            memory=memory,
            fits_hbm=bool(memory["peak_memory_in_bytes"] <= H100_SXM["hbm_bytes"]),
            trace={
                "flops_per_chip": cost.flops,
                "bytes_per_chip": cost.bytes,
                "collective_bytes": cost.collective_bytes,
                "n_ops": cost.n_ops,
            },
            roofline=terms.as_dict(),
        )
    except Exception as e:  # noqa: BLE001 (record and continue the sweep)
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-2000:])
    return record


def run_outer_sync(arch: str, *, compression: str = "none") -> Dict:
    """Trace the cross-pod FedAvg sync (multi-pod only, the paper's burst)."""
    cfg = get_config(arch)
    tcfg = TrainConfig(compression=compression)
    record = {"arch": arch, "step": f"outer_sync:{compression}", "mesh": "2x16x16"}
    t0 = time.time()
    try:
        mesh = fake_mesh(make_production_mesh(multi_pod=True))
        built = build_outer_sync(cfg, tcfg, mesh, compression=compression)
        cost, memory, _ = _trace_cost(built, mesh)
        record.update(
            status="ok",
            trace_s=round(time.time() - t0, 1),
            collective_bytes=cost.collective_bytes,
            memory=memory,
            fits_hbm=bool(memory["peak_memory_in_bytes"] <= H100_SXM["hbm_bytes"]),
        )
    except Exception as e:  # noqa: BLE001
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      trace=traceback.format_exc()[-2000:])
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="one architecture id")
    ap.add_argument("--shape", default=None, help="one shape name")
    ap.add_argument("--all", action="store_true", help="all 40 grid cells")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="sync", choices=["sync", "local_sgd"])
    ap.add_argument("--outer-sync", action="store_true",
                    help="also trace the cross-pod FedAvg sync per arch")
    ap.add_argument("--compression", default="none", choices=["none", "int8"])
    ap.add_argument("--out", default=None, help="append results to this JSON")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already present in --out")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in GRID_ARCHS
                 for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    existing = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    done = {(r.get("arch"), r.get("shape"), r.get("mesh"), r.get("mode")) for r in existing}

    mesh_name = "2x16x16" if args.multi_pod else "16x16"
    results = list(existing)

    def save():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    for arch, shape in cells:
        if args.resume and (arch, shape, mesh_name, args.mode) in done:
            print(f"[skip] {arch} x {shape} ({mesh_name}) already done")
            continue
        print(f"[dryrun] {arch} x {shape} mesh={mesh_name} mode={args.mode} ...", flush=True)
        rec = run_cell(arch, shape, multi_pod=args.multi_pod, mode=args.mode)
        _print_record(rec)
        results.append(rec)
        save()

    if args.outer_sync:
        for arch in sorted({a for a, _ in cells}):
            rec = run_outer_sync(arch, compression=args.compression)
            print(f"[outer_sync] {arch}: {rec['status']} coll={rec.get('collective_bytes')}"
                  + (f" ERROR: {rec.get('error')}" if rec["status"] == "error" else ""),
                  flush=True)
            results.append(rec)
            save()

    n_ok = sum(1 for r in results if r.get("status") == "ok")
    n_err = sum(1 for r in results if r.get("status") == "error")
    n_skip = sum(1 for r in results if r.get("status") == "skipped")
    print(f"\n== dry-run summary: {n_ok} ok / {n_skip} skipped / {n_err} errors ==")
    return 1 if n_err else 0


def _print_record(rec: Dict):
    if rec["status"] == "ok":
        r = rec["roofline"]
        print(
            f"  ok ({rec['trace_s']}s trace): dominant={r['dominant']} "
            f"compute={r['compute_s']*1e3:.1f}ms memory={r['memory_s']*1e3:.1f}ms "
            f"collective={r['collective_s']*1e3:.1f}ms ({r['link']}) "
            f"useful={r['useful_ratio']:.2f} peak={rec['memory']['peak_memory_in_bytes']/1e9:.2f}GB "
            f"fits_hbm={rec['fits_hbm']}", flush=True)
    elif rec["status"] == "skipped":
        print(f"  skipped: {rec.get('skip_reason', '')[:80]}")
    else:
        print(f"  ERROR: {rec.get('error')}")


if __name__ == "__main__":
    raise SystemExit(main())
