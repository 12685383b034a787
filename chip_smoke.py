#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root. Phases, each printing one JSON line:

1. device    card, torch/CUDA versions, TF32 turned off for matmul and cuDNN
             (the JAX reference computes in full f32);
2. build     every ``src/repro_torch/kernels/csrc/*.cu``, one nvcc each, in
             parallel, into ``build/repro_torch/``;
3. kernel    each hand-written kernel against its plain PyTorch version on
             the card, at the reference test shapes and the main path's
             shapes, with device time, plain time, one-call library time
             and the HBM/FLOP bound;
4. quant_kernels
             the three quantize kernels against their plain versions, codes
             and bf16 bits equal (not close), at the reference sweep sizes
             and the main path's 8 leaf shapes with R = 10 rows, with the
             same timing fields as ``kernel``;
5. main_path the paper's experiment through ``FederatedServer.run``:
             10 clients x 200 examples, batch 32, 4 local steps, 8 rounds,
             fedavg(min_fit=0.1), the quickstart chaos schedule, batched
             engine, DEFAULT and TUNED_EDGE TCP; launch counts reset just
             before each run and read just after;
6. profile   device time by kernel over one more main-path run;
7. compressed
             the same config with the int8, bf16 and topk(0.05) compressors:
             all 8 rounds, the quantize kernels launched once per leaf per
             round, dense == sparse StatePlane bitwise, compress_plane ==
             per-client compress/decompress bitwise over 3 rounds, s/round
             and device time by kernel;
8. engines   the sequential engine on the same config: equal numpy fields,
             final accuracy within 1e-3;
9. headline  6 s one-way delay: DEFAULT completes 0 rounds, TUNED_EDGE all 4
             (accuracy > 0.3); one stochastic fused_transport run.

Then the kernels line, the card's name and power limit as nvidia-smi gives
them, and the final ``{"ok": true, ...}`` line. A failed phase raises: the
script exits non-zero and prints no result. Without CUDA, or without the
repository beside it, it exits 2.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
MAIN_ROUNDS = 8


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


def device_us(torch, fn, iters: int = 100, reps: int = 7) -> float:
    """Median device microseconds per call. A sleep kernel holds the card
    while the host enqueues ``iters`` calls, so the events bracket device
    execution only, not Python launch overhead."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) * 1e3 / iters)
    return statistics.median(samples)


def wall_us(torch, fn, iters: int = 100, reps: int = 7) -> float:
    """Median host-to-completion microseconds per back-to-back call (what
    a caller issuing one call at a time sees, launch overhead included)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e6 / iters)
    return statistics.median(samples)


def fedavg_work(C: int, N: int, itemsize: int) -> tuple:
    """(bytes, flops) of out = w @ x: each input read once, the output
    written once, one multiply-add per element of x."""
    return C * N * itemsize + 4 * C + 4 * N, 2 * C * N


def bound_us(bytes_moved: int, flops: int) -> tuple:
    """Least time the card could take: HBM time or f32 FMA time, whichever
    is larger, and which of the two it is."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e6
    t_ops = flops / F32_FLOPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_kernel(torch, main_leaf_sizes):
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import fedavg_reduce_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tol = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
    cases = [(C, N, dt, "reference") for C, N in ((3, 1000), (10, 4096), (7, 12345))
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(3, N, torch.float32, "padding") for N in (1, 100, 2048, 2049, 12345)]
    cases += [(10, N, torch.float32, "main_path") for N in main_leaf_sizes]
    max_err = 0.0
    main = {"us": 0.0, "wall_us": 0.0, "plain_us": 0.0, "library_us": 0.0, "bytes": 0, "flops": 0}
    for C, N, dtype, group in cases:
        x = torch.randn(C, N, generator=gen, device=dev).to(dtype)
        w = torch.rand(C, generator=gen, device=dev) + 0.05
        w = w / w.sum()
        got = fr.fedavg_reduce_flat(x, w)
        plain = fedavg_reduce_ref(x, w)
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(got - plain)))
        check(got.dtype == torch.float32 and got.shape == (N,), f"fedavg_reduce output {C}x{N}")
        check(err <= tol[dtype], f"fedavg_reduce {C}x{N} {dtype}: max err {err} > {tol[dtype]}")
        max_err = max(max_err, err)
        work = fedavg_work(C, N, x.element_size())
        bound, bound_by = bound_us(*work)
        row = {
            "C": C, "N": N, "dtype": str(dtype).replace("torch.", ""), "group": group,
            "max_abs_err": err,
            "us": device_us(torch, lambda: fr.fedavg_reduce_flat(x, w)),
            "wall_us": wall_us(torch, lambda: fr.fedavg_reduce_flat(x, w)),
            "plain_us": device_us(torch, lambda: fedavg_reduce_ref(x, w)),
            # one PyTorch call computing the same function (yardstick only)
            "library_us": (
                device_us(torch, lambda: torch.mv(x.t(), w)) if dtype == torch.float32 else None
            ),
            "bound_us": bound, "bound_by": bound_by,
        }
        if group == "main_path":
            for k in ("us", "wall_us", "plain_us", "library_us"):
                main[k] += row[k]
            main["bytes"] += work[0]
            main["flops"] += work[1]
        emit("kernel", **row)
    # C = 1 identity and weight-scale invariance through the tree wrapper
    x = torch.randn(1, 3000, generator=gen, device=dev)
    ident = ops.fedavg_reduce({"x": x}, torch.tensor([17.0], device=dev))["x"]
    x4 = torch.randn(4, 512, generator=gen, device=dev)
    w4 = torch.tensor([1.0, 2.0, 3.0, 4.0], device=dev)
    scaled = float(torch.max(torch.abs(
        ops.fedavg_reduce({"x": x4}, w4)["x"] - ops.fedavg_reduce({"x": x4}, w4 * 100)["x"]
    )))
    ident_err = float(torch.max(torch.abs(ident - x[0])))
    check(ident_err <= 1e-6, f"C=1 identity err {ident_err}")
    check(scaled <= 1e-6, f"weight-scale invariance err {scaled}")
    emit("kernel_invariants", c1_identity_err=ident_err, weight_scale_err=scaled)
    return max(max_err, ident_err, scaled), main


# name -> (bytes, operations) of one call on x [R, N] f32: each input read
# once, each output written once; a division and an add per int8 code, one
# conversion per bf16 value
QUANT_WORK = {
    "quantize_rows": lambda R, N: (R * N * 4 + R * 4 + R * N, 2 * R * N),
    "downcast_bf16_rows": lambda R, N: (R * N * 4 + R * N * 2, R * N),
    "quantize_stochastic": lambda R, N: (N * 8 + 4 + N, 2 * N),
}
NO_LIBRARY = ("no single PyTorch call computes these codes: quantize_per_channel "
              "rounds half to even and carries a zero point")


def phase_quant_kernels(torch, main_leaf_sizes):
    """Each quantize kernel against its plain version: int8 codes and bf16
    bits must be EQUAL. Main-path rows are the 8 CNN leaves at R = 10 (one
    compressed round), summed; the stochastic kernel, off the main path,
    is timed on the whole flattened CNN (N = 206,922)."""
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    c127 = torch.tensor(127.0, device=dev)

    def scales_of(x):
        return torch.clamp(x.abs().amax(dim=-1), min=1e-12) / c127

    def rows_case(R, N):
        x = torch.randn(R, N, generator=gen, device=dev) * 2.5
        s = scales_of(x)
        return (lambda: qz.quantize_rows_flat(x, s), lambda: ref.quantize_rows_ref(x, s),
                None)

    def bf16_case(R, N):
        x = torch.randn(R, N, generator=gen, device=dev)
        return (lambda: qz.downcast_bf16_rows_flat(x), lambda: ref.downcast_bf16_rows_ref(x),
                lambda: x.to(torch.bfloat16))

    def stochastic_case(R, N):
        x = torch.randn(N, generator=gen, device=dev) * 3.0
        u = torch.rand(N, generator=gen, device=dev)
        scale = torch.clamp(x.abs().max(), min=1e-12) / c127
        return (lambda: qz.quantize_stochastic_flat(x, u, scale),
                lambda: ref.quantize_stochastic_ref(x, u, scale), None)

    makers = {"quantize_rows": rows_case, "downcast_bf16_rows": bf16_case,
              "quantize_stochastic": stochastic_case}
    cases = [("quantize_rows", 3, N, "reference") for N in (100, 2048, 2049, 9999)]
    cases += [("downcast_bf16_rows", 2, N, "reference") for N in (128, 2050)]
    cases += [("quantize_stochastic", 1, N, "reference") for N in (100, 4096, 9999)]
    cases += [(k, 10, N, "main_path") for k in ("quantize_rows", "downcast_bf16_rows")
              for N in main_leaf_sizes]
    cases += [("quantize_stochastic", 1, sum(main_leaf_sizes), "main_path")]
    fields = ("us", "wall_us", "plain_us", "library_us")
    out = {k: {**{f: 0.0 for f in fields}, "bytes": 0, "ops": 0, "max_abs_err": 0.0,
               "check_launches": 0} for k in makers}
    for name, R, N, group in cases:
        kernel, plain, library = makers[name](R, N)
        before = qz.launches[name]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        out[name]["check_launches"] += qz.launches[name] - before
        check(got.dtype == want.dtype and got.shape == want.shape, f"{name} {R}x{N} output")
        if got.dtype == torch.bfloat16:
            equal = torch.equal(got.view(torch.int16), want.view(torch.int16))
        else:
            equal = torch.equal(got, want)
        err = float(torch.max(torch.abs(got.float() - want.float())))
        check(equal, f"{name} {R}x{N}: kernel != plain version (max err {err})")
        row = {"kernel": name, "R": R, "N": N, "group": group, "equal": equal, "max_abs_err": err}
        if group == "main_path":
            work = QUANT_WORK[name](R, N)
            bound, bound_by = bound_us(*work)
            row.update(us=device_us(torch, kernel), wall_us=wall_us(torch, kernel),
                       plain_us=device_us(torch, plain),
                       library_us=device_us(torch, library) if library else None,
                       bound_us=bound, bound_by=bound_by)
            acc = out[name]
            for f in fields:
                acc[f] = None if row[f] is None else acc[f] + row[f]
            acc["bytes"] += work[0]
            acc["ops"] += work[1]
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        emit("quant_kernels", **row)
    # an all-zero row hits the scale clamp and quantizes to exact zeros
    x = torch.stack([torch.zeros(300, device=dev), torch.linspace(-1.0, 1.0, 300, device=dev)])
    q = qz.quantize_rows_flat(x, scales_of(x))
    check(not q[0].any() and q[1].any() and torch.equal(q, ref.quantize_rows_ref(x, scales_of(x))),
          "quantize_rows zero row")
    emit("quant_kernels_zero_row", equal=True)
    return out


def _stacked_deltas(torch, template, rows, seed):
    from repro_torch.utils import tree_map

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tree_map(
        lambda l: torch.randn((rows,) + tuple(l.shape), generator=gen, device="cuda") * 1e-2,
        template,
    )


def _trees_equal(torch, a, b) -> bool:
    from repro_torch.utils import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def phase_compressed(torch, uncompressed_s_per_round):
    """The quickstart with each plane compressor: all 8 rounds, the kernels
    launched once per leaf per round, dense == sparse bitwise, and the
    plane == the per-client loop bitwise on the card."""
    from repro_torch.compress import get_compressor, init_residual_plane
    from repro_torch.utils import tree_stack, tree_unstack

    expect_kernel = {"int8": "quantize_rows", "bf16": "downcast_bf16_rows", "topk": None}
    runs = {}
    for name in ("int8", "bf16", "topk"):
        hists = {}
        for plane in ("dense", "sparse"):
            hist, wall, counts = timed_run(torch, paper_server(
                torch, compressor=get_compressor(name, ratio=0.05), state_plane=plane))
            hists[plane] = (hist, wall, counts)
        hist, wall, counts = hists["dense"]
        acc = hist.final_accuracy()
        done = hist.completed_rounds
        check(done == MAIN_ROUNDS, f"{name}: {done} of {MAIN_ROUNDS} rounds completed")
        check(acc is not None and acc == acc, f"{name}: accuracy not finite")
        check(counts["fedavg_reduce"] == 8 * done, f"{name}: fedavg_reduce launches {counts}")
        for kern in ("quantize_rows", "downcast_bf16_rows"):
            want = 8 * done if kern == expect_kernel[name] else 0
            for plane in ("dense", "sparse"):
                got = hists[plane][2][kern]
                check(got == want, f"{name} ({plane}): {got} {kern} launches, expected {want}")
        sparse = hists["sparse"][0]
        check(numpy_fields(hist) == numpy_fields(sparse), f"{name}: dense vs sparse numpy fields")
        check(all(a == b for a, b in zip(hist.rounds, sparse.rounds))
              and len(hist.rounds) == len(sparse.rounds), f"{name}: dense vs sparse records")
        check(hist.eval_metrics == sparse.eval_metrics, f"{name}: dense vs sparse eval trace")
        runs[name] = {"wall_s": wall, "s_per_round": wall / len(hist.rounds),
                      "sparse_s_per_round": hists["sparse"][1] / len(sparse.rounds),
                      "launches": counts, "final_accuracy": acc, "completed_rounds": done,
                      "accuracy": [m["accuracy"] for m in hist.eval_metrics]}

    # compress_plane == per-client compress/decompress, bitwise, 3 rounds
    from repro_torch.models.cnn import cnn_init

    template = tree_unstack(_stacked_deltas(torch, cnn_init(torch.Generator()), 1, 0))[0]
    slots = [7, 0, 3, 9, 5, 1]
    for name in ("int8", "bf16", "topk"):
        comp = get_compressor(name, ratio=0.05)
        seq_res = [None] * 10
        plane_res = init_residual_plane(template, 10)
        for rnd in range(3):
            stacked = _stacked_deltas(torch, template, len(slots), 10 + rnd)
            rows = tree_unstack(stacked)
            seq_out = []
            for j, s in enumerate(slots):
                payload, seq_res[s] = comp.compress(rows[j], seq_res[s])
                seq_out.append(comp.decompress(payload))
            plane_out, plane_res = comp.compress_plane(stacked, plane_res, slots)
            check(_trees_equal(torch, tree_stack(seq_out), plane_out),
                  f"{name} round {rnd}: plane output != per-client output")
            res_rows = tree_unstack(plane_res)
            check(all(_trees_equal(torch, seq_res[s], res_rows[s]) for s in slots),
                  f"{name} round {rnd}: plane residuals != per-client residuals")
    torch.cuda.synchronize()
    emit("compressed", uncompressed_s_per_round=uncompressed_s_per_round,
         runs=runs, dense_equals_sparse=True, plane_equals_per_client=True)
    return runs


def paper_server(torch, *, tcp_name="DEFAULT", batched=True, rounds=MAIN_ROUNDS,
                 compressor=None, **cfg):
    """The quickstart: 10 clients x 200 examples, fedavg(min_fit=0.1), a
    degraded network from t=60 s and 30 % of pods killed from t=120 s."""
    from repro_torch import transport
    from repro_torch.chaos import ChaosSchedule, client_failure_schedule, netem
    from repro_torch.core import EdgeClient, FederatedServer, ServerConfig, fedavg, mnist_cnn_task
    from repro_torch.data import make_federated_mnist, synthetic_mnist

    shards = make_federated_mnist(n_clients=10, examples_per_client=200, seed=0)
    chaos = ChaosSchedule(transport.LAB).add(
        netem(60.0, 10_000.0, delay=0.8, loss=0.10),
        client_failure_schedule(10, 0.3, t_start=120.0, seed=3),
    )
    return FederatedServer(
        mnist_cnn_task(lr=0.05, batch_size=32),
        [EdgeClient(i, dataset=s) for i, s in enumerate(shards)],
        fedavg(min_fit=0.1),
        tcp=getattr(transport, tcp_name),
        chaos=chaos,
        config=ServerConfig(rounds=rounds, local_steps=4, seed=0, batched=batched, **cfg),
        compressor=compressor,
        eval_data=synthetic_mnist(400, seed=99),
    )


def reset_launches() -> None:
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import quantize as qz

    fr.launches = 0
    for name in qz.launches:
        qz.launches[name] = 0


def read_launches() -> dict:
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import quantize as qz

    return {"fedavg_reduce": fr.launches, **qz.launches}


def timed_run(torch, server):
    """Run ``server`` with every kernel's launch count set to 0 just before
    and read just after; returns (history, wall s, launches by kernel)."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    hist = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return hist, wall, read_launches()


def numpy_fields(hist):
    return {
        "total_time": hist.total_time,
        "completed_rounds": hist.completed_rounds,
        "delivered": [r.delivered for r in hist.rounds],
        "reconnects": [r.reconnects for r in hist.rounds],
        "status": (hist.status, hist.cause),
        "selected_ids": [r.selected_ids for r in hist.rounds],
    }


def phase_main_path(torch):
    # warm-up: CUDA context, cuBLAS/cuDNN handles; counts are reset after it
    timed_run(torch, paper_server(torch, rounds=1))
    runs = {}
    for tcp_name in ("DEFAULT", "TUNED_EDGE"):
        hist, wall, counts = timed_run(torch, paper_server(torch, tcp_name=tcp_name))
        launches = counts["fedavg_reduce"]
        accs = [m["accuracy"] for m in hist.eval_metrics]
        check(launches == 8 * hist.completed_rounds,
              f"{tcp_name}: {launches} fedavg_reduce launches for {hist.completed_rounds} rounds")
        check(hist.completed_rounds > 0 and accs[-1] > accs[0],
              f"{tcp_name}: accuracy did not rise: {accs}")
        emit("main_path", tcp=tcp_name, summary=hist.summary(), accuracy=accs,
             wall_s=wall, wall_s_per_round=wall / len(hist.rounds),
             fedavg_reduce_launches=launches)
        runs[tcp_name] = (hist, launches, wall)
    return runs


def phase_profile(torch, unprofiled_wall_s, phase="profile", names=("fedavg_reduce",), **cfg):
    """Device time by kernel name over one more main-path run (CUPTI). The
    profiler slows the host, so the idle share is taken against the wall
    time of the same run unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    server = paper_server(torch, **cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        server.run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]

    def device_time(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else e.self_cuda_time_total

    device_total = sum(device_time(e) for e in kernels)
    top = sorted(kernels, key=lambda e: -device_time(e))[:12]
    by_name = {f"{n}_device_us": sum(device_time(e) for e in kernels if n in e.key)
               for n in names}
    emit(phase, profiled_wall_s=wall, unprofiled_wall_s=unprofiled_wall_s,
         device_busy_us=device_total, **by_name,
         device_idle_share=1.0 - device_total / (unprofiled_wall_s * 1e6),
         top=[{"name": e.key[:90], "device_us": device_time(e), "calls": e.count}
              for e in top])


def phase_engines(torch, batched_hist):
    seq, wall, counts = timed_run(torch, paper_server(torch, batched=False))
    launches = counts["fedavg_reduce"]
    a, b = numpy_fields(batched_hist), numpy_fields(seq)
    check(a == b, f"batched vs sequential numpy fields differ: {a} vs {b}")
    diff = abs(batched_hist.final_accuracy() - seq.final_accuracy())
    check(diff <= 1e-3, f"batched vs sequential final accuracy differ by {diff}")
    emit("engines", numpy_fields_equal=True, final_accuracy_diff=diff,
         sequential_wall_s=wall, sequential_launches=launches)


def phase_headline(torch):
    from repro_torch import transport
    from repro_torch.chaos import ChaosSchedule
    from repro_torch.core import EdgeClient, FederatedServer, ServerConfig, fedavg, mnist_cnn_task
    from repro_torch.data import make_federated_mnist, synthetic_mnist

    def server(tcp):
        shards = make_federated_mnist(8, 80, seed=0)
        return FederatedServer(
            mnist_cnn_task(),
            [EdgeClient(i, dataset=s) for i, s in enumerate(shards)],
            fedavg(min_fit=0.5),
            tcp=tcp,
            chaos=ChaosSchedule(transport.LAB.replace(delay=6.0)),
            config=ServerConfig(rounds=4, local_steps=3, seed=0, batched=True),
            eval_data=synthetic_mnist(250, seed=11),
        )

    dead, _, dead_counts = timed_run(torch, server(transport.DEFAULT))
    alive, _, alive_counts = timed_run(torch, server(transport.TUNED_EDGE))
    dead_launches, alive_launches = dead_counts["fedavg_reduce"], alive_counts["fedavg_reduce"]
    check(dead.completed_rounds == 0 and dead_launches == 0, "DEFAULT trained at 6 s delay")
    check(alive.completed_rounds == 4 and alive_launches == 32, "TUNED_EDGE lost rounds at 6 s")
    check(alive.final_accuracy() > 0.3, f"TUNED_EDGE accuracy {alive.final_accuracy()}")
    fused, wall, counts = timed_run(
        torch, paper_server(torch, stochastic=True, engine="fused_transport")
    )
    launches = counts["fedavg_reduce"]
    acc = fused.final_accuracy()
    check(fused.completed_rounds > 0 and launches == 8 * fused.completed_rounds,
          f"fused_transport: {launches} launches for {fused.completed_rounds} rounds")
    check(acc is not None and acc == acc, "fused_transport accuracy not finite")
    emit("headline", default_completed=dead.completed_rounds,
         tuned_completed=alive.completed_rounds, tuned_accuracy=alive.final_accuracy(),
         fused_transport=fused.summary(), fused_wall_s=wall)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # the reference computes in full f32; TF32 would keep ~3 digits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device_name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         tf32={"matmul": torch.backends.cuda.matmul.allow_tf32,
               "cudnn": torch.backends.cudnn.allow_tf32})

    from repro_torch.compress import get_compressor
    from repro_torch.kernels.build import build_all
    from repro_torch.models.cnn import cnn_init
    from repro_torch.utils import tree_leaves

    t0 = time.perf_counter()
    reports = build_all()
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(reports),
         ptxas={k: [ln.strip() for ln in v.splitlines() if "Used" in ln]
                for k, v in reports.items()})

    leaf_sizes = [l.numel() for l in tree_leaves(cnn_init(torch.Generator()))]
    max_err, main_kernel = phase_kernel(torch, leaf_sizes)
    quant = phase_quant_kernels(torch, leaf_sizes)
    runs = phase_main_path(torch)
    phase_profile(torch, runs["DEFAULT"][2])
    hist, launches, wall = runs["DEFAULT"]
    compressed = phase_compressed(torch, wall / len(hist.rounds))
    for name, names in (("int8", ("quantize_rows", "fedavg_reduce")),
                        ("bf16", ("downcast_bf16_rows", "fedavg_reduce")),
                        ("topk", ("fedavg_reduce",))):
        phase_profile(torch, compressed[name]["wall_s"], phase=f"profile_{name}", names=names,
                      compressor=get_compressor(name, ratio=0.05))
    phase_engines(torch, runs["DEFAULT"][0])
    phase_headline(torch)

    us = main_kernel
    agg_bound_us, agg_bound_by = bound_us(us["bytes"], us["flops"])

    def quant_row(name, run, replaces, note):
        q = quant[name]
        bound, bound_by = bound_us(q["bytes"], q["ops"])
        if run is None:  # off the main path: the quant_kernels phase's checking launches
            n, per_round = q["check_launches"], 0
        else:
            n = run["launches"][name]
            per_round = n // max(run["completed_rounds"], 1)
        lib = q["library_us"]
        return {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quantize.cu", "replaces": replaces,
            "launches": n, "launches_per_round": per_round,
            "max_abs_err": q["max_abs_err"], "max_err": q["max_abs_err"],
            "ms": q["us"] / 1e3, "plain_ms": q["plain_us"] / 1e3,
            "bound_ms": bound / 1e3, "bound_by": bound_by,
            "library_ms": None if lib is None else lib / 1e3,
            "library_note": note,
            "us": q["us"], "wall_us": q["wall_us"], "plain_us": q["plain_us"],
            "library_us": lib, "bound_us": bound, "bytes": q["bytes"],
        }

    print(json.dumps({"kernels": [{
        "name": "fedavg_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fedavg_reduce.cu",
        "replaces": "src/repro/kernels/fedavg_reduce.py:37",
        "launches": launches,
        "launches_per_round": launches // max(hist.completed_rounds, 1),
        "max_abs_err": max_err,
        "max_err": max_err,
        # one aggregation: the 8 CNN leaves at C = 10, summed
        "ms": us["us"] / 1e3, "plain_ms": us["plain_us"] / 1e3,
        "bound_ms": agg_bound_us / 1e3, "bound_by": agg_bound_by,
        "library_ms": us["library_us"] / 1e3,
        "us": us["us"], "wall_us": us["wall_us"], "plain_us": us["plain_us"],
        "library_us": us["library_us"], "bound_us": agg_bound_us,
        "bytes_per_aggregation": us["bytes"],
    },
        # one compressed round: the 8 CNN leaves at R = 10, summed
        quant_row("quantize_rows", compressed["int8"], "src/repro/kernels/quantize.py:83",
                  NO_LIBRARY),
        quant_row("downcast_bf16_rows", compressed["bf16"], "src/repro/kernels/quantize.py:112",
                  "x.to(torch.bfloat16)"),
        # the whole flattened CNN (N = 206,922), as ops.quantize_tree feeds it
        quant_row("quantize_stochastic", None, "src/repro/kernels/quantize.py:44", NO_LIBRARY),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
