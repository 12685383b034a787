#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root. Phases, each printing one JSON line:

1. device    card, torch/CUDA versions, TF32 turned off for matmul and cuDNN
             (the JAX reference computes in full f32);
2. build     every ``src/repro_torch/kernels/csrc/*.cu``, one nvcc each, in
             parallel, into ``build/repro_torch/``; registers, shared memory
             and spill bytes of the bf16 flash_attention and swiglu kernels,
             which must not spill;
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
             (accuracy > 0.3); one stochastic fused_transport run;
10. lm_kernels
             flash_attention and swiglu against their plain versions on the
             card: the reference sweeps, serving lengths, bf16 windows, both
             sides of the GQA packing boundary (G * Sq = 64, 65), the
             serving shape (B = 4, S = 16, 32 / 8 heads, D = 128), one
             S = 4096 prefill, and swiglu at Qwen3-8B's widths for
             M = 1, 4, 7, 44, 56, 64, with the same timing fields as
             ``kernel`` and one PyTorch call's time; the share of the bf16
             swiglu's time that its cross-block reduction takes (the
             kernel built again with ``-DSWIGLU_NO_REDUCE``);
11. serve     ``Server("qwen3-8b", reduced=False)`` on the card, params from a
             seeded generator: serve.py:main's 8 requests (batch 4, 12 new
             tokens each); launches asserted per prefill and per decode step;
             prefill ms, decode ms per step, tokens/s, peak memory, and the
             device-idle share of one profiled run (``serve_profile``);
12. full_width
             a 2-layer model at Qwen3-8B's full widths with the served
             params: one prefill and three decode steps on the card
             (kernels) and on the CPU (plain versions, fed the card's
             tokens); logits within 3e-2 of max |logit|.

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
BF16_FLOPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense (NVIDIA data sheet)
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


def bound_us(bytes_moved: int, flops: int, flops_per_s: float = F32_FLOPS_PER_S) -> tuple:
    """Least time the card could take: HBM time or compute time at the peak
    rate for the operands' type (f32 FMA by default), whichever is larger,
    and which of the two it is."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e6
    t_ops = flops / flops_per_s * 1e6
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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import swiglu as sw

    fr.launches = fa.launches = sw.launches = 0
    for name in qz.launches:
        qz.launches[name] = 0


def read_launches() -> dict:
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import swiglu as sw

    return {"fedavg_reduce": fr.launches, **qz.launches,
            "flash_attention": fa.launches, "swiglu": sw.launches}


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
    server = paper_server(torch, **cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    busy, top, by_name = device_profile(torch, server.run, names)
    wall = time.perf_counter() - t0
    emit(phase, profiled_wall_s=wall, unprofiled_wall_s=unprofiled_wall_s,
         device_busy_us=busy, **by_name,
         device_idle_share=1.0 - busy / (unprofiled_wall_s * 1e6), top=top)


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


# --------------------------------------------------------------------------
# the LM serving path: flash_attention and swiglu, the Qwen3-8B server
# --------------------------------------------------------------------------

QWEN_D, QWEN_F, QWEN_LAYERS = 4096, 12288, 36
SWIGLU_NO_LIBRARY = "none: no single PyTorch call computes the fused SwiGLU MLP"
SERVE_LOGIT_RTOL = 3e-2  # bf16 card vs bf16 CPU logits, relative to max |logit|


def attention_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head attends to under the masks."""
    n = 0
    for i in range(Sq):
        hi = min(Skv, i + 1) if causal else Skv
        lo = max(0, i - window + 1) if window else 0
        n += max(0, hi - lo)
    return n


def flash_work(B, Sq, Skv, Hq, Hkv, D, itemsize, causal=True, window=0) -> tuple:
    """(bytes, flops): q, k, v read once and the output written once; a
    multiply-add for q.k and for p.v per unmasked pair and head dim."""
    bytes_moved = (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D) * itemsize
    return bytes_moved, 4 * D * B * Hq * attention_pairs(Sq, Skv, causal, window)


def swiglu_work(M, d, F, itemsize) -> tuple:
    """(bytes, flops): x and the three weights read once, the output
    written once; three products of 2*M*d*F."""
    return (2 * M * d + 3 * d * F) * itemsize, 6 * M * d * F


# the redesigned bf16 kernels (flash_attention: wgmma + TMA; swiglu: cp.async
# ring + mma.sync, and its cast launch), held to zero spills at build time
NEW_KERNELS = ("flash_kernel_wgmma", "swiglu_kernel_mma", "swiglu_cast_kernel")
KNOWN_ENTRIES = NEW_KERNELS + ("flash_kernel_simt", "swiglu_kernel_simt")


def ptxas_entries(report: str) -> list:
    """Registers, static shared memory and spill bytes of each entry function
    in an ``nvcc -Xptxas -v`` report, by kernel name (and template D)."""
    import re

    entries, cur = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            mangled = m.group(1)
            kernel = next((k for k in KNOWN_ENTRIES if k in mangled), mangled)
            d = re.search(re.escape(kernel) + r"ILi(\d+)E", mangled)
            cur = {"entry": kernel + (f"<{d.group(1)}>" if d else ""), "kernel": kernel}
            entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return entries


def redesigned_smem() -> dict:
    """Dynamic shared memory the bf16 kernels ask for at launch."""
    from repro_torch.kernels.build import load_library

    fa = load_library("flash_attention").flash_attention_bf16_smem_bytes
    return {**{f"flash_kernel_wgmma<{D}>": fa(D) for D in (32, 64, 128)},
            "swiglu_kernel_mma": load_library("swiglu").swiglu_bf16_smem_bytes()}


def swiglu_reduction_share(torch, rows=(4, 64)) -> dict:
    """Device us of the bf16 swiglu as the wrapper launches it, and of the
    same source built with ``-DSWIGLU_NO_REDUCE`` (its workspace atomics
    behind a branch never taken: the products still run, nothing is added),
    at Qwen3-8B's widths; the share of the call that the cross-block
    reduction takes is 1 - without / with."""
    import ctypes

    from repro_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc, library_path, load_library

    full = library_path("swiglu")
    bare = full.with_name(full.stem + "-no-reduce.so")
    if not bare.exists():
        built = subprocess.run([_nvcc(), *NVCC_FLAGS, "-DSWIGLU_NO_REDUCE", "-o", str(bare),
                                str(CSRC / "swiglu.cu")], capture_output=True, text=True)
        check(built.returncode == 0, f"swiglu -DSWIGLU_NO_REDUCE failed to build:\n"
                                     f"{(built.stdout + built.stderr)[-4000:]}")
    libs = {"full": load_library("swiglu"), "no_reduce": ctypes.CDLL(str(bare))}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for M in rows:
        x = torch.randn(M, QWEN_D, generator=gen, device=dev).to(torch.bfloat16)
        ws = [(torch.randn(s, generator=gen, device=dev) * s[0] ** -0.5).to(torch.bfloat16)
              for s in ((QWEN_D, QWEN_F), (QWEN_D, QWEN_F), (QWEN_F, QWEN_D))]
        bufs = [torch.zeros(M, QWEN_D, device=dev),
                torch.empty(M, QWEN_D, dtype=torch.bfloat16, device=dev)]
        ptrs = [t.data_ptr() for t in (x, *ws, *bufs)]
        stream = torch.cuda.current_stream().cuda_stream
        us = {}
        for name, lib in libs.items():
            fn = lib.swiglu_bf16
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            check(fn(*ptrs, M, QWEN_D, QWEN_F, stream) == 0, f"swiglu {name} launch failed")
            us[name] = device_us(torch, lambda: fn(*ptrs, M, QWEN_D, QWEN_F, stream), 20, 5)
        out[M] = {"us": us["full"], "no_reduce_us": us["no_reduce"],
                  "reduction_share": 1.0 - us["no_reduce"] / us["full"]}
    return out


def _timings(torch, kernel, plain, library, work, dtype, *, iters=100, reps=7):
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    bound, bound_by = bound_us(*work, flops_per_s=peak)
    return {
        "us": device_us(torch, kernel, iters, reps), "wall_us": wall_us(torch, kernel, iters, reps),
        "plain_us": device_us(torch, plain, iters, reps),
        "library_us": device_us(torch, library, iters, reps) if library else None,
        "bound_us": bound, "bound_by": bound_by, "bytes": work[0], "flops": work[1],
    }


def phase_lm_kernels(torch):
    """flash_attention and swiglu against their plain versions on the card;
    timed at the serving shapes, the S = 4096 prefill and full width."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import swiglu as sw
    from repro_torch.kernels.ref import flash_attention_ref, swiglu_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    f32, bf16 = torch.float32, torch.bfloat16
    name = {f32: "float32", bf16: "bfloat16"}
    out = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0, "timed": {}} for k in ("flash_attention", "swiglu")}
    out["flash_attention"]["max_row_rel_err"] = 0.0

    flash_cases = [(shape, dt, 0, "reference") for shape in (
        (1, 128, 128, 2, 2, 64), (2, 256, 256, 4, 2, 64), (1, 128, 256, 8, 1, 32),
        (2, 128, 128, 4, 4, 128)) for dt in (f32, bf16)]
    flash_cases += [((1, 256, 256, 2, 2, 32), dt, w, "window") for w in (32, 64) for dt in (f32, bf16)]
    # G * Sq = 64 packs the query heads of a kv head into one tile, 65 does not
    flash_cases += [((1, 16, 16, 4, 1, 128), bf16, 0, "packing"), ((1, 13, 13, 5, 1, 128), bf16, 0, "packing")]
    flash_cases += [((4, S, S, 32, 8, 128), dt, 0, "lengths") for S in (1, 7, 100) for dt in (f32, bf16)]
    flash_cases += [((4, 16, 16, 32, 8, 128), f32, 0, "lengths")]
    flash_cases += [((4, 16, 16, 32, 8, 128), bf16, 0, "serving"),
                    ((1, 4096, 4096, 32, 8, 128), bf16, 0, "long_prefill")]
    tol = {f32: 2e-5, bf16: 5e-2}
    # per query row, relative to that row's max |plain|: a late row of the
    # S = 4096 prefill averages ~1,500 keys and is only ~0.02 in size, below
    # the absolute bf16 tolerance; bf16 rounds each output once (2**-8)
    row_tol = {f32: 1e-3, bf16: 1e-2}
    for (B, Sq, Skv, Hq, Hkv, D), dt, window, group in flash_cases:
        q = torch.randn(B * Hq, Sq, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B * Hkv, Skv, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B * Hkv, Skv, D, generator=gen, device=dev).to(dt)
        kernel = lambda: fa.flash_attention_bhsd(q, k, v, causal=True, window=window)
        plain = lambda: flash_attention_ref(q, k, v, causal=True, window=window)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(got.float() - want.float())))
        scale = float(torch.max(torch.abs(want.float())))
        row_err = float(torch.max(torch.amax(torch.abs(got.float() - want.float()), -1)
                                  / torch.amax(torch.abs(want.float()), -1).clamp_min(1e-30)))
        check(got.dtype == dt and got.shape == q.shape, f"flash_attention {group} output")
        check(err < tol[dt], f"flash_attention {(B, Sq, Skv, Hq, Hkv, D)} {dt} w={window}: "
                             f"max err {err} >= {tol[dt]}")
        check(row_err < row_tol[dt], f"flash_attention {(B, Sq, Skv, Hq, Hkv, D)} {dt} "
                                     f"w={window}: row-relative err {row_err} >= {row_tol[dt]}")
        acc = out["flash_attention"]
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        acc["max_rel_err"] = max(acc["max_rel_err"], err / max(scale, 1e-30))
        acc["max_row_rel_err"] = max(acc["max_row_rel_err"], row_err)
        row = {"kernel": "flash_attention", "shape": [B, Sq, Skv, Hq, Hkv, D], "dtype": name[dt],
               "window": window, "group": group, "max_abs_err": err, "max_abs_ref": scale,
               "max_row_rel_err": row_err, "row_rtol": row_tol[dt]}
        if group in ("serving", "long_prefill"):
            library = lambda: F.scaled_dot_product_attention(
                q.view(B, Hq, Sq, D), k.view(B, Hkv, Skv, D), v.view(B, Hkv, Skv, D),
                is_causal=True, enable_gqa=True)
            n = 100 if group == "serving" else 5
            row.update(_timings(torch, kernel, plain, library,
                                flash_work(B, Sq, Skv, Hq, Hkv, D, q.element_size()), dt,
                                iters=n, reps=7 if n == 100 else 3))
            acc["timed"][group] = row
        emit("lm_kernels", **row)

    swiglu_cases = [((M, d, F_), dt, "reference") for M, d, F_ in (
        (64, 32, 128), (128, 64, 256), (256, 128, 512)) for dt in (f32, bf16)]
    # M = 44 and 56: the serve run's prefill rows (B = 4 x S = 11, 14)
    swiglu_cases += [((M, QWEN_D, QWEN_F), dt, "full_width") for M in (1, 4, 7, 44, 56, 64)
                     for dt in (f32, bf16)]
    # full width: relative to max |plain|; f32 differs in summation order
    # only, bf16 also rounds h and the output to bf16
    rel_tol = {f32: 1e-5, bf16: 2e-2}
    for (M, d, F_), dt, group in swiglu_cases:
        full = group == "full_width"
        x = torch.randn(M, d, generator=gen, device=dev).to(dt)
        ws = [(torch.randn(s, generator=gen, device=dev) * (s[0] ** -0.5 if full else 0.1)).to(dt)
              for s in ((d, F_), (d, F_), (F_, d))]
        kernel = lambda: sw.swiglu_fused(x, *ws)
        plain = lambda: swiglu_ref(x, *ws)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(got.float() - want.float())))
        scale = float(torch.max(torch.abs(want.float())))
        check(got.dtype == dt and got.shape == (M, d), f"swiglu {group} output")
        limit = rel_tol[dt] * scale if full else (1e-4 if dt == f32 else 5e-2)
        check(err <= limit, f"swiglu {(M, d, F_)} {dt}: max err {err} > {limit}")
        acc = out["swiglu"]
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        acc["max_rel_err"] = max(acc["max_rel_err"], err / max(scale, 1e-30))
        row = {"kernel": "swiglu", "shape": [M, d, F_], "dtype": name[dt], "group": group,
               "max_abs_err": err, "max_abs_ref": scale}
        if full and dt == bf16:
            wg, wu, wd = ws
            composite = lambda: (F.silu(x @ wg) * (x @ wu)) @ wd
            row.update(_timings(torch, kernel, plain, None, swiglu_work(M, d, F_, 2), dt,
                                iters=20, reps=5))
            row["composite_us"] = device_us(torch, composite, 20, 5)
            acc["timed"][M] = row
        emit("lm_kernels", **row)
    share = swiglu_reduction_share(torch)
    out["swiglu"]["reduction"] = share
    emit("lm_kernels", kernel="swiglu", group="reduction_share", rows=share)
    return out


def device_profile(torch, fn, names=()):
    """Run ``fn`` under the profiler (CUPTI): (device busy us, top kernels,
    device us by name substring)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]

    def device_time(e):
        t = getattr(e, "self_device_time_total", None)
        return t if t is not None else e.self_cuda_time_total

    total = sum(device_time(e) for e in kernels)
    top = [{"name": e.key[:90], "device_us": device_time(e), "calls": e.count}
           for e in sorted(kernels, key=lambda e: -device_time(e))[:12]]
    by_name = {f"{n}_device_us": sum(device_time(e) for e in kernels if n in e.key) for n in names}
    return total, top, by_name


def phase_serve(torch):
    """The Qwen3-8B server at full width on the card: every request gets its
    12 tokens, every token lies below padded_vocab, every logit is finite,
    and each prefill launches flash_attention and swiglu once per layer,
    each decode step swiglu once per layer and flash_attention never."""
    from repro_torch.launch import Server
    from repro_torch.launch.serve import example_requests

    t0 = time.perf_counter()
    server = Server("qwen3-8b", reduced=False, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = server.cfg
    prefill, decode = server._prefill, server._decode
    calls = {"prefill": [], "decode": []}

    def traced(kind, fn):
        def call(*args):
            torch.cuda.synchronize()
            before = read_launches()
            t = time.perf_counter()
            logits, cache = fn(*args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            after = read_launches()
            check(logits.dtype == torch.float32 and logits.shape == (server.batch, cfg.padded_vocab),
                  f"{kind}: logits {logits.dtype} {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits).all()), f"{kind}: non-finite logits")
            calls[kind].append((ms, after["flash_attention"] - before["flash_attention"],
                                after["swiglu"] - before["swiglu"]))
            return logits, cache
        return call

    server._prefill, server._decode = traced("prefill", prefill), traced("decode", decode)
    server.run(example_requests(cfg.vocab_size))  # warm-up: kernel builds, cuBLAS handles
    for v in calls.values():
        v.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    done = server.run(example_requests(cfg.vocab_size))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(r.generated) for r in done)
    check(len(done) == 8 and all(len(r.generated) == 12 for r in done),
          f"serve: generated {[len(r.generated) for r in done]}")
    check(all(0 <= t < cfg.padded_vocab for r in done for t in r.generated), "serve: token range")
    n_pre, n_dec = len(calls["prefill"]), len(calls["decode"])
    check(all(c[1:] == (QWEN_LAYERS, QWEN_LAYERS) for c in calls["prefill"]),
          f"serve: per-prefill launches {[c[1:] for c in calls['prefill']]}")
    check(all(c[1:] == (0, QWEN_LAYERS) for c in calls["decode"]),
          f"serve: per-decode launches {[c[1:] for c in calls['decode']]}")
    check(launches["flash_attention"] == QWEN_LAYERS * n_pre
          and launches["swiglu"] == QWEN_LAYERS * (n_pre + n_dec), f"serve: launches {launches}")
    prefill_ms = [c[0] for c in calls["prefill"]]
    decode_ms = [c[0] for c in calls["decode"]]

    # the same requests unwrapped (no per-call synchronize), then profiled
    server._prefill, server._decode = prefill, decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    server.run(example_requests(cfg.vocab_size))
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    busy, top, by_name = device_profile(
        torch, lambda: server.run(example_requests(cfg.vocab_size)),
        names=("flash_kernel", "swiglu_kernel", "swiglu_cast", "nvjet", "elementwise"))
    emit("serve", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
         params=cfg.param_count(), init_s=init_s, requests=len(done), tokens=n_tok,
         wall_s=wall, tokens_per_s=n_tok / wall, unsynced_wall_s=plain_wall,
         unsynced_tokens_per_s=n_tok / plain_wall,
         prefills=n_pre, decode_steps=n_dec, prefill_ms=prefill_ms,
         decode_ms_per_step=statistics.mean(decode_ms), decode_ms_median=statistics.median(decode_ms),
         peak_memory_bytes=peak, launches={k: launches[k] for k in ("flash_attention", "swiglu")},
         prompt_lengths=[len(r.prompt) for r in done], first_tokens=[r.generated[:4] for r in done])
    emit("serve_profile", device_busy_us=busy, unsynced_wall_s=plain_wall,
         device_idle_share=1.0 - busy / (plain_wall * 1e6), **by_name, top=top)
    # (flash_attention, swiglu) launches of one call, equal for every call
    return server, {"launches": launches, "prefills": n_pre, "decode_steps": n_dec,
                    "per_prefill": calls["prefill"][0][1:], "per_decode": calls["decode"][0][1:]}


def phase_full_width(torch, server):
    """A 2-layer model at Qwen3-8B's full widths, the served params' first
    two layers: one prefill and three decode steps on the card (kernels)
    and on the CPU (plain versions), the CPU fed the card's tokens."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import example_requests
    from repro_torch.models import Model
    from repro_torch.utils import tree_map

    cfg = get_config("qwen3-8b").replace(n_layers=2)
    params = {k: tree_map(lambda t: t[:2], v) if k.startswith("seg") else v
              for k, v in server.params.items()}
    cpu_params = tree_map(lambda t: t.cpu(), params)
    model = Model(cfg)
    reqs = example_requests(cfg.vocab_size)[:4]
    S = max(8, max(len(r.prompt) for r in reqs))
    toks = np.zeros((4, S), np.int32)
    for i, r in enumerate(reqs):
        toks[i, S - len(r.prompt):] = r.prompt
    toks = torch.from_numpy(toks)

    reset_launches()
    logits, cache = model.prefill(params, {"tokens": toks.cuda()}, 128)
    card = [logits.cpu()]
    for _ in range(3):
        cur = logits.argmax(-1)[:, None].to(torch.int32)
        logits, cache = model.decode_step(params, cache, cur)
        card.append(logits.cpu())
    counts = read_launches()
    check(counts["flash_attention"] == 2 and counts["swiglu"] == 8, f"full_width launches {counts}")

    logits, cache = model.prefill(cpu_params, {"tokens": toks}, 128)
    cpu = [logits]
    for step in range(3):
        cur = card[step].argmax(-1)[:, None].to(torch.int32)  # the card's tokens
        logits, cache = model.decode_step(cpu_params, cache, cur)
        cpu.append(logits)
    errs, scales, agree = [], [], 0
    for a, b in zip(card, cpu):
        check(bool(torch.isfinite(a).all()), "full_width: non-finite card logits")
        errs.append(float(torch.max(torch.abs(a - b))))
        scales.append(float(torch.max(torch.abs(b))))
        agree += int((a.argmax(-1) == b.argmax(-1)).sum())
    worst = max(e / s for e, s in zip(errs, scales))
    check(worst <= SERVE_LOGIT_RTOL, f"full_width: logits differ by {worst} of max |logit|")
    emit("full_width", n_layers=2, d_model=cfg.d_model, max_abs_err=errs, max_abs_logit=scales,
         rel_err=worst, rtol=SERVE_LOGIT_RTOL, greedy_agree=agree, greedy_total=4 * len(card))


FL_DESIGN = {
    "fedavg_reduce": "grid-stride, one thread per column, weights in shared memory",
    "quantize_rows": "grid-stride, one thread per element, correctly rounded quotient",
    "downcast_bf16_rows": "grid-stride, one thread per element",
    "quantize_stochastic": "grid-stride, one thread per element, correctly rounded quotient",
}


def lm_rows(lm, served):
    """The kernels-line rows of flash_attention (at the serving prefill
    shape, with the S = 4096 prefill beside it) and swiglu (at decode,
    M = 4, with the M = 64 prefill beside it), launches from the serve run."""
    launches, n_pre, n_dec = served["launches"], served["prefills"], served["decode_steps"]
    per_pre, per_dec = served["per_prefill"], served["per_decode"]

    def ms(row, prefix=""):
        lib = row["library_us"]
        return {f"{prefix}ms": row["us"] / 1e3, f"{prefix}plain_ms": row["plain_us"] / 1e3,
                f"{prefix}bound_ms": row["bound_us"] / 1e3, f"{prefix}bound_by": row["bound_by"],
                f"{prefix}library_ms": None if lib is None else lib / 1e3,
                f"{prefix}wall_ms": row["wall_us"] / 1e3, f"{prefix}shape": row["shape"]}

    fa, sw = lm["flash_attention"], lm["swiglu"]
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:127",
         "design": "wgmma+tma, bf16 P, GQA rows packed (bf16); CUDA cores (f32)",
         "launches": launches["flash_attention"],
         "launches_per_prefill": per_pre[0], "launches_per_decode_step": per_dec[0],
         "prefills": n_pre, "decode_steps": n_dec,
         "max_abs_err": fa["max_abs_err"], "max_rel_err": fa["max_rel_err"],
         "max_row_rel_err": fa["max_row_rel_err"],
         **ms(fa["timed"]["serving"]), **ms(fa["timed"]["long_prefill"], "long_prefill_"),
         "library_note": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)"},
        {"name": "swiglu", "route": "cuda", "source": "src/repro_torch/kernels/csrc/swiglu.cu",
         "replaces": "src/repro/kernels/swiglu.py:46",
         "design": "cp.async ring + swap-AB mma.sync, float4 atomics, cast launch (bf16); "
                   "CUDA cores (f32)",
         "launches": launches["swiglu"],
         "launches_per_prefill": per_pre[1], "launches_per_decode_step": per_dec[1],
         "prefills": n_pre, "decode_steps": n_dec,
         "max_abs_err": sw["max_abs_err"], "max_rel_err": sw["max_rel_err"],
         **ms(sw["timed"][4]), **ms(sw["timed"][64], "prefill_"),
         "composite_ms": sw["timed"][4]["composite_us"] / 1e3,
         "prefill_composite_ms": sw["timed"][64]["composite_us"] / 1e3,
         "reduction_share": sw["reduction"][4]["reduction_share"],
         "prefill_reduction_share": sw["reduction"][64]["reduction_share"],
         "library_note": SWIGLU_NO_LIBRARY + " (composite_ms: silu(x@Wg)*(x@Wu)@Wd in cuBLAS bf16)"},
    ]


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
    build_s = time.perf_counter() - t0
    redesigned = ptxas_entries(reports["flash_attention"] + reports["swiglu"])
    check(set(NEW_KERNELS) <= {e["kernel"] for e in redesigned},
          f"build: ptxas reported {[e['kernel'] for e in redesigned]}")
    for e in redesigned:
        if e["kernel"] in NEW_KERNELS:
            check(e["spill_stores"] == 0 and e["spill_loads"] == 0, f"build: {e['entry']} spills")
    emit("build", seconds=build_s, sources=sorted(reports),
         ptxas={k: [ln.strip() for ln in v.splitlines() if "Used" in ln]
                for k, v in reports.items()},
         redesigned=redesigned, dynamic_smem_bytes=redesigned_smem())

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
    lm = phase_lm_kernels(torch)
    server, served = phase_serve(torch)
    phase_full_width(torch, server)

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
            "design": FL_DESIGN[name],
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
        "design": FL_DESIGN["fedavg_reduce"],
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
        *lm_rows(lm, served),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
