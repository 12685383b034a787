#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root. Phases, each printing one JSON line:

1. device    card, torch/CUDA versions, the TF32 flags as found (PyTorch's
             defaults: the port's CNN task turns TF32 off in its own scope);
2. build     every ``src/repro_torch/kernels/csrc/*.cu``, one nvcc each, in
             parallel, into ``build/repro_torch/``; registers, shared memory
             and spill bytes of the bf16 flash_attention and swiglu kernels,
             which must not spill;
3. kernel    fedavg_reduce against its plain PyTorch version on the card, at
             the reference test shapes and as the main path calls it (one
             grouped launch over the CNN's 8 leaves), with device time,
             plain time, library time and the HBM/FLOP bound; once more past
             the 50 MB L2 ([10, 4,194,304] f32) against its HBM bound;
4. quant_kernels
             the three quantize kernels against their plain versions, codes
             and bf16 bits equal (not close), at the reference sweep sizes
             and the main path's 8 leaf shapes with R = 10 rows (int8 and
             bf16 each as one grouped launch), with the same timing fields
             as ``kernel``, the launch floor (a 16-element launch) and, for
             bf16, one ``x.to(torch.bfloat16)`` over the same elements as a
             single [10, 206922] tensor; then each kernel once more at a size
             past the 50 MB L2 (R = 10, N = 4,194,304; stochastic
             N = 33,554,432), time against its HBM bound;
5. main_path the paper's experiment through ``FederatedServer.run``:
             10 clients x 200 examples, batch 32, 4 local steps, 8 rounds,
             fedavg(min_fit=0.1), the quickstart chaos schedule, batched
             engine, DEFAULT and TUNED_EDGE TCP; launch counts reset just
             before each run and read just after: fedavg_reduce once per
             round;
6. profile   device time by kernel over one more main-path run;
7. compressed
             the same config with the int8, bf16 and topk(0.05) compressors:
             all 8 rounds, quantize_rows launched once per int8 round and
             downcast_bf16_rows once per bf16 round, dense == sparse
             StatePlane bitwise, compress_plane ==
             per-client compress/decompress bitwise over 3 rounds, s/round
             and device time by kernel;
8. engines   the sequential engine on the same config: equal numpy fields,
             final accuracy within 1e-3;
9. headline  6 s one-way delay: DEFAULT completes 0 rounds, TUNED_EDGE all 4
             (accuracy > 0.3); one stochastic fused_transport run;
10. reference_history
             the 8 engine runs (one on the device transport plane), the int8
             / bf16 compressed runs and the two async runs of
             ``tests/_card_reference.py`` on the card, with PyTorch's TF32
             defaults, against the reference's committed Histories
             (``tests/data/card_reference.json``, written on the CPU):
             numpy fields exactly (the device plane's clocks within 1e-6),
             accuracy, loss and client metrics within 1e-3; then the same runs and a profiled quickstart with the
             task's guard (TF32 off, deterministic cuDNN) bypassed,
             reported and not checked (what a run without the guard would
             give);
11. grid_rows one row's delta and metrics at dispatch widths 1, 3, 12, 24 and
             64 and at the first, middle and last position, with and without
             the prox term: the same bits (the plane runs every dispatch as
             fixed-width row chunks); the same with each dispatch as one call
             of its own width, and the chunks' cost at 64 rows, reported;
12. grid      the full fig3 grid (10 delays x DEFAULT / TUNED_EDGE, 20 points, 8
             rounds) through ``run_fl_grid`` against 20 per-point batched runs:
             every History and the final params bitwise, timed in turns
             (grid, per-point, per-point, grid), ``GridStats``, fedavg_reduce
             once per aggregating point-round; then the compressed grid
             (int8, bf16, topk 0.05; dense and sparse plane) against its
             per-point twins, quantize_rows / downcast_bf16_rows once per
             computed compression (``grid_compressed``);
13. paper_sweeps
             fig3, fig4, fig5 and tuned_vs_default through
             ``repro_torch.experiments`` at full width on the card, table3,
             figs 6-8 and the adaptive daemon, each with its reference
             threshold asserts; each sweep's rows and wall time; then
             ``grid_phases``, the seconds of phases 11-13;
14. fault_domain
             kill-and-resume on the card: the quickstart killed after round
             4 of 8 and resumed on a fresh server, uncompressed and with
             int8 / bf16 on the dense and the sparse plane, and sparse
             checkpoints resumed into dense runs, bitwise equal to the
             uninterrupted run, launches once per completed round of the
             resumed half, save and restore ms; the fig3 grid killed after
             round 4 and resumed, bitwise, equal ``GridStats``; the
             reference's committed round-2 checkpoint
             (``tests/data/card_reference_ckpt/``) finished on the card
             against the committed History; ``resilience_bench``
             (kill-and-resume per transport mode, a poisoned point
             quarantined alone, the retry frontier and the degenerate
             retry ladder on both transport planes); a ``server_restart``
             losing its round;
15. async     ``async_bench``: degenerate async == sync bitwise (sequential
             and batched, fedavg_reduce once per flush), the latency-cliff
             and dropout sections with their gates; an async fig3-shaped
             grid == its 20 per-point runs bitwise, fedavg_reduce launches
             == buffer flushes; the async quickstart killed and resumed,
             bitwise;
16. population
             ``population_bench``: the dense == sparse and Population ==
             list parity gate, and the scale section (1,000,000 and 100,000
             clients, cohort 32, 3 rounds): plane occupancy,
             ``torch.cuda.max_memory_allocated``, the tracemalloc host peak
             against the 1 GB budget (tracemalloc does not see torch's CPU
             allocator), clients materialized; then ``reliability_phases``,
             the seconds of phases 14-16 against their 90 s budget;
17. transport_plane
             the device transport plane: ``transport_plane_bench`` at 64,
             512 and 4,096 rows (host loop, fused numpy plane, device plane;
             the 3x gate over the host loop at 4,096 rows, the exact and the
             distributional parity gates, the end-to-end fig4 sweep on both
             backends); at 4,096 rows one round with the transfer loop one
             iteration at a time and as CUDA graph blocks, in turns (equal
             bits; wall, iterations, host syncs, device busy, idle share);
             ``reliability_bench`` with its gates and the retry sections of
             phase 14's ``resilience_bench``; a fig3-shaped device-backend
             grid killed after round 2 and resumed, bitwise, fedavg_reduce
             once per aggregating point-round; the fixture's device run
             against the reference's History; ``env_profiles``;
18. lm_kernels
             flash_attention and swiglu against their plain versions on the
             card: the reference sweeps, serving lengths, bf16 windows, both
             sides of the GQA packing boundary (G * Sq = 64, 65), the
             serving shape (B = 4, S = 16, 32 / 8 heads, D = 128), one
             S = 4096 prefill, and swiglu at Qwen3-8B's widths for
             M = 1, 4, 7, 44, 56, 64, with the same timing fields as
             ``kernel`` and one PyTorch call's time; the share of the bf16
             swiglu's time that its cross-block reduction takes (the
             kernel built again with ``-DSWIGLU_NO_REDUCE``);
19. serve     ``Server("qwen3-8b", reduced=False)`` on the card, params from a
             seeded generator: serve.py:main's 8 requests (batch 4, 12 new
             tokens each); launches asserted per prefill and per decode step;
             prefill ms, decode ms per step, tokens/s, peak memory, and the
             device-idle share of one profiled run (``serve_profile``);
20. full_width
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
    max_err = 0.0
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
        emit("kernel", **row)

    # the main path: one grouped launch over the CNN's 8 leaves at C = 10
    xs = [torch.randn(10, N, generator=gen, device=dev) for N in main_leaf_sizes]
    w = torch.rand(10, generator=gen, device=dev) + 0.05
    w = w / w.sum()
    before = fr.launches
    got = fr.fedavg_reduce_leaves(xs, w)
    torch.cuda.synchronize()
    check(fr.launches == before + 1, "fedavg_reduce: grouped call took more than one launch")
    plain = lambda: torch.cat([fedavg_reduce_ref(x, w) for x in xs])
    err = float(torch.max(torch.abs(got - plain())))
    check(err <= tol[torch.float32], f"fedavg_reduce grouped: max err {err}")
    off, alone_equal = 0, True
    for x in xs:  # each leaf bitwise the same alone as among the others
        alone_equal &= torch.equal(got[off:off + x.shape[1]], fr.fedavg_reduce_flat(x, w))
        off += x.shape[1]
    check(alone_equal, "fedavg_reduce: a leaf differs alone and among others")
    max_err = max(max_err, err)
    works = [fedavg_work(10, N, 4) for N in main_leaf_sizes]
    main = {"bytes": sum(b for b, _ in works), "flops": sum(f for _, f in works)}
    bound, bound_by = bound_us(main["bytes"], main["flops"])
    # calls of several launches are timed 20 at a time, so the host enqueues
    # them all before the sleep kernel ends and the events see device time
    main.update(
        us=device_us(torch, lambda: fr.fedavg_reduce_leaves(xs, w)),
        wall_us=wall_us(torch, lambda: fr.fedavg_reduce_leaves(xs, w)),
        plain_us=device_us(torch, plain, iters=20),
        # PyTorch's matrix-vector product per leaf (yardstick only)
        library_us=device_us(torch, lambda: [torch.mv(x.t(), w) for x in xs], iters=20),
        per_leaf_us=device_us(torch, lambda: [fr.fedavg_reduce_flat(x, w) for x in xs], iters=20),
    )
    emit("kernel", C=10, N=main_leaf_sizes, dtype="float32", group="main_path",
         max_abs_err=err, alone_equals_grouped=alone_equal, bound_us=bound, bound_by=bound_by,
         **main)
    # past the 50 MB L2: one call moving 185 MB, so no launch finds its
    # inputs in the cache left by the one before; time against its HBM bound
    C, N = FEDAVG_PAST_L2
    x = torch.randn(C, N, generator=gen, device=dev)
    w = torch.rand(C, generator=gen, device=dev) + 0.05
    w = w / w.sum()
    got = fr.fedavg_reduce_flat(x, w)
    l2_err = float(torch.max(torch.abs(got - fedavg_reduce_ref(x, w))))
    check(l2_err <= tol[torch.float32], f"fedavg_reduce {C}x{N}: max err {l2_err}")
    max_err = max(max_err, l2_err)
    l2_bytes, l2_flops = fedavg_work(C, N, 4)
    l2_bound, l2_bound_by = bound_us(l2_bytes, l2_flops)
    l2_us = device_us(torch, lambda: fr.fedavg_reduce_flat(x, w))
    main["past_l2"] = {"C": C, "N": N, "us": l2_us, "bound_us": l2_bound, "bytes": l2_bytes,
                       "share_of_bound": l2_bound / l2_us,
                       "within_2x_of_bound": l2_us <= 2.0 * l2_bound}
    emit("kernel", C=C, N=N, dtype="float32", group="past_l2", max_abs_err=l2_err,
         bound_by=l2_bound_by, **{k: v for k, v in main["past_l2"].items() if k not in ("C", "N")})
    del x, got
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


# fedavg_reduce past L2: [C, N] f32, one call moving 185 MB
FEDAVG_PAST_L2 = (10, 4_194_304)

# the past-L2 rows: (R, N) per kernel, each call moving 210-302 MB, so no
# launch finds its inputs in the 50 MB L2 left by the one before
PAST_L2 = {"quantize_rows": (10, 4_194_304), "downcast_bf16_rows": (10, 4_194_304),
           "quantize_stochastic": (1, 33_554_432)}


def phase_quant_kernels(torch, main_leaf_sizes):
    """Each quantize kernel against its plain version: int8 codes and bf16
    bits must be EQUAL. Main-path rows are the 8 CNN leaves at R = 10 (one
    compressed round), int8 and bf16 each as one grouped call, beside the
    same leaves as 8 one-leaf calls; the stochastic kernel, off the main
    path, is timed on the whole flattened CNN (N = 206,922). Each kernel is
    timed once more past L2 (``PAST_L2``) against its HBM bound."""
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
        return lambda: qz.quantize_rows_flat(x, s), lambda: ref.quantize_rows_ref(x, s)

    def bf16_case(R, N):
        x = torch.randn(R, N, generator=gen, device=dev)
        return lambda: qz.downcast_bf16_rows_flat(x), lambda: ref.downcast_bf16_rows_ref(x)

    def stochastic_case(R, N):
        x = torch.randn(N, generator=gen, device=dev) * 3.0
        u = torch.rand(N, generator=gen, device=dev)
        scale = torch.clamp(x.abs().max(), min=1e-12) / c127
        return (lambda: qz.quantize_stochastic_flat(x, u, scale),
                lambda: ref.quantize_stochastic_ref(x, u, scale))

    def same(got, want):
        if got.dtype == torch.bfloat16:
            return torch.equal(got.view(torch.int16), want.view(torch.int16))
        return torch.equal(got, want)

    # the least time of any launch timed this way: a 16-element downcast
    tiny = torch.randn(1, 16, generator=gen, device=dev)
    floor_us = device_us(torch, lambda: qz.downcast_bf16_rows_flat(tiny))

    makers = {"quantize_rows": rows_case, "downcast_bf16_rows": bf16_case,
              "quantize_stochastic": stochastic_case}
    cases = [("quantize_rows", 3, N, "reference") for N in (100, 2048, 2049, 9999)]
    cases += [("downcast_bf16_rows", 2, N, "reference") for N in (128, 2050)]
    cases += [("quantize_stochastic", 1, N, "reference") for N in (1, 3, 5, 100, 4096, 4111, 9999)]
    cases += [("quantize_stochastic", 1, sum(main_leaf_sizes), "main_path")]
    cases += [(name, R, N, "past_l2") for name, (R, N) in PAST_L2.items()]
    out = {k: {"bytes": 0, "ops": 0, "max_abs_err": 0.0, "check_launches": 0,
               "launch_floor_us": floor_us} for k in makers}
    for name, R, N, group in cases:
        kernel, plain = makers[name](R, N)
        before = qz.launches[name]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        out[name]["check_launches"] += qz.launches[name] - before
        check(got.dtype == want.dtype and got.shape == want.shape, f"{name} {R}x{N} output")
        equal = same(got, want)
        err = float(torch.max(torch.abs(got.float() - want.float())))
        check(equal, f"{name} {R}x{N}: kernel != plain version (max err {err})")
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        row = {"kernel": name, "R": R, "N": N, "group": group, "equal": equal, "max_abs_err": err}
        if group != "reference":
            bytes_, ops = QUANT_WORK[name](R, N)
            bound, bound_by = bound_us(bytes_, ops)
            us = device_us(torch, kernel)
            row.update(us=us, bound_us=bound, bound_by=bound_by, bytes=bytes_,
                       share_of_bound=bound / us)
        if group == "main_path":  # the stochastic kernel on the flattened CNN
            row.update(wall_us=wall_us(torch, kernel), plain_us=device_us(torch, plain),
                       library_us=None, launch_floor_us=floor_us)
            out[name].update(bytes=row["bytes"], ops=ops,
                             **{k: row[k] for k in ("us", "wall_us", "plain_us", "library_us")})
        if group == "past_l2":
            row["within_2x_of_bound"] = row["us"] <= 2.0 * bound
            out[name]["past_l2"] = {k: row[k] for k in ("R", "N", "us", "bound_us", "bytes",
                                                        "share_of_bound", "within_2x_of_bound")}
        emit("quant_kernels", **row)

    def grouped(name, kernel, plain, alone, library=None, library_flat=None):
        """One main-path round: the 8 leaves in one grouped call (one
        launch), each leaf equal to the plain version and to itself alone;
        timed beside the same leaves as 8 one-leaf calls."""
        before = qz.launches[name]
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        acc = out[name]
        acc["check_launches"] += qz.launches[name] - before
        check(qz.launches[name] == before + 1, f"{name}: grouped call launches")
        equal = all(same(g, w_) for g, w_ in zip(got, want))
        alone_equal = all(same(g, a()) for g, a in zip(got, alone))
        check(equal and alone_equal,
              f"{name} grouped: equal {equal}, alone == grouped {alone_equal}")
        works = [QUANT_WORK[name](10, N) for N in main_leaf_sizes]
        acc["bytes"], acc["ops"] = sum(b for b, _ in works), sum(o for _, o in works)
        bound, bound_by = bound_us(acc["bytes"], acc["ops"])
        # calls of several launches are timed 20 at a time (see phase_kernel)
        acc.update(us=device_us(torch, kernel), wall_us=wall_us(torch, kernel),
                   plain_us=device_us(torch, plain, iters=20),
                   per_leaf_us=device_us(torch, lambda: [a() for a in alone], iters=20),
                   library_us=None if library is None else device_us(torch, library, iters=20),
                   library_flat_us=None if library_flat is None else device_us(torch, library_flat))
        emit("quant_kernels", kernel=name, R=10, N=main_leaf_sizes, group="main_path",
             equal=equal, alone_equals_grouped=alone_equal, max_abs_err=0.0, bound_us=bound,
             bound_by=bound_by, share_of_bound=bound / acc["us"], launch_floor_us=floor_us,
             **{k: acc[k] for k in ("us", "wall_us", "plain_us", "per_leaf_us", "library_us",
                                    "library_flat_us")})

    # the main path's int8 and bf16: one grouped launch over the 8 leaves at R = 10
    xs = [torch.randn(10, N, generator=gen, device=dev) * 2.5 for N in main_leaf_sizes]
    ss = [scales_of(x) for x in xs]
    grouped("quantize_rows", lambda: qz.quantize_rows_leaves(xs, ss),
            lambda: [ref.quantize_rows_ref(x, s) for x, s in zip(xs, ss)],
            [lambda x=x, s=s: qz.quantize_rows_flat(x, s) for x, s in zip(xs, ss)])
    xs = [torch.randn(10, N, generator=gen, device=dev) for N in main_leaf_sizes]
    flat = torch.cat(xs, dim=1)  # the same elements as one [10, 206922] tensor
    grouped("downcast_bf16_rows", lambda: qz.downcast_bf16_rows_leaves(xs),
            lambda: [ref.downcast_bf16_rows_ref(x) for x in xs],
            [lambda x=x: qz.downcast_bf16_rows_flat(x) for x in xs],
            library=lambda: [x.to(torch.bfloat16) for x in xs],
            library_flat=lambda: flat.to(torch.bfloat16))

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
    """The quickstart with each plane compressor: all 8 rounds, fedavg_reduce
    launched once per round, quantize_rows once per int8 round and
    downcast_bf16_rows once per bf16 round, dense == sparse bitwise, and the
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
        check(counts["fedavg_reduce"] == done, f"{name}: fedavg_reduce launches {counts}")
        for kern, per_round in (("quantize_rows", 1), ("downcast_bf16_rows", 1)):
            want = per_round * done if kern == expect_kernel[name] else 0
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
        check(launches == hist.completed_rounds,
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
    check(alive.completed_rounds == 4 and alive_launches == 4, "TUNED_EDGE lost rounds at 6 s")
    check(alive.final_accuracy() > 0.3, f"TUNED_EDGE accuracy {alive.final_accuracy()}")
    fused, wall, counts = timed_run(
        torch, paper_server(torch, stochastic=True, engine="fused_transport")
    )
    launches = counts["fedavg_reduce"]
    acc = fused.final_accuracy()
    check(fused.completed_rounds > 0 and launches == fused.completed_rounds,
          f"fused_transport: {launches} launches for {fused.completed_rounds} rounds")
    check(acc is not None and acc == acc, "fused_transport accuracy not finite")
    emit("headline", default_completed=dead.completed_rounds,
         tuned_completed=alive.completed_rounds, tuned_accuracy=alive.final_accuracy(),
         fused_transport=fused.summary(), fused_wall_s=wall)


def phase_reference_history(torch):
    """The port on the card against the reference's committed Histories:
    the 8 engine runs (the device transport plane's degenerate run among
    them), the int8 / bf16 compressed runs and the two async runs of
    ``tests/_card_reference.py``, with PyTorch's TF32 defaults (the task
    turns TF32 off in its own scope). Numpy fields exactly (the device
    plane's clocks within ``CLOCK_RTOL``), accuracy, loss and client
    metrics within 1e-3; fedavg_reduce once per completed
    round on the batched engines (once per buffer flush on the async runs),
    quantize_rows once per int8 round. Then the
    task's guard bypassed: the same runs' gaps and a profiled quickstart,
    reported, not checked."""
    import contextlib

    sys.path.insert(0, str(ROOT / "tests"))
    import _card_reference as card
    from repro_torch.core import client as client_mod

    flags = {"cudnn": torch.backends.cudnn.allow_tf32,
             "matmul": torch.backends.cuda.matmul.allow_tf32}
    records = card.load_records()
    task = card.port_task("cuda")
    pkgs = card.port_packages()
    batched = {name: kw.get("batched", False) for name, kw, _, _ in card.ENGINES}

    def run_all(checked):
        gaps, launches = {}, {}
        for name in card.RUNS:
            torch.cuda.synchronize()
            reset_launches()
            hist, clients = card.run(name, task, *pkgs)
            torch.cuda.synchronize()
            counts = read_launches()
            got = card.history_record(hist, clients)
            gaps[name] = card.history_gaps(records[name], got)
            launches[name] = {k: counts[k] for k in ("fedavg_reduce", "quantize_rows",
                                                     "downcast_bf16_rows")}
            if not checked:
                continue
            try:
                card.assert_records_match(records[name], got,
                                          clock_rtol=card.CLOCK_RTOL.get(name, 0.0))
            except AssertionError as e:
                raise PhaseFailed(f"reference_history {name}: {e!r}; gaps {gaps[name]}") from e
            done = hist.completed_rounds
            agg = done if batched.get(name, True) else 0
            if name in card.ASYNC:  # batched: one launch per buffer flush
                agg = sum(1 for r in hist.rounds if "async_flush_size" in r.metrics)
            int8 = done if name == "compressed_int8" else 0
            bf16 = done if name == "compressed_bf16" else 0
            check(launches[name] == {"fedavg_reduce": agg, "quantize_rows": int8,
                                     "downcast_bf16_rows": bf16},
                  f"reference_history {name}: launches {launches[name]} for {done} rounds")
        worst = {k: max(g[k] for g in gaps.values()) for k in next(iter(gaps.values()))}
        return gaps, launches, worst

    gaps, launches, worst = run_all(checked=True)
    quickstart = lambda: paper_server(torch).run()
    busy = {"guard": [], "bypassed": []}
    guard = client_mod.f32_math
    unguarded = lambda device: contextlib.nullcontext()
    try:
        client_mod.f32_math = unguarded
        bypassed_gaps, _, bypassed_worst = run_all(checked=False)
        for mode in ("guard", "bypassed", "bypassed", "guard"):  # in turns
            client_mod.f32_math = guard if mode == "guard" else unguarded
            busy[mode].append(device_profile(torch, quickstart)[0])
    finally:
        client_mod.f32_math = guard
    emit("reference_history", runs=len(gaps), tf32_flags=flags, tol=card.HISTORY_TOL,
         max_gap=worst, gaps=gaps, launches=launches,
         guard_bypassed={"max_gap": bypassed_worst, "gaps": bypassed_gaps,
                         "within_tol": all(v <= card.HISTORY_TOL for v in bypassed_worst.values())},
         quickstart_device_busy_us=busy)


# --------------------------------------------------------------------------
# the grid engine and the paper's sweeps
# --------------------------------------------------------------------------

GRID_ROW_WIDTHS = (1, 3, 12, 24, 64)
GRID_COMPRESSORS = ("int8", "bf16", "topk:0.05")


def _same_bits(torch, a, b) -> bool:
    """Equal bits: dataclasses, dicts, sequences, tensors, floats (nan equal
    to nan) and other scalars."""
    import dataclasses
    import math

    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(
            _same_bits(torch, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_bits(torch, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_bits(torch, x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def _plain(x):
    """Rows as JSON: nan as null, tuples as lists."""
    if isinstance(x, float) and x != x:
        return None
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def phase_grid_rows(torch):
    """Row independence on the card: one row's delta and metrics at dispatch
    widths 1, 3, 12, 24 and 64, at the first, middle and last position,
    beside rows from another anchor, with and without the prox term, must
    be the same bits (the plane runs every dispatch as chunks of
    ``_ROW_CHUNK`` rows). The same comparison with each dispatch run as one
    call of its own width (the port before the chunks) is reported, not
    checked; so is the chunks' cost at 64 rows, timed in turns."""
    import numpy as np

    from repro_torch.core import EdgeClient, bucket_rows, mnist_cnn_task
    from repro_torch.core import client as client_mod
    from repro_torch.data import make_federated_mnist
    from repro_torch.utils import tree_leaves

    task = mnist_cnn_task()
    clients = [EdgeClient(i, dataset=s)
               for i, s in enumerate(make_federated_mnist(10, 200, seed=0))]
    rows = list(zip(clients, task.plan_fit(clients, 4, np.random.default_rng(3))))
    anchors = [task.init_fn(torch.Generator().manual_seed(s)) for s in (0, 1)]
    target, chunk = rows[3], client_mod._ROW_CHUNK

    def fit(rs, aidx, mu, one_call):
        client_mod._ROW_CHUNK = bucket_rows(len(rs)) if one_call else chunk
        try:
            return task.fit_rows(anchors, rs, 4, [mu] * len(rs), mu > 0, anchor_idx=aidx)
        finally:
            client_mod._ROW_CHUNK = chunk

    equal = {"chunked": {}, "one_call": {}}
    variants = {"chunked": {}, "one_call": {}}  # distinct bits of the row over its placements
    for mu in (0.0, 0.01):
        for mode in equal:
            want, _, want_m = fit([target], [1], mu, mode == "one_call")
            seen = set()
            for w in GRID_ROW_WIDTHS:
                for pos in sorted({0, w // 2, w - 1}):
                    rs = [rows[(k * 7) % len(rows)] for k in range(w)]
                    aidx = [k % 2 for k in range(w)]
                    rs[pos], aidx[pos] = target, 1
                    plane, _, mets = fit(rs, aidx, mu, mode == "one_call")
                    same = mets[pos] == want_m[0] and all(
                        torch.equal(a[pos], b[0])
                        for a, b in zip(tree_leaves(plane), tree_leaves(want)))
                    equal[mode][f"mu={mu} width={w} pos={pos}"] = same
                    seen.add(b"".join(a[pos].cpu().numpy().tobytes()
                                      for a in tree_leaves(plane)))
            variants[mode][f"mu={mu}"] = len(seen)
    bad = [k for k, v in equal["chunked"].items() if not v]
    check(not bad, f"grid_rows: a row's bits move with its dispatch: {bad}")

    rs = [rows[k % len(rows)] for k in range(64)]
    aidx = [0] * 64
    wall = {"chunked": [], "one_call": []}
    for mode in ("chunked", "one_call", "one_call", "chunked"):  # in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(rs, aidx, 0.0, mode == "one_call")
        torch.cuda.synchronize()
        wall[mode].append(time.perf_counter() - t0)
    emit("grid_rows", row_chunk=chunk, widths=GRID_ROW_WIDTHS, chunked_all_equal=True,
         one_call_all_equal=all(equal["one_call"].values()),
         one_call_unequal=[k for k, v in equal["one_call"].items() if not v],
         distinct_bit_patterns=variants, fit_rows_64_wall_s=wall)


def _grid_run(torch, task, points, eval_data):
    """``run_fl_grid`` with every kernel's launch count set to 0 just before
    and read just after: (result, wall s, launches by kernel)."""
    from repro_torch.core import run_fl_grid

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = run_fl_grid(task, points, eval_data=eval_data)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, read_launches()


def _per_point_runs(torch, task, points, eval_data):
    """Each point through its own batched ``FederatedServer.run``: (servers,
    wall s)."""
    from repro_torch.core import FederatedServer

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    servers = []
    for p in points:
        srv = FederatedServer(task, p.clients, p.strategy, tcp=p.tcp, chaos=p.chaos,
                              config=p.config, compressor=p.compressor, eval_data=eval_data)
        srv.run()
        servers.append(srv)
    torch.cuda.synchronize()
    return servers, time.perf_counter() - t0


def _check_grid_equals_per_point(torch, what, grid_servers, servers):
    for i, (g, s) in enumerate(zip(grid_servers, servers)):
        check(_same_bits(torch, g.history, s.history), f"{what}: point {i} History differs")
        check(_same_bits(torch, g.global_params, s.global_params),
              f"{what}: point {i} final params differ")


def phase_grid(torch):
    """The full fig3 grid (10 delays x DEFAULT / TUNED_EDGE, 20 points, 8
    rounds, full width) through ``run_fl_grid`` against 20 per-point
    batched runs: every History and the final params bitwise, timed as an
    A/B in turns (grid, per-point, per-point, grid); fedavg_reduce launched
    once per aggregating point-round. Then the compressed grid (int8, bf16,
    topk 0.05; dense and sparse state plane) against its per-point twins,
    with quantize_rows (int8) and downcast_bf16_rows (bf16) launched once
    per computed compression (``GridStats.compress_computed``)."""
    import dataclasses

    from repro_torch.experiments import common, fig3_latency

    task, eval_data = common._shared_task("cuda"), common._shared_eval_data()
    _, kwargs = fig3_latency.sweep_points()
    make = lambda **extra: [common._make_point(**kw, **extra) for kw in kwargs]  # noqa: E731
    grids, per_point = [], []
    for engine in ("grid", "per_point", "per_point", "grid"):  # in turns
        if engine == "grid":
            grids.append(_grid_run(torch, task, make(), eval_data))
        else:
            per_point.append(_per_point_runs(torch, task, make(), eval_data))
    for res, _, counts in grids:
        _check_grid_equals_per_point(torch, "grid", res.servers, per_point[0][0])
        aggregating = sum(h.completed_rounds for h in res.histories)
        check(counts["fedavg_reduce"] == aggregating,
              f"grid: {counts['fedavg_reduce']} fedavg_reduce launches for {aggregating} "
              "aggregating point-rounds")
    res, _, counts = grids[0]
    n = len(kwargs)
    out = {"points": n, "rounds": common.ROUNDS, "stats": dataclasses.asdict(res.stats),
           "grid_wall_s": [w for _, w, _ in grids], "per_point_wall_s": [w for _, w in per_point],
           "grid_s_per_point": [w / n for _, w, _ in grids],
           "per_point_s_per_point": [w / n for _, w in per_point],
           "fit_rows_unique_share": res.stats.fit_rows_unique / res.stats.fit_rows_total,
           "launches": {k: counts[k] for k in ("fedavg_reduce", "quantize_rows",
                                               "downcast_bf16_rows")},
           "aggregating_point_rounds": sum(h.completed_rounds for h in res.histories),
           "grid_equals_per_point": True}
    emit("grid", **out)

    compressed = {}
    for spec in GRID_COMPRESSORS:
        name = spec.partition(":")[0]
        for plane in ("dense", "sparse"):
            res, wall, counts = _grid_run(
                torch, task, make(compressor=spec, state_plane=plane), eval_data)
            servers, pp_wall = _per_point_runs(
                torch, task, make(compressor=spec, state_plane=plane), eval_data)
            _check_grid_equals_per_point(torch, f"grid {spec} {plane}", res.servers, servers)
            s = res.stats
            want = {"fedavg_reduce": sum(h.completed_rounds for h in res.histories),
                    "quantize_rows": s.compress_computed if name == "int8" else 0,
                    "downcast_bf16_rows": s.compress_computed if name == "bf16" else 0}
            got = {k: counts[k] for k in want}
            check(got == want, f"grid {spec} {plane}: launches {got}, expected {want}")
            compressed[f"{spec} {plane}"] = {
                "grid_wall_s": wall, "per_point_wall_s": pp_wall,
                "grid_s_per_point": wall / n, "per_point_s_per_point": pp_wall / n,
                "stats": dataclasses.asdict(s), "launches": got}
    emit("grid_compressed", points=n, equal_to_per_point=True, runs=compressed)
    out["compressed"] = compressed
    return out


def phase_paper_sweeps(torch):
    """The paper's sweeps through ``repro_torch.experiments`` at full width on
    the card, each with its reference thresholds (``assert`` in each
    ``main``): fig3, fig4, fig5 and tuned_vs_default through the grid
    engine (fedavg_reduce launched in each), table3, figs 6-8 and the
    adaptive daemon."""
    import contextlib
    import io

    from repro_torch.experiments import (
        adaptive_daemon,
        fig3_latency,
        fig4_loss,
        fig5_client_failure,
        fig678_tcp_params,
        table3_boundaries,
        tuned_vs_default,
    )

    check(__debug__, "paper_sweeps: the sweeps' thresholds are asserts, and python -O drops them")
    sweeps = [
        ("fig3_latency", lambda: fig3_latency.main(device="cuda"), True),
        ("fig4_loss", lambda: fig4_loss.main(device="cuda"), True),
        ("fig5_client_failure", lambda: fig5_client_failure.main(device="cuda"), True),
        ("tuned_vs_default", lambda: tuned_vs_default.main(device="cuda"), True),
        ("table3_boundaries", table3_boundaries.main, False),
        ("fig678_tcp_params", fig678_tcp_params.main, False),
        ("adaptive_daemon", adaptive_daemon.main, False),
    ]
    for name, run, on_card in sweeps:
        csv = io.StringIO()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(csv):
                rows = run()
        except AssertionError as e:
            raise PhaseFailed(f"paper_sweeps {name}: a threshold failed: {e!r}\n"
                              f"{csv.getvalue()}") from e
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()["fedavg_reduce"]
        check(launches > 0 or not on_card, f"paper_sweeps {name}: no fedavg_reduce launch")
        emit("paper_sweeps", sweep=name, wall_s=wall, asserts_hold=True,
             fedavg_reduce_launches=launches, rows=_plain(rows),
             csv_lines=len(csv.getvalue().splitlines()))


# --------------------------------------------------------------------------
# the reliability techniques: the fault domain, the async engine, the lazy
# population
# --------------------------------------------------------------------------

RELIABILITY_BUDGET_S = 90.0  # the three phases together
KILL_AT = 4  # rounds run before the kill, of MAIN_ROUNDS


def counted(torch, fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after: (result, wall s, launches by kernel)."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, read_launches()


def _same_server_state(torch, a, b) -> bool:
    """History, clients, clock, staleness clock and final params: equal bits."""
    return (_same_bits(torch, a.history, b.history)
            and _same_bits(torch, a.global_params, b.global_params)
            and a.sim_time == b.sim_time and a.model_version == b.model_version
            and [(c.connected, c.rounds_participated, c.bytes_sent) for c in a.clients]
            == [(c.connected, c.rounds_participated, c.bytes_sent) for c in b.clients])


def _median_ms(torch, fn, reps=5) -> float:
    samples = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def _kill_and_resume(torch, make, tmp, name):
    """``make()`` run uninterrupted, then killed after round ``KILL_AT`` and
    resumed on a fresh server from the same ``checkpoint_dir`` (one
    checkpoint per round). Checks the resumed run equal to the uninterrupted
    one, bitwise. Returns (resumed server, launches of the resumed segment,
    that segment's completed rounds / flushes / wall s, the directory)."""
    ref = make()
    ref.run()
    d = str(Path(tmp) / name)
    killed = make()
    killed.run(checkpoint_dir=d, stop_after_round=KILL_AT)
    check(len(killed.history.rounds) == KILL_AT,
          f"{name}: the killed run has {len(killed.history.rounds)} rounds, not {KILL_AT}")
    res = make()
    _, wall, counts = counted(torch, lambda: res.run(checkpoint_dir=d))
    check(_same_server_state(torch, ref, res), f"{name}: resumed run != uninterrupted run")
    segment = res.history.rounds[KILL_AT:]
    return res, counts, {"completed": sum(0 if r.failed_round else 1 for r in segment),
                         "flushes": res.model_version - killed.model_version,
                         "wall_s": wall, "dir": d}


def _checkpoint_ms(torch, srv, make, d):
    """Median ms of one save of ``srv``'s boundary state (every array off the
    card, the npz written and fsync'd) and of one restore onto a fresh
    server (read, and back onto the card), and the checkpoint's bytes."""
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(d + "_timed", keep=1)
    steps = iter(range(1000, 2000))
    save = _median_ms(torch, lambda: srv._save_checkpoint(mgr, next(steps)))
    fresh = iter([make() for _ in range(5)])  # built outside the timed restores
    restore = _median_ms(torch, lambda: next(fresh)._restore_checkpoint(mgr))
    nbytes = sum(p.stat().st_size for p in Path(mgr._step_dir(mgr.latest_step())).iterdir())
    return {"save_ms": save, "restore_ms": restore, "checkpoint_bytes": nbytes}


def phase_fault_domain(torch, tmp):
    """Kill-and-resume on the card. The quickstart (8 rounds, killed after
    4) uncompressed and with int8 / bf16 on the dense and the sparse plane,
    and a sparse checkpoint resumed into a dense run: bitwise equal to the
    uninterrupted run, fedavg_reduce (and quantize_rows /
    downcast_bf16_rows) once per completed round of the resumed segment,
    save and restore ms. The fig3 grid killed after round 4 and resumed:
    equal to the uninterrupted grid, equal GridStats. The reference's
    committed round-2 checkpoint finished on the card against the committed
    History. ``resilience_bench`` (kill-and-resume per transport mode, a
    poisoned point quarantined alone). A ``server_restart`` loses its
    round."""
    import contextlib
    import dataclasses
    import io

    from repro_torch.chaos import server_restart
    from repro_torch.compress import get_compressor
    from repro_torch.core import run_fl_grid
    from repro_torch.experiments import common, fig3_latency, resilience_bench

    t0 = time.perf_counter()
    point = {}
    for comp in (None, "int8", "bf16"):
        for plane in (("dense",) if comp is None else ("dense", "sparse")):
            name = f"{comp or 'none'}_{plane}"
            make = lambda c=comp, p=plane: paper_server(  # noqa: E731
                torch, compressor=None if c is None else get_compressor(c), state_plane=p)
            srv, counts, seg = _kill_and_resume(torch, make, tmp, name)
            want = {"fedavg_reduce": seg["completed"],
                    "quantize_rows": seg["completed"] if comp == "int8" else 0,
                    "downcast_bf16_rows": seg["completed"] if comp == "bf16" else 0}
            got = {k: counts[k] for k in want}
            check(got == want, f"fault_domain {name}: resumed launches {got}, expected {want}")
            point[name] = {"resumed_launches": got, "resumed_wall_s": seg["wall_s"],
                           **_checkpoint_ms(torch, srv, make, seg["dir"])}
    for comp in ("int8", "bf16"):  # a sparse checkpoint resumed into a dense run
        d = str(Path(tmp) / f"cross_{comp}")
        ref = paper_server(torch, compressor=get_compressor(comp), state_plane="dense")
        ref.run()
        paper_server(torch, compressor=get_compressor(comp), state_plane="sparse").run(
            checkpoint_dir=d, stop_after_round=KILL_AT)
        res = paper_server(torch, compressor=get_compressor(comp), state_plane="dense")
        res.run(checkpoint_dir=d)
        check(_same_server_state(torch, ref, res), f"fault_domain {comp}: sparse -> dense resume")
        point[f"{comp}_sparse_to_dense"] = {"equal": True}

    # the fig3 grid (20 points, 8 rounds) killed after round 4 and resumed
    task, eval_data = common._shared_task("cuda"), common._shared_eval_data()
    _, kwargs = fig3_latency.sweep_points()
    make = lambda: [common._make_point(**kw) for kw in kwargs]  # noqa: E731
    d = str(Path(tmp) / "grid")
    ref, ref_wall, _ = counted(torch, lambda: run_fl_grid(task, make(), eval_data=eval_data))
    part = run_fl_grid(task, make(), eval_data=eval_data, checkpoint_dir=d,
                       stop_after_round=KILL_AT)
    res, res_wall, counts = counted(
        torch, lambda: run_fl_grid(task, make(), eval_data=eval_data, checkpoint_dir=d))
    for i, (a, b) in enumerate(zip(ref.servers, res.servers)):
        check(_same_server_state(torch, a, b), f"fault_domain grid: point {i} differs")
    ckpt_fields = ("checkpoints_saved", "resumed_round")
    a, b = dataclasses.asdict(ref.stats), dataclasses.asdict(res.stats)
    check({k: v for k, v in a.items() if k not in ckpt_fields}
          == {k: v for k, v in b.items() if k not in ckpt_fields},
          f"fault_domain grid: GridStats {b} vs {a}")
    check(res.stats.resumed_round == KILL_AT and part.stats.checkpoints_saved == KILL_AT,
          f"fault_domain grid: {res.stats}")
    resumed_rounds = sum(0 if r.failed_round else 1
                         for h in res.histories for r in h.rounds[KILL_AT:])
    check(counts["fedavg_reduce"] == resumed_rounds,
          f"fault_domain grid: {counts['fedavg_reduce']} launches for {resumed_rounds} "
          "aggregating point-rounds after the resume")
    grid = {"points": len(kwargs), "stats": b, "uninterrupted_wall_s": ref_wall,
            "resumed_wall_s": res_wall, "resumed_launches": counts["fedavg_reduce"],
            "resumed_aggregating_point_rounds": resumed_rounds}

    # the reference's committed round-2 checkpoint, finished on the card
    sys.path.insert(0, str(ROOT / "tests"))
    import _card_reference as card

    (hist, clients), _, counts = counted(torch, lambda: card.resume(
        card.port_task("cuda"), Path(tmp) / "reference_ckpt", *card.port_packages()))
    got = card.history_record(hist, clients)
    try:
        card.assert_records_match(card.load_records()[card.CHECKPOINT_RUN], got)
    except AssertionError as e:
        raise PhaseFailed(f"fault_domain: the reference checkpoint's run: {e!r}") from e
    check(counts["fedavg_reduce"] == 1, f"fault_domain: reference checkpoint launches {counts}")
    reference = {"run": card.CHECKPOINT_RUN, "rounds_resumed": 1,
                 "gaps": card.history_gaps(card.load_records()[card.CHECKPOINT_RUN], got)}

    # resilience_bench: kill-and-resume per transport mode, quarantine
    with contextlib.redirect_stdout(io.StringIO()):
        bench = resilience_bench.run_bench(device="cuda")
    check(bench["parity"], f"fault_domain: resilience_bench gates: {bench}")

    # a server_restart inside round 1 loses that round and nothing else
    probe = paper_server(torch)
    probe.run(stop_after_round=2)
    t_crash = probe.history.rounds[1].t_start + 0.01
    srv = paper_server(torch)
    srv.chaos.add(server_restart(t_crash, downtime=5.0))
    hist, _, counts = counted(torch, srv.run)
    causes = [r.cause for r in hist.rounds]
    check(causes.count("server_restart") == 1 and causes[1] == "server_restart"
          and hist.rounds[1].t_end == t_crash + 5.0,
          f"fault_domain: server_restart causes {causes}")
    check(counts["fedavg_reduce"] == hist.completed_rounds,
          f"fault_domain: {counts['fedavg_reduce']} launches for {hist.completed_rounds} rounds")
    seconds = time.perf_counter() - t0
    emit("fault_domain", seconds=seconds, kill_at_round=KILL_AT, rounds=MAIN_ROUNDS,
         point=point, grid=grid, reference_checkpoint=reference, resilience_bench=bench,
         server_restart={"causes": causes, "completed_rounds": hist.completed_rounds})
    return {"seconds": seconds, "point": point, "grid": grid, "resilience_bench": bench}


def phase_async(torch, tmp):
    """The async engine on the card: degenerate async == sync bitwise
    (``async_bench``'s sequential pair, and a batched pair with
    fedavg_reduce once per flush); ``async_bench``'s latency-cliff and
    dropout sections with their gates, and the cliff's async point with
    fedavg_reduce once per flush; an async fig3-shaped grid (20 points,
    buffer of 3) equal to its per-point runs bitwise, launches equal to the
    flushes; the async quickstart killed after tick 4 and resumed, bitwise."""
    import contextlib
    import dataclasses
    import io

    from repro_torch.chaos import ChaosSchedule
    from repro_torch.core import EdgeClient, FederatedServer, ServerConfig, fedavg, run_fl_grid
    from repro_torch.data import make_federated_mnist
    from repro_torch.experiments import async_bench, common, fig3_latency
    from repro_torch.transport import DEFAULT, LAB

    t0 = time.perf_counter()
    degenerate = async_bench.degenerate_section(device="cuda")
    check(degenerate["parity"], f"async: degenerate sequential pair {degenerate}")

    def one_client(async_mode):
        return FederatedServer(
            common._shared_task("cuda"),
            [EdgeClient(0, dataset=make_federated_mnist(1, 64, seed=0)[0])], fedavg(),
            tcp=DEFAULT, chaos=ChaosSchedule(LAB),
            config=ServerConfig(rounds=3, local_steps=2, seed=0, batched=True,
                                async_mode=async_mode, async_buffer_k=1),
            eval_data=common._shared_eval_data())

    sync = one_client(False)
    sync.run()
    asy = one_client(True)
    _, _, counts = counted(torch, asy.run)
    check(counts["fedavg_reduce"] == asy.model_version == 3,
          f"async: degenerate batched: {counts['fedavg_reduce']} launches, "
          f"{asy.model_version} flushes")
    check(_same_bits(torch, sync.global_params, asy.global_params)
          and sync.sim_time == asy.sim_time
          and sync.history.eval_metrics == asy.history.eval_metrics
          and [r.t_end for r in sync.history.rounds] == [r.t_end for r in asy.history.rounds],
          "async: degenerate batched async != sync (params, clock, eval trace)")

    csv = io.StringIO()
    with contextlib.redirect_stdout(csv):
        cliff = async_bench.latency_cliff_section(device="cuda")
        dropout = async_bench.dropout_section(device="cuda")
    check(cliff["parity"], f"async: latency cliff gates {cliff}")
    check(dropout["parity"], f"async: dropout gates {dropout}")
    half = common.N_CLIENTS // 2
    slow = LAB.replace(delay=async_bench.CLIFF_DELAY, name="slow")
    (srv, hist), _, counts = counted(torch, lambda: async_bench._run_point(dict(
        min_fit=0.6, rounds=cliff["rounds"], max_consecutive_failures=3, async_mode=True,
        async_buffer_k=3, client_links=[None] * half + [slow] * half), "cuda"))
    check(counts["fedavg_reduce"] == srv.model_version > 0,
          f"async: cliff point {counts['fedavg_reduce']} launches, {srv.model_version} flushes")
    cliff_point = {"flushes": srv.model_version, "launches": counts["fedavg_reduce"],
                   "summary": hist.summary()}

    # an async fig3-shaped grid against its per-point runs
    task, eval_data = common._shared_task("cuda"), common._shared_eval_data()
    _, kwargs = fig3_latency.sweep_points()
    make = lambda: [common._make_point(**kw, async_mode=True, async_buffer_k=3)  # noqa: E731
                    for kw in kwargs]
    res, grid_wall, counts = counted(torch, lambda: run_fl_grid(task, make(),
                                                                eval_data=eval_data))
    servers, pp_wall = _per_point_runs(torch, task, make(), eval_data)
    for i, (g, s) in enumerate(zip(res.servers, servers)):
        check(_same_server_state(torch, g, s), f"async grid: point {i} != its per-point run")
    flushes = sum(s.model_version for s in res.servers)
    check(counts["fedavg_reduce"] == flushes == res.stats.async_flushes > 0,
          f"async grid: {counts['fedavg_reduce']} launches, {flushes} flushes, "
          f"{res.stats.async_flushes} async_flushes")
    grid = {"points": len(kwargs), "stats": dataclasses.asdict(res.stats), "grid_wall_s": grid_wall,
            "per_point_wall_s": pp_wall, "launches": counts["fedavg_reduce"], "flushes": flushes}

    # the async quickstart killed after tick 4 and resumed
    _, counts, seg = _kill_and_resume(
        torch, lambda: paper_server(torch, async_mode=True, async_buffer_k=3), tmp, "async")
    check(counts["fedavg_reduce"] == seg["flushes"],
          f"async resume: {counts['fedavg_reduce']} launches for {seg['flushes']} flushes")
    seconds = time.perf_counter() - t0
    emit("async", seconds=seconds, degenerate=degenerate, degenerate_batched_launches=3,
         latency_cliff=cliff, dropout=dropout, cliff_point=cliff_point, grid=grid,
         resume={"launches": counts["fedavg_reduce"], "flushes": seg["flushes"],
                 "wall_s": seg["wall_s"]},
         csv_lines=csv.getvalue().splitlines())
    return {"seconds": seconds, "grid": grid, "cliff_point": cliff_point}


def phase_population(torch):
    """``population_bench`` on the card: the parity gate (dense == sparse
    for every engine x plane compressor, the lazy Population == the list)
    and the scale section (1,000,000 clients and 100,000, cohort 32, topk
    on the sparse plane, 3 rounds), its gates, the plane's occupancy,
    ``torch.cuda.max_memory_allocated`` and the tracemalloc host peak
    against the 1 GB budget; fedavg_reduce once per round."""
    from repro_torch.experiments import population_bench

    t0 = time.perf_counter()
    parity = population_bench.run_parity_gate(device="cuda")
    check(parity["all_bitwise"], f"population: parity cells {parity['cells']}")
    scale, _, counts = counted(torch, lambda: population_bench.run_scale(device="cuda"))
    check(scale["all_gates"], f"population: scale gates {scale['gates']}")
    rounds = 1 + scale["small"]["completed_rounds"] + scale["big"]["completed_rounds"]
    check(counts["fedavg_reduce"] == rounds,
          f"population: {counts['fedavg_reduce']} launches for {rounds} rounds")
    seconds = time.perf_counter() - t0
    emit("population", seconds=seconds, parity=parity, scale=scale,
         host_budget_bytes=population_bench.MEM_BUDGET_BYTES,
         host_peak_note="tracemalloc sees numpy and Python objects, not torch's CPU allocator",
         launches=counts["fedavg_reduce"])
    return {"seconds": seconds, "launches": counts["fedavg_reduce"], "rounds": rounds}


DEVICE_KILL_AT = 2  # rounds the device-backend grid runs before its kill


def phase_transport_plane(torch, tmp, resilience):
    """The device transport plane on the card. ``transport_plane_bench`` at
    its three sizes (host loop, fused numpy plane, device plane, speedups),
    its 3x gate at 4,096 rows, both parity gates and its end-to-end fig4
    sweep on both backends; at 4,096 rows one round with the transfer loop
    run one iteration at a time and as CUDA graph blocks, in turns: the same
    bits, and each one's wall, loop iterations, host syncs, device busy time
    and idle share; ``reliability_bench`` (full size) with its gates, and the retry
    sections of the ``resilience_bench`` run of ``fault_domain``; a
    fig3-shaped device-backend grid (20 points, fused, split streams)
    killed after round 2 and resumed, bitwise, fedavg_reduce once per
    aggregating point-round; the fixture's ``device_degenerate`` run against
    the committed reference History, fedavg_reduce once per round;
    ``env_profiles``."""
    import contextlib
    import io

    from repro_torch.core import run_fl_grid
    from repro_torch.experiments import (
        common,
        env_profiles,
        fig3_latency,
        reliability_bench,
        transport_plane_bench as tpb,
    )
    from repro_torch.transport.plane import new_plane_stats

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench = tpb.run_bench(device="cuda")
    check(bench["parity_exact"], "transport_plane: degenerate grid != host oracle")
    check(bench["parity_distributional"]["ok"],
          f"transport_plane: distributional gate {bench['parity_distributional']}")
    check(bench["meets_target"],
          f"transport_plane: {bench['speedup']}x over the host loop at "
          f"{bench['sizes'][-1]['rows']} rows, under the {tpb.GATE_SPEEDUP}x gate: "
          f"{bench['sizes']}")
    e2e = bench["end_to_end"]
    check(e2e["transport_device_dispatches"] == common.ROUNDS,
          f"transport_plane: end-to-end device dispatches {e2e}")

    # one round at 4,096 rows, the transfer loop one iteration at a time
    # (as the reference writes it) and as CUDA graph blocks, in turns: the
    # same bits; wall, iterations, host syncs, device busy and idle share
    import numpy as np

    from repro_torch.transport import plane as plane_mod

    tcps, links, _ = tpb._grid(tpb.SIZES[-1])
    kw = tpb._round_args(links)
    loops = {"iters": plane_mod._transfer_iters, "blocks": plane_mod._transfer_blocks}

    @contextlib.contextmanager
    def transfer_loop(name):
        saved = plane_mod._transfer_blocks
        plane_mod._transfer_blocks = loops[name]  # the loop _plane_transfer runs on CUDA
        try:
            yield
        finally:
            plane_mod._transfer_blocks = saved

    one_round = lambda stats=None: tpb._run_device(tcps, links, kw, 1, "cuda", stats)[0]  # noqa
    rounds = {name: {"wall_s": []} for name in loops}
    outs = {}
    for name in ("iters", "blocks", "blocks", "iters"):
        with transfer_loop(name):
            stats = new_plane_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            outs[name] = one_round(stats)
            rounds[name]["wall_s"].append(time.perf_counter() - t1)
            rounds[name].update(stats)
    check(all(np.array_equal(a, b) for a, b in zip(outs["iters"], outs["blocks"])),
          "transport_plane: the CUDA graph blocks' round != the loop's round")
    for name, r in rounds.items():
        with transfer_loop(name):
            busy_us, top, _ = device_profile(torch, one_round)
        wall_s = min(r["wall_s"])
        r.update(device_busy_ms=busy_us / 1e3, device_idle_share=1.0 - busy_us / (wall_s * 1e6),
                 top=top[:6])
    round_profile = {"rows": len(links) * len(links[0]), "block": plane_mod._BLOCK,
                     "bitwise_equal": True, **rounds}

    with contextlib.redirect_stdout(io.StringIO()):
        reliability = reliability_bench.run_bench(device="cuda")
    check(reliability["parity"], f"transport_plane: reliability_bench gates {reliability}")
    retry = {k: resilience[k] for k in ("retry_frontier", "retry_degenerate")}
    check(retry["retry_frontier"]["parity"] and retry["retry_degenerate"]["parity"],
          f"transport_plane: resilience_bench retry sections {retry}")

    # a fig3-shaped device-backend grid killed after round 2 and resumed
    task, eval_data = common._shared_task("cuda"), common._shared_eval_data()
    _, kwargs = fig3_latency.sweep_points()
    make = lambda: [common._make_point(**kw, stochastic=True, rng_streams="split",  # noqa
                                       transport_backend="device") for kw in kwargs]
    grid_kw = dict(eval_data=eval_data, transport="fused")
    d = str(Path(tmp) / "device_grid")
    ref, ref_wall, ref_counts = counted(torch, lambda: run_fl_grid(task, make(), **grid_kw))
    part = run_fl_grid(task, make(), checkpoint_dir=d, stop_after_round=DEVICE_KILL_AT,
                       **grid_kw)
    res, res_wall, counts = counted(
        torch, lambda: run_fl_grid(task, make(), checkpoint_dir=d, **grid_kw))
    for i, (a, b) in enumerate(zip(ref.servers, res.servers)):
        check(_same_server_state(torch, a, b), f"transport_plane grid: point {i} differs")
    check(ref.stats.transport_device_dispatches == common.ROUNDS
          and part.stats.checkpoints_saved == DEVICE_KILL_AT
          and res.stats.resumed_round == DEVICE_KILL_AT,
          f"transport_plane grid: {ref.stats} / {res.stats}")
    aggregating = sum(h.completed_rounds for h in ref.histories)
    resumed = sum(0 if r.failed_round else 1
                  for h in res.histories for r in h.rounds[DEVICE_KILL_AT:])
    check(ref_counts["fedavg_reduce"] == aggregating and counts["fedavg_reduce"] == resumed,
          f"transport_plane grid: launches {ref_counts['fedavg_reduce']} / "
          f"{counts['fedavg_reduce']} for {aggregating} / {resumed} aggregating point-rounds")
    grid = {"points": len(kwargs), "rounds": common.ROUNDS, "kill_at_round": DEVICE_KILL_AT,
            "uninterrupted_wall_s": ref_wall, "resumed_wall_s": res_wall,
            "transport_device_dispatches": ref.stats.transport_device_dispatches,
            "completed_rounds": [h.completed_rounds for h in ref.histories],
            "launches": ref_counts["fedavg_reduce"], "aggregating_point_rounds": aggregating,
            "resumed_launches": counts["fedavg_reduce"],
            "resumed_aggregating_point_rounds": resumed}

    # the fixture's device-backend run against the reference's History
    sys.path.insert(0, str(ROOT / "tests"))
    import _card_reference as card

    name = "device_degenerate"
    (hist, clients), _, counts = counted(torch, lambda: card.run(
        name, card.port_task("cuda"), *card.port_packages()))
    got = card.history_record(hist, clients)
    want = card.load_records()[name]
    try:
        card.assert_records_match(want, got, clock_rtol=card.CLOCK_RTOL[name])
    except AssertionError as e:
        raise PhaseFailed(f"transport_plane: {name} against the reference: {e!r}") from e
    check(counts["fedavg_reduce"] == hist.completed_rounds,
          f"transport_plane: {name}: {counts['fedavg_reduce']} launches for "
          f"{hist.completed_rounds} rounds")
    clock_gap = max(abs(w[k] - g[k]) / abs(w[k]) for w, g in zip(want["rounds"], got["rounds"])
                    for k in ("t_start", "t_end") if w[k])
    reference = {"run": name, "launches": counts["fedavg_reduce"],
                 "completed_rounds": hist.completed_rounds, "clock_rtol": card.CLOCK_RTOL[name],
                 "max_clock_rel_gap": clock_gap, "gaps": card.history_gaps(want, got)}

    with contextlib.redirect_stdout(io.StringIO()):
        env_rows = env_profiles.main()
    seconds = time.perf_counter() - t0
    emit("transport_plane", seconds=seconds, sizes=bench["sizes"], speedup=bench["speedup"],
         target_speedup=bench["target_speedup"], meets_target=bench["meets_target"],
         parity_exact=bench["parity_exact"],
         parity_distributional=bench["parity_distributional"], end_to_end=e2e,
         round_4096=round_profile, reliability_bench=reliability, resilience_retry=retry,
         device_grid=grid, reference_history=reference, env_profiles=env_rows)
    return {"seconds": seconds, "grid": grid, "reference": reference}


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
    allocated_before = torch.cuda.memory_allocated()  # held by the server and earlier phases
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
         peak_memory_bytes=peak, allocated_before_run_bytes=allocated_before, launches={k: launches[k] for k in ("flash_attention", "swiglu")},
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
    "fedavg_reduce": "one launch over a leaf table passed by value; 16-byte loads where a "
                     "leaf is aligned, clients unrolled 16 deep, weights in shared memory",
    "quantize_rows": "one launch over a leaf table passed by value; 16 elements per thread "
                     "(four 16-byte loads, one 16-byte store) where a leaf is aligned, "
                     "correctly rounded quotient",
    "downcast_bf16_rows": "one launch over a leaf table passed by value, each leaf one flat "
                          "row; four float4 loads a block width apart and 8-byte bf16 stores "
                          "per thread where a leaf is aligned, else scalar; __float2bfloat16_rn",
    "quantize_stochastic": "one tile per block, no grid-stride loop; one float4 of x and of u "
                           "and one 4-byte store of codes per thread, a masked scalar tail, "
                           "scalar for an unaligned array, the scale once per block, "
                           "correctly rounded quotient",
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
    phase_reference_history(torch)
    t_grid = time.perf_counter()
    phase_grid_rows(torch)
    grid = phase_grid(torch)
    phase_paper_sweeps(torch)
    emit("grid_phases", seconds=time.perf_counter() - t_grid)
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        fault = phase_fault_domain(torch, tmp)
        asyn = phase_async(torch, tmp)
    population = phase_population(torch)
    reliability_s = fault["seconds"] + asyn["seconds"] + population["seconds"]
    emit("reliability_phases", seconds=reliability_s, budget_s=RELIABILITY_BUDGET_S,
         within_budget=reliability_s <= RELIABILITY_BUDGET_S,
         by_phase={"fault_domain": fault["seconds"], "async": asyn["seconds"],
                   "population": population["seconds"]})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plane_") as tmp:
        plane = phase_transport_plane(torch, tmp, fault["resilience_bench"])
    from repro_torch.utils import f32_math

    with f32_math("cuda"):  # the f32 plain versions as yardsticks in full f32
        lm = phase_lm_kernels(torch)
    server, served = phase_serve(torch)
    phase_full_width(torch, server)

    us = main_kernel
    agg_bound_us, agg_bound_by = bound_us(us["bytes"], us["flops"])

    def quant_row(name, run, replaces, note, grid_run=None):
        q = quant[name]
        bound, bound_by = bound_us(q["bytes"], q["ops"])
        if run is None:  # off the main path: the quant_kernels phase's checking launches
            n, per_round = q["check_launches"], 0
        else:
            n = run["launches"][name]
            per_round = n // max(run["completed_rounds"], 1)
        lib, l2 = q["library_us"], q["past_l2"]
        if q.get("library_flat_us") is not None:  # one call over the same elements
            lib = q["library_flat_us"]
        row = {
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
            "launch_floor_ms": q["launch_floor_us"] / 1e3,
            "past_l2_ms": l2["us"] / 1e3, "past_l2_bound_ms": l2["bound_us"] / 1e3,
            "past_l2_share_of_bound": l2["share_of_bound"],
            "past_l2_within_2x": l2["within_2x_of_bound"], "past_l2_shape": [l2["R"], l2["N"]],
        }
        if "per_leaf_us" in q:  # the same leaves as 8 one-leaf launches of the kernel
            row["per_leaf_ms"] = q["per_leaf_us"] / 1e3
        if q.get("library_flat_us") is not None:
            row["library_per_leaf_ms"] = q["library_us"] / 1e3
        if grid_run is not None:  # the compressed fig3 grid, dense plane
            row["grid_launches"] = grid_run["launches"][name]
            row["grid_compress_computed"] = grid_run["stats"]["compress_computed"]
        return row

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
        # one aggregation: the 8 CNN leaves at C = 10 in one grouped call
        "ms": us["us"] / 1e3, "plain_ms": us["plain_us"] / 1e3,
        "bound_ms": agg_bound_us / 1e3, "bound_by": agg_bound_by,
        "library_ms": us["library_us"] / 1e3,
        "us": us["us"], "wall_us": us["wall_us"], "plain_us": us["plain_us"],
        "library_us": us["library_us"], "bound_us": agg_bound_us,
        "bytes_per_aggregation": us["bytes"],
        # the same 8 leaves as 8 one-leaf launches of the same kernel
        "per_leaf_ms": us["per_leaf_us"] / 1e3,
        "library_note": "torch.mv per leaf (8 calls): no single call reduces a tree",
        "past_l2_ms": us["past_l2"]["us"] / 1e3,
        "past_l2_bound_ms": us["past_l2"]["bound_us"] / 1e3,
        "past_l2_share_of_bound": us["past_l2"]["share_of_bound"],
        "past_l2_within_2x": us["past_l2"]["within_2x_of_bound"],
        "past_l2_shape": [us["past_l2"]["C"], us["past_l2"]["N"]],
        # the fig3 grid (20 points, 8 rounds): one launch per aggregating point-round
        "grid_launches": grid["launches"]["fedavg_reduce"],
        "grid_aggregating_point_rounds": grid["aggregating_point_rounds"],
        # the reliability paths: once per completed round of a resumed run,
        # once per async buffer flush
        "resumed_point_launches": fault["point"]["none_dense"]["resumed_launches"][
            "fedavg_reduce"],
        "resumed_grid_launches": fault["grid"]["resumed_launches"],
        "resumed_grid_aggregating_point_rounds": fault["grid"][
            "resumed_aggregating_point_rounds"],
        "async_grid_launches": asyn["grid"]["launches"],
        "async_grid_flushes": asyn["grid"]["flushes"],
        "async_cliff_launches": asyn["cliff_point"]["launches"],
        "async_cliff_flushes": asyn["cliff_point"]["flushes"],
        "population_launches": population["launches"],
        "population_rounds": population["rounds"],
        # the device transport backend: once per aggregating point-round of
        # the fig3-shaped device grid, once per round of the fixture's run
        "device_grid_launches": plane["grid"]["launches"],
        "device_grid_aggregating_point_rounds": plane["grid"]["aggregating_point_rounds"],
        "device_reference_launches": plane["reference"]["launches"],
        "device_reference_rounds": plane["reference"]["completed_rounds"],
    },
        # one compressed round: the 8 CNN leaves at R = 10 (int8 grouped, bf16 summed)
        quant_row("quantize_rows", compressed["int8"], "src/repro/kernels/quantize.py:83",
                  NO_LIBRARY, grid["compressed"]["int8 dense"]),
        quant_row("downcast_bf16_rows", compressed["bf16"], "src/repro/kernels/quantize.py:112",
                  "one x.to(torch.bfloat16) over the same elements as a single [10, 206922] "
                  "tensor (library_per_leaf_ms: one call per leaf, 8 calls)",
                  grid["compressed"]["bf16 dense"]),
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
