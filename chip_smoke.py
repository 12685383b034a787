#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root. Phases, each printing one JSON line:

1. device    card, torch/CUDA versions, the TF32 flags as found (PyTorch's
             defaults: the port's CNN task turns TF32 off in its own scope);
2. build     every ``src/repro_torch/kernels/csrc/*.cu``, one nvcc each, in
             parallel, into ``build/repro_torch/``; registers, shared memory
             and spill bytes of the bf16 flash_attention (each of its 17
             (D, Dv) instances) and swiglu kernels, which must not spill;
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
18. server_opt
             the server-side optimizers: the quickstart under fedadam,
             fedyogi, fedadagrad and diloco and under fedavg, in turns
             (s/round against fedavg's), fedavg_reduce once per completed
             round; the fixture's four server-optimizer runs against the
             reference's committed Histories; a fedadam quickstart killed
             after round 4 and resumed, bitwise, server state included; the
             fig3 grid under fedadam == its 20 per-point runs bitwise, then
             with split-stream stochastic transport on the fused transport
             plane, killed after round 4 and resumed, bitwise;
19. engine_benches
             ``round_engine_bench``, ``sweep_bench`` and ``compress_bench``
             at their ``fast`` sizes (at the default sizes the phase outran
             its 180 s budget; the round bench alone took 103.5 s of the
             script's time on a slow host): every parity flag
             true, their seconds and speedups, launches per bench
             (quantize_rows in compress_bench's int8 points);
20. lm_kernels
             flash_attention and swiglu against their plain versions on the
             card: the reference sweeps, serving lengths, bf16 windows, both
             sides of the GQA packing boundary (G * Sq = 64, 65), the
             serving shape (B = 4, S = 16, 32 / 8 heads, D = 128), one
             S = 4096 prefill, Mixtral's windowed prefill (S = 5,016,
             window 4,096; SDPA with a boolean mask beside it), MLA's
             prefill at D 192 / Dv 128 (B = 4 x S = 16 and B = 1 x S =
             4,096, 128 heads), Phi-3-vision's at D 96 (B = 4 x S = 272,
             32 heads) and Zamba2's at D = Dv = 112 (B = 4 x S = 16 and
             B = 1 x S = 4,096, 32 heads) and Whisper's three shapes
             without a mask (8 heads of 64: the encoder at B = 4 x S =
             1,536, the cross attention of Sq = 16 and Sq = 1 over 1,536
             keys; SDPA without a mask beside them) in f32 and bf16, timed,
             with the custom op's backward at mla_train's shape (B = 2 x S =
             256), Phi-3-vision's, hybrid_train's (B = 2 x S = 256, D 112)
             and Whisper's encoder's (B = 2 x S = 1,536, no mask) against
             autograd through the plain version, and swiglu
             at Qwen3-8B's widths for
             M = 1, 4, 7, 44, 56, 64, with the same timing fields as
             ``kernel`` and one PyTorch call's time; the share of the bf16
             swiglu's time that its cross-block reduction takes (the
             kernel built again with ``-DSWIGLU_NO_REDUCE``);
21. serve     ``Server("qwen3-8b", reduced=False)`` on the card, params from a
             seeded generator: serve.py:main's 8 requests (batch 4, 12 new
             tokens each); launches asserted per prefill and per decode step;
             prefill ms, decode ms per step, tokens/s, peak memory, and the
             device-idle share of one profiled run (``serve_profile``);
22. full_width
             a 2-layer model at Qwen3-8B's full widths with the served
             params: one prefill and three decode steps on the card
             (kernels) and on the CPU (plain versions, fed the card's
             tokens); logits within 3e-2 of max |logit|;
23. lm_grad  flash_attention and swiglu under autograd (their
             ``torch.autograd.Function``s) against autograd through their
             plain versions at the training shapes (flash B = 2, S = 256,
             32 / 8 heads, D = 128, causal and a 64-key window; swiglu
             M = 512 at Qwen3-8B's widths), f32 and bf16: the output and
             every input gradient relative to its max |value|, the
             tolerance beside it; forward and backward timed (CUDA events)
             beside the bound, the plain version and SDPA;
24. lm_train_qwen
             Qwen3-8B at full width (bf16, Adafactor, 2 x 256 tokens): one
             step's loss and gradient norm through the kernels and through
             the plain versions, within a stated bf16 tolerance; then
             train steps under remat "block" (the config's) and "full" in
             turns, 3 steps a turn, two turns each: losses finite, s/step, tokens/s, peak memory, each
             kernel's launches per step ("block": flash_attention 36
             forward + 36 recomputed, swiglu 36, its output kept; "full":
             both 72) and backward passes (36), the device-idle share of
             one profiled step;
25. lm_train_starcoder2
             ``train("starcoder2-3b", reduced=False, n_layers=15)`` under
             AdamW (15 of 30 layers: the whole model's 31.8 GB checkpoint
             took 133 s to write and read back), 10 steps checkpointing at
             step 8 (the machine takes at most 45 GiB of disk writes a run),
             then a restart that resumes from step 8: its losses against
             steps 9 and 10 of the uninterrupted run, the loss falling,
             save / restore seconds;
26. lm_fl     ``FederatedServer`` on ``lm_task`` (reduced Qwen3), 4 clients,
             2 rounds, batched and sequential: fedavg_reduce once per round
             on the batched engine, the Histories equal by the CPU test's
             rules;
27. dense_serving
             Phi-3-medium-14B and Minitron-8B at full width, one at a time:
             one batch of serve.py:main's prompts with launches per prefill
             and decode step, logits finite over the padded vocab (256,000
             for Minitron), swiglu at their widths and flash_attention at
             their heads against the plain versions;
28. moe_serving
             ``Server("mixtral-8x7b", reduced=False, n_layers=16)``: full
             width (d 4096, 32 / 8 heads, 8 experts of d_ff 14,336, top-2,
             capacity 1.25, window 4,096), 16 of 32 layers (46.97 GB of
             params); serve.py:main's 8 requests: flash_attention 16 a
             prefill and 0 a decode step, prefill ms, decode ms per step,
             tokens/s, peak memory, the tokens capacity drops per call;
29. moe_long_prompt
             the same params at capacity 4.0 (drop-free), B = 1: a 5,000-token
             prompt into a 5,200-token cache (a 4,096-slot ring the prompt
             wraps, position p at slot p % 4,096), 16 teacher-forced decode
             steps, each step's logits within 3e-2 of max |logit| of one
             forward over all 5,016 tokens;
30. moe_train
             Mixtral at full width, 4 of 32 layers (6.07 B params), bf16,
             Adafactor, 2 x 256 tokens: one loss and gradient through the
             kernel and through the plain version (loss 1e-3, gradient norm
             2e-3; the kernel zeroed must fail), then ``train()`` for 3
             steps: losses finite, aux > 0, s/step, tokens/s, peak memory,
             launches per step;
31. mla_serving
             ``Server("deepseek-v2-236b", reduced=False, n_layers=6)``: full
             width (d 5,120, 128 heads, MLA, 160 experts of d_ff 1,536,
             top-6, 2 shared, capacity 1.25), layer 0 dense and 5 MoE layers
             (21.25 B params, 42.49 GB); serve.py:main's 8 requests:
             flash_attention 6 a prefill and 0 a decode step (the absorbed
             decode is plain torch), swiglu 1 each; prefill ms, decode ms
             per step, tokens/s, peak, the tokens dropped per call; then
             the same params at capacity 27 (drop-free), B = 1: a 512-token
             prompt and 8 teacher-forced decode steps, each within 3e-2 of
             max |logit| of one forward over all 520 tokens;
32. mla_train
             DeepSeek-V2 at full width, layer 0 and one MoE layer (5.36 B),
             Adafactor, 2 x 256 tokens: loss, gradient norm and the six MLA
             weights' gradient norms through the kernels against the plain
             versions (``TRAIN_RTOL``; each kernel zeroed must fail), then
             ``train()`` for 3 steps: s/step, tokens/s, peak, launches;
33. vlm_serving
             Phi-3-vision whole (32 layers, 3.83 B), B = 4: 256 random patch
             embeddings before serve.py:main's first 4 prompts, 12 greedy
             decode steps in bf16 (timed) and in f32, each step against one
             forward over the patches, the prompt and the decoded tokens:
             within 1e-4 of max |logit| in f32 (the cache position after
             patches, C6); the bf16 gap read at 2, 8, 16 and 32 layers;
             flash_attention at D 96 32 a prefill, swiglu 32 a prefill and
             a step;
34. rwkv_serving
             ``Server("rwkv6-1.6b", reduced=False)`` whole (24 layers, d
             2,048, 1.58 B params) on serve.py:main's 8 requests (the
             prompts pad to 8-15 tokens: the step-by-step time mix), no
             kernel launched; then B = 1, a 512-token prompt (the chunked
             form, 4 chunks of 128) and 8 teacher-forced decode steps
             against one forward over 640 tokens (positions 511-519): in
             bf16 timed, the gap read at 2, 8 and 24 layers
             (``RECURRENT_BF16_NOTE``), and with the same params in f32
             within ``RECURRENT_F32_RTOL`` of max |logit|;
35. rwkv_train
             RWKV6 whole, 2 x 256 tokens: one loss and gradient, every
             gradient finite, then ``train()`` for 3 AdamW steps: s/step,
             tokens/s, peak memory;
36. hybrid_serving
             ``Server("zamba2-7b", reduced=False)`` whole (81 Mamba2 layers,
             the shared block applied 13 times, a 3-layer tail; 6.75 B
             params) on the same 8 requests: flash_attention at D = Dv =
             112 13 a prefill and 0 a decode step, swiglu 13 each; then the
             same 512-token check, the bf16 gap read at 6, 24 and 81 layers;
37. hybrid_train
             Zamba2 whole, Adafactor, 2 x 256 tokens: loss, gradient norm
             and the shared block's seven weights' gradient norms through the
             kernels against the plain versions (``TRAIN_RTOL``; each
             kernel zeroed must fail; every gradient finite: C7), then
             ``train()`` for 3 steps: s/step, tokens/s, peak, launches a
             step (flash 26, swiglu 13);
38. encdec_serving
             ``Server("whisper-base", reduced=False)`` whole (6 encoder and 6
             decoder layers, d 512, 8 heads of 64, 1,536 zero frames) on
             serve.py:main's 8 requests: flash_attention 18 a prefill
             (encoder, decoder self and cross attention) and 6 a decode
             step (cross attention, no mask); then B = 4 random frames, a
             64-token prompt and 8 teacher-forced decode steps against one
             72-token forward: bf16 timed and its gap read, f32 within 1e-4
             of max |logit|; the per-call copy of one layer's cross k / v
             into the kernel's layout timed;
39. encdec_train
             Whisper whole, AdamW, 2 x 256 tokens over 1,536 frames: loss,
             gradient norm and eight weights' gradient norms (an encoder
             ``wq``, whose gradient reaches the loss only through the cross
             attention's k / v, and the decoder's ``cross_attn.wk``) through
             the kernel against the plain version (``TRAIN_RTOL``; the
             kernel zeroed must fail), then ``train()`` for 3 steps: s/step,
             tokens/s, peak, launches a step (flash 36, 18 backward
             passes);
40. sharded_steps
             item 16's sharded steps on a 1 x 1 ``nccl`` DeviceMesh and a
             1 x 1 x 1 pod mesh: Qwen3-8B at full width, 8 layers, its
             sharded loss / gradient and 2 ``build_train_step`` steps
             against the one-device ones (``TRAIN_RTOL``, the kernels'
             launches equal), a sharded prefill and 4 decode steps
             (3e-2 of max |logit|); Mixtral, 2 layers, through ``ep_a2a``
             at drop-free capacity; local-SGD then the int8 outer sync
             bit for bit against plain torch; then ``lm_phases``, the
             seconds of phases 23-40 against their budget;
41. flash_small_heads
             the flash kernel at (D, Dv) = (16, 16) and (24, 16), f32 and
             bf16, against the plain version (timed at B = 4 x S = 64 beside
             the bound and SDPA); then reduced Phi-3-medium, StarCoder2,
             Phi-3-vision, Whisper (heads of 16) and DeepSeek-V2 (MLA
             prefill at 24 / 16) served (a prefill, two decode steps) and
             trained (a loss and gradient) on the card: f32 against the same
             weights on the CPU, bf16 against the plain flash version on the
             card (the kernel zeroed must fail);
42. dryrun    item 16.2: ``python -m repro_torch.launch.dryrun`` for Qwen3-8B
             x train_4k on the 16 x 16 mesh, and on 2 x 16 x 16 with the int8
             outer sync, each a process of its own started after the build
             (they trace while the card works): every record ``ok``, one
             rank's FLOPs, bytes, collective bytes by kind, peak live bytes
             and ``fits_hbm``, the roofline terms on ``H100_SXM``, printed
             as model estimates; each train cell's peak printed beside the
             card's 80 GB and ``fits_hbm`` required true;
43. examples  ``repro_torch.examples``: quickstart (2 x 8 rounds), edge_africa
             (7 profiles x 2 x 5 rounds), tcp_tuning and train_100m (200
             steps, its loss falling by more than 0.5) on the card (the FL
             drivers keep the reference's sequential engine, whose mean is
             plain torch), flash_attention and swiglu in every train step;
             then ``port_completion_phases``,
             the seconds of phases 41-43 against their 240 s budget
             (checked).

Then the kernels line, the card's name and power limit as nvidia-smi gives
them, and the final ``{"ok": true, ...}`` line. A failed phase raises: the
script exits non-zero and prints no result. Without CUDA, or without the
repository beside it, it exits 2.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
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
                 compressor=None, strategy="fedavg", **cfg):
    """The quickstart: 10 clients x 200 examples, fedavg(min_fit=0.1) (or
    another strategy of ``STRATEGIES`` at min_fit 0.1), a degraded network
    from t=60 s and 30 % of pods killed from t=120 s."""
    from repro_torch import transport
    from repro_torch.chaos import ChaosSchedule, client_failure_schedule, netem
    from repro_torch.core import (
        STRATEGIES,
        EdgeClient,
        FederatedServer,
        ServerConfig,
        mnist_cnn_task,
    )
    from repro_torch.data import make_federated_mnist, synthetic_mnist

    shards = make_federated_mnist(n_clients=10, examples_per_client=200, seed=0)
    chaos = ChaosSchedule(transport.LAB).add(
        netem(60.0, 10_000.0, delay=0.8, loss=0.10),
        client_failure_schedule(10, 0.3, t_start=120.0, seed=3),
    )
    return FederatedServer(
        mnist_cnn_task(lr=0.05, batch_size=32),
        [EdgeClient(i, dataset=s) for i, s in enumerate(shards)],
        STRATEGIES[strategy](min_fit=0.1),
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
    fa.backward_calls = sw.backward_calls = 0
    for name in qz.launches:
        qz.launches[name] = 0


def read_launches() -> dict:
    from repro_torch.kernels import fedavg_reduce as fr
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import swiglu as sw

    return {"fedavg_reduce": fr.launches, **qz.launches,
            "flash_attention": fa.launches, "swiglu": sw.launches,
            # backward passes of their autograd ops (plain torch, no launch)
            "flash_attention_backward": fa.backward_calls, "swiglu_backward": sw.backward_calls}


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
    """History, clients, clock, staleness clock, final params and the server
    optimizer's state: equal bits."""
    return (_same_bits(torch, a.history, b.history)
            and _same_bits(torch, a.global_params, b.global_params)
            and _same_bits(torch, a.strategy.server_state, b.strategy.server_state)
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
# the server-side optimizers and the engine benches
# --------------------------------------------------------------------------

SERVER_OPTS = ("fedadam", "fedyogi", "fedadagrad", "diloco")


def phase_server_opt(torch, tmp):
    """The server-side optimizers on the card. The quickstart (10 clients, 8
    rounds, batched) under fedadam, fedyogi, fedadagrad and diloco, and
    under fedavg, in turns (fedavg, the four, the four reversed, fedavg):
    s/round against fedavg's, fedavg_reduce once per completed round. The
    fixture's four server-optimizer runs against the reference's committed
    Histories. A fedadam quickstart killed after round ``KILL_AT`` and
    resumed, bitwise (server state included). The fig3 grid under fedadam
    == its 20 per-point runs bitwise, fedavg_reduce once per aggregating
    point-round; then fig3's links with split-stream stochastic transport on
    the fused transport plane, killed after round ``KILL_AT`` and resumed,
    bitwise."""
    import dataclasses

    from repro_torch.core import STRATEGIES, run_fl_grid
    from repro_torch.experiments import common, fig3_latency

    t0 = time.perf_counter()
    runs = {}
    for name in ("fedavg",) + SERVER_OPTS + SERVER_OPTS[::-1] + ("fedavg",):  # in turns
        hist, wall, counts = timed_run(torch, paper_server(torch, strategy=name))
        accs = [m["accuracy"] for m in hist.eval_metrics]
        check(hist.completed_rounds > 0 and all(0.0 <= a <= 1.0 for a in accs),
              f"server_opt {name}: {hist.summary()}")
        check(counts["fedavg_reduce"] == hist.completed_rounds,
              f"server_opt {name}: {counts['fedavg_reduce']} fedavg_reduce launches for "
              f"{hist.completed_rounds} rounds")
        runs.setdefault(name, []).append({
            "wall_s_per_round": wall / len(hist.rounds), "launches": counts["fedavg_reduce"],
            "completed_rounds": hist.completed_rounds, "final_accuracy": accs[-1]})
    s_per_round = {k: [r["wall_s_per_round"] for r in v] for k, v in runs.items()}
    base = statistics.median(s_per_round["fedavg"])
    opt_runs = [r for name in SERVER_OPTS for r in runs[name]]

    sys.path.insert(0, str(ROOT / "tests"))
    import _card_reference as card

    records, task, pkgs = card.load_records(), card.port_task("cuda"), card.port_packages()
    fixture = {}
    for name in card.SERVER_OPT:
        (hist, clients), _, counts = counted(torch, lambda n=name: card.run(n, task, *pkgs))
        got = card.history_record(hist, clients)
        try:
            card.assert_records_match(records[name], got)
        except AssertionError as e:
            raise PhaseFailed(f"server_opt fixture {name}: {e!r}; "
                              f"gaps {card.history_gaps(records[name], got)}") from e
        check(counts["fedavg_reduce"] == hist.completed_rounds,
              f"server_opt fixture {name}: launches {counts['fedavg_reduce']}")
        fixture[name] = {"gaps": card.history_gaps(records[name], got),
                         "launches": counts["fedavg_reduce"]}

    make = lambda: paper_server(torch, strategy="fedadam")  # noqa: E731
    _, counts, seg = _kill_and_resume(torch, make, tmp, "server_opt_fedadam")
    check(counts["fedavg_reduce"] == seg["completed"],
          f"server_opt: resumed launches {counts['fedavg_reduce']} for {seg['completed']}")
    resume = {"resumed_launches": counts["fedavg_reduce"], "resumed_rounds": seg["completed"],
              "resumed_wall_s": seg["wall_s"]}

    eval_data = common._shared_eval_data()
    grid_task = common._shared_task("cuda")
    _, kwargs = fig3_latency.sweep_points()

    def points(**extra):
        pts = [common._make_point(**kw, **extra) for kw in kwargs]
        return [dataclasses.replace(p, strategy=STRATEGIES["fedadam"](
            min_fit=p.strategy.min_fit_fraction)) for p in pts]

    res, grid_wall, counts = _grid_run(torch, grid_task, points(), eval_data)
    servers, pp_wall = _per_point_runs(torch, grid_task, points(), eval_data)
    for i, (g, s) in enumerate(zip(res.servers, servers)):
        check(_same_server_state(torch, g, s), f"server_opt grid: point {i} != its per-point run")
    aggregating = sum(h.completed_rounds for h in res.histories)
    check(counts["fedavg_reduce"] == aggregating,
          f"server_opt grid: {counts['fedavg_reduce']} launches for {aggregating}")
    grid = {"points": len(kwargs), "grid_wall_s": grid_wall, "per_point_wall_s": pp_wall,
            "stats": dataclasses.asdict(res.stats), "launches": counts["fedavg_reduce"],
            "aggregating_point_rounds": aggregating, "grid_equals_per_point": True}

    split = dict(stochastic=True, rng_streams="split")
    d = str(Path(tmp) / "server_opt_grid")
    fused = lambda **kw: run_fl_grid(grid_task, points(**split), eval_data=eval_data,  # noqa: E731
                                     transport="fused", **kw)
    ref = fused()
    fused(checkpoint_dir=d, stop_after_round=KILL_AT)
    res, _, counts = counted(torch, lambda: fused(checkpoint_dir=d))
    for i, (a, b) in enumerate(zip(ref.servers, res.servers)):
        check(_same_server_state(torch, a, b), f"server_opt fused grid: point {i} differs")
    check(res.stats.resumed_round == KILL_AT, f"server_opt fused grid: {res.stats}")
    resumed = sum(0 if r.failed_round else 1 for h in res.histories for r in h.rounds[KILL_AT:])
    check(counts["fedavg_reduce"] == resumed,
          f"server_opt fused grid: {counts['fedavg_reduce']} launches for {resumed}")
    grid["fused_resume"] = {"equal": True, "resumed_launches": counts["fedavg_reduce"],
                            "resumed_aggregating_point_rounds": resumed,
                            "stats": dataclasses.asdict(res.stats)}
    seconds = time.perf_counter() - t0
    emit("server_opt", seconds=seconds, rounds=MAIN_ROUNDS, runs=runs,
         s_per_round=s_per_round,
         s_per_round_over_fedavg={k: statistics.median(v) / base for k, v in s_per_round.items()},
         fixture=fixture, tol=card.HISTORY_TOL,
         fixture_max_gap={k: max(f["gaps"][k] for f in fixture.values())
                          for k in ("accuracy", "loss", "client_metrics")},
         kill_and_resume=resume, grid=grid)
    return {"seconds": seconds, "launches": sum(r["launches"] for r in opt_runs),
            "rounds": sum(r["completed_rounds"] for r in opt_runs)}


ENGINE_BENCHES = ("round_engine_bench", "sweep_bench", "compress_bench")
ENGINE_BENCH_BUDGET_S = 180.0  # the phase's budget


def phase_engine_benches(torch):
    """The three engine benches of ``repro_torch.experiments`` on the card
    at their ``fast`` sizes: ``round_engine_bench`` (8 clients, 3 rounds of
    4 local steps, sequential vs batched), ``sweep_bench`` (the fig3 grid vs
    per-point, fig3 / fig4 / table3 row parity, the fused transport section)
    and ``compress_bench`` (the (loss x tcp x {topk 0.05, int8}) grid
    through the plane vs unstacked): at the default sizes the phase took
    181 s on an H100, over its 180 s budget, and the round bench's full size
    alone 103.5 s (PERF.md). Every parity flag must hold; the speed
    targets are readings. Launches are counted per bench (fedavg_reduce;
    quantize_rows in compress_bench)."""
    import contextlib
    import io

    from repro_torch.experiments import compress_bench, round_engine_bench, sweep_bench

    t0 = time.perf_counter()
    out = {}
    for name, fn, kw in zip(ENGINE_BENCHES, (
        round_engine_bench.run_bench, sweep_bench.run_bench, compress_bench.run_bench),
            ({"fast": True}, {"fast": True}, {"fast": True})):
        with contextlib.redirect_stdout(io.StringIO()):
            r, wall, counts = counted(torch, lambda f=fn, k=kw: f(device="cuda", **k))
        parity = {k: v for k, v in r.items() if k.startswith(("parity", "agree_", "accuracy_"))}
        if "fused_transport" in r:
            parity["fused_transport_parity"] = r["fused_transport"]["parity"]
        check(all(parity.values()), f"engine_benches {name}: parity {parity}")
        out[name] = {"seconds": wall, "bench": r, "parity": parity,
                     "launches": {k: counts[k] for k in ("fedavg_reduce", "quantize_rows")}}
    check(out["compress_bench"]["launches"]["quantize_rows"] > 0,
          "engine_benches: compress_bench launched no quantize_rows")
    seconds = time.perf_counter() - t0
    emit("engine_benches", seconds=seconds, fast=True,
         budget_s=ENGINE_BENCH_BUDGET_S, within_budget=seconds <= ENGINE_BENCH_BUDGET_S,
         speedups={k: v["bench"]["speedup"] for k, v in out.items()}, **out)
    return {"seconds": seconds, **out}


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


def flash_work(B, Sq, Skv, Hq, Hkv, D, itemsize, causal=True, window=0, Dv=None) -> tuple:
    """(bytes, flops): q, k (head dim D), v (Dv, D by default) read once and
    the output (Dv) written once; a multiply-add per unmasked pair for each
    of q.k's D and p.v's Dv."""
    Dv = D if Dv is None else Dv
    bytes_moved = (B * Hq * Sq * (D + Dv) + B * Hkv * Skv * (D + Dv)) * itemsize
    return bytes_moved, 2 * (D + Dv) * B * Hq * attention_pairs(Sq, Skv, causal, window)


def swiglu_work(M, d, F, itemsize) -> tuple:
    """(bytes, flops): x and the three weights read once, the output
    written once; three products of 2*M*d*F."""
    return (2 * M * d + 3 * d * F) * itemsize, 6 * M * d * F


# the redesigned bf16 kernels (flash_attention: wgmma + TMA; swiglu: cp.async
# ring + mma.sync, and its cast launch), held to zero spills at build time
NEW_KERNELS = ("flash_kernel_wgmma", "swiglu_kernel_mma", "swiglu_cast_kernel")
# every (D, Dv) flash_attention takes (csrc/flash_attention.cu's FLASH_PAIRS)
FLASH_HEAD_PAIRS = ((16, 16), (24, 16), (32, 32), (64, 32), (64, 64), (96, 32), (96, 64),
                    (96, 96), (112, 112), (128, 32), (128, 64), (128, 96), (128, 128), (192, 32),
                    (192, 64), (192, 96), (192, 128))
# MLA's prefill heads (DeepSeek-V2: 128 heads, q/k 128 + 64 rope, v 128) and
# Phi-3-vision's (32 heads of 96; 256 patches before a 16-token prompt) and
# Zamba2's shared attention (32 heads of 3584 / 32 = 112)
MLA_HEADS, MLA_D, MLA_DV = 128, 192, 128
VLM_HEADS, VLM_D, VLM_PATCHES = 32, 96, 256
ZAMBA_HEADS, ZAMBA_D = 32, 112
# Whisper-base: 8 heads of 64, 1,536 encoder frames; its flash shapes run
# without a mask (the encoder and the cross attention)
WHISPER_HEADS, WHISPER_D, WHISPER_SE = 8, 64, 1536
WHISPER_GROUPS = ("whisper_encoder", "whisper_cross_prefill", "whisper_cross_decode")
VLM_PREFILL_S = VLM_PATCHES + 16
KNOWN_ENTRIES = NEW_KERNELS + ("flash_kernel_simt", "swiglu_kernel_simt")


def ptxas_entries(report: str) -> list:
    """Registers, static shared memory and spill bytes of each entry function
    in an ``nvcc -Xptxas -v`` report, by kernel name (and template arguments:
    flash's D and Dv)."""
    import re

    entries, cur = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            mangled = m.group(1)
            kernel = next((k for k in KNOWN_ENTRIES if k in mangled), mangled)
            t = re.search(re.escape(kernel) + r"I((?:Li\d+E)+)E", mangled)
            args = ",".join(re.findall(r"Li(\d+)E", t.group(1))) if t else ""
            cur = {"entry": kernel + (f"<{args}>" if args else ""), "kernel": kernel}
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
    return {**{f"flash_kernel_wgmma<{D},{Dv}>": fa(D, Dv) for D, Dv in FLASH_HEAD_PAIRS},
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


# the attention backward at MLA's training shape (mla_train: B = 2 x S =
# 256, 128 heads, D 192 / Dv 128), Phi-3-vision's prefill (D 96) and
# Zamba2's training shape (hybrid_train: B = 2 x S = 256, 32 heads, D 112):
# (B, S, Hq, Hkv, D, Dv)
HEAD_DIM_BACKWARD = (("mla_train", (2, 256, MLA_HEADS, MLA_HEADS, MLA_D, MLA_DV)),
                     ("vlm_prefill", (4, VLM_PREFILL_S, VLM_HEADS, VLM_HEADS, VLM_D, VLM_D)))
ZAMBA_BACKWARD = (("zamba_train", (2, 256, ZAMBA_HEADS, ZAMBA_HEADS, ZAMBA_D, ZAMBA_D)),)
# Whisper's encoder under training: B = 2 x S = 1,536 frames, no mask
WHISPER_BACKWARD = (("whisper_encoder", (2, WHISPER_SE, WHISPER_HEADS, WHISPER_HEADS, WHISPER_D,
                                         WHISPER_D)),)


def head_dim_backward(torch, gen, groups, causal=True) -> dict:
    """flash_attention's custom op at the head dims of ``groups``, f32 and bf16: the
    output and every input gradient against autograd through the plain
    version, relative to its max |value| (``GRAD_RTOL``); bf16 forward and
    backward timed beside the bound, the plain version and SDPA's."""
    import functools

    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    out = {}
    sdpa_kw = {"is_causal": True} if causal else {}
    for group, (B, S, Hq, Hkv, D, Dv) in groups:
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).removeprefix("torch.")
            q = torch.randn(B * Hq, S, D, generator=gen, device="cuda").to(dt)
            k = torch.randn(B * Hkv, S, D, generator=gen, device="cuda").to(dt)
            v = torch.randn(B * Hkv, S, Dv, generator=gen, device="cuda").to(dt)
            gaps = grad_gaps(torch, functools.partial(fa.flash_attention_grad, causal=causal),
                             functools.partial(flash_attention_ref, causal=causal), [q, k, v], 3)
            check(max(gaps) < GRAD_RTOL[name],
                  f"lm_kernels backward {group} {name}: rel errs {gaps} >= {GRAD_RTOL[name]}")
            row = {"kernel": "flash_attention", "group": f"{group}_backward",
                   "shape": [B, S, S, Hq, Hkv, D, Dv], "dtype": name, "causal": causal,
                   "rel_err": dict(zip(("out", "dq", "dk", "dv"), gaps)), "rtol": GRAD_RTOL[name]}
            if dt == torch.bfloat16:
                o = fa.flash_attention_bhsd(q, k, v, causal=causal)
                dout = torch.randn(o.shape, generator=gen, device="cuda").to(dt)
                qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
                ref_out = flash_attention_ref(qs, ks, vs, causal=causal)
                lib_out = F.scaled_dot_product_attention(
                    qs.view(B, Hq, S, D), ks.view(B, Hkv, S, D), vs.view(B, Hkv, S, Dv),
                    enable_gqa=True, **sdpa_kw)
                row["forward"] = _timings(
                    torch, lambda: fa.flash_attention_bhsd(q, k, v, causal=causal),
                    lambda: flash_attention_ref(q, k, v, causal=causal),
                    lambda: F.scaled_dot_product_attention(
                        q.view(B, Hq, S, D), k.view(B, Hkv, S, D), v.view(B, Hkv, S, Dv),
                        enable_gqa=True, **sdpa_kw),
                    flash_work(B, S, S, Hq, Hkv, D, 2, causal=causal, Dv=Dv), dt, iters=20,
                    reps=5)
                row["backward"] = _timings(
                    torch, lambda: fa._flash_backward(q, k, v, o, dout, causal, 0, D ** -0.5),
                    lambda: torch.autograd.grad(ref_out, (qs, ks, vs), dout, retain_graph=True),
                    lambda: torch.autograd.grad(lib_out, (qs, ks, vs), dout.view(B, Hq, S, Dv),
                                                retain_graph=True),
                    flash_backward_work(B, S, Hq, Hkv, D, 2, Dv=Dv, causal=causal), dt, iters=10,
                    reps=5)
                out[group] = row
            emit("lm_kernels", **row)
    torch.cuda.empty_cache()
    return out


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
                    ((1, 4096, 4096, 32, 8, 128), bf16, 0, "long_prefill"),
                    # Mixtral's windowed prefill: moe_long_prompt's 5,016 tokens
                    ((1, MIXTRAL_LONG_S, MIXTRAL_LONG_S, 32, 8, 128), bf16, MIXTRAL_WINDOW,
                     "window_prefill")]
    # MLA's prefill at D 192 / Dv 128 (serve.py:main's batch, then one long
    # causal prompt) and Phi-3-vision's at D 96: (B, Sq, Skv, Hq, Hkv, D, Dv)
    head_dim_cases = [((4, 16, 16, MLA_HEADS, MLA_HEADS, MLA_D, MLA_DV), "mla_prefill"),
                      ((1, 4096, 4096, MLA_HEADS, MLA_HEADS, MLA_D, MLA_DV), "mla_long_prefill"),
                      ((4, VLM_PREFILL_S, VLM_PREFILL_S, VLM_HEADS, VLM_HEADS, VLM_D, VLM_D),
                       "vlm_prefill")]
    flash_cases += [(shape, dt, 0, group) for shape, group in head_dim_cases for dt in (f32, bf16)]
    # Zamba2's shared attention at D = Dv = 112: serve.py:main's batch, then
    # one long causal prompt; drawn from a generator of their own, so that
    # the cases before and after them keep their inputs
    zgen = torch.Generator(device=dev).manual_seed(112)
    zamba_cases = [((4, 16, 16, ZAMBA_HEADS, ZAMBA_HEADS, ZAMBA_D, ZAMBA_D), dt, 0, "zamba_prefill")
                   for dt in (f32, bf16)]
    zamba_cases += [((1, 4096, 4096, ZAMBA_HEADS, ZAMBA_HEADS, ZAMBA_D, ZAMBA_D), dt, 0,
                     "zamba_long_prefill") for dt in (f32, bf16)]
    # Whisper's three non-causal shapes, at serve.py:main's batch of 4: the
    # encoder over 1,536 frames, the cross attention of a 16-token prompt
    # and of one decode token over them; drawn from a generator of their own
    wgen = torch.Generator(device=dev).manual_seed(64)
    whisper_cases = [((4, Sq, Skv, WHISPER_HEADS, WHISPER_HEADS, WHISPER_D), dt, 0, group)
                     for Sq, Skv, group in ((WHISPER_SE, WHISPER_SE, "whisper_encoder"),
                                            (16, WHISPER_SE, "whisper_cross_prefill"),
                                            (1, WHISPER_SE, "whisper_cross_decode"))
                     for dt in (f32, bf16)]
    timed_groups = ("serving", "long_prefill", "window_prefill", "mla_prefill",
                    "mla_long_prefill", "vlm_prefill", "zamba_prefill", "zamba_long_prefill",
                    *WHISPER_GROUPS)
    tol = {f32: 2e-5, bf16: 5e-2}
    # per query row, relative to that row's max |plain|: a late row of the
    # S = 4096 prefill averages ~1,500 keys and is only ~0.02 in size, below
    # the absolute bf16 tolerance; bf16 rounds each output once (2**-8)
    row_tol = {f32: 1e-3, bf16: 1e-2}
    for (shape, dt, window, group), g in ([(c, gen) for c in flash_cases]
                                          + [(c, zgen) for c in zamba_cases]
                                          + [(c, wgen) for c in whisper_cases]):
        B, Sq, Skv, Hq, Hkv, D, *rest = shape
        Dv = rest[0] if rest else D
        causal = group not in WHISPER_GROUPS
        q = torch.randn(B * Hq, Sq, D, generator=g, device=dev).to(dt)
        k = torch.randn(B * Hkv, Skv, D, generator=g, device=dev).to(dt)
        v = torch.randn(B * Hkv, Skv, Dv, generator=g, device=dev).to(dt)
        kernel = lambda: fa.flash_attention_bhsd(q, k, v, causal=causal, window=window)
        plain = lambda: flash_attention_ref(q, k, v, causal=causal, window=window)
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(got.float() - want.float())))
        scale = float(torch.max(torch.abs(want.float())))
        row_err = float(torch.max(torch.amax(torch.abs(got.float() - want.float()), -1)
                                  / torch.amax(torch.abs(want.float()), -1).clamp_min(1e-30)))
        check(got.dtype == dt and got.shape == (B * Hq, Sq, Dv), f"flash_attention {group} output")
        check(err < tol[dt], f"flash_attention {shape} {dt} w={window}: "
                             f"max err {err} >= {tol[dt]}")
        check(row_err < row_tol[dt], f"flash_attention {shape} {dt} "
                                     f"w={window}: row-relative err {row_err} >= {row_tol[dt]}")
        acc = out["flash_attention"]
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        acc["max_rel_err"] = max(acc["max_rel_err"], err / max(scale, 1e-30))
        acc["max_row_rel_err"] = max(acc["max_row_rel_err"], row_err)
        row = {"kernel": "flash_attention", "shape": list(shape), "dtype": name[dt],
               "window": window, "causal": causal, "group": group, "max_abs_err": err,
               "max_abs_ref": scale, "max_row_rel_err": row_err, "row_rtol": row_tol[dt]}
        if group in timed_groups:
            if window:  # SDPA takes a window as a boolean mask (True: attend)
                i = torch.arange(Sq, device=dev)[:, None]
                j = torch.arange(Skv, device=dev)[None, :]
                sdpa_kw = {"attn_mask": (j <= i) & (i - j < window)}
            else:
                sdpa_kw = {"is_causal": True} if causal else {}
            library = lambda: F.scaled_dot_product_attention(
                q.view(B, Hq, Sq, D), k.view(B, Hkv, Skv, D), v.view(B, Hkv, Skv, Dv),
                enable_gqa=True, **sdpa_kw)
            n = 100 if Sq <= 16 else 5
            row.update(_timings(torch, kernel, plain, library,
                                flash_work(B, Sq, Skv, Hq, Hkv, D, q.element_size(),
                                           causal=causal, window=window, Dv=Dv), dt,
                                iters=n, reps=7 if n == 100 else 3))
            acc["timed"][group if dt == bf16 else f"{group}_f32"] = row
        emit("lm_kernels", **row)
        del q, k, v, got, want
    out["flash_attention"]["head_dim_backward"] = {
        **head_dim_backward(torch, gen, HEAD_DIM_BACKWARD),
        **head_dim_backward(torch, zgen, ZAMBA_BACKWARD),
        **head_dim_backward(torch, wgen, WHISPER_BACKWARD, causal=False)}

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


# --------------------------------------------------------------------------
# LM training (phases 23-27)
# --------------------------------------------------------------------------

LM_BUDGET_S = 300.0  # phases 23-40 together
STARCODER_TRAIN_LAYERS = 15  # of 30 (see phase_lm_train_starcoder)
TRAIN_B, TRAIN_S = 2, 256  # the training batch: 2 sequences of 256 tokens
# kernel Function vs autograd through the plain version, relative to the
# largest |value|: f32 sums in another order; bf16 also rounds P (flash) or
# h (swiglu) once more and runs the backward's products in bf16
GRAD_RTOL = {"float32": 1e-4, "bfloat16": 3e-2}
# one Qwen3-8B loss and gradient with the kernels against the plain
# versions (bf16), relative gaps: the loss, the gradients' global norm, and
# the norms of the attention's and the MLP's weight gradients over all
# layers (the loss at random init sits near ln V whatever attention does,
# so the leaves carry the check). A few times the gaps read on the card
# (PERF.md).
TRAIN_RTOL = {"loss": 1e-3, "grad_norm": 2e-3, "leaf": 5e-3}
TRAIN_LEAVES = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))
RESUME_TOL = 1e-4  # StarCoder2's resumed losses against the uninterrupted run's
REMAT_TURNS = ("block", "full", "block", "full")  # lm_train_qwen's turns of 3 steps


def flash_backward_work(B, S, Hq, Hkv, D, itemsize, window=0, Dv=None, causal=True) -> tuple:
    """(bytes, flops) of the attention backward: q, k, v, out and dO read
    once, dq, dk, dv written once; per unmasked pair a multiply-add for each
    head dim of S = q k^T, dQ and dK (D) and of dV and dP (Dv, D by
    default)."""
    Dv = D if Dv is None else Dv
    bytes_moved = (2 * B * Hq * S * (D + Dv) + 2 * B * Hkv * S * (D + Dv)) * itemsize
    return bytes_moved, 2 * (3 * D + 2 * Dv) * B * Hq * attention_pairs(S, S, causal, window)


def swiglu_backward_work(M, d, F, itemsize) -> tuple:
    """(bytes, flops) of the SwiGLU backward: x, the three weights and dOut
    read once, dx and the three weight gradients written once; eight
    products of 2*M*d*F (g and u again, dh, dWd, dx twice, dWg, dWu)."""
    return (4 * M * d + 6 * d * F) * itemsize, 16 * M * d * F


def grad_gaps(torch, fn, plain, inputs, seed):
    """max |kernel - plain| / max |plain| of the output and of each input's
    gradient under one random cotangent; launches and backward passes made
    here are comparisons, not the main path's."""
    gen = torch.Generator(device=inputs[0].device).manual_seed(seed)
    xs = [t.detach().requires_grad_(True) for t in inputs]
    ys = [t.detach().requires_grad_(True) for t in inputs]
    out, ref = fn(*xs), plain(*ys)
    cot = torch.randn(ref.shape, generator=gen, device=ref.device).to(ref.dtype)
    got = torch.autograd.grad(out, xs, cot)
    want = torch.autograd.grad(ref, ys, cot)
    torch.cuda.synchronize()
    return [float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
            for a, b in zip((out.detach(), *got), (ref.detach(), *want))]


def phase_lm_grad(torch):
    """flash_attention and swiglu under autograd against autograd through
    their plain versions at the training shapes, in f32 and bf16; forward
    and backward timed beside the bound and one PyTorch call."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import swiglu as sw
    from repro_torch.kernels.ref import flash_attention_ref, swiglu_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {"flash_attention": {}, "swiglu": {}}
    B, S, Hq, Hkv, D = TRAIN_B, TRAIN_S, 32, 8, 128
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).removeprefix("torch.")
        for window in (0, 64):
            q = torch.randn(B * Hq, S, D, generator=gen, device=dev).to(dt)
            k, v = (torch.randn(B * Hkv, S, D, generator=gen, device=dev).to(dt) for _ in "kv")
            gaps = grad_gaps(torch, lambda *t: fa.flash_attention_grad(*t, window=window),
                             lambda *t: flash_attention_ref(*t, window=window), [q, k, v], 1)
            check(max(gaps) < GRAD_RTOL[name],
                  f"lm_grad flash {name} window={window}: rel errs {gaps} >= {GRAD_RTOL[name]}")
            row = {"kernel": "flash_attention", "shape": [B, S, S, Hq, Hkv, D], "dtype": name,
                   "window": window, "rel_err": dict(zip(("out", "dq", "dk", "dv"), gaps)),
                   "rtol": GRAD_RTOL[name]}
            if window == 0:
                scale = D ** -0.5
                o = fa.flash_attention_bhsd(q, k, v)
                dout = torch.randn(o.shape, generator=gen, device=dev).to(dt)
                qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
                ref_out = flash_attention_ref(qs, ks, vs)
                lib_out = F.scaled_dot_product_attention(
                    qs.view(B, Hq, S, D), ks.view(B, Hkv, S, D), vs.view(B, Hkv, S, D),
                    is_causal=True, enable_gqa=True)
                fwd = _timings(torch, lambda: fa.flash_attention_bhsd(q, k, v),
                               lambda: flash_attention_ref(q, k, v),
                               lambda: F.scaled_dot_product_attention(
                                   q.view(B, Hq, S, D), k.view(B, Hkv, S, D), v.view(B, Hkv, S, D),
                                   is_causal=True, enable_gqa=True),
                               flash_work(B, S, S, Hq, Hkv, D, q.element_size()), dt,
                               iters=20, reps=5)
                bwd = _timings(torch, lambda: fa._flash_backward(q, k, v, o, dout, True, 0, scale),
                               lambda: torch.autograd.grad(ref_out, (qs, ks, vs), dout,
                                                           retain_graph=True),
                               lambda: torch.autograd.grad(lib_out, (qs, ks, vs),
                                                           dout.view(B, Hq, S, D),
                                                           retain_graph=True),
                               flash_backward_work(B, S, Hq, Hkv, D, q.element_size()), dt,
                               iters=10, reps=5)
                row.update(forward=fwd, backward=bwd)
                out["flash_attention"][name] = row
            emit("lm_grad", **row)
        M, d, F_ = TRAIN_B * TRAIN_S, QWEN_D, QWEN_F
        x = torch.randn(M, d, generator=gen, device=dev).to(dt)
        ws = [(torch.randn(s, generator=gen, device=dev) * s[0] ** -0.5).to(dt)
              for s in ((d, F_), (d, F_), (F_, d))]
        gaps = grad_gaps(torch, sw.swiglu_grad, swiglu_ref, [x, *ws], 2)
        check(max(gaps) < GRAD_RTOL[name], f"lm_grad swiglu {name}: rel errs {gaps}")
        dout = torch.randn(M, d, generator=gen, device=dev).to(dt)
        xs = [t.detach().requires_grad_(True) for t in (x, *ws)]
        ref_out = swiglu_ref(*xs)
        comp_out = (F.silu(xs[0] @ xs[1]) * (xs[0] @ xs[2])) @ xs[3]
        fwd = _timings(torch, lambda: sw.swiglu_fused(x, *ws), lambda: swiglu_ref(x, *ws), None,
                       swiglu_work(M, d, F_, x.element_size()), dt, iters=5, reps=3)
        fwd["composite_us"] = device_us(
            torch, lambda: (F.silu(x @ ws[0]) * (x @ ws[1])) @ ws[2], 5, 3)
        bwd = _timings(torch, lambda: sw._swiglu_backward(x, *ws, dout),
                       lambda: torch.autograd.grad(ref_out, xs, dout, retain_graph=True), None,
                       swiglu_backward_work(M, d, F_, x.element_size()), dt, iters=5, reps=3)
        bwd["composite_us"] = device_us(
            torch, lambda: torch.autograd.grad(comp_out, xs, dout, retain_graph=True), 5, 3)
        row = {"kernel": "swiglu", "shape": [M, d, F_], "dtype": name,
               "rel_err": dict(zip(("out", "dx", "dw_gate", "dw_up", "dw_down"), gaps)),
               "rtol": GRAD_RTOL[name], "forward": fwd, "backward": bwd}
        out["swiglu"][name] = row
        emit("lm_grad", **row)
        del x, ws, xs, ref_out, comp_out
    torch.cuda.empty_cache()
    return out


def _batch(torch, cfg, seed, batch=TRAIN_B, seq=TRAIN_S):
    from repro_torch.data.tokens import token_batch_for

    return {k: torch.as_tensor(v, device="cuda")
            for k, v in token_batch_for(cfg, batch=batch, seq=seq, seed=seed).items()}


def _train_gaps(kern, plain) -> dict:
    """Relative gaps of (loss, grad norm, leaf norms) readings."""
    def rel(a, b):
        return abs(a - b) / abs(b)
    return {"loss": rel(kern[0], plain[0]), "grad_norm": rel(kern[1], plain[1]),
            **{k: rel(kern[2][k], plain[2][k]) for k in plain[2]}}


def _train_within(gaps) -> bool:
    return all(v <= TRAIN_RTOL.get(k, TRAIN_RTOL["leaf"]) for k, v in gaps.items())


def phase_lm_train_qwen(torch):
    """One Qwen3-8B train step at full width (bf16, Adafactor, 2 x 256
    tokens): its loss, gradient norm and the attention / MLP weights'
    gradient norms through the kernels and through the plain versions, and
    the same with each kernel's output zeroed, which the check must refuse;
    then 3 steps under remat "block", 3 under "full" and both again, with
    launches, time and memory, and the device-idle share of one profiled
    step."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref, swiglu_ref
    from repro_torch.launch.steps import build_train_step, make_optimizer
    from repro_torch.models import Model
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

    cfg = get_config("qwen3-8b")
    L = cfg.n_layers
    tcfg = TrainConfig(optimizer="adafactor", total_steps=12, warmup_steps=1)
    model = Model(cfg)
    check(cfg.remat == "block", f"lm_train: qwen3-8b remat {cfg.remat}")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(params))

    def loss_and_norms():
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = model.loss(ps, _batch(torch, cfg, 0))
        grads = torch.autograd.grad(loss, tree_leaves(ps))
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        seg = tree_unflatten(ps, grads)["seg0"]
        leaves = {f"{a}.{b}": float(torch.linalg.vector_norm(seg[a][b].float()))
                  for a, b in TRAIN_LEAVES}
        return float(loss.detach()), float(gnorm), leaves

    def swapped(flash, swiglu):
        saved = ops.flash_attention_grad, ops.swiglu_grad
        ops.flash_attention_grad, ops.swiglu_grad = flash, swiglu
        try:
            return loss_and_norms()
        finally:
            ops.flash_attention_grad, ops.swiglu_grad = saved

    kern, _, launches = counted(torch, loss_and_norms)
    check(launches["flash_attention"] == 2 * L and launches["swiglu"] == L
          and launches["flash_attention_backward"] == launches["swiglu_backward"] == L,
          f"lm_train: one loss+grad launched {launches}")
    plain = swapped(lambda q, k, v, **kw: flash_attention_ref(q, k, v, **kw), swiglu_ref)
    gaps = _train_gaps(kern, plain)
    check(_train_within(gaps), f"lm_train: kernels vs plain gaps {gaps} over {TRAIN_RTOL}")
    # a faulted kernel (its output zeroed) must fail the same check
    flash, swiglu = ops.flash_attention_grad, ops.swiglu_grad
    faulted = {
        "flash_attention": _train_gaps(swapped(
            lambda q, k, v, **kw: flash(q, k, v, **kw) * 0, swiglu), plain),
        "swiglu": _train_gaps(swapped(flash, lambda *a: swiglu(*a) * 0), plain)}
    for name, g in faulted.items():
        check(not _train_within(g), f"lm_train: {name} zeroed passes the check: {g}")

    opt = make_optimizer(tcfg)
    state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}
    # remat "block" (the config's) keeps the swiglu output: each kernel launches
    # 36 times forward, flash 36 more in the recompute; "full" recomputes both.
    # Two turns of 3 steps each, in turns (block, full, block, full)
    runs, seed = {}, 1
    for remat in REMAT_TURNS:
        step = build_train_step(cfg.replace(remat=remat), tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        walls, losses, gnorms = [], [], []
        for i in range(3):
            b = _batch(torch, cfg, seed)
            seed += 1
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
            walls.append(time.perf_counter() - t)
        launches = read_launches()
        check(all(math.isfinite(x) for x in losses + gnorms), f"lm_train {remat}: losses {losses}")
        want = {"flash_attention": 3 * 2 * L, "swiglu": 3 * (L if remat == "block" else 2 * L),
                "flash_attention_backward": 3 * L, "swiglu_backward": 3 * L}
        check(all(launches[k] == v for k, v in want.items()),
              f"lm_train {remat}: 3 steps launched {launches}, want {want}")
        run = runs.setdefault(remat, {"losses": [], "grad_norms": [], "step_walls_s": [],
                                      "peak_memory_bytes": 0})
        run["losses"] += losses
        run["grad_norms"] += gnorms
        run["step_walls_s"] += walls
        run["peak_memory_bytes"] = max(run["peak_memory_bytes"], torch.cuda.max_memory_allocated())
        run["launches_per_step"] = {k: launches[k] // 3 for k in ("flash_attention", "swiglu")}
        run["backward_calls_per_step"] = {k: launches[f"{k}_backward"] // 3
                                          for k in ("flash_attention", "swiglu")}
    for run in runs.values():
        run["s_per_step"] = statistics.median(run["step_walls_s"])
        run["tokens_per_s"] = TRAIN_B * TRAIN_S / run["s_per_step"]
    check(int(state["step"]) == 3 * len(REMAT_TURNS), "lm_train: step counter")
    check(max(r["peak_memory_bytes"] for r in runs.values()) < 80e9,
          f"lm_train: peak {[r['peak_memory_bytes'] for r in runs.values()]}")
    # one profiled step at each setting: device busy against the step's wall
    b = _batch(torch, cfg, seed)
    for remat in ("full", "block"):
        step = build_train_step(cfg.replace(remat=remat), tcfg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        busy, top, by_name = device_profile(torch, lambda: step(state, b),
                                            names=("flash_kernel", "swiglu_kernel", "nvjet",
                                                   "gemm", "elementwise", "reduce"))
        runs[remat].update(profiled_wall_s=time.perf_counter() - t, device_busy_us=busy)
    block = runs["block"]
    row = {"arch": cfg.name, "params": n_params, "optimizer": "adafactor", "dtype": cfg.dtype,
           "batch": TRAIN_B, "seq": TRAIN_S, "init_s": init_s,
           "kernels_loss": kern[0], "plain_loss": plain[0], "kernels_grad_norm": kern[1],
           "plain_grad_norm": plain[1], "plain_leaf_grad_norms": plain[2], "rel_err": gaps,
           "rtol": TRAIN_RTOL, "faulted_rel_err": faulted,
           **block, "remat": runs,
           "forward_launches_per_step": L, "recomputed_launches_per_step": {
               "flash_attention": L, "swiglu": 0},
           "device_busy_us": busy, "device_idle_share": 1.0 - busy / (block["s_per_step"] * 1e6),
           **by_name, "top": top}
    emit("lm_train_qwen", **row)
    del state, params, b
    torch.cuda.empty_cache()
    return row


def phase_lm_train_starcoder(torch, tmp):
    """``train("starcoder2-3b", reduced=False, n_layers=15)`` under AdamW: a
    10-step run checkpointing at step 8, then a restart in the same
    directory that resumes from step 8; its two losses against the
    uninterrupted run's steps 9 and 10. The card's machine takes at most
    45 GiB of disk writes a run, so the run checkpoints once
    (``ckpt_every=8``); the depth is cut to 15 of 30 layers to make room in
    the script's time for the recurrent phases (8 layers do not bring the
    loss down within the 10 steps; the whole model's checkpoint,
    bf16 params and f32 moments, is 31.8 GB and took 133 s to write and read
    back)."""
    import shutil

    from repro_torch.launch import train as tr

    walls, io = [], {"save_s": [], "restore_s": []}
    manager = tr.CheckpointManager

    class TimedManager(manager):
        def save(self, *a, **kw):
            t = time.perf_counter()
            out = super().save(*a, **kw)
            io["save_s"].append(time.perf_counter() - t)
            return out

        def restore_latest(self, *a, **kw):
            t = time.perf_counter()
            out = super().restore_latest(*a, **kw)
            if out is not None:
                io["restore_s"].append(time.perf_counter() - t)
            return out

    free_before = shutil.disk_usage(tmp).free
    kw = dict(reduced=False, n_layers=STARCODER_TRAIN_LAYERS, steps=10, batch=TRAIN_B, seq=TRAIN_S,
              ckpt_dir=tmp, ckpt_every=8, log_every=100)
    tr.CheckpointManager = TimedManager
    try:
        with _timed_train_steps(torch, tr, walls):
            torch.cuda.reset_peak_memory_stats()
            full, _, launches = counted(torch, lambda: tr.train("starcoder2-3b", **kw))
            peak = torch.cuda.max_memory_allocated()
            full_walls = list(walls)
            ckpt_bytes = sum(f.stat().st_size for f in Path(tmp).rglob("*") if f.is_file())
            torch.cuda.empty_cache()
            resumed, _, resumed_launches = counted(torch, lambda: tr.train("starcoder2-3b", **kw))
    finally:
        tr.CheckpointManager = manager
    L = STARCODER_TRAIN_LAYERS
    losses, tail = full["losses"], resumed["losses"]
    check(len(losses) == 10 and len(tail) == 2 and len(io["save_s"]) == 1
          and len(io["restore_s"]) == 1,
          f"lm_train starcoder2: {len(losses)}, {len(tail)} steps, checkpoint io {io}")
    check(all(math.isfinite(x) for x in losses + tail), f"lm_train starcoder2: losses {losses}")
    check(losses[-1] < losses[0], f"lm_train starcoder2: loss did not fall {losses}")
    gap = max(abs(a - b) for a, b in zip(tail, losses[8:]))
    check(gap <= RESUME_TOL, f"lm_train starcoder2: resumed {tail} vs {losses[8:]}")
    check(launches["flash_attention"] == 10 * 2 * L and launches["swiglu"] == 0
          and resumed_launches["flash_attention"] == 2 * 2 * L,
          f"lm_train starcoder2: launches {launches}, resumed {resumed_launches}")
    s_per_step = statistics.median(full_walls[1:])
    row = {"arch": "starcoder2-3b", "n_layers": L, "published_layers": 30, "optimizer": "adamw",
           "batch": TRAIN_B, "seq": TRAIN_S,
           "losses": losses, "resumed_losses": tail, "resume_gap": gap, "resume_tol": RESUME_TOL,
           "resume_bitwise": tail == losses[8:], "step_walls_s": full_walls,
           "s_per_step": s_per_step, "tokens_per_s": TRAIN_B * TRAIN_S / s_per_step,
           "peak_memory_bytes": peak, "save_s": io["save_s"], "restore_s": io["restore_s"],
           "disk_free_before_bytes": free_before, "checkpoint_bytes": ckpt_bytes,
           "flash_attention_launches_per_step": launches["flash_attention"] // 10,
           "swiglu_launches": launches["swiglu"]}
    emit("lm_train_starcoder2", **row)
    torch.cuda.empty_cache()
    return row


def phase_lm_fl(torch):
    """FederatedServer on lm_task(reduced Qwen3) on the card, batched and
    sequential engines, 4 clients, 2 rounds: the batched engine aggregates
    with fedavg_reduce once per completed round (the sequential engine
    averages a list of trees in plain torch, as the reference's does), the
    two Histories equal by the CPU test's rules. Each engine runs twice, in
    turns; the walls are the second turn's (the first pays the model's
    first calls on the card)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _card_reference as card

    from repro_torch import chaos, core, data, transport
    from repro_torch.configs import get_reduced

    task = core.lm_task(get_reduced("qwen3-8b"), device="cuda")

    def server(batched):
        shards = data.make_federated_mnist(4, 16, seed=0)
        return core.FederatedServer(
            task, [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)],
            core.fedavg(min_fit=0.5), tcp=transport.DEFAULT,
            chaos=chaos.ChaosSchedule(transport.LAB),
            config=core.ServerConfig(rounds=2, local_steps=2, seed=0, batched=batched),
            eval_data=data.synthetic_mnist(16, seed=1))

    runs = {}
    for batched in (True, False, True, False):
        srv = server(batched)
        hist, wall, counts = counted(torch, srv.run)
        check(hist.completed_rounds == 2
              and counts["fedavg_reduce"] == (hist.completed_rounds if batched else 0),
              f"lm_fl batched={batched}: {counts['fedavg_reduce']} fedavg_reduce launches for "
              f"{hist.completed_rounds} rounds")
        check(counts["flash_attention"] > 0 and counts["swiglu"] > 0, f"lm_fl: launches {counts}")
        record = card.history_record(hist, srv.clients)
        if batched in runs:
            try:
                card.assert_records_match(runs[batched][0], record)
            except AssertionError as e:
                raise PhaseFailed(f"lm_fl batched={batched}: second run differs: {e}") from e
        runs[batched] = (record, wall, counts)
    try:
        card.assert_records_match(runs[False][0], runs[True][0])
    except AssertionError as e:
        raise PhaseFailed(f"lm_fl: batched != sequential: {e}") from e
    row = {"arch": "qwen3-smoke", "clients": 4, "rounds": 2,
           "gaps": card.history_gaps(runs[False][0], runs[True][0]),
           "batched_wall_s": runs[True][1], "sequential_wall_s": runs[False][1],
           "launches": {("batched" if b else "sequential"): {k: r[2][k] for k in (
               "fedavg_reduce", "flash_attention", "swiglu")} for b, r in runs.items()},
           "final_eval": runs[True][0]["eval_metrics"][-1]}
    emit("lm_fl", **row)
    return row


def phase_dense_serving(torch):
    """Phi-3-medium-14B and Minitron-8B served at full width on the card,
    one model at a time: one batch of serve.py:main's prompts, launches per
    prefill and decode step, logits finite over the padded vocab; swiglu at
    their widths and flash_attention at their heads against the plain
    versions."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import swiglu as sw
    from repro_torch.kernels.ref import flash_attention_ref, swiglu_ref
    from repro_torch.launch import Server
    from repro_torch.launch.serve import example_requests

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(13)
    for arch in ("phi3-medium-14b", "minitron-8b"):
        t0 = time.perf_counter()
        server = Server(arch, reduced=False, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg, L = server.cfg, server.cfg.n_layers
        calls = []

        def traced(kind, fn):
            def call(*args):
                before = read_launches()
                logits, cache = fn(*args)
                after = read_launches()
                check(logits.dtype == torch.float32
                      and logits.shape == (server.batch, cfg.padded_vocab),
                      f"{arch} {kind}: logits {logits.dtype} {tuple(logits.shape)}")
                check(bool(torch.isfinite(logits).all()), f"{arch} {kind}: non-finite logits")
                calls.append((kind, after["flash_attention"] - before["flash_attention"],
                              after["swiglu"] - before["swiglu"]))
                return logits, cache
            return call

        server._prefill = traced("prefill", server._prefill)
        server._decode = traced("decode", server._decode)
        reqs = example_requests(cfg.vocab_size)[:server.batch]
        torch.cuda.reset_peak_memory_stats()
        done, wall, launches = counted(torch, lambda: server.run(reqs))
        check(all(len(r.generated) == 12 and all(0 <= t < cfg.padded_vocab for t in r.generated)
                  for r in done), f"{arch}: generated {[r.generated for r in done]}")
        check(all(c[1:] == ((L, L) if c[0] == "prefill" else (0, L)) for c in calls),
              f"{arch}: per-call launches {calls}")
        S = max(8, max(len(r.prompt) for r in reqs))
        d, F_, D = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
        errs = {}
        for M in (server.batch * S, server.batch):  # the prefill's rows, a decode step's
            x = torch.randn(M, d, generator=gen, device="cuda").bfloat16()
            ws = [(torch.randn(s, generator=gen, device="cuda") * s[0] ** -0.5).bfloat16()
                  for s in ((d, F_), (d, F_), (F_, d))]
            got, want = sw.swiglu_fused(x, *ws).float(), swiglu_ref(x, *ws).float()
            errs[f"swiglu_M{M}"] = float((got - want).abs().max() / want.abs().max())
            check(errs[f"swiglu_M{M}"] <= 2e-2, f"{arch}: swiglu M={M} rel err {errs}")
        q = torch.randn(server.batch * cfg.n_heads, S, D, generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn(server.batch * cfg.n_kv_heads, S, D, generator=gen,
                            device="cuda").bfloat16() for _ in "kv")
        got, want = fa.flash_attention_bhsd(q, k, v).float(), flash_attention_ref(q, k, v).float()
        errs["flash_attention"] = float((got - want).abs().max())
        check(errs["flash_attention"] < 5e-2, f"{arch}: flash_attention err {errs}")
        n_tok = sum(len(r.generated) for r in done)
        out[arch] = {"params": cfg.param_count(), "init_s": init_s, "wall_s": wall,
                     "tokens": n_tok, "tokens_per_s": n_tok / wall,
                     "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                     "launches": {k: launches[k] for k in ("flash_attention", "swiglu")},
                     "per_call": calls[:2], "swiglu_shape": [d, F_], "heads": [cfg.n_heads,
                     cfg.n_kv_heads, D], "padded_vocab": cfg.padded_vocab, "kernel_rel_err": errs,
                     "first_tokens": [r.generated[:4] for r in done]}
        emit("dense_serving", arch=arch, **out[arch])
        del server, q, k, v, x, ws, got, want
        gc.collect()  # the traced steps hold the server in a cycle
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Mixtral 8x7B (phases 28-30)
# --------------------------------------------------------------------------

# the published config is 93.4 GB in bf16 and the card has 80 GB: full
# width, depth cut to 16 of 32 layers for serving (46.97 GB of params) and to
# 4 for training (6.07 B params: params, gradients and Adafactor ~46 GB)
MIXTRAL_SERVE_LAYERS, MIXTRAL_TRAIN_LAYERS = 16, 4
MIXTRAL_WINDOW = 4096
# a prompt past the ring (5,000 % 4,096 != 0), 16 teacher-forced decode steps
MIXTRAL_PROMPT, MIXTRAL_DECODE, MIXTRAL_MAX_LEN = 5000, 16, 5200
MIXTRAL_LONG_S = MIXTRAL_PROMPT + MIXTRAL_DECODE
MIXTRAL_DROP_FREE = 4.0  # capacity factor: C = 4 * 2 * T / 8 = T, no token dropped
MOE_TRAIN_RTOL = {"loss": 1e-3, "grad_norm": 2e-3}
MOE_TRAIN_LEAVES = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                    ("mlp", "router"), ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))


class RouteRecorder:
    """Wraps ``models.mlp._router`` while active: per router call the token
    count T, the capacity C and the tokens the gather dispatch drops (per
    expert, those routed past C), kept on the device until read."""

    def __init__(self, torch, cfg):
        from repro_torch.models import mlp

        self.torch, self.cfg, self.mlp, self.calls = torch, cfg, mlp, []
        self.router = mlp._router

    def __enter__(self):
        torch, E = self.torch, self.cfg.moe.num_experts

        def recording(cfg, p, x):
            gates, ids, aux = self.router(cfg, p, x)
            C = self.mlp.capacity(cfg, x.shape[0])
            routed = torch.bincount(ids.reshape(-1), minlength=E)
            self.calls.append((x.shape[0], C, torch.clamp(routed - C, min=0).sum()))
            return gates, ids, aux

        self.mlp._router = recording
        return self

    def __exit__(self, *exc):
        self.mlp._router = self.router

    def take(self):
        """[(T, C, dropped), ...] since the last take."""
        out = [(T, C, int(n)) for T, C, n in self.calls]
        self.calls = []
        return out


def _traced_serving(torch, server, phase, per_prefill, per_decode):
    """serve.py:main's 8 requests on ``server``, once with a MoE's router
    recorded (tokens dropped per call) and once timed with the launches
    counted; each prefill must launch (flash_attention, swiglu)
    ``per_prefill`` times and each decode step ``per_decode``."""
    import contextlib

    from repro_torch.launch.serve import example_requests

    cfg = server.cfg
    moe = cfg.moe is not None and cfg.moe.num_experts > 0
    prefill, decode = server._prefill, server._decode
    calls = []

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
                  f"{phase} {kind}: logits {logits.dtype} {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits).all()), f"{phase} {kind}: non-finite logits")
            calls.append((kind, ms, after["flash_attention"] - before["flash_attention"],
                          after["swiglu"] - before["swiglu"]))
            return logits, cache
        return call

    drops = {"prefill": [], "decode": []}
    with RouteRecorder(torch, cfg) if moe else contextlib.nullcontext() as rec:
        if moe:
            server._prefill = traced("prefill", _recorded(prefill, rec, drops["prefill"]))
            server._decode = traced("decode", _recorded(decode, rec, drops["decode"]))
        else:  # the first run: a warm-up
            server._prefill, server._decode = traced("prefill", prefill), traced("decode", decode)
        server.run(example_requests(cfg.vocab_size))
    server._prefill, server._decode = traced("prefill", prefill), traced("decode", decode)
    calls.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        done, wall, launches = counted(torch, lambda: server.run(example_requests(cfg.vocab_size)))
    finally:
        server._prefill, server._decode = prefill, decode
    peak = torch.cuda.max_memory_allocated()
    n_tok = sum(len(r.generated) for r in done)
    check(len(done) == 8 and all(len(r.generated) == 12 for r in done),
          f"{phase}: generated {[len(r.generated) for r in done]}")
    check(all(0 <= t < cfg.padded_vocab for r in done for t in r.generated), f"{phase}: tokens")
    if moe:
        moe_layers = cfg.n_layers - cfg.moe.first_k_dense
        check(all(len(d) == moe_layers for d in drops["prefill"] + drops["decode"]),
              f"{phase}: router calls per step {[len(d) for d in drops['decode']]}")
    pre = [c for c in calls if c[0] == "prefill"]
    dec = [c for c in calls if c[0] == "decode"]
    check(all(c[2:] == per_prefill for c in pre), f"{phase}: per-prefill launches {pre}")
    check(all(c[2:] == per_decode for c in dec), f"{phase}: per-decode launches {dec}")
    check(all(launches[k] == per_prefill[i] * len(pre) + per_decode[i] * len(dec)
              for i, k in enumerate(("flash_attention", "swiglu"))),
          f"{phase}: launches {launches}")
    decode_ms = [c[1] for c in dec]
    row = {"requests": len(done), "tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "prefills": len(pre), "decode_steps": len(dec), "prefill_ms": [c[1] for c in pre],
           "decode_ms_per_step": statistics.mean(decode_ms),
           "decode_ms_median": statistics.median(decode_ms), "peak_memory_bytes": peak,
           "launches": {k: launches[k] for k in ("flash_attention", "swiglu")},
           "launches_per_prefill": list(per_prefill), "launches_per_decode_step": list(per_decode),
           "prompt_lengths": [len(r.prompt) for r in done],
           "first_tokens": [r.generated[:4] for r in done]}
    if moe:
        row.update(prefill_capacity=[d[0][1] for d in drops["prefill"]],
                   decode_capacity=drops["decode"][0][0][1],
                   dropped_per_prefill=[sum(x[2] for x in d) for d in drops["prefill"]],
                   dropped_per_decode_step=[sum(x[2] for x in d) for d in drops["decode"]])
    return row


def phase_moe_serving(torch):
    """``Server("mixtral-8x7b", reduced=False, n_layers=16)`` on the card:
    serve.py:main's 8 requests (batch 4, 12 greedy tokens); per prefill
    flash_attention once per layer, per decode step never; prefill ms,
    decode ms per step, tokens/s, peak memory and the tokens the published
    capacity (1.25) drops in each call (a 4-row decode step has C = 1)."""
    from repro_torch.launch import Server

    t0 = time.perf_counter()
    server = Server("mixtral-8x7b", reduced=False, n_layers=MIXTRAL_SERVE_LAYERS, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, L = server.cfg, server.cfg.n_layers
    check(cfg.d_model == 4096 and cfg.moe.num_experts == 8 and cfg.moe.expert_d_ff == 14336
          and cfg.sliding_window == MIXTRAL_WINDOW and cfg.moe.capacity_factor == 1.25,
          f"moe_serving: config {cfg}")
    served = _traced_serving(torch, server, "moe_serving", (L, 0), (0, 0))
    row = {"arch": cfg.name, "n_layers": L, "published_layers": 32, "d_model": cfg.d_model,
           "params": cfg.param_count(), "active_params": cfg.param_count(active_only=True),
           "init_s": init_s, **served, "capacity_factor": cfg.moe.capacity_factor,
           "routed_per_decode_step": L * server.batch * cfg.moe.top_k}
    emit("moe_serving", **row)
    return server, row


def _recorded(fn, rec, sink):
    """``fn`` whose router calls (T, C, dropped) are appended to ``sink``."""
    def call(*args):
        out = fn(*args)
        sink.append(rec.take())
        return out
    return call


def phase_moe_long_prompt(torch, server):
    """The served Mixtral params at a drop-free capacity (4.0), B = 1: a
    5,000-token prompt into a 5,200-token cache (a ring of 4,096 slots,
    which the prompt wraps), then 16 teacher-forced decode steps; every
    step's logits (and the prefill's) against the same positions of one
    forward over all 5,016 tokens, within 3e-2 of max |logit| (bf16)."""
    import dataclasses

    from repro_torch.models import Model
    from repro_torch.models import lm as lm_mod

    cfg = server.cfg.replace(moe=dataclasses.replace(server.cfg.moe,
                                                     capacity_factor=MIXTRAL_DROP_FREE))
    model, params, L = Model(cfg), server.params, cfg.n_layers
    gen = torch.Generator(device="cuda").manual_seed(17)
    toks = torch.randint(0, cfg.vocab_size, (1, MIXTRAL_LONG_S), generator=gen, device="cuda",
                         dtype=torch.int32)
    steps, launches = [], []
    with torch.no_grad(), RouteRecorder(torch, cfg) as rec:
        logits, cache = model.prefill(params, {"tokens": toks[:, :MIXTRAL_PROMPT]}, MIXTRAL_MAX_LEN)
        # timed once more, the launches counted around it
        (logits, cache), prefill_s, pre_launch = counted(torch, lambda: model.prefill(
            params, {"tokens": toks[:, :MIXTRAL_PROMPT]}, MIXTRAL_MAX_LEN))
        prefill_routes = rec.take()
        seg = cache["seg0"]
        check(seg["k"].shape[2] == MIXTRAL_WINDOW and "kv_pos" in seg,
              f"moe_long_prompt: cache {[(k, tuple(v.shape)) for k, v in seg.items()]}")
        kv_pos = seg["kv_pos"][0, 0]
        want_pos = torch.arange(MIXTRAL_PROMPT - MIXTRAL_WINDOW, MIXTRAL_PROMPT, device="cuda")
        check(torch.equal(kv_pos[want_pos % MIXTRAL_WINDOW].long(), want_pos),
              "moe_long_prompt: the ring does not hold position p at slot p % 4096")
        steps.append(logits.float())
        decode_s = []
        for j in range(MIXTRAL_DECODE):
            cur = toks[:, MIXTRAL_PROMPT + j:MIXTRAL_PROMPT + j + 1]
            (logits, cache), s, n = counted(torch, lambda: model.decode_step(params, cache, cur))
            decode_s.append(s)
            launches.append(n["flash_attention"])
            steps.append(logits.float())
        decode_routes = rec.take()
        t = time.perf_counter()
        h, _, _ = lm_mod.lm_forward(cfg, params, {"tokens": toks})
        full = lm_mod.unembed(cfg, params, h[:, MIXTRAL_PROMPT - 1:])[0]
        torch.cuda.synchronize()
        full_s = time.perf_counter() - t
        full_routes = rec.take()
    errs, scales, agree = [], [], 0
    for i, got in enumerate(steps):
        want = full[i]
        check(bool(torch.isfinite(got).all()), f"moe_long_prompt: step {i} non-finite")
        errs.append(float((got[0] - want).abs().max()))
        scales.append(float(want.abs().max()))
        agree += int(got[0].argmax() == want.argmax())
    rel = [e / s for e, s in zip(errs, scales)]
    dropped = sum(x[2] for x in prefill_routes + decode_routes + full_routes)
    check(dropped == 0, f"moe_long_prompt: {dropped} tokens dropped at capacity {MIXTRAL_DROP_FREE}")
    check(pre_launch["flash_attention"] == L and all(n == 0 for n in launches),
          f"moe_long_prompt: flash launches prefill {pre_launch['flash_attention']}, decode {launches}")
    check(max(rel) <= SERVE_LOGIT_RTOL,
          f"moe_long_prompt: decode vs full forward {max(rel)} of max |logit| > {SERVE_LOGIT_RTOL}")
    row = {"arch": cfg.name, "n_layers": L, "prompt": MIXTRAL_PROMPT, "decode_steps": MIXTRAL_DECODE,
           "max_len": MIXTRAL_MAX_LEN, "ring_slots": MIXTRAL_WINDOW,
           "prompt_mod_ring": MIXTRAL_PROMPT % MIXTRAL_WINDOW, "capacity_factor": MIXTRAL_DROP_FREE,
           "prefill_s": prefill_s, "decode_ms_per_step": 1e3 * statistics.mean(decode_s),
           "full_forward_s": full_s, "flash_launches_prefill": pre_launch["flash_attention"],
           "flash_launches_per_decode_step": launches[0], "rel_err": rel, "max_rel_err": max(rel),
           "rtol": SERVE_LOGIT_RTOL, "max_abs_logit": max(scales), "greedy_agree": agree,
           "greedy_total": len(steps), "dropped": dropped}
    emit("moe_long_prompt", **row)
    return row


def phase_moe_train(torch):
    """Mixtral at full width, 4 of 32 layers, bf16, Adafactor, 2 x 256
    tokens: one loss and gradient through the kernels and through the plain
    versions (loss within 1e-3, gradient norm within 2e-3; flash's output
    zeroed must fail that check), then ``train("mixtral-8x7b", n_layers=4)``
    for 3 steps: losses finite, aux > 0, s/step, tokens/s, peak memory and
    launches per step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import Model
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

    cfg = get_config("mixtral-8x7b").replace(n_layers=MIXTRAL_TRAIN_LAYERS)
    L = cfg.n_layers
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))

    def loss_and_norms():
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = model.loss(ps, _batch(torch, cfg, 0))
        grads = torch.autograd.grad(loss, tree_leaves(ps))
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        seg = tree_unflatten(ps, grads)["seg0"]
        leaves = {f"{a}.{b}": float(torch.linalg.vector_norm(seg[a][b].float()))
                  for a, b in MOE_TRAIN_LEAVES}
        return float(loss.detach()), float(gnorm), leaves, float(metrics["aux"])

    def with_flash(flash):
        saved = ops.flash_attention_grad
        ops.flash_attention_grad = flash
        try:
            return loss_and_norms()
        finally:
            ops.flash_attention_grad = saved

    def within(gaps):
        return all(gaps[k] <= v for k, v in MOE_TRAIN_RTOL.items())

    kern, _, launches = counted(torch, loss_and_norms)
    check(launches["flash_attention"] == 2 * L and launches["swiglu"] == 0
          and launches["flash_attention_backward"] == L,
          f"moe_train: one loss+grad launched {launches}")
    plain = with_flash(lambda q, k, v, **kw: flash_attention_ref(q, k, v, **kw))
    gaps = _train_gaps(kern, plain)
    check(within(gaps), f"moe_train: kernels vs plain gaps {gaps} over {MOE_TRAIN_RTOL}")
    flash = ops.flash_attention_grad
    faulted = _train_gaps(with_flash(
        lambda q, k, v, **kw: flash(q, k, v, **kw) * 0), plain)
    check(not within(faulted), f"moe_train: flash zeroed passes the check: {faulted}")
    del params
    torch.cuda.empty_cache()

    out, walls, launches, peak = _timed_train(torch, "mixtral-8x7b", n_layers=L,
                                              optimizer="adafactor", steps=3, batch=TRAIN_B,
                                              seq=TRAIN_S)
    losses, auxes = out["losses"], out["aux"]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses),
          f"moe_train: losses {losses}")
    check(all(a > 0 for a in auxes), f"moe_train: aux {auxes}")
    check(launches["flash_attention"] == 3 * 2 * L and launches["swiglu"] == 0
          and launches["flash_attention_backward"] == 3 * L, f"moe_train: 3 steps launched {launches}")
    check(peak < 80e9, f"moe_train: peak {peak}")
    s_per_step = statistics.median(walls[1:])
    row = {"arch": cfg.name, "n_layers": L, "published_layers": 32, "params": n_params,
           "optimizer": "adafactor", "dtype": cfg.dtype, "remat": cfg.remat, "batch": TRAIN_B,
           "seq": TRAIN_S, "kernels_loss": kern[0], "plain_loss": plain[0],
           "kernels_grad_norm": kern[1], "plain_grad_norm": plain[1], "kernels_aux": kern[3],
           "plain_leaf_grad_norms": plain[2], "rel_err": gaps, "rtol": MOE_TRAIN_RTOL,
           "faulted_rel_err": faulted, "losses": losses, "aux": auxes, "step_walls_s": walls,
           "s_per_step": s_per_step, "tokens_per_s": TRAIN_B * TRAIN_S / s_per_step,
           "peak_memory_bytes": peak,
           "launches_per_step": {k: launches[k] // 3 for k in ("flash_attention", "swiglu")},
           "backward_calls_per_step": launches["flash_attention_backward"] // 3}
    emit("moe_train", **row)
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# DeepSeek-V2 (MLA) and Phi-3-vision (the vision stub)
# --------------------------------------------------------------------------

# DeepSeek-V2 is 471.5 GB in bf16 whole: full width, depth cut to layer 0
# (dense) and 5 MoE layers for serving (21.25 B params, 42.49 GB) and to
# layer 0 and one MoE layer for training (5.36 B)
DEEPSEEK_SERVE_LAYERS, DEEPSEEK_TRAIN_LAYERS = 6, 2
# capacity >= E / k = 160 / 6 makes C >= T: no token dropped
DEEPSEEK_DROP_FREE = 27.0
DEEPSEEK_PROMPT, DEEPSEEK_DECODE = 512, 8
VLM_DECODE = 12
# Phi-3-vision's decode against its full forward in f32: the same sums in
# another order through 32 layers (1e-5 of max |logit| read on the card)
VLM_F32_RTOL = 1e-4
VLM_BF16_DEPTHS = (2, 8, 16)  # the bf16 gap read again on the first layers only
VLM_BF16_NOTE = ("bf16 decode-vs-forward gaps of a random-weight model grow with depth "
                 "(bf16_gap_by_depth), with patches or without and with the kernel or the plain "
                 "version alike, so they are read, not checked; f32 holds C6")
MLA_TRAIN_LEAVES = tuple(("attn", n) for n in ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "wo"))


def _decode_vs_forward(torch, model, params, batch, n_decode, max_len, tokens=None, after=None):
    """Prefill ``batch``, then ``n_decode`` decode steps, teacher-forced on
    ``tokens`` [B, n_decode] or greedy; every step's logits (and the
    prefill's) against the same positions of one forward over the prompt,
    the decoded tokens and ``after`` (tokens past the last step: causal
    attention and scans leave the earlier positions as they are, and a
    Mamba2 forward needs a multiple of its chunk), relative to max |logit|.
    Returns the row and the (flash_attention, swiglu) launches of the
    prefill and of each decode step."""
    from repro_torch.models import encdec as encdec_mod
    from repro_torch.models import hybrid as hybrid_mod
    from repro_torch.models import lm as lm_mod

    cfg = model.cfg
    steps, fed, launches = [], [], []

    def kernels(n):
        return n["flash_attention"], n["swiglu"]

    (logits, cache), prefill_s, pre = counted(torch, lambda: model.prefill(params, batch, max_len))
    steps.append(logits.float())
    decode_s = []
    for j in range(n_decode):
        cur = tokens[:, j:j + 1] if tokens is not None else \
            logits.argmax(-1)[:, None].to(torch.int32)
        fed.append(cur)
        (logits, cache), s, n = counted(torch, lambda: model.decode_step(params, cache, cur))
        decode_s.append(s)
        launches.append(kernels(n))
        steps.append(logits.float())
    extra = [] if after is None else [after]
    whole = dict(batch, tokens=torch.cat([batch["tokens"], *fed, *extra], dim=1))
    forward = {"hybrid": hybrid_mod.hybrid_forward, "lm": lm_mod.lm_forward,
               "encdec": encdec_mod.encdec_loss_forward}[model.family]
    # the logits as the decode path rounds them: an encoder-decoder's in the
    # activation dtype (tied embeddings), the others' summed in f32
    logits_of = (encdec_mod._logits if model.family == "encdec"
                 else lambda ps, h: lm_mod.unembed(cfg, ps, h))
    t = time.perf_counter()
    h, _, _ = forward(cfg, params, whole)
    end = h.shape[1] - sum(a.shape[1] for a in extra)
    full = logits_of(params, h[:, end - n_decode - 1:end])
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t
    errs, scales, agree = [], [], 0
    for i, got in enumerate(steps):
        want = full[:, i]
        check(bool(torch.isfinite(got).all()), f"decode step {i}: non-finite logits")
        errs.append(float((got - want).abs().max()))
        scales.append(float(want.abs().max()))
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
    rel = [e / sc for e, sc in zip(errs, scales)]
    row = {"prefill_s": prefill_s, "decode_ms_per_step": 1e3 * statistics.mean(decode_s),
           "full_forward_s": full_s, "full_forward_tokens": whole["tokens"].shape[1],
           "rel_err": rel, "max_rel_err": max(rel),
           "rtol": SERVE_LOGIT_RTOL, "max_abs_logit": max(scales), "greedy_agree": agree,
           "greedy_total": len(steps) * full.shape[0]}
    return row, kernels(pre), launches


def _swiglu_gaps(torch, gen, d, F_, rows) -> dict:
    """The bf16 swiglu kernel against its plain version at widths (d, F) for
    each row count, relative to max |plain|."""
    from repro_torch.kernels import swiglu as sw
    from repro_torch.kernels.ref import swiglu_ref

    errs = {}
    for M in rows:
        x = torch.randn(M, d, generator=gen, device="cuda").bfloat16()
        ws = [(torch.randn(s, generator=gen, device="cuda") * s[0] ** -0.5).bfloat16()
              for s in ((d, F_), (d, F_), (F_, d))]
        got, want = sw.swiglu_fused(x, *ws).float(), swiglu_ref(x, *ws).float()
        errs[f"swiglu_M{M}"] = float((got - want).abs().max() / want.abs().max())
        check(errs[f"swiglu_M{M}"] <= 2e-2, f"swiglu ({M}, {d}, {F_}): rel err {errs}")
    return errs


def phase_mla_serving(torch):
    """``Server("deepseek-v2-236b", reduced=False, n_layers=6)``: full width
    (d 5120, 128 heads, MLA ranks 1,536 / 512, 160 experts of d_ff 1,536,
    top-6, 2 shared, capacity 1.25), layer 0 dense and 5 MoE layers.
    serve.py:main's 8 requests: flash_attention (D 192 / Dv 128) 6 a
    prefill and 0 a decode step (the absorbed decode is plain torch), swiglu
    1 each (layer 0); prefill ms, decode ms a step, tokens/s, peak, drops.
    Then the same params at a drop-free capacity (27), B = 1: a 512-token
    prompt and 8 teacher-forced decode steps against one forward over all
    520 tokens, within 3e-2 of max |logit|: the absorbed decode against the
    naive prefill at full width."""
    import dataclasses

    from repro_torch.launch import Server
    from repro_torch.models import Model
    from repro_torch.utils import tree_leaves

    t0 = time.perf_counter()
    server = Server("deepseek-v2-236b", reduced=False, n_layers=DEEPSEEK_SERVE_LAYERS,
                    device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg, L = server.cfg, server.cfg.n_layers
    m = cfg.moe
    check(cfg.d_model == 5120 and cfg.n_heads == MLA_HEADS and cfg.attn_kind == "mla"
          and m.num_experts == 160 and m.top_k == 6 and m.num_shared == 2
          and m.expert_d_ff == 1536 and m.first_k_dense == 1, f"mla_serving: config {cfg}")
    served = _traced_serving(torch, server, "mla_serving", (L, 1), (0, 1))

    drop_free = cfg.replace(moe=dataclasses.replace(m, capacity_factor=DEEPSEEK_DROP_FREE))
    gen = torch.Generator(device="cuda").manual_seed(19)
    toks = torch.randint(0, cfg.vocab_size, (1, DEEPSEEK_PROMPT + DEEPSEEK_DECODE), generator=gen,
                         device="cuda", dtype=torch.int32)
    with torch.no_grad(), RouteRecorder(torch, drop_free) as rec:
        long, pre, dec = _decode_vs_forward(
            torch, Model(drop_free), server.params, {"tokens": toks[:, :DEEPSEEK_PROMPT]},
            DEEPSEEK_DECODE, DEEPSEEK_PROMPT + DEEPSEEK_DECODE + 8, toks[:, DEEPSEEK_PROMPT:])
        dropped = sum(x[2] for x in rec.take())
    check(dropped == 0, f"mla_serving: {dropped} tokens dropped at capacity {DEEPSEEK_DROP_FREE}")
    check(pre == (L, 1) and all(n == (0, 1) for n in dec),
          f"mla_serving: launches prefill {pre}, decode {dec}")
    check(long["max_rel_err"] <= SERVE_LOGIT_RTOL,
          f"mla_serving: decode vs full forward {long['max_rel_err']} of max |logit|")
    # layer 0's swiglu at a 16-token batch's prefill rows and a decode step's
    errs = _swiglu_gaps(torch, gen, cfg.d_model, m.dense_d_ff, (4 * 16, 4))
    row = {"arch": cfg.name, "n_layers": L, "published_layers": 60, "d_model": cfg.d_model,
           "params": sum(t.numel() for t in tree_leaves(server.params)), "init_s": init_s,
           **served, "capacity_factor": m.capacity_factor,
           "long_prompt": dict(long, prompt=DEEPSEEK_PROMPT, decode_steps=DEEPSEEK_DECODE,
                               capacity_factor=DEEPSEEK_DROP_FREE, dropped=dropped,
                               launches_prefill=list(pre)),
           "swiglu_rel_err": errs}
    emit("mla_serving", **row)
    del server
    gc.collect()  # the traced steps hold the server in a cycle
    torch.cuda.empty_cache()
    return row


def phase_mla_train(torch):
    """DeepSeek-V2 at full width, layer 0 (dense) and one MoE layer (5.36 B
    params), bf16, Adafactor, 2 x 256 tokens: one loss and gradient through
    the kernels and through the plain versions (loss, gradient norm and the
    six MLA weights' gradient norms within ``TRAIN_RTOL``; each kernel's
    output zeroed must fail that check), then ``train()`` for 3 steps:
    losses finite, aux > 0, s/step, tokens/s, peak memory, launches a
    step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref, swiglu_ref
    from repro_torch.models import Model
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

    cfg = get_config("deepseek-v2-236b").replace(n_layers=DEEPSEEK_TRAIN_LAYERS)
    L = cfg.n_layers
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))

    def loss_and_norms():
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = model.loss(ps, _batch(torch, cfg, 0))
        grads = torch.autograd.grad(loss, tree_leaves(ps))
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        tree = tree_unflatten(ps, grads)
        leaves = {f"{a}.{b}": float(torch.sqrt(sum(torch.sum(torch.square(tree[seg][a][b].float()))
                                                   for seg in ("seg0", "seg1"))))
                  for a, b in MLA_TRAIN_LEAVES}
        return float(loss.detach()), float(gnorm), leaves, float(metrics["aux"])

    def swapped(flash, swiglu):
        saved = ops.flash_attention_grad, ops.swiglu_grad
        ops.flash_attention_grad, ops.swiglu_grad = flash, swiglu
        try:
            return loss_and_norms()
        finally:
            ops.flash_attention_grad, ops.swiglu_grad = saved

    kern, _, launches = counted(torch, loss_and_norms)
    check(launches["flash_attention"] == 2 * L and launches["swiglu"] == 1
          and launches["flash_attention_backward"] == L and launches["swiglu_backward"] == 1,
          f"mla_train: one loss+grad launched {launches}")
    plain = swapped(lambda q, k, v, **kw: flash_attention_ref(q, k, v, **kw), swiglu_ref)
    gaps = _train_gaps(kern, plain)
    check(_train_within(gaps), f"mla_train: kernels vs plain gaps {gaps} over {TRAIN_RTOL}")
    flash, swiglu = ops.flash_attention_grad, ops.swiglu_grad
    faulted = {
        "flash_attention": _train_gaps(swapped(
            lambda q, k, v, **kw: flash(q, k, v, **kw) * 0, swiglu), plain),
        "swiglu": _train_gaps(swapped(flash, lambda *a: swiglu(*a) * 0), plain)}
    for name, g in faulted.items():
        check(not _train_within(g), f"mla_train: {name} zeroed passes the check: {g}")
    del params
    torch.cuda.empty_cache()

    out, walls, launches, peak = _timed_train(torch, "deepseek-v2-236b", n_layers=L,
                                              optimizer="adafactor", steps=3, batch=TRAIN_B,
                                              seq=TRAIN_S)
    losses, auxes = out["losses"], out["aux"]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses), f"mla_train: losses {losses}")
    check(all(a > 0 for a in auxes), f"mla_train: aux {auxes}")
    # remat "block": flash forward and recomputed per layer, swiglu (layer 0) kept
    check(launches["flash_attention"] == 3 * 2 * L and launches["swiglu"] == 3
          and launches["flash_attention_backward"] == 3 * L and launches["swiglu_backward"] == 3,
          f"mla_train: 3 steps launched {launches}")
    check(peak < 80e9, f"mla_train: peak {peak}")
    s_per_step = statistics.median(walls[1:])
    row = {"arch": cfg.name, "n_layers": L, "published_layers": 60, "params": n_params,
           "optimizer": "adafactor", "dtype": cfg.dtype, "remat": cfg.remat, "batch": TRAIN_B,
           "seq": TRAIN_S, "kernels_loss": kern[0], "plain_loss": plain[0],
           "kernels_grad_norm": kern[1], "plain_grad_norm": plain[1], "kernels_aux": kern[3],
           "plain_leaf_grad_norms": plain[2], "rel_err": gaps, "rtol": TRAIN_RTOL,
           "faulted_rel_err": faulted, "losses": losses, "aux": auxes, "step_walls_s": walls,
           "s_per_step": s_per_step, "tokens_per_s": TRAIN_B * TRAIN_S / s_per_step,
           "peak_memory_bytes": peak,
           "launches_per_step": {k: launches[k] // 3 for k in ("flash_attention", "swiglu")},
           "backward_calls_per_step": launches["flash_attention_backward"] // 3}
    emit("mla_train", **row)
    torch.cuda.empty_cache()
    return row


def phase_vlm_serving(torch):
    """Phi-3-vision whole (32 layers, 3.83 B params) on the card, B = 4: 256
    random patch embeddings before serve.py:main's first 4 prompts
    (left-padded as ``Server`` pads them), prefilled with the flash kernel
    at D = 96, then 12 greedy decode steps, in bf16 (timed; flash_attention
    32 a prefill and 0 a decode step, swiglu 32 each) and again with the
    same params in f32. Every step's logits (and the prefill's) against one
    forward over the patches, the prompt and the decoded tokens: in f32
    within ``VLM_F32_RTOL`` of max |logit|, which holds the cache position
    after a prefill with patches (C6) on the card; in bf16 the gap is
    reported, not checked, beside the same gap over the first 2, 8 and 16
    layers: bf16 rounding alone grows it with depth (``VLM_BF16_NOTE``)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import example_requests
    from repro_torch.models import Model
    from repro_torch.utils import tree_leaves, tree_map

    cfg = get_config("phi-3-vision-4.2b")
    L, B = cfg.n_layers, 4
    check(cfg.frontend == "vision_stub" and cfg.resolved_head_dim == VLM_D
          and cfg.n_heads == VLM_HEADS, f"vlm_serving: config {cfg}")
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = example_requests(cfg.vocab_size)[:B]
    S = max(8, max(len(r.prompt) for r in reqs))
    toks = np.zeros((B, S), np.int32)
    for i, r in enumerate(reqs):
        toks[i, S - len(r.prompt):] = r.prompt
    gen = torch.Generator(device="cuda").manual_seed(23)
    patches = torch.randn(B, VLM_PATCHES, cfg.d_model, generator=gen, device="cuda")
    max_len = VLM_PATCHES + S + VLM_DECODE + 4
    runs = {}
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        c = cfg.replace(dtype=name, param_dtype=name)
        model = Model(c)
        ps = params if dt == torch.bfloat16 else tree_map(lambda t: t.float(), params)
        batch = {"tokens": torch.from_numpy(toks).cuda(), "patch_embed": patches.to(dt)}
        with torch.no_grad():  # warm-up: a prefill and a decode step
            model.decode_step(ps, model.prefill(ps, batch, max_len)[1], batch["tokens"][:, -1:])
            torch.cuda.reset_peak_memory_stats()
            row, pre, dec = _decode_vs_forward(torch, model, ps, batch, VLM_DECODE, max_len)
            row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        check(pre == (L, L) and all(n == (0, L) for n in dec),
              f"vlm_serving {name}: launches prefill {pre}, decode {dec}")
        decode_s = row["decode_ms_per_step"] * VLM_DECODE / 1e3
        row.update(tokens=B * VLM_DECODE,
                   tokens_per_s=B * VLM_DECODE / (row["prefill_s"] + decode_s),
                   launches_per_prefill=list(pre), launches_per_decode_step=list(dec[0]))
        runs[name] = row
        del ps
    f32 = runs["float32"]
    f32["rtol"] = VLM_F32_RTOL
    check(f32["max_rel_err"] <= VLM_F32_RTOL,
          f"vlm_serving: f32 decode vs full forward {f32['max_rel_err']} of max |logit|")
    runs["bfloat16"]["rtol"] = None
    by_depth = {}
    batch = {"tokens": torch.from_numpy(toks).cuda(), "patch_embed": patches.bfloat16()}
    with torch.no_grad():
        for depth in VLM_BF16_DEPTHS:
            cut = {k: tree_map(lambda t: t[:depth], v) if k.startswith("seg") else v
                   for k, v in params.items()}
            by_depth[depth] = _decode_vs_forward(torch, Model(cfg.replace(n_layers=depth)), cut,
                                                 batch, VLM_DECODE, max_len)[0]["max_rel_err"]
    by_depth[L] = runs["bfloat16"]["max_rel_err"]
    errs = _swiglu_gaps(torch, gen, cfg.d_model, cfg.d_ff, (B * (VLM_PATCHES + S), B))
    row = {"arch": cfg.name, "n_layers": L, "d_model": cfg.d_model,
           "params": sum(t.numel() for t in tree_leaves(params)), "init_s": init_s, "batch": B,
           "patches": VLM_PATCHES, "prompt": S, "decode_steps": VLM_DECODE,
           **runs["bfloat16"], "runs": runs, "bf16_gap_by_depth": by_depth,
           "bf16_note": VLM_BF16_NOTE,
           "swiglu_rel_err": errs, "prompt_lengths": [len(r.prompt) for r in reqs]}
    emit("vlm_serving", **row)
    del params
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# RWKV6 and the Mamba2 / shared-attention hybrid (Zamba2)
# --------------------------------------------------------------------------

# B = 1: a 512-token prompt (a multiple of both chunks, 128: the chunked
# RWKV6 and Mamba2 forms) and 8 teacher-forced decode steps, against one
# forward over 640 tokens (5 chunks; causal, so positions 511-519 are those
# of a 520-token forward, which no Mamba2 chunk of 128 divides)
LONG_PROMPT, LONG_DECODE, LONG_FORWARD = 512, 8, 640
# The same params in f32: the decode steps against the forward within 2e-4
# of max |logit|. The chunked forms sum the log decay over a chunk in f32:
# at RWKV6's strongest decays (-e^4 a step) that sum reaches ~-7,000, so
# its exps carry ~1e-4 relative error where the steps carry none (read on
# the card: 7.6e-5 for RWKV6's 24 layers, 1.2e-5 for Zamba2's 81)
RECURRENT_F32_RTOL = 2e-4
RWKV_BF16_DEPTHS, HYBRID_BF16_DEPTHS = (2, 8), (6, 24)  # the bf16 gap read again there
RECURRENT_BF16_NOTE = (
    "bf16 decode-vs-forward gaps of these random-weight models grow with depth "
    "(bf16_gap_by_depth): one bf16 rounding that lands the other way in a short and a long "
    "product is amplified layer by layer (Zamba2's prefill logits alone differ by 4e-2 of max "
    "|logit| between a 512- and a 640-token forward), so they are read, not checked; f32 holds "
    "the decode path to RECURRENT_F32_RTOL")
HYBRID_TRAIN_LEAVES = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                       ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))


@contextlib.contextmanager
def _timed_train_steps(torch, tr, walls):
    """Within the block, each train step that ``tr.train`` runs
    (``run_built`` of a "train:" built step) timed between
    synchronizations into ``walls``."""
    run = tr.run_built

    def timed(built, mesh, *args):
        if not built.name.startswith("train:"):
            return run(built, mesh, *args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run(built, mesh, *args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        return out

    tr.run_built = timed
    try:
        yield walls
    finally:
        tr.run_built = run


def _timed_train(torch, arch, **kw):
    """``train(arch, reduced=False, **kw)`` with each step's wall time
    taken between synchronizations and the launches counted: (result,
    step walls s, launches, peak memory bytes)."""
    from repro_torch.launch import train as tr

    walls = []
    with _timed_train_steps(torch, tr, walls):
        torch.cuda.reset_peak_memory_stats()
        out, _, launches = counted(torch, lambda: tr.train(arch, reduced=False, log_every=100,
                                                           **kw))
        peak = torch.cuda.max_memory_allocated()
    return out, walls, launches, peak


def _long_prompt(torch, model, params, phase, seed, launches, cut):
    """B = 1: the ``LONG_PROMPT``-token prompt and ``LONG_DECODE``
    teacher-forced decode steps, each step's logits against one forward over
    ``LONG_FORWARD`` tokens, relative to max |logit|: in bf16 (timed; the
    gap read, not checked, beside the same gap at the depths of ``cut``, a
    {depth: (config, params)} of the first layers), then with the same
    params in f32 within ``RECURRENT_F32_RTOL``. ``launches(cfg)`` gives the
    (flash_attention, swiglu) launches a prefill and a decode step must make."""
    from repro_torch.models import Model
    from repro_torch.utils import tree_map

    gen = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, model.cfg.vocab_size, (1, LONG_FORWARD), generator=gen, device="cuda",
                         dtype=torch.int32)
    end = LONG_PROMPT + LONG_DECODE

    def run(m, ps):
        with torch.no_grad():
            row, pre, dec = _decode_vs_forward(
                torch, m, ps, {"tokens": toks[:, :LONG_PROMPT]}, LONG_DECODE, end + 8,
                toks[:, LONG_PROMPT:end], after=toks[:, end:])
        per_prefill, per_decode = launches(m.cfg)
        check(pre == per_prefill and all(n == per_decode for n in dec),
              f"{phase} ({m.cfg.n_layers} layers): launches prefill {pre}, decode {dec}")
        return dict(row, launches_prefill=list(pre), launches_per_decode_step=list(dec[0]))

    row = dict(run(model, params), rtol=None, prompt=LONG_PROMPT, decode_steps=LONG_DECODE)
    by_depth = {depth: run(Model(c), ps)["max_rel_err"] for depth, (c, ps) in cut.items()}
    by_depth[model.cfg.n_layers] = row["max_rel_err"]
    f32 = model.cfg.replace(dtype="float32", param_dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    row32 = dict(run(Model(f32), p32), rtol=RECURRENT_F32_RTOL)
    del p32
    torch.cuda.empty_cache()
    check(row32["max_rel_err"] <= RECURRENT_F32_RTOL,
          f"{phase}: f32 decode vs full forward {row32['max_rel_err']} of max |logit|")
    return dict(row, float32=row32, bf16_gap_by_depth=by_depth, bf16_note=RECURRENT_BF16_NOTE)


def phase_rwkv_serving(torch):
    """``Server("rwkv6-1.6b", reduced=False)`` whole (24 layers, d 2,048, 32
    heads of 64, chunk 128; 1.58 B params) on serve.py:main's 8 requests:
    the prompts pad to 8-15 tokens, so every prefill runs the step-by-step
    time mix; no flash_attention or swiglu launch (the channel mix is
    relu^2). Then the 512-token prompt (the chunked form) and 8 decode
    steps against one forward."""
    from repro_torch.launch import Server
    from repro_torch.utils import tree_leaves, tree_map

    t0 = time.perf_counter()
    server = Server("rwkv6-1.6b", reduced=False, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = server.cfg
    check(cfg.d_model == 2048 and cfg.n_layers == 24 and cfg.ssm.kind == "rwkv6"
          and cfg.ssm.head_dim == 64 and cfg.ssm.chunk_len == 128, f"rwkv_serving: config {cfg}")
    served = _traced_serving(torch, server, "rwkv_serving", (0, 0), (0, 0))
    cut = {d: (cfg.replace(n_layers=d), {k: tree_map(lambda t: t[:d], v) if k == "seg0" else v
                                         for k, v in server.params.items()})
           for d in RWKV_BF16_DEPTHS}
    long = _long_prompt(torch, server.model, server.params, "rwkv_serving", 29,
                        lambda c: ((0, 0), (0, 0)), cut)
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": sum(t.numel() for t in tree_leaves(server.params)), "init_s": init_s,
           **served, "long_prompt": long}
    emit("rwkv_serving", **row)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_rwkv_train(torch):
    """RWKV6 whole at full width, bf16, 2 x 256 tokens (the chunked time
    mix): one loss and gradient, every gradient finite; then
    ``train("rwkv6-1.6b", reduced=False)`` for 3 AdamW steps: losses
    finite, s/step, tokens/s, peak memory, no kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.utils import tree_leaves, tree_map

    cfg = get_config("rwkv6-1.6b")
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = model.loss(ps, _batch(torch, cfg, 0))
    grads = torch.autograd.grad(loss, tree_leaves(ps))
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    gnorm = float(torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads)))
    check(math.isfinite(float(loss.detach())) and finite and math.isfinite(gnorm),
          f"rwkv_train: loss {float(loss.detach())}, grads finite {finite}, norm {gnorm}")
    del params, ps, grads
    torch.cuda.empty_cache()

    out, walls, launches, peak = _timed_train(torch, "rwkv6-1.6b", optimizer="adamw", steps=3,
                                              batch=TRAIN_B, seq=TRAIN_S)
    losses = out["losses"]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses), f"rwkv_train: losses {losses}")
    check(launches["flash_attention"] == launches["swiglu"] == 0,
          f"rwkv_train: kernels launched {launches}")
    s_per_step = statistics.median(walls[1:])
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params, "optimizer": "adamw",
           "dtype": cfg.dtype, "remat": cfg.remat, "batch": TRAIN_B, "seq": TRAIN_S,
           "loss": float(loss.detach()), "grad_norm": gnorm, "grads_finite": finite,
           "losses": losses, "step_walls_s": walls, "s_per_step": s_per_step,
           "tokens_per_s": TRAIN_B * TRAIN_S / s_per_step, "peak_memory_bytes": peak}
    emit("rwkv_train", **row)
    torch.cuda.empty_cache()
    return row


def phase_hybrid_serving(torch):
    """``Server("zamba2-7b", reduced=False)`` whole (81 Mamba2 layers, d
    3,584, and the shared block applied 13 times with a 3-layer tail; 32
    heads of 112, window 4,096; 6.75 B params) on serve.py:main's 8
    requests: flash_attention (D = Dv = 112) 13 a prefill and 0 a decode
    step, swiglu 13 each; then the 512-token prompt and 8 decode steps
    against one forward."""
    from repro_torch.launch import Server
    from repro_torch.utils import tree_leaves, tree_map

    t0 = time.perf_counter()
    server = Server("zamba2-7b", reduced=False, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = server.cfg
    n_super, tail = divmod(cfg.n_layers, cfg.hybrid.attn_every)
    check(cfg.d_model == 3584 and cfg.n_layers == 81 and (n_super, tail) == (13, 3)
          and cfg.resolved_head_dim == ZAMBA_D and cfg.n_heads == ZAMBA_HEADS
          and cfg.sliding_window == 4096 and cfg.ssm.chunk_len == 128,
          f"hybrid_serving: config {cfg}")
    served = _traced_serving(torch, server, "hybrid_serving", (n_super, n_super), (0, n_super))
    # the first d Mamba2 layers (d a multiple of 6: d / 6 applications, no tail)
    cut = {d: (cfg.replace(n_layers=d), {
        **{k: v for k, v in server.params.items() if k != "tail"},
        "mamba": tree_map(lambda t: t[:d], server.params["mamba"])})
        for d in HYBRID_BF16_DEPTHS}
    def launches(c):
        n = c.n_layers // c.hybrid.attn_every
        return (n, n), (0, n)

    long = _long_prompt(torch, server.model, server.params, "hybrid_serving", 31, launches, cut)
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "shared_block_applications": n_super,
           "tail_layers": tail, "d_model": cfg.d_model,
           "params": sum(t.numel() for t in tree_leaves(server.params)), "init_s": init_s,
           **served, "long_prompt": long}
    emit("hybrid_serving", **row)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_hybrid_train(torch):
    """Zamba2 whole at full width, bf16, Adafactor, 2 x 256 tokens (2
    Mamba2 chunks of 128): one loss and gradient through the kernels and
    through the plain versions (loss, gradient norm and the shared block's
    seven weights' gradient norms within ``TRAIN_RTOL``; each kernel's
    output zeroed must fail that check; every gradient finite, C7), then
    ``train("zamba2-7b", reduced=False)`` for 3 steps: s/step, tokens/s,
    peak, launches a step (remat "block" by super-block: flash 2 x 13 and
    swiglu 13)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref, swiglu_ref
    from repro_torch.models import Model
    from repro_torch.optim import global_norm
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

    cfg = get_config("zamba2-7b")
    n_super = cfg.n_layers // cfg.hybrid.attn_every
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    finite = []

    def loss_and_norms():
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = model.loss(ps, _batch(torch, cfg, 0))
        grads = torch.autograd.grad(loss, tree_leaves(ps))
        finite.append(all(bool(torch.isfinite(g).all()) for g in grads))
        tree = tree_unflatten(ps, grads)
        gnorm = global_norm(tree)  # slab by slab: the Mamba2 in_proj leaf is 4.1 G elements
        shared = tree["shared_attn"]
        leaves = {f"{a}.{b}": float(torch.linalg.vector_norm(shared[a][b].float()))
                  for a, b in HYBRID_TRAIN_LEAVES}
        return float(loss.detach()), float(gnorm), leaves

    def swapped(flash, swiglu):
        saved = ops.flash_attention_grad, ops.swiglu_grad
        ops.flash_attention_grad, ops.swiglu_grad = flash, swiglu
        try:
            return loss_and_norms()
        finally:
            ops.flash_attention_grad, ops.swiglu_grad = saved

    torch.cuda.reset_peak_memory_stats()
    kern, grad_s, launches = counted(torch, loss_and_norms)
    grad_peak = torch.cuda.max_memory_allocated()
    check(finite == [True], "hybrid_train: a gradient is not finite")
    check(launches["flash_attention"] == 2 * n_super and launches["swiglu"] == n_super
          and launches["flash_attention_backward"] == launches["swiglu_backward"] == n_super,
          f"hybrid_train: one loss+grad launched {launches}")
    plain = swapped(lambda q, k, v, **kw: flash_attention_ref(q, k, v, **kw), swiglu_ref)
    gaps = _train_gaps(kern, plain)
    check(_train_within(gaps), f"hybrid_train: kernels vs plain gaps {gaps} over {TRAIN_RTOL}")
    flash, swiglu = ops.flash_attention_grad, ops.swiglu_grad
    faulted = {
        "flash_attention": _train_gaps(swapped(
            lambda q, k, v, **kw: flash(q, k, v, **kw) * 0, swiglu), plain),
        "swiglu": _train_gaps(swapped(flash, lambda *a: swiglu(*a) * 0), plain)}
    for name, g in faulted.items():
        check(not _train_within(g), f"hybrid_train: {name} zeroed passes the check: {g}")
    del params
    torch.cuda.empty_cache()

    out, walls, launches, peak = _timed_train(torch, "zamba2-7b", optimizer="adafactor", steps=3,
                                              batch=TRAIN_B, seq=TRAIN_S)
    losses = out["losses"]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses),
          f"hybrid_train: losses {losses}")
    check(launches["flash_attention"] == 3 * 2 * n_super and launches["swiglu"] == 3 * n_super
          and launches["flash_attention_backward"] == launches["swiglu_backward"] == 3 * n_super,
          f"hybrid_train: 3 steps launched {launches}")
    check(peak < 80e9, f"hybrid_train: peak {peak}")
    s_per_step = statistics.median(walls[1:])
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
           "optimizer": "adafactor", "dtype": cfg.dtype, "remat": cfg.remat, "batch": TRAIN_B,
           "seq": TRAIN_S, "kernels_loss": kern[0], "plain_loss": plain[0],
           "kernels_grad_norm": kern[1], "plain_grad_norm": plain[1],
           "plain_leaf_grad_norms": plain[2], "rel_err": gaps, "rtol": TRAIN_RTOL,
           "faulted_rel_err": faulted, "grads_finite": all(finite), "loss_grad_s": grad_s,
           "loss_grad_peak_memory_bytes": grad_peak, "losses": losses, "step_walls_s": walls,
           "s_per_step": s_per_step, "tokens_per_s": TRAIN_B * TRAIN_S / s_per_step,
           "peak_memory_bytes": peak,
           "launches_per_step": {k: launches[k] // 3 for k in ("flash_attention", "swiglu")},
           "backward_calls_per_step": launches["flash_attention_backward"] // 3}
    emit("hybrid_train", **row)
    torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------
# Whisper's encoder-decoder
# --------------------------------------------------------------------------

# B = 4 random frames [4, 1536, 512], a 64-token prompt and 8 teacher-forced
# decode steps against one 72-token forward; f32 held within 1e-4 of max
# |logit| (the port's decode equals its prefill within 2e-7 on the CPU)
ENCDEC_PROMPT, ENCDEC_DECODE, ENCDEC_F32_RTOL = 64, 8, 1e-4
# one loss and gradient through the kernel against the plain version: the
# encoder's and the decoder's attention weights and MLP; the encoder's reach
# the loss only through the cross attention's k and v
ENCDEC_TRAIN_LEAVES = (("encoder", "attn", "wq"), ("encoder", "attn", "wo"),
                       ("encoder", "mlp", "w_up"), ("decoder", "self_attn", "wq"),
                       ("decoder", "cross_attn", "wq"), ("decoder", "cross_attn", "wk"),
                       ("decoder", "cross_attn", "wv"), ("decoder", "cross_attn", "wo"))


def phase_encdec_serving(torch):
    """``Server("whisper-base", reduced=False)`` whole (6 encoder and 6
    decoder layers, d 512, 8 heads of 64, 1,536 zero frames) on serve.py:main's
    8 requests: flash_attention 18 a prefill (6 encoder, 6 decoder self, 6
    cross) and 6 a decode step (cross). Then B = 4 random frames, a 64-token
    prompt and 8 decode steps against one 72-token forward: bf16 timed, its
    gap read; f32 within ``ENCDEC_F32_RTOL``. The per-call copy of one
    layer's cross k and v into the kernel's layout is timed beside it."""
    from repro_torch.launch import Server
    from repro_torch.models import Model
    from repro_torch.utils import tree_leaves, tree_map

    t0 = time.perf_counter()
    server = Server("whisper-base", reduced=False, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = server.cfg
    L = cfg.n_layers
    check(cfg.d_model == 512 and L == cfg.n_enc_layers == 6 and cfg.n_heads == WHISPER_HEADS
          and cfg.resolved_head_dim == WHISPER_D and cfg.enc_seq_len == WHISPER_SE,
          f"encdec_serving: config {cfg}")
    served = _traced_serving(torch, server, "encdec_serving", (3 * L, 0), (L, 0))
    B = server.batch
    gen = torch.Generator(device="cuda").manual_seed(37)
    frames = torch.randn(B, WHISPER_SE, cfg.d_model, generator=gen, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (B, ENCDEC_PROMPT + ENCDEC_DECODE), generator=gen,
                         device="cuda", dtype=torch.int32)
    runs = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).removeprefix("torch.")
        m = Model(cfg.replace(dtype=name, param_dtype=name))
        ps = server.params if dt == torch.bfloat16 else tree_map(lambda t: t.float(),
                                                                 server.params)
        batch = {"tokens": toks[:, :ENCDEC_PROMPT], "frames": frames.to(dt)}
        with torch.no_grad():
            torch.cuda.reset_peak_memory_stats()
            row, pre, dec = _decode_vs_forward(torch, m, ps, batch, ENCDEC_DECODE,
                                               ENCDEC_PROMPT + ENCDEC_DECODE + 8,
                                               toks[:, ENCDEC_PROMPT:])
            row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        check(pre == (3 * L, 0) and all(n == (L, 0) for n in dec),
              f"encdec_serving {name}: launches prefill {pre}, decode {dec}")
        row.update(launches_per_prefill=list(pre), launches_per_decode_step=list(dec[0]))
        runs[name] = row
        del ps
    runs["float32"]["rtol"], runs["bfloat16"]["rtol"] = ENCDEC_F32_RTOL, None
    check(runs["float32"]["max_rel_err"] <= ENCDEC_F32_RTOL,
          f"encdec_serving: f32 decode vs full forward {runs['float32']['max_rel_err']} "
          f"of max |logit|")
    # ops.flash_attention's copy of one layer's cross k and v ([B, Se, H, D],
    # the reference's cache layout) into [B*H, Se, D], on every call
    k = torch.randn(B, WHISPER_SE, WHISPER_HEADS, WHISPER_D, generator=gen,
                    device="cuda").bfloat16()

    v = torch.randn(k.shape, generator=gen, device="cuda").bfloat16()

    def copy():
        for t in (k, v):
            t.transpose(1, 2).reshape(B * WHISPER_HEADS, WHISPER_SE, WHISPER_D).contiguous()

    copy_bytes = 2 * 2 * k.numel() * k.element_size()  # k and v, each read and written
    row = {"arch": cfg.name, "n_layers": L, "n_enc_layers": cfg.n_enc_layers,
           "d_model": cfg.d_model, "enc_seq_len": cfg.enc_seq_len,
           "params": sum(t.numel() for t in tree_leaves(server.params)), "init_s": init_s,
           **served, "long_prompt": {"batch": B, "prompt": ENCDEC_PROMPT,
                                     "decode_steps": ENCDEC_DECODE, **runs["bfloat16"],
                                     "float32": runs["float32"]},
           "cross_kv_copy_us_per_layer": device_us(torch, copy, 100, 5),
           "cross_kv_copy_bytes_per_layer": copy_bytes,
           "cross_kv_copy_bound_us": copy_bytes / HBM_BYTES_PER_S * 1e6}
    emit("encdec_serving", **row)
    del server
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_encdec_train(torch):
    """Whisper whole at full width, bf16, AdamW, 2 x 256 tokens over 1,536
    random frames: one loss and gradient through the kernel and through the
    plain version (loss, gradient norm and the eight weights' gradient norms
    of ``ENCDEC_TRAIN_LEAVES`` within ``TRAIN_RTOL``; the kernel's output
    zeroed must fail that check), then ``train("whisper-base",
    reduced=False)`` for 3 steps: s/step, tokens/s, peak, launches a step
    (remat "block": flash 18 forward + 18 recomputed, 18 backward passes)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import Model
    from repro_torch.optim import global_norm
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

    cfg = get_config("whisper-base")
    per_pass = cfg.n_enc_layers + 2 * cfg.n_layers
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch = _batch(torch, cfg, 0)
    check(tuple(batch["frames"].shape) == (TRAIN_B, WHISPER_SE, cfg.d_model),
          f"encdec_train: frames {tuple(batch['frames'].shape)}")
    finite = []

    def loss_and_norms():
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = model.loss(ps, batch)
        grads = torch.autograd.grad(loss, tree_leaves(ps))
        finite.append(all(bool(torch.isfinite(g).all()) for g in grads))
        tree = tree_unflatten(ps, grads)
        leaves = {".".join(path): float(torch.linalg.vector_norm(
            tree[path[0]][path[1]][path[2]].float())) for path in ENCDEC_TRAIN_LEAVES}
        return float(loss.detach()), float(global_norm(tree)), leaves

    def swapped(flash):
        saved = ops.flash_attention_grad
        ops.flash_attention_grad = flash
        try:
            return loss_and_norms()
        finally:
            ops.flash_attention_grad = saved

    torch.cuda.reset_peak_memory_stats()
    kern, grad_s, launches = counted(torch, loss_and_norms)
    grad_peak = torch.cuda.max_memory_allocated()
    check(finite == [True], "encdec_train: a gradient is not finite")
    check(launches["flash_attention"] == 2 * per_pass and launches["swiglu"] == 0
          and launches["flash_attention_backward"] == per_pass,
          f"encdec_train: one loss+grad launched {launches}")
    plain = swapped(lambda q, k, v, **kw: flash_attention_ref(q, k, v, **kw))
    gaps = _train_gaps(kern, plain)
    check(_train_within(gaps), f"encdec_train: kernel vs plain gaps {gaps} over {TRAIN_RTOL}")
    flash = ops.flash_attention_grad
    faulted = _train_gaps(swapped(lambda q, k, v, **kw: flash(q, k, v, **kw) * 0), plain)
    check(not _train_within(faulted), f"encdec_train: flash zeroed passes the check: {faulted}")
    del params
    torch.cuda.empty_cache()

    out, walls, launches, peak = _timed_train(torch, "whisper-base", optimizer="adamw", steps=3,
                                              batch=TRAIN_B, seq=TRAIN_S)
    losses = out["losses"]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses),
          f"encdec_train: losses {losses}")
    check(launches["flash_attention"] == 3 * 2 * per_pass and launches["swiglu"] == 0
          and launches["flash_attention_backward"] == 3 * per_pass,
          f"encdec_train: 3 steps launched {launches}")
    s_per_step = statistics.median(walls[1:])
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "n_enc_layers": cfg.n_enc_layers,
           "params": n_params, "optimizer": "adamw", "dtype": cfg.dtype, "remat": cfg.remat,
           "batch": TRAIN_B, "seq": TRAIN_S, "frames": WHISPER_SE,
           "kernels_loss": kern[0], "plain_loss": plain[0], "kernels_grad_norm": kern[1],
           "plain_grad_norm": plain[1], "plain_leaf_grad_norms": plain[2], "rel_err": gaps,
           "rtol": TRAIN_RTOL, "faulted_rel_err": faulted, "grads_finite": all(finite),
           "loss_grad_s": grad_s, "loss_grad_peak_memory_bytes": grad_peak, "losses": losses,
           "step_walls_s": walls, "s_per_step": s_per_step,
           "tokens_per_s": TRAIN_B * TRAIN_S / s_per_step, "peak_memory_bytes": peak,
           "launches_per_step": launches["flash_attention"] // 3,
           "backward_calls_per_step": launches["flash_attention_backward"] // 3}
    emit("encdec_train", **row)
    torch.cuda.empty_cache()
    return row


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


SHARDED_QWEN_LAYERS = 8  # of 36: Qwen3-8B at full width, cut for the phase's cost
SHARDED_MIXTRAL_LAYERS = 2  # of 32
SHARDED_DECODE = 4
SHARDED_BUDGET_S = 40.0


def _sharded_loss_and_norms(torch, model, params, batch, leaves, mesh=None, p_specs=None):
    """(loss, global grad norm, {leaf: grad norm}) of one loss and gradient:
    on one device, or on ``mesh`` with the params and batch as DTensors
    (the sharded train step's own loss and gradient)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import mesh_context
    from repro_torch.sharding.rules import distribute_tree, full_tree, input_shardings
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

    if mesh is not None:
        params = distribute_tree(params, p_specs, mesh)
        batch = distribute_tree(batch, input_shardings(batch, mesh), mesh)
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    ctx = mesh_context(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx, (implicit_replication() if mesh is not None else contextlib.nullcontext()):
        loss, _ = model.loss(ps, batch)
        if mesh is not None:
            loss = loss.full_tensor()
        grads = tree_unflatten(ps, torch.autograd.grad(loss, tree_leaves(ps)))
    grads = full_tree(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    seg = grads["seg0"]
    return float(loss.detach()), float(gnorm), {
        f"{a}.{b}": float(torch.linalg.vector_norm(seg[a][b].float())) for a, b in leaves}


def phase_sharded_steps(torch):
    """Item 16's sharded steps on one card, over ``nccl``: a 1 x 1 ("data",
    "model") DeviceMesh and a 1 x 1 x 1 ("pod", "data", "model") one.

    - Qwen3-8B at full width, 8 of 36 layers, bf16, Adafactor, 2 x 256
      tokens, 2 microbatches: the sharded step's loss and gradient against
      the one-device ones (loss, grad norm, the seven weight-gradient norms
      within ``TRAIN_RTOL``), then two ``build_train_step`` steps against
      two one-device steps from the same params on the same batches, with
      the kernels' launches per step equal; then ``build_prefill_step`` and
      4 ``build_decode_step`` calls against ``Model.prefill`` /
      ``decode_step`` (bf16, within 3e-2 of max |logit|), launches counted.
    - Mixtral at full width, 2 layers, through ``ep_a2a`` (what
      ``pick_moe_path`` picks on 1 x 1) at drop-free capacity, against the
      one-device gather path: a loss and gradient (``TRAIN_RTOL``) and a
      prefill (3e-2 of max |logit|).
    - local-SGD on the pod mesh: 2 inner steps of Qwen3-8B at full width, 2
      layers, then ``build_outer_sync(compression="int8")``: the new anchor
      and outer momentum bit for bit those of plain torch on the same
      replicas (the int8 round trip per pod, half to even, then Nesterov).
    """
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import MeshShape, make_device_mesh
    from repro_torch.models import Model
    from repro_torch.models import moe_sharded
    from repro_torch.models.mlp import capacity
    from repro_torch.optim import nesterov_outer
    from repro_torch.sharding import param_shardings
    from repro_torch.sharding.rules import full_tree
    from repro_torch.utils import tree_leaves, tree_map

    t_phase = time.perf_counter()
    mesh = make_device_mesh(MeshShape(("data", "model"), (1, 1)), device="cuda")
    out = {"mesh": [1, 1], "backend": torch.distributed.get_backend()}
    clone = lambda t: tree_map(torch.clone, t)  # noqa: E731

    # ---- Qwen3-8B: train, prefill, decode
    cfg = get_config("qwen3-8b").replace(n_layers=SHARDED_QWEN_LAYERS)
    L = cfg.n_layers
    tcfg = TrainConfig(optimizer="adafactor", total_steps=12, warmup_steps=1, microbatches=2)
    model = Model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    shape = ShapeSpec("sharded", "train", TRAIN_S, TRAIN_B)
    built = S.build_train_step(cfg, tcfg, shape, mesh)
    p_specs = built.in_shardings[0]["params"]
    one = _sharded_loss_and_norms(torch, model, params, _batch(torch, cfg, 0), TRAIN_LEAVES)
    sh = _sharded_loss_and_norms(torch, Model(S._with_act_sharding(cfg, mesh)), params,
                                 _batch(torch, cfg, 0), TRAIN_LEAVES, mesh, p_specs)
    gaps = _train_gaps(sh, one)
    check(_train_within(gaps), f"sharded_steps: qwen loss/grad gaps {gaps} over {TRAIN_RTOL}")
    opt = S.make_optimizer(tcfg)
    single = S.build_train_step(cfg, tcfg)
    st_one = {"params": clone(params), "opt": opt.init(params),
              "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    st_sh = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device="cuda")}
    steps = []
    for i in range(2):
        b = _batch(torch, cfg, 10 + i)
        (st_one, m_one), w_one, l_one = counted(torch, lambda: single(st_one, b))
        (st_sh, m_sh), w_sh, l_sh = counted(torch, lambda: S.run_built(built, mesh, st_sh, b))
        m_sh = full_tree(m_sh)
        g = {k: abs(float(m_sh[k]) - float(m_one[k])) / abs(float(m_one[k]))
             for k in ("loss", "grad_norm")}
        check(all(v <= TRAIN_RTOL[k] for k, v in g.items()), f"sharded_steps: step {i} gaps {g}")
        kl = ("flash_attention", "swiglu", "flash_attention_backward", "swiglu_backward")
        check({k: l_sh[k] for k in kl} == {k: l_one[k] for k in kl} and l_sh["flash_attention"] > 0,
              f"sharded_steps: step {i} launches {l_sh} vs one device {l_one}")
        steps.append({"loss": float(m_sh["loss"]), "one_device_loss": float(m_one["loss"]),
                      "rel_err": g, "s": w_sh, "one_device_s": w_one,
                      "launches": {k: l_sh[k] for k in kl}})
    peak = torch.cuda.max_memory_allocated()
    out["qwen_train"] = {"layers": L, "loss_and_grad_rel_err": gaps, "steps": steps,
                         "s_per_step": steps[-1]["s"], "one_device_s_per_step": steps[-1]["one_device_s"],
                         "peak_memory_bytes": peak}
    del st_one, st_sh, single, built
    gc.collect()
    torch.cuda.empty_cache()

    prompt = _batch(torch, cfg, 20)["tokens"]
    B, Sp = prompt.shape
    max_len = Sp + SHARDED_DECODE
    pre = S.build_prefill_step(cfg, ShapeSpec("p", "prefill", max_len, B), mesh)
    dec = S.build_decode_step(cfg, ShapeSpec("d", "decode", max_len, B), mesh)
    with torch.no_grad():
        (want, w_cache), _, _ = counted(torch, lambda: model.prefill(params, {"tokens": prompt},
                                                                      max_len))
        (got, cache), pre_s, l_pre = counted(torch, lambda: S.run_built(pre, mesh, params,
                                                                       {"tokens": prompt}))
    check(l_pre["flash_attention"] == L and l_pre["swiglu"] == L,
          f"sharded_steps: a prefill launched {l_pre}")
    gaps = [float((got.full_tensor() - want).abs().max() / want.abs().max())]
    dec_s, l_dec = [], []
    for _ in range(SHARDED_DECODE):
        nxt = torch.argmax(want, -1)[:, None].to(torch.int32)
        with torch.no_grad():
            want, w_cache = model.decode_step(params, w_cache, nxt)
            (got, cache), t, l = counted(torch, lambda: S.run_built(dec, mesh, params, cache, nxt))
        dec_s.append(t)
        l_dec.append(l)
        gaps.append(float((got.full_tensor() - want).abs().max() / want.abs().max()))
    check(all(l["swiglu"] == L and l["flash_attention"] == 0 for l in l_dec),
          f"sharded_steps: decode launched {l_dec}")
    check(max(gaps) <= SERVE_LOGIT_RTOL, f"sharded_steps: serve gaps {gaps}")
    out["qwen_serve"] = {"prefill_ms": pre_s * 1e3, "decode_ms": [t * 1e3 for t in dec_s],
                         "logit_rel_err": gaps, "launches_per_prefill": {
                             k: l_pre[k] for k in ("flash_attention", "swiglu")},
                         "launches_per_decode_step": {
                             k: l_dec[-1][k] for k in ("flash_attention", "swiglu")}}
    del params, cache, w_cache, pre, dec
    gc.collect()
    torch.cuda.empty_cache()

    # ---- Mixtral through ep_a2a at drop-free capacity
    mcfg = get_config("mixtral-8x7b").replace(n_layers=SHARDED_MIXTRAL_LAYERS)
    mcfg = mcfg.replace(moe=dataclasses.replace(mcfg.moe, capacity_factor=MIXTRAL_DROP_FREE))
    acfg = S._with_act_sharding(mcfg, mesh)
    path = moe_sharded.pick_moe_path(acfg, TRAIN_B, TRAIN_S)
    check(path == "ep_a2a", f"sharded_steps: mixtral takes {path}")
    T = TRAIN_B * TRAIN_S  # on 1 x 1 every token is on the one rank
    check(capacity(mcfg, T) >= T, "sharded_steps: mixtral capacity drops tokens")
    mmodel = Model(mcfg)
    mparams = mmodel.init(torch.Generator(device="cuda").manual_seed(1))
    m_specs = param_shardings(mmodel.abstract_params(), mmodel.param_axes(), mesh)
    one = _sharded_loss_and_norms(torch, mmodel, mparams, _batch(torch, mcfg, 0), MOE_TRAIN_LEAVES)
    sh = _sharded_loss_and_norms(torch, Model(acfg), mparams, _batch(torch, mcfg, 0),
                                 MOE_TRAIN_LEAVES, mesh, m_specs)
    mgaps = _train_gaps(sh, one)
    check(_train_within(mgaps), f"sharded_steps: mixtral gaps {mgaps} over {TRAIN_RTOL}")
    prompt = _batch(torch, mcfg, 21)["tokens"]
    pre = S.build_prefill_step(mcfg, ShapeSpec("p", "prefill", prompt.shape[1], prompt.shape[0]),
                               mesh)
    with torch.no_grad():
        want, _ = mmodel.prefill(mparams, {"tokens": prompt}, prompt.shape[1])
        (got, _), m_pre_s, m_l = counted(torch, lambda: S.run_built(pre, mesh, mparams,
                                                                   {"tokens": prompt}))
    mgap = float((got.full_tensor() - want).abs().max() / want.abs().max())
    check(mgap <= SERVE_LOGIT_RTOL, f"sharded_steps: mixtral prefill gap {mgap}")
    out["mixtral"] = {"layers": mcfg.n_layers, "path": path, "dropped": 0,
                      "capacity_factor": MIXTRAL_DROP_FREE, "loss_and_grad_rel_err": mgaps,
                      "prefill_logit_rel_err": mgap, "prefill_ms": m_pre_s * 1e3,
                      "prefill_flash_launches": m_l["flash_attention"]}
    print(json.dumps({"phase": "sharded_steps_moe_path", "path": path}), flush=True)
    del mparams, pre
    gc.collect()
    torch.cuda.empty_cache()

    # ---- local-SGD over the pod mesh and the int8 outer sync
    pod_mesh = make_device_mesh(MeshShape(("pod", "data", "model"), (1, 1, 1)), device="cuda")
    lcfg = get_config("qwen3-8b").replace(n_layers=2)
    ltcfg = TrainConfig(optimizer="adafactor", total_steps=12, warmup_steps=1)
    lmodel = Model(lcfg)
    lparams = lmodel.init(torch.Generator(device="cuda").manual_seed(2))
    local = S.build_train_step(lcfg, ltcfg, shape, pod_mesh, mode="local_sgd")
    lopt = S.make_optimizer(ltcfg)
    state = tree_map(lambda t: t[None].clone(), {
        "params": lparams, "opt": lopt.init(lparams),
        "step": torch.zeros((), dtype=torch.int32, device="cuda")})
    for i in range(2):
        b = {k: v[None] for k, v in _batch(torch, lcfg, 30 + i).items()}
        state, _ = S.run_built(local, pod_mesh, state, b)
    replicas = full_tree(state["params"])
    outer = nesterov_outer(ltcfg.outer_lr, ltcfg.outer_momentum)
    sync = S.build_outer_sync(lcfg, ltcfg, pod_mesh, compression="int8")

    def plain_delta(ps, a):
        d = ps.float() - a.float()[None]
        scale = torch.clamp(torch.amax(torch.abs(d), dim=tuple(range(1, d.ndim)), keepdim=True),
                            min=1e-12) / 127.0
        d = torch.clamp(torch.round(d / scale), -127, 127).to(torch.int8).float() * scale
        return torch.mean(d, dim=0)

    delta = tree_map(plain_delta, replicas, lparams)
    mu, lr = ltcfg.outer_momentum, ltcfg.outer_lr
    want_m = tree_map(lambda d: mu * torch.zeros_like(d) + d.float(), delta)
    want_anchor = tree_map(lambda a, mm, d: (a.float() + lr * (mu * mm + d.float())).to(a.dtype),
                           lparams, want_m, delta)
    t = time.perf_counter()
    _, anchor, ost = S.run_built(sync, pod_mesh, clone(replicas), clone(lparams),
                                 outer.init(lparams), torch.full((), 2, dtype=torch.int32,
                                                                 device="cuda"))
    torch.cuda.synchronize()
    sync_s = time.perf_counter() - t
    anchor, m = full_tree(anchor), full_tree(ost["m"])
    bitwise = all(torch.equal(a, b) for a, b in zip(tree_leaves(anchor), tree_leaves(want_anchor))) \
        and all(torch.equal(a, b) for a, b in zip(tree_leaves(m), tree_leaves(want_m)))
    check(bitwise, "sharded_steps: the int8 outer sync differs from plain torch")
    out["local_sgd"] = {"layers": 2, "inner_steps": 2, "outer_sync_ms": sync_s * 1e3,
                        "outer_sync_bitwise": bitwise}
    del lparams, state, replicas, anchor, m, want_anchor, want_m, delta
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["budget_s"] = SHARDED_BUDGET_S
    out["within_budget"] = out["seconds"] <= SHARDED_BUDGET_S
    emit("sharded_steps", **out)
    return out


# --------------------------------------------------------------------------
# the port's last slice: the flash kernel's heads of 16 and 24 / 16, the
# dry-run and the example drivers
# --------------------------------------------------------------------------

# the reduced configs whose attention heads are narrower than 32: heads of
# 16, and reduced DeepSeek-V2's MLA prefill at q / k 24 (16 + 8 rope), v 16
SMALL_HEAD_ARCHS = ("phi3-medium-14b", "starcoder2-3b", "phi-3-vision-4.2b", "whisper-base",
                    "deepseek-v2-236b")
# (B, Sq, Skv, Hq, Hkv, D, Dv): the reduced models' prefill heads at a
# 64-token prompt, batch 4 (Phi-3-medium's 5 heads of 16, DeepSeek-V2's 4
# MLA heads), timed; then past one query tile with GQA (StarCoder2's 6 / 2)
# and a window, and packed (G * Sq <= 64)
SMALL_HEAD_TIMED = (((4, 64, 64, 5, 5, 16, 16), "small_d16"),
                    ((4, 64, 64, 4, 4, 24, 16), "small_d24"))
SMALL_HEAD_CHECKED = (((1, 300, 300, 6, 2, 16, 16), 0), ((1, 300, 300, 4, 4, 24, 16), 0),
                      ((2, 200, 200, 6, 2, 16, 16), 64), ((2, 200, 200, 4, 4, 24, 16), 64),
                      ((2, 9, 9, 6, 2, 16, 16), 0), ((2, 13, 13, 4, 1, 24, 16), 0))
SMALL_HEAD_SEQ, SMALL_HEAD_DECODE = 16, 2
# f32: the card (the kernel) against the CPU (the plain version), relative
# to the CPU's max |value|, as the f32 parity tests (1e-4); bf16: the
# kernel against the plain version on the card (every other op the same),
# logits as the serving checks (3e-2 of max |logit|), loss and gradient norm
# TRAIN_RTOL's; the bf16 card-against-CPU gaps are read, not checked (cuBLAS
# and the CPU round every other bf16 product their own way)
SMALL_HEAD_RTOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _small_head_run(torch, model, params, batch, device, flash=None):
    """(prefill + decode logits stacked, loss, gradient global norm, flash
    launches, flash backward passes) of one reduced model on ``device``;
    ``flash`` in place of the flash op when given."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.utils import tree_leaves, tree_map

    params = tree_map(lambda t: t.to(device), params)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    counts = (fa.launches, fa.backward_calls)
    toks = batch["tokens"]
    S = toks.shape[1] - SMALL_HEAD_DECODE
    prompt = {k: v for k, v in batch.items() if k not in ("targets", "loss_mask")}
    saved = ops.flash_attention_grad
    ops.flash_attention_grad = flash or saved
    try:
        with torch.no_grad():
            logits, cache = model.prefill(params, dict(prompt, tokens=toks[:, :S]), S + 8)
            out = [logits]
            for j in range(S, S + SMALL_HEAD_DECODE):
                logits, cache = model.decode_step(params, cache, toks[:, j:j + 1])
                out.append(logits)
        ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = model.loss(ps, batch)
        grads = torch.autograd.grad(loss, tree_leaves(ps))
    finally:
        ops.flash_attention_grad = saved
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
    torch.cuda.synchronize()
    return (torch.stack(out).float().cpu(), float(loss.detach()), float(gnorm),
            fa.launches - counts[0], fa.backward_calls - counts[1])


def phase_flash_small_heads(torch):
    """The flash kernel at (D, Dv) = (16, 16) and (24, 16), f32 and bf16,
    against the plain version (timed at the reduced prefill shapes beside
    their bound and SDPA); then each of the five reduced configs with such
    heads served (a prefill and two decode steps) and trained (one loss and
    gradient) on the card through the kernel: in f32 against the same
    weights on the CPU through the plain versions, in bf16 against the
    plain flash version on the card (``SMALL_HEAD_RTOL``), the kernel's
    output zeroed failing that check."""
    import torch.nn.functional as F

    from repro_torch.configs import get_reduced
    from repro_torch.data.tokens import token_batch_for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import Model

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    f32, bf16 = torch.float32, torch.bfloat16
    tol = {f32: 2e-5, bf16: 5e-2}
    out = {"max_abs_err": 0.0, "timed": {}}
    cases = [(s, g, 0) for s, g in SMALL_HEAD_TIMED] + [(s, "checked", w) for s, w in SMALL_HEAD_CHECKED]
    for (shape, group, window), dt in [(c, dt) for c in cases for dt in (f32, bf16)]:
        B, Sq, Skv, Hq, Hkv, D, Dv = shape
        q = torch.randn(B * Hq, Sq, D, generator=gen, device=dev).to(dt)
        k = torch.randn(B * Hkv, Skv, D, generator=gen, device=dev).to(dt)
        v = torch.randn(B * Hkv, Skv, Dv, generator=gen, device=dev).to(dt)
        kernel = lambda: fa.flash_attention_bhsd(q, k, v, causal=True, window=window)
        plain = lambda: flash_attention_ref(q, k, v, causal=True, window=window)
        before = fa.launches
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        check(fa.launches == before + 1, f"flash_small_heads {shape}: the kernel did not launch")
        err = float(torch.max(torch.abs(got.float() - want.float())))
        check(got.dtype == dt and got.shape == (B * Hq, Sq, Dv), f"flash {shape} output")
        check(err < tol[dt], f"flash_attention {shape} {dt} w={window}: max err {err} >= {tol[dt]}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        row = {"shape": list(shape), "dtype": str(dt).split(".")[1], "window": window,
               "group": group, "max_abs_err": err}
        if group != "checked":
            library = lambda: F.scaled_dot_product_attention(
                q.view(B, Hq, Sq, D), k.view(B, Hkv, Skv, D), v.view(B, Hkv, Skv, Dv),
                is_causal=True, enable_gqa=True)
            row.update(_timings(torch, kernel, plain, library,
                                flash_work(B, Sq, Skv, Hq, Hkv, D, q.element_size(), Dv=Dv), dt))
            out["timed"][group if dt == bf16 else f"{group}_f32"] = row
        emit("flash_small_heads", **row)

    def gaps(got, want):
        return (float(torch.max(torch.abs(got[0] - want[0]))
                      / torch.max(torch.abs(want[0])).clamp_min(1e-30)),
                abs(got[1] - want[1]) / max(abs(want[1]), 1e-30),
                abs(got[2] - want[2]) / max(abs(want[2]), 1e-30))

    def within(g, dtype):
        tol = ((SMALL_HEAD_RTOL[dtype], TRAIN_RTOL["loss"], TRAIN_RTOL["grad_norm"])
               if dtype == "bfloat16" else (SMALL_HEAD_RTOL[dtype],) * 3)
        return all(a <= b for a, b in zip(g, tol)), list(tol)

    plain_flash = lambda q, k, v, **kw: flash_attention_ref(q, k, v, **kw)
    served = {}
    for arch in SMALL_HEAD_ARCHS:
        for dtype in ("float32", "bfloat16"):
            cfg = get_reduced(arch).replace(dtype=dtype, param_dtype=dtype)
            model = Model(cfg)
            params = model.init(torch.Generator().manual_seed(0))
            batch = token_batch_for(cfg, batch=2, seq=SMALL_HEAD_SEQ + SMALL_HEAD_DECODE, seed=3)
            card = _small_head_run(torch, model, params, batch, dev)
            cpu = _small_head_run(torch, model, params, batch, torch.device("cpu"))
            check(card[3] > 0 and card[4] > 0 and cpu[3] == 0,
                  f"flash_small_heads {arch} {dtype}: launches {card[3]}, backward {card[4]}")
            row = {"arch": arch, "dtype": dtype, "head_dims": sorted(_flash_pairs(cfg)),
                   "flash_launches": card[3], "flash_backward_calls": card[4],
                   "cpu_flash_launches": cpu[3],
                   "card_vs_cpu_gaps": dict(zip(("logits", "loss", "grad_norm"), gaps(card, cpu)))}
            if dtype == "float32":
                ok, tol = within(gaps(card, cpu), dtype)
            else:
                plain = _small_head_run(torch, model, params, batch, dev, flash=plain_flash)
                ok, tol = within(gaps(card, plain), dtype)
                row["kernel_vs_plain_gaps"] = dict(zip(("logits", "loss", "grad_norm"),
                                                       gaps(card, plain)))
                flash = fa.flash_attention_grad
                zeroed = _small_head_run(torch, model, params, batch, dev,
                                         flash=lambda q, k, v, **kw: flash(q, k, v, **kw) * 0)
                row["zeroed_kernel_vs_plain_gaps"] = dict(zip(("logits", "loss", "grad_norm"),
                                                              gaps(zeroed, plain)))
                check(not within(gaps(zeroed, plain), dtype)[0],
                      f"flash_small_heads {arch}: the kernel zeroed passes {row}")
            row["rtol"] = dict(zip(("logits", "loss", "grad_norm"), tol))
            emit("flash_small_heads", **row)
            check(ok, f"flash_small_heads {arch} {dtype}: {row}")
            served[f"{arch}/{dtype}"] = row
    out["served"] = served
    out["seconds"] = time.perf_counter() - t0
    emit("flash_small_heads", seconds=out["seconds"], max_abs_err=out["max_abs_err"])
    return out


def _flash_pairs(cfg) -> set:
    """The (D, Dv) pairs ``ops.flash_attention`` reaches in ``cfg``'s loss,
    read from a forward on meta tensors."""
    import torch

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.models import Model

    seen, orig = set(), ops.flash_attention

    def record(q, k, v, **kw):
        seen.add((int(q.shape[-1]), int(v.shape[-1])))
        return orig(q, k, v, **kw)

    ops.flash_attention = record
    try:
        model = Model(cfg)
        with torch.no_grad():
            model.loss(model.abstract_params(), model.input_specs(ShapeSpec("pairs", "train", 512, 2)))
    finally:
        ops.flash_attention = orig
    return seen


# item 16.2's dry-run: the two commands (16 x 16, then 2 x 16 x 16 with the
# int8 outer sync), each a process of its own (the fake world of 256 or
# 512 ranks is the process's default group), started before the first
# phase so that they trace while the card works; their records are read at
# the end
DRYRUN_ARGS = (("16x16", ["--arch", "qwen3-8b", "--shape", "train_4k"]),
               ("2x16x16", ["--arch", "qwen3-8b", "--shape", "train_4k", "--multi-pod",
                            "--outer-sync", "--compression", "int8"]))
DRYRUN_TIMEOUT_S = 900
# flash_small_heads, dryrun (the wait for its processes) and examples together
PORT_COMPLETION_BUDGET_S = 240.0


def start_dryrun(tmp: str) -> list:
    """The dry-run commands as background processes; each writes its
    records to ``<tmp>/<mesh>.json`` and its output to ``<tmp>/<mesh>.log``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for mesh, args in DRYRUN_ARGS:
        out, log = os.path.join(tmp, f"{mesh}.json"), os.path.join(tmp, f"{mesh}.log")
        with open(log, "w") as f:
            proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                                     "--out", out], stdout=f, stderr=subprocess.STDOUT, env=env,
                                    cwd=str(ROOT))
        procs.append((mesh, proc, out, log, time.time()))
    return procs


def phase_dryrun(procs) -> dict:
    """Waits for the dry-run processes and checks their records: every one
    ``ok``, the train cells with per-rank FLOPs, bytes and collective bytes
    by kind, roofline terms on ``H100_SXM``, and one rank's peak within the
    card's 80 GB (``fits_hbm`` true: the loss keeps its vocab split); the
    outer sync's int8 payload. Prints each record's terms (model estimates
    from a trace, not measurements), and each train cell's peak beside
    80 GB on a line of its own."""
    from repro_torch.launch.mesh import H100_SXM

    t0 = time.perf_counter()
    out = {"records": {}}
    try:
        for mesh, proc, path, log, started in procs:
            try:
                rc = proc.wait(timeout=max(DRYRUN_TIMEOUT_S - (time.time() - started), 1))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise PhaseFailed(f"dryrun {mesh}: no result in {DRYRUN_TIMEOUT_S} s")
            text = Path(log).read_text()
            check(rc == 0 and os.path.exists(path),
                  f"dryrun {mesh}: exit {rc}\n{text[-4000:]}")
            records = json.loads(Path(path).read_text())
            # the process's own seconds: its last record is written as it ends
            wall = os.path.getmtime(path) - started
            check(records and all(r.get("status") == "ok" for r in records),
                  f"dryrun {mesh}: {[(r.get('step', r.get('shape')), r.get('status'), r.get('error')) for r in records]}")
            for r in records:
                if "roofline" in r:
                    t = r["trace"]
                    check(t["flops_per_chip"] > 0 and t["bytes_per_chip"] > 0
                          and t["collective_bytes"] and isinstance(r["fits_hbm"], bool),
                          f"dryrun {mesh}: record {r}")
                    peak = r["memory"]["peak_memory_in_bytes"]
                    emit("dryrun_fit", mesh=r["mesh"], cell=f"{r['arch']} x {r['shape']}",
                         peak_memory_in_bytes=peak, hbm_bytes=H100_SXM["hbm_bytes"],
                         fits_hbm=r["fits_hbm"])
                    check(r["fits_hbm"] is True and peak <= H100_SXM["hbm_bytes"],
                          f"dryrun {mesh}: one rank's peak {peak / 1e9:.2f} GB over "
                          f"{H100_SXM['hbm_bytes'] / 1e9:.0f} GB")
                    row = {"mesh": r["mesh"], "cell": f"{r['arch']} x {r['shape']}",
                           "microbatches": r["microbatches"], "trace_s": r["trace_s"],
                           "n_ops": t["n_ops"], "fits_hbm": r["fits_hbm"],
                           "peak_memory_in_bytes": r["memory"]["peak_memory_in_bytes"],
                           "argument_size_in_bytes": r["memory"]["argument_size_in_bytes"],
                           "roofline": {k: r["roofline"][k] for k in (
                               "flops_per_chip", "bytes_per_chip", "collective_bytes_per_chip",
                               "compute_s", "memory_s", "collective_s", "dominant", "link",
                               "model_flops", "useful_ratio", "step_s", "roofline_fraction",
                               "collective_breakdown")}}
                else:  # the outer sync
                    check(r["collective_bytes"].get("all-gather", 0) > 0,
                          f"dryrun {mesh}: outer sync moved nothing {r}")
                    row = {"mesh": r["mesh"], "cell": f"{r['arch']} {r['step']}",
                           "trace_s": r["trace_s"], "collective_bytes": r["collective_bytes"],
                           "fits_hbm": r["fits_hbm"],
                           "peak_memory_in_bytes": r["memory"]["peak_memory_in_bytes"]}
                emit("dryrun", estimate="model estimate from a trace, not a measurement",
                     process_wall_s=wall, **row)
                out["records"][row["cell"] + " " + row["mesh"]] = row
    finally:
        for _, proc, *_ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["seconds"] = time.perf_counter() - t0  # the wait, not the processes' time
    emit("dryrun", seconds=out["seconds"], records=len(out["records"]))
    return out


def phase_examples(torch) -> dict:
    """The four example drivers at their reference sizes on the card:
    quickstart (2 x 8 rounds), edge_africa (7 profiles x 2 TCP settings x 5
    rounds), tcp_tuning (numpy) and train_100m (200 steps, batch 8 x 128,
    its own check that the loss falls by more than 0.5); launches counted
    from 0 over the drivers. The FL drivers keep the reference's
    ``ServerConfig`` and so its sequential engine, whose aggregation is the
    plain list mean in both packages (no kernel: fedavg_reduce serves the
    batched engine, phase 5); flash_attention and swiglu launch in every
    train_100m step."""
    from repro_torch.examples import edge_africa, quickstart, tcp_tuning, train_100m

    out, t_all = {}, time.perf_counter()
    reset_launches()
    t = time.perf_counter()
    d, tuned = quickstart.main([])
    quick_rounds = d["completed_rounds"] + tuned["completed_rounds"]
    out["quickstart"] = {"seconds": time.perf_counter() - t, "default": d, "tuned": tuned}
    check(d["completed_rounds"] == tuned["completed_rounds"] == 8
          and d["final_accuracy"] > 0.5, f"examples quickstart: {d} {tuned}")
    t = time.perf_counter()
    rows = edge_africa.main([])
    fl_rounds = quick_rounds + sum(r[1]["completed_rounds"] + r[2]["completed_rounds"]
                                   for r in rows.values())
    out["edge_africa"] = {"seconds": time.perf_counter() - t,
                          "rows": {k: {"region": r[0], "default_time_s": r[1]["total_time_s"],
                                       "tuned_time_s": r[2]["total_time_s"],
                                       "tuned_accuracy": r[2]["final_accuracy"],
                                       "default_rounds": r[1]["completed_rounds"],
                                       "tuned_rounds": r[2]["completed_rounds"]}
                                   for k, r in rows.items()}}
    check(len(rows) == 7 and rows["europe"][2]["completed_rounds"] == 5,
          f"examples edge_africa: {out['edge_africa']['rows']}")
    out["fl_launches"] = read_launches()
    t = time.perf_counter()
    tcp_tuning.main()
    out["tcp_tuning"] = {"seconds": time.perf_counter() - t}
    before = read_launches()
    t = time.perf_counter()
    steps = 200
    res = train_100m.main(["--steps", str(steps)])
    lm = {k: read_launches()[k] - before[k] for k in ("flash_attention", "swiglu",
                                                       "flash_attention_backward",
                                                       "swiglu_backward")}
    out["train_100m"] = {"seconds": time.perf_counter() - t, "first_loss": res["losses"][0],
                         "final_loss": res["final_loss"], "steps": steps,
                         "launches_per_step": {k: v / steps for k, v in lm.items()}}
    check(all(lm[k] > 0 and lm[k] % steps == 0 for k in lm), f"examples train_100m: {lm}")
    out["launches"] = read_launches()
    out["fl_rounds"] = fl_rounds
    out["seconds"] = time.perf_counter() - t_all
    emit("examples", **{k: v for k, v in out.items() if k != "edge_africa"},
         edge_africa_seconds=out["edge_africa"]["seconds"],
         edge_africa=out["edge_africa"]["rows"])
    return out


def lm_rows(lm, served, grad, qwen, moe_launches, head_launches, hybrid_launches,
            encdec_launches, sharded, small, examples):
    """The kernels-line rows of flash_attention (at the serving prefill
    shape, with the S = 4096 prefill beside it) and swiglu (at decode,
    M = 4, with the M = 64 prefill beside it), launches from the serve run;
    then each kernel at the training shape (bf16, B = 2 x S = 256: forward
    and the autograd op's backward) with its launches and backward passes
    per Qwen3-8B train step; flash_attention also at Mixtral's windowed
    5,016-token prefill, with its launches in the Mixtral phases; at MLA's
    D 192 / Dv 128 (B = 4 x S = 16 and one S = 4096 prompt, 128 heads; the
    backward at mla_train's shape), Phi-3-vision's D 96 (B = 4 x S = 272,
    32 heads, forward and backward) and Zamba2's D 112 (B = 4 x S = 16 and
    one S = 4096 prompt, 32 heads; the backward at hybrid_train's shape),
    with their launches in the DeepSeek, Phi-3-vision and Zamba2 phases,
    and swiglu's launches in the Zamba2 phases; and at Whisper's three
    shapes without a mask (8 heads of 64: the encoder at B = 4 x S = 1,536,
    the cross attention of a 16-token prompt and of one decode token over
    1,536 keys; the encoder's backward at B = 2), with its launches and the
    per-call copy of a layer's cross k / v in the Whisper phases; and both
    kernels' launches under ``local_map`` in the sharded steps (a step,
    a prefill, a decode step of 8-layer Qwen3-8B on a 1 x 1 mesh); flash
    at (D, Dv) = (16, 16) and (24, 16) (the reduced configs' prefill heads,
    B = 4 x S = 64, f32 and bf16); both kernels' launches in train_100m's
    200 steps (``examples``)."""
    launches, n_pre, n_dec = served["launches"], served["prefills"], served["decode_steps"]
    per_pre, per_dec = served["per_prefill"], served["per_decode"]

    def train(name):
        row = grad[name]["bfloat16"]
        out = {"train_launches_per_step": qwen["launches_per_step"][name],
               "train_backward_calls_per_step": qwen["backward_calls_per_step"][name],
               "train_shape": row["shape"], "train_grad_rel_err": row["rel_err"],
               "train_grad_rel_err_f32": grad[name]["float32"]["rel_err"]}
        for part in ("forward", "backward"):
            t = row[part]
            lib = t["library_us"]
            out.update({f"train_{part}_ms": t["us"] / 1e3, f"train_{part}_plain_ms": t["plain_us"] / 1e3,
                        f"train_{part}_bound_ms": t["bound_us"] / 1e3,
                        f"train_{part}_bound_by": t["bound_by"],
                        f"train_{part}_library_ms": None if lib is None else lib / 1e3})
        for part in ("forward", "backward"):
            if "composite_us" in row[part]:
                out[f"train_{part}_composite_ms"] = row[part]["composite_us"] / 1e3
        return out

    def ms(row, prefix=""):
        lib = row["library_us"]
        return {f"{prefix}ms": row["us"] / 1e3, f"{prefix}plain_ms": row["plain_us"] / 1e3,
                f"{prefix}bound_ms": row["bound_us"] / 1e3, f"{prefix}bound_by": row["bound_by"],
                f"{prefix}library_ms": None if lib is None else lib / 1e3,
                f"{prefix}wall_ms": row["wall_us"] / 1e3, f"{prefix}shape": row["shape"]}

    fa, sw = lm["flash_attention"], lm["swiglu"]

    def example_launches(name):
        return {"examples_train_100m_launches": examples["launches"][name],
                "examples_train_100m_launches_per_step":
                    examples["train_100m"]["launches_per_step"][name],
                "examples_train_100m_backward_calls_per_step":
                    examples["train_100m"]["launches_per_step"][f"{name}_backward"]}

    def sharded_launches(name):
        q = sharded["qwen_train"]["steps"][-1]["launches"]
        return {"sharded_train_launches_per_step": q[name],
                "sharded_train_backward_calls_per_step": q[f"{name}_backward"],
                "sharded_launches_per_prefill": sharded["qwen_serve"]["launches_per_prefill"][name],
                "sharded_launches_per_decode_step":
                    sharded["qwen_serve"]["launches_per_decode_step"][name]}

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
         **ms(fa["timed"]["window_prefill"], "window_prefill_"),
         **ms(fa["timed"]["mla_prefill"], "mla_prefill_"),
         **ms(fa["timed"]["mla_long_prefill"], "mla_long_prefill_"),
         **ms(fa["timed"]["vlm_prefill"], "vlm_prefill_"),
         **ms(fa["timed"]["zamba_prefill"], "zamba_prefill_"),
         **ms(fa["timed"]["zamba_long_prefill"], "zamba_long_prefill_"),
         **{k: v for g in WHISPER_GROUPS for k, v in ms(fa["timed"][g], f"{g}_").items()},
         **{f"{g}_f32_ms": fa["timed"][f"{g}_f32"]["us"] / 1e3
            for g in ("mla_prefill", "mla_long_prefill", "vlm_prefill", "zamba_prefill",
                      "zamba_long_prefill", *WHISPER_GROUPS)},
         **{k: v for g, row in fa["head_dim_backward"].items()
            for part in ("forward", "backward")
            for k, v in ms(dict(row[part], shape=row["shape"]), f"{g}_{part}_").items()},
         **moe_launches, **head_launches, **hybrid_launches["flash_attention"],
         **encdec_launches, **sharded_launches("flash_attention"),
         **{k: v for g in ("small_d16", "small_d24") for k, v in ms(small["timed"][g], f"{g}_").items()},
         **{f"{g}_f32_ms": small["timed"][f"{g}_f32"]["us"] / 1e3 for g in ("small_d16", "small_d24")},
         "small_heads_max_abs_err": small["max_abs_err"],
         **example_launches("flash_attention"),
         "library_note": "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True); "
                         "window_prefill_library_ms: with a boolean window mask; "
                         "whisper_*_library_ms: with no mask (is_causal=False); "
                         "train_backward_library_ms and *_backward_library_ms: its autograd "
                         "backward",
         **train("flash_attention")},
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
         "library_note": SWIGLU_NO_LIBRARY + " (composite_ms: silu(x@Wg)*(x@Wu)@Wd in cuBLAS bf16;"
                         " train_backward_composite_ms: its autograd backward)",
         **hybrid_launches["swiglu"], **train("swiglu"), **sharded_launches("swiglu"),
         **example_launches("swiglu")},
    ]


def main() -> int:
    # The phases free and allocate multi-GB leaves in turn (Zamba2's stacked
    # Mamba2 in_proj is 8 GB in bf16): expandable segments keep the freed
    # memory usable for the next large block instead of split up in the cache
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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

    from repro_torch.kernels.build import build_all

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

    import shutil
    import tempfile

    dry_tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dry_procs = start_dryrun(dry_tmp)
    try:
        return run_phases(torch, smi, dry_procs)
    finally:
        for _, proc, *_ in dry_procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(dry_tmp, ignore_errors=True)


def run_phases(torch, smi, dry_procs) -> int:
    """Every phase after the build, then the kernels line, the card's line
    and the result."""
    from repro_torch.compress import get_compressor
    from repro_torch.models.cnn import cnn_init
    from repro_torch.utils import tree_leaves

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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_server_opt_") as tmp:
        server_opt = phase_server_opt(torch, tmp)
    benches = phase_engine_benches(torch)
    from repro_torch.utils import f32_math

    with f32_math("cuda"):  # the f32 plain versions as yardsticks in full f32
        lm = phase_lm_kernels(torch)
    server, served = phase_serve(torch)
    phase_full_width(torch, server)
    del server  # the LM phases need the card's memory (its wrapped steps hold it in a cycle)
    gc.collect()
    torch.cuda.empty_cache()
    lm_s = {}
    t = time.perf_counter()
    with f32_math("cuda"):
        grad = phase_lm_grad(torch)
    lm_s["lm_grad"] = time.perf_counter() - t
    t = time.perf_counter()
    qwen = phase_lm_train_qwen(torch)
    lm_s["lm_train_qwen"] = time.perf_counter() - t
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        phase_lm_train_starcoder(torch, tmp)
    lm_s["lm_train_starcoder2"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_lm_fl(torch)
    lm_s["lm_fl"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_dense_serving(torch)
    lm_s["dense_serving"] = time.perf_counter() - t
    t = time.perf_counter()
    server, moe_served = phase_moe_serving(torch)
    lm_s["moe_serving"] = time.perf_counter() - t
    t = time.perf_counter()
    moe_long = phase_moe_long_prompt(torch, server)
    lm_s["moe_long_prompt"] = time.perf_counter() - t
    del server
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    moe_train = phase_moe_train(torch)
    lm_s["moe_train"] = time.perf_counter() - t
    moe_launches = {"moe_serving_launches": moe_served["launches"]["flash_attention"],
                    "moe_serving_launches_per_prefill": moe_served["launches_per_prefill"][0],
                    "moe_serving_launches_per_decode_step":
                        moe_served["launches_per_decode_step"][0],
                    "moe_long_prompt_launches_prefill": moe_long["flash_launches_prefill"],
                    "moe_train_launches_per_step": moe_train["launches_per_step"]["flash_attention"],
                    "moe_train_backward_calls_per_step": moe_train["backward_calls_per_step"]}
    t = time.perf_counter()
    mla = phase_mla_serving(torch)
    lm_s["mla_serving"] = time.perf_counter() - t
    t = time.perf_counter()
    mla_train = phase_mla_train(torch)
    lm_s["mla_train"] = time.perf_counter() - t
    t = time.perf_counter()
    vlm = phase_vlm_serving(torch)
    lm_s["vlm_serving"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_rwkv_serving(torch)
    lm_s["rwkv_serving"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_rwkv_train(torch)
    lm_s["rwkv_train"] = time.perf_counter() - t
    t = time.perf_counter()
    hybrid = phase_hybrid_serving(torch)
    lm_s["hybrid_serving"] = time.perf_counter() - t
    t = time.perf_counter()
    hybrid_train = phase_hybrid_train(torch)
    lm_s["hybrid_train"] = time.perf_counter() - t
    hybrid_launches = {kernel: {
        "hybrid_serving_launches": hybrid["launches"][kernel],
        "hybrid_serving_launches_per_prefill": hybrid["launches_per_prefill"][i],
        "hybrid_serving_launches_per_decode_step": hybrid["launches_per_decode_step"][i],
        "hybrid_train_launches_per_step": hybrid_train["launches_per_step"][kernel]}
        for i, kernel in enumerate(("flash_attention", "swiglu"))}
    hybrid_launches["flash_attention"]["hybrid_train_backward_calls_per_step"] = \
        hybrid_train["backward_calls_per_step"]
    t = time.perf_counter()
    encdec = phase_encdec_serving(torch)
    lm_s["encdec_serving"] = time.perf_counter() - t
    t = time.perf_counter()
    encdec_train = phase_encdec_train(torch)
    lm_s["encdec_train"] = time.perf_counter() - t
    encdec_launches = {
        "encdec_serving_launches": encdec["launches"]["flash_attention"],
        "encdec_serving_launches_per_prefill": encdec["launches_per_prefill"][0],
        "encdec_serving_launches_per_decode_step": encdec["launches_per_decode_step"][0],
        "encdec_train_launches_per_step": encdec_train["launches_per_step"],
        "encdec_train_backward_calls_per_step": encdec_train["backward_calls_per_step"],
        "encdec_cross_kv_copy_ms_per_layer": encdec["cross_kv_copy_us_per_layer"] / 1e3}
    head_launches = {
        "mla_serving_launches": mla["launches"]["flash_attention"],
        "mla_serving_launches_per_prefill": mla["launches_per_prefill"][0],
        "mla_serving_launches_per_decode_step": mla["launches_per_decode_step"][0],
        "mla_train_launches_per_step": mla_train["launches_per_step"]["flash_attention"],
        "mla_train_backward_calls_per_step": mla_train["backward_calls_per_step"],
        "vlm_serving_launches_per_prefill": vlm["launches_per_prefill"][0],
        "vlm_serving_launches_per_decode_step": vlm["launches_per_decode_step"][0]}
    t = time.perf_counter()
    sharded = phase_sharded_steps(torch)
    lm_s["sharded_steps"] = time.perf_counter() - t
    emit("lm_phases", seconds=sum(lm_s.values()), budget_s=LM_BUDGET_S,
         within_budget=sum(lm_s.values()) <= LM_BUDGET_S, by_phase=lm_s)
    small = phase_flash_small_heads(torch)
    dry = phase_dryrun(dry_procs)
    examples = phase_examples(torch)
    port_s = {"flash_small_heads": small["seconds"], "dryrun": dry["seconds"],
              "examples": examples["seconds"]}
    emit("port_completion_phases", seconds=sum(port_s.values()),
         budget_s=PORT_COMPLETION_BUDGET_S,
         within_budget=sum(port_s.values()) <= PORT_COMPLETION_BUDGET_S, by_phase=port_s)
    check(sum(port_s.values()) <= PORT_COMPLETION_BUDGET_S,
          f"port_completion_phases: {sum(port_s.values()):.1f} s over the "
          f"{PORT_COMPLETION_BUDGET_S} s budget")

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
        # the quickstart under fedadam / fedyogi / fedadagrad / diloco, two
        # runs each: one launch per completed round
        "server_opt_launches": server_opt["launches"],
        "server_opt_rounds": server_opt["rounds"],
        # the three engine benches (the grid benches at their fast sizes)
        "engine_bench_launches": {k: benches[k]["launches"]["fedavg_reduce"]
                                  for k in ENGINE_BENCHES},
    },
        # one compressed round: the 8 CNN leaves at R = 10 (int8 grouped, bf16 summed)
        {**quant_row("quantize_rows", compressed["int8"], "src/repro/kernels/quantize.py:83",
                     NO_LIBRARY, grid["compressed"]["int8 dense"]),
         # compress_bench: the int8 points' plane compressions and the
         # unstacked baseline's per-client compressions
         "compress_bench_launches": benches["compress_bench"]["launches"]["quantize_rows"]},
        quant_row("downcast_bf16_rows", compressed["bf16"], "src/repro/kernels/quantize.py:112",
                  "one x.to(torch.bfloat16) over the same elements as a single [10, 206922] "
                  "tensor (library_per_leaf_ms: one call per leaf, 8 calls)",
                  grid["compressed"]["bf16 dense"]),
        # the whole flattened CNN (N = 206,922), as ops.quantize_tree feeds it
        quant_row("quantize_stochastic", None, "src/repro/kernels/quantize.py:44", NO_LIBRARY),
        *lm_rows(lm, served, grad, qwen, moe_launches, head_launches, hybrid_launches,
                 encdec_launches, sharded, small, examples),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
