"""The paper's figure and table sweeps on the port (the counterpart of the
sweep harness in ``benchmarks/``, whose file names these follow): fig3,
fig4 and fig5 and tuned_vs_default through the grid engine, table3 and
figs 6-8 through the transport model and ``repro_torch.tuning``, and the
adaptive daemon; the reliability benches; the engine benches
(``round_engine_bench``, ``sweep_bench``, ``compress_bench``) with their
parity gates; and ``run``, which runs them all as ``benchmarks/run.py``
does. Each ``main`` prints its rows as CSV or a BENCH json line and asserts
the paper's thresholds or exits 1 on a failed gate; the FL sweeps run on
CUDA unless given ``device=``."""
