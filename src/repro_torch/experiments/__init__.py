"""The paper's figure and table sweeps on the port (the counterpart of the
sweep harness in ``benchmarks/``, whose file names these follow): fig3,
fig4 and fig5 and tuned_vs_default through the grid engine, table3 and
figs 6-8 through the transport model and ``repro_torch.tuning``, and the
adaptive daemon. Each ``main`` prints its rows as CSV and asserts the
paper's thresholds; the FL sweeps run on CUDA unless given ``device=``."""
