"""The reference FL Histories that the port is held to, on the CPU and on the
card, and the rules of that comparison.

The runs are defined here with builders that take the package modules as
arguments, so one definition drives the JAX reference (``repro``) and the
port (``repro_torch``). The module imports neither at module level: the
card's Python has no jax, so it imports these definitions, loads the
committed fixture and runs only the port.

The fixture is written on the CPU by the reference:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_card_reference.py

- ``tests/data/card_reference_params.npz``: the reference's
  ``cnn_init(PRNGKey(0))`` params, keyed by ``/``-joined paths as
  ``checkpoint/store.py`` keys them (threefry draws have no torch
  counterpart, so every run starts from these);
- ``tests/data/card_reference.json``: each run's History (every
  ``RoundRecord`` field, events included, ``eval_metrics``, ``status`` and
  ``cause``) and each client's (connected, rounds participated, bytes
  sent). Python floats round-trip exactly through ``json``;
- ``tests/data/card_reference_ckpt/``: the reference's point checkpoint
  of the ``CHECKPOINT_RUN`` run after round 2 of 3 (``LATEST`` and
  ``step_000000002/``, in the format of ``checkpoint/store.py``). A port
  server restores it and finishes the run (``resume``), held to that run's
  committed History.

Not collected by pytest (the name does not start with ``test_``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"
PARAMS_PATH = DATA / "card_reference_params.npz"
HISTORY_PATH = DATA / "card_reference.json"

HISTORY_TOL = 1e-3

# (name, ServerConfig overrides, chaos kind, tcp name)
ENGINES = [
    ("sequential_analytic", dict(batched=False), "quickstart", "DEFAULT"),
    ("batched_analytic", dict(batched=True), "quickstart", "DEFAULT"),
    ("batched_analytic_split", dict(batched=True, rng_streams="split"), "restart", "TUNED_EDGE"),
    ("sequential_stochastic", dict(batched=False, stochastic=True), "quickstart", "TUNED_EDGE"),
    ("batched_stochastic", dict(batched=True, stochastic=True), "quickstart", "DEFAULT"),
    ("fused_transport", dict(batched=True, stochastic=True, engine="fused_transport"),
     "quickstart", "DEFAULT"),
    ("batched_retry_zero_rtt",
     dict(batched=True, stochastic=True, transport_profile="zero_rtt", quorum_close_fraction=0.8),
     "restart", "DEFAULT"),
    # the device transport plane on a clean link (no draw decides anything)
    ("device_degenerate", dict(batched=True, stochastic=True, transport_backend="device"),
     "clean", "DEFAULT"),
]
# runs whose clocks come from the device plane's f32 arithmetic: their
# clock-derived fields are held within this relative tolerance
CLOCK_RTOL = {"device_degenerate": 1e-6}
# the plane compressors with kernels, batched engine, sparse StatePlane,
# zero initial residuals (the server's default)
COMPRESSED = ("int8", "bf16")
# the async engine, batched: degenerate (one client, clean link, a buffer
# of one) and buffered (k=3, half the clients throttled, staleness weights)
ASYNC = ("async_degenerate", "async_buffered")
# the server-side optimizers (FedOpt's three kinds, DiLoCo's outer
# Nesterov), each from ``STRATEGIES`` on the batched engine, quickstart chaos
SERVER_OPT = ("fedadam", "fedyogi", "fedadagrad", "diloco")
RUNS = ([e[0] for e in ENGINES] + [f"compressed_{c}" for c in COMPRESSED] + list(ASYNC)
        + list(SERVER_OPT))
# the run whose round-2 checkpoint is committed (single-stream stochastic
# transport: the restore must carry the generator's state exactly)
CHECKPOINT_RUN = "batched_stochastic"
CHECKPOINT_PATH = DATA / "card_reference_ckpt"


def _chaos(pkg, tr, kind):
    sched = pkg.ChaosSchedule(tr.LAB)
    sched.add(
        # "clean": the delay step without loss
        pkg.netem(1.5, 10_000.0, delay=0.4, loss=0.0 if kind == "clean" else 0.05),
        pkg.client_failure_schedule(6, 0.3, t_start=2.0, seed=3),
    )
    if kind == "restart":  # lands inside round 2
        sched.add(pkg.server_restart(8.0, downtime=5.0))
    return sched


def _server(core, data, tr, chaos_pkg, task, name, overrides, chaos_kind, tcp_name,
            strategy="fedavg"):
    """One engine run's server: 6 clients x 64 examples, 3 rounds of 2 local
    steps, ``strategy`` from ``STRATEGIES`` with min_fit 0.3."""
    shards = data.make_federated_mnist(6, 64, seed=0)
    clients = [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    kw = dict(rounds=3, local_steps=2, seed=0, **overrides)
    if name == "batched_retry_zero_rtt":
        kw["retry"] = tr.RetryPolicy(max_retries=2, jitter=0.3, resume=True)
    return core.FederatedServer(
        task,
        clients,
        core.STRATEGIES[strategy](min_fit=0.3),
        tcp=getattr(tr, tcp_name),
        chaos=_chaos(chaos_pkg, tr, chaos_kind),
        config=core.ServerConfig(**kw),
        eval_data=data.synthetic_mnist(2000, seed=77),
    )


def _run(core, data, tr, chaos_pkg, task, name, overrides, chaos_kind, tcp_name):
    server = _server(core, data, tr, chaos_pkg, task, name, overrides, chaos_kind, tcp_name)
    return server.run(), server.clients


def _run_compressed(core, data, tr, chaos_pkg, comp_pkg, task, comp):
    """One compressed run: 10 clients x 64 examples, 3 rounds of 2 local
    steps, batched engine, sparse StatePlane."""
    shards = data.make_federated_mnist(10, 64, seed=0)
    clients = [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    sched = chaos_pkg.ChaosSchedule(tr.LAB).add(
        chaos_pkg.netem(1.5, 10_000.0, delay=0.4, loss=0.05))
    server = core.FederatedServer(
        task, clients, core.fedavg(min_fit=0.3), tcp=tr.DEFAULT, chaos=sched,
        config=core.ServerConfig(rounds=3, local_steps=2, seed=0, batched=True,
                                 state_plane="sparse"),
        compressor=getattr(comp_pkg, f"{comp}_compressor")(),
        eval_data=data.synthetic_mnist(2000, seed=77),
    )
    return server.run(), clients


def _run_async(core, data, tr, chaos_pkg, task, name):
    """``async_degenerate``: 1 client x 64 examples on a clean link, buffer
    of one, 3 ticks. ``async_buffered``: 6 clients x 64 examples, clients
    0-2 at a fifth of the compute rate, buffer of 3, alpha 0.5, the
    quickstart chaos (clients die mid-flight), 4 ticks. Both batched, 2
    local steps."""
    if name == "async_degenerate":
        n, kw, sched = 1, dict(rounds=3, async_buffer_k=1), chaos_pkg.ChaosSchedule(tr.LAB)
    else:
        n, kw = 6, dict(rounds=4, async_buffer_k=3, staleness_alpha=0.5)
        sched = _chaos(chaos_pkg, tr, "quickstart")
    shards = data.make_federated_mnist(n, 64, seed=0)
    clients = [core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    for c in clients[: n // 2]:
        c.compute_rate = 0.2
    server = core.FederatedServer(
        task, clients, core.fedavg(min_fit=0.3), tcp=tr.DEFAULT, chaos=sched,
        config=core.ServerConfig(local_steps=2, seed=0, batched=True, async_mode=True, **kw),
        eval_data=data.synthetic_mnist(2000, seed=77),
    )
    return server.run(), clients


def run(name, task, core, data, tr, chaos_pkg, comp_pkg):
    """Run ``name`` (one of ``RUNS``) with the given package's modules;
    returns (History, clients)."""
    if name.startswith("compressed_"):
        return _run_compressed(core, data, tr, chaos_pkg, comp_pkg, task,
                               name[len("compressed_"):])
    if name in ASYNC:
        return _run_async(core, data, tr, chaos_pkg, task, name)
    if name in SERVER_OPT:
        server = _server(core, data, tr, chaos_pkg, task, name, dict(batched=True),
                         "quickstart", "DEFAULT", strategy=name)
        return server.run(), server.clients
    engine = next(e for e in ENGINES if e[0] == name)
    return _run(core, data, tr, chaos_pkg, task, *engine)


def checkpoint_server(task, core, data, tr, chaos_pkg, comp_pkg):
    """A fresh server of ``CHECKPOINT_RUN`` with the given package's modules."""
    engine = next(e for e in ENGINES if e[0] == CHECKPOINT_RUN)
    return _server(core, data, tr, chaos_pkg, task, *engine)


def resume(task, directory, core, data, tr, chaos_pkg, comp_pkg):
    """Finish ``CHECKPOINT_RUN`` from a copy of the committed round-2
    checkpoint in ``directory`` (a scratch directory: the run writes its
    round-3 checkpoint there). Returns (History, clients)."""
    import shutil

    shutil.copytree(CHECKPOINT_PATH, directory, dirs_exist_ok=True)
    server = checkpoint_server(task, core, data, tr, chaos_pkg, comp_pkg)
    return server.run(checkpoint_dir=str(directory)), server.clients


def port_packages():
    """The port's modules, in ``run``'s argument order after ``task``."""
    import repro_torch.chaos
    import repro_torch.compress
    import repro_torch.core
    import repro_torch.data
    import repro_torch.transport

    return (repro_torch.core, repro_torch.data, repro_torch.transport, repro_torch.chaos,
            repro_torch.compress)


# --------------------------------------------------------------------------
# the fixture: params and Histories as plain data
# --------------------------------------------------------------------------


def _plain(x):
    """``x`` as ``json`` writes and reads it back: tuples as lists, numpy
    scalars as Python numbers, dict keys as strings."""
    return json.loads(json.dumps(x, default=lambda v: v.item()))


def history_record(hist, clients) -> dict:
    """A History and its clients as plain data (the fixture's form)."""
    return _plain({
        "rounds": [dataclasses.asdict(r) for r in hist.rounds],
        "eval_metrics": hist.eval_metrics,
        "status": hist.status,
        "cause": hist.cause,
        "clients": [[c.connected, c.rounds_participated, c.bytes_sent] for c in clients],
    })


def load_records() -> dict:
    return json.loads(HISTORY_PATH.read_text())


def load_params() -> dict:
    """The reference's initial CNN params as a nested dict of numpy."""
    tree: dict = {}
    with np.load(PARAMS_PATH) as arrays:
        for key in arrays.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = arrays[key]
    return tree


def port_task(device):
    """The port's CNN task on ``device``, started from the fixture's params."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import mnist_cnn_task

    params = load_params()
    return dataclasses.replace(mnist_cnn_task(device=device),
                               init_fn=lambda _g: params_from_numpy(params, device))


# --------------------------------------------------------------------------
# the comparison
# --------------------------------------------------------------------------


def history_gaps(want: dict, got: dict) -> dict:
    """Largest |difference| of eval accuracy, eval loss and client metrics
    between two records (fixture form)."""
    acc = loss = metric = 0.0
    for w, g in zip(want["eval_metrics"], got["eval_metrics"]):
        acc = max(acc, abs(w["accuracy"] - g["accuracy"]))
        loss = max(loss, abs(w["loss"] - g["loss"]))
    for w, g in zip(want["rounds"], got["rounds"]):
        for k in w["metrics"].keys() & g["metrics"].keys():
            metric = max(metric, abs(w["metrics"][k] - g["metrics"][k]))
    return {"accuracy": acc, "loss": loss, "client_metrics": metric}


def _clock_equal(want: float, got: float, rtol: float) -> bool:
    return want == got if rtol == 0.0 else abs(want - got) <= rtol * abs(want)


def assert_records_match(want: dict, got: dict, tol: float = HISTORY_TOL,
                         clock_rtol: float = 0.0):
    """Every numpy-computed field (clock, counts, reconnects, ids, cause,
    bytes, events, status, clients) exactly; client metrics and eval
    accuracy/loss within ``tol``. With ``clock_rtol`` the clock-derived
    fields (``t_start``, ``t_end``, the eval ``t``) are held within that
    relative tolerance instead (``CLOCK_RTOL``)."""
    assert (want["status"], want["cause"]) == (got["status"], got["cause"])
    assert want["clients"] == got["clients"]
    assert len(want["rounds"]) == len(got["rounds"])
    for w_rec, g_rec in zip(want["rounds"], got["rounds"]):
        w_d, g_d = dict(w_rec), dict(g_rec)
        w_m, g_m = w_d.pop("metrics"), g_d.pop("metrics")
        for k in ("t_start", "t_end"):
            assert _clock_equal(w_d.pop(k), g_d.pop(k), clock_rtol), k
        assert w_d == g_d
        assert sorted(w_m) == sorted(g_m)
        for k in w_m:
            assert abs(w_m[k] - g_m[k]) <= tol, k
    assert len(want["eval_metrics"]) == len(got["eval_metrics"])
    for w_e, g_e in zip(want["eval_metrics"], got["eval_metrics"]):
        assert w_e["round"] == g_e["round"] and _clock_equal(w_e["t"], g_e["t"], clock_rtol)
        assert abs(w_e["accuracy"] - g_e["accuracy"]) <= tol
        assert abs(w_e["loss"] - g_e["loss"]) <= tol


def assert_histories_match(r_hist, r_clients, p_hist, p_clients, tol: float = HISTORY_TOL):
    """Reference and port History and clients by the rules of
    ``assert_records_match``."""
    assert_records_match(history_record(r_hist, r_clients), history_record(p_hist, p_clients), tol)


def main() -> None:
    """Run the reference on the CPU and write the fixture."""
    import jax

    import repro.chaos
    import repro.compress
    import repro.core
    import repro.data
    import repro.transport
    from repro.models.cnn import cnn_init

    params = jax.tree.map(np.asarray, cnn_init(jax.random.PRNGKey(0)))
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v

    walk(params, "")
    task = repro.core.mnist_cnn_task()
    pkgs = (repro.core, repro.data, repro.transport, repro.chaos, repro.compress)
    records = {}
    for name in RUNS:
        hist, clients = run(name, task, *pkgs)
        records[name] = history_record(hist, clients)
        print(name, hist.summary(), flush=True)
    DATA.mkdir(exist_ok=True)
    np.savez(PARAMS_PATH, **flat)
    HISTORY_PATH.write_text(json.dumps(records, indent=1) + "\n")
    write_checkpoint(task, CHECKPOINT_PATH, pkgs)


def write_checkpoint(task, directory, pkgs) -> None:
    """The reference's round-2 checkpoint of ``CHECKPOINT_RUN`` (one step
    directory and ``LATEST``) written to ``directory``."""
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        checkpoint_server(task, *pkgs).run(checkpoint_dir=tmp, checkpoint_every=2,
                                           stop_after_round=2)
        shutil.rmtree(directory, ignore_errors=True)
        shutil.copytree(tmp, directory)


if __name__ == "__main__":
    main()
