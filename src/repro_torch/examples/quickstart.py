"""Quickstart: federated MNIST training under degraded-edge conditions (the
port of ``examples/quickstart.py``).

Reproduces the paper's core experiment in one script: 10 Raspberry-Pi-class
clients, FedAvg, a chaos schedule that degrades the network mid-training,
and the tuned-TCP comparison (paper §V). ``ServerConfig`` is the
reference's, so the sequential engine runs it: each client's local SGD on
the card, the aggregation a plain mean of the deltas (the batched engine,
``ServerConfig(batched=True)``, aggregates with the ``fedavg_reduce``
kernel).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.chaos import ChaosSchedule, client_failure_schedule, netem
from repro_torch.core import EdgeClient, FederatedServer, ServerConfig, fedavg, mnist_cnn_task
from repro_torch.data import make_federated_mnist, synthetic_mnist
from repro_torch.transport import DEFAULT, LAB, TUNED_EDGE


def run(tcp, label, device=None):
    shards = make_federated_mnist(n_clients=10, examples_per_client=200, seed=0)
    clients = [EdgeClient(i, dataset=s) for i, s in enumerate(shards)]

    # the chaos story: clean start, then a rural-Africa-grade degradation,
    # then 30% of pods die (Chaos-Mesh style)
    chaos = ChaosSchedule(LAB).add(
        netem(60.0, 10_000.0, delay=0.8, loss=0.10),       # degraded network
        client_failure_schedule(10, 0.3, t_start=120.0, seed=3),  # pod kills
    )

    server = FederatedServer(
        mnist_cnn_task(device=device),
        clients,
        fedavg(min_fit=0.1),  # paper Rec #3: tolerate heavy dropout
        tcp=tcp,
        chaos=chaos,
        config=ServerConfig(rounds=8, local_steps=4, seed=0),
        eval_data=synthetic_mnist(400, seed=99),
    )
    hist = server.run()
    s = hist.summary()
    print(f"[{label:8s}] rounds={s['completed_rounds']}/8 "
          f"time={s['total_time_s']:7.1f}s acc={s['final_accuracy']:.3f} "
          f"reconnects/round={s['mean_reconnects']:.1f}")
    return s


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    print("== Surviving the Edge: quickstart ==")
    d = run(DEFAULT, "default", device=args.device)
    t = run(TUNED_EDGE, "tuned", device=args.device)
    if t["total_time_s"] < d["total_time_s"]:
        print(f"tuned TCP params finished {d['total_time_s']/t['total_time_s']:.2f}x faster")
    return d, t


if __name__ == "__main__":
    main()
