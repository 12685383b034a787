"""Edge-Africa scenario: the paper's Tables I/II link profiles end-to-end
(the port of ``examples/edge_africa.py``).

Federated training of the MNIST CNN over every link preset (continent
averages + urban/rural), comparing default vs paper-tuned TCP parameters
and classifying each environment into the paper's Table III regions. As
in the reference, the sequential engine runs it (the aggregation a plain
mean; see ``quickstart``).

  PYTHONPATH=src python -m repro_torch.examples.edge_africa [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.chaos import ChaosSchedule
from repro_torch.core import EdgeClient, FederatedServer, ServerConfig, fedavg, mnist_cnn_task
from repro_torch.data import make_federated_mnist, synthetic_mnist
from repro_torch.transport import DEFAULT, PROFILES, TUNED_EDGE, classify

NAMES = ("global_avg", "europe", "n_america", "asia", "africa", "africa_urban", "africa_rural")


def run(link, tcp, rounds=5, device=None):
    shards = make_federated_mnist(10, 150, seed=1, iid=False, alpha=0.5)  # non-IID!
    clients = [EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    server = FederatedServer(
        mnist_cnn_task(device=device),
        clients,
        fedavg(min_fit=0.3),
        tcp=tcp,
        chaos=ChaosSchedule(link),
        config=ServerConfig(rounds=rounds, local_steps=3, seed=1),
        eval_data=synthetic_mnist(300, seed=5),
    )
    return server.run().summary()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    rows = {}
    print(f"{'profile':14s} {'region':11s} {'default_time':>13s} {'tuned_time':>11s} {'acc':>6s}")
    for name in NAMES:
        link = PROFILES[name]
        region = classify(DEFAULT, link)
        d = run(link, DEFAULT, device=args.device)
        t = run(link, TUNED_EDGE, device=args.device)
        dt = f"{d['total_time_s']:.0f}s" if d["completed_rounds"] else "FAIL"
        tt = f"{t['total_time_s']:.0f}s" if t["completed_rounds"] else "FAIL"
        print(f"{name:14s} {region:11s} {dt:>13s} {tt:>11s} {t['final_accuracy']:.3f}")
        rows[name] = (region, d, t)
    return rows


if __name__ == "__main__":
    main()
