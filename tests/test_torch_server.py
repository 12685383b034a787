"""Port parity: the synchronous round engine. With the same config and the
same initial params, the port's History equals the reference's exactly on
every numpy-computed field, and within 1e-3 on eval accuracy and loss.
Also the paper's system claims, run on the port."""

import pytest

from _card_reference import ENGINES, _run, assert_histories_match
from _torch_parity import ref_params_np, with_params
import repro.chaos as r_chaos
import repro.core as r_core
import repro.data as r_data
import repro.transport as r_tr
import repro_torch.chaos as p_chaos
import repro_torch.configs as p_configs
import repro_torch.core as p_core
import repro_torch.data as p_data
import repro_torch.transport as p_tr

R_TASK = r_core.mnist_cnn_task()
P_TASK = with_params(p_core.mnist_cnn_task(device="cpu"), ref_params_np(0))


@pytest.mark.parametrize("name,overrides,chaos_kind,tcp_name", ENGINES, ids=[e[0] for e in ENGINES])
def test_history_matches_reference(name, overrides, chaos_kind, tcp_name):
    r_hist, r_clients = _run(r_core, r_data, r_tr, r_chaos, R_TASK, name, overrides, chaos_kind, tcp_name)
    p_hist, p_clients = _run(p_core, p_data, p_tr, p_chaos, P_TASK, name, overrides, chaos_kind, tcp_name)
    assert p_hist.completed_rounds > 0
    assert_histories_match(r_hist, r_clients, p_hist, p_clients)


def _port_server(tcp, link=p_tr.LAB, rounds=4, chaos=None, min_fit=0.5, batched=False):
    shards = p_data.make_federated_mnist(8, 80, seed=0)
    clients = [p_core.EdgeClient(i, dataset=s) for i, s in enumerate(shards)]
    return p_core.FederatedServer(
        P_TASK,
        clients,
        p_core.fedavg(min_fit=min_fit),
        tcp=tcp,
        chaos=chaos or p_chaos.ChaosSchedule(link),
        config=p_core.ServerConfig(rounds=rounds, local_steps=3, seed=0, batched=batched),
        eval_data=p_data.synthetic_mnist(250, seed=11),
    )


@pytest.mark.parametrize("batched", [False, True])
def test_paper_headline_claim_on_the_port(batched):
    """At 6 s one-way delay the default stack cannot train; the three tuned
    TCP parameters restore training."""
    link = p_tr.LAB.replace(delay=6.0)
    dead = _port_server(p_tr.DEFAULT, link, batched=batched).run()
    alive = _port_server(p_tr.TUNED_EDGE, link, batched=batched).run()
    assert dead.completed_rounds == 0
    assert alive.completed_rounds == 4
    assert alive.final_accuracy() is not None and alive.final_accuracy() > 0.3


def test_rec3_min_fit_under_90pct_failure_on_the_port():
    chaos = p_chaos.ChaosSchedule(p_tr.LAB).add(p_chaos.client_failure_schedule(8, 0.875, seed=2))
    hist = _port_server(p_tr.DEFAULT, chaos=chaos, min_fit=0.1, rounds=3).run()
    assert hist.completed_rounds == 3  # one surviving client suffices


@pytest.mark.parametrize(
    "build,item",
    [
        (lambda: p_configs.get_config("phi3-medium-14b"), 15),
        (lambda: p_configs.get_reduced("starcoder2-3b"), 15),
        (lambda: p_configs.get_config("mixtral-8x7b"), 15),
    ],
    ids=["phi3-medium-14b", "starcoder2-3b", "mixtral-8x7b"],
)
def test_configs_outside_the_slice_raise(build, item):
    with pytest.raises(NotImplementedError, match=rf"ROADMAP Queue 1, item {item}\)"):
        build()
