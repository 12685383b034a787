"""The four ranks of ``tests/test_torch_multirank.py``: one ``gloo`` world
on the CPU (a ``FileStore``, no port) that runs the port's sharded steps
on (2, 2) and (2, 2, 1) meshes and the loss with its vocab split over
"model", and writes what the parent's tests assert on. Imports no jax:
the parent brings the reference's inputs in ``inputs.pkl`` and holds the
results to it.

Run alone: ``PYTHONPATH=src:tests python tests/_torch_multirank.py DIR
[cuda]`` (DIR holding the parent's ``inputs.pkl``; ``rank0.pkl`` is
written there); with ``cuda`` the four ranks run over ``nccl`` on four
cards.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import sys

import torch

WORLD = 4
DEVICE = torch.device("cpu")  # each rank's device: the CPU here, card ``rank`` over nccl


def _t(x):
    return torch.as_tensor(x, device=DEVICE)


class GroupSpy:
    """Records the ranks of every process group a collective is called on
    (through ``torch.distributed`` or its functional collectives, which
    DTensor uses), with the dtype of what it moves."""

    DIST = ("all_reduce", "all_gather_into_tensor", "all_gather", "all_to_all_single",
            "reduce_scatter_tensor", "broadcast", "reduce_scatter")
    FUNCOL = ("all_reduce", "all_gather_tensor", "all_gather_tensor_autograd", "all_gather_single",
              "reduce_scatter_tensor", "reduce_scatter_tensor_autograd", "reduce_scatter_single",
              "all_to_all_single", "all_to_all_single_autograd", "broadcast")

    def __init__(self):
        self.calls = []
        self._saved = []

    def __enter__(self):
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol

        for mod, names in ((dist, self.DIST), (funcol, self.FUNCOL)):
            for name in names:
                if hasattr(mod, name):
                    fn = getattr(mod, name)
                    self._saved.append((mod, name, fn))
                    setattr(mod, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        import inspect

        sig = inspect.signature(fn)

        def spy(*args, **kwargs):
            bound = sig.bind_partial(*args, **kwargs).arguments
            tensor = next((a for a in bound.values() if isinstance(a, torch.Tensor)), None)
            self.calls.append((name, self._ranks(bound.get("group", bound.get("group_name"))),
                               None if tensor is None else str(tensor.dtype)))
            return fn(*args, **kwargs)

        return spy

    @staticmethod
    def _ranks(group):
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        if group is None:
            return tuple(range(dist.get_world_size()))
        if isinstance(group, str):
            from torch.distributed.distributed_c10d import _resolve_process_group

            group = _resolve_process_group(group)
        elif isinstance(group, tuple) and isinstance(group[0], DeviceMesh):
            group = group[0].get_group(group[1])
        elif isinstance(group, DeviceMesh):
            group = group.get_group()
        elif isinstance(group, list):
            return tuple(group)
        return tuple(dist.get_process_group_ranks(group))

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _tree(np_tree):
    from repro_torch.convert import params_from_numpy

    return params_from_numpy(np_tree, DEVICE)


def _gap(a, b):
    from repro_torch.utils import tree_leaves

    return max(float((x.double() - y.double()).abs().max()) for x, y in
               zip(tree_leaves(a), tree_leaves(b)))


def _rel_gap(a, b):
    from repro_torch.utils import tree_leaves

    return max(float((x.double() - y.double()).abs().max() / max(float(x.abs().max()), 1e-30))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _state(opt, params):
    from repro_torch.utils import tree_map

    p = tree_map(torch.clone, params)
    return {"params": p, "opt": opt.init(p), "step": torch.zeros((), dtype=torch.int32, device=DEVICE)}


def _sync_and_serve(arch, inp, mesh, out):
    """One sync train step (2 microbatches) and a prefill then a decode
    step on the mesh, each against the same on one rank."""
    from repro_torch.configs import TrainConfig, get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps as S
    from repro_torch.models import Model
    from repro_torch.sharding.rules import full_tree

    cfg = get_reduced(arch).replace(dtype="float32", param_dtype="float32", loss_chunk=0,
                                    n_layers=inp["layers"])
    tcfg = TrainConfig(optimizer="adafactor", learning_rate=2e-3, total_steps=6, warmup_steps=1,
                       microbatches=2)
    params = _tree(inp[arch]["params"])
    opt = S.make_optimizer(tcfg)
    batch = {k: _t(v) for k, v in inp[arch]["batch"].items()}
    B, T = batch["tokens"].shape
    built = S.build_train_step(cfg, tcfg, ShapeSpec("t", "train", T, B), mesh)
    sharded, metrics = S.run_built(built, mesh, _state(opt, params), batch)
    one, one_metrics = S.build_train_step(cfg, tcfg)(_state(opt, params), batch)
    metrics = full_tree(metrics)
    out[f"{arch}/train"] = {
        "metrics": {k: (float(metrics[k]), float(one_metrics[k])) for k in one_metrics},
        "param_gap": _gap(full_tree(sharded["params"]), one["params"]),
        "opt_rel_gap": _rel_gap(one["opt"], full_tree(sharded["opt"])),
        "step": int(full_tree({"s": sharded["step"]})["s"]),
    }
    tokens = _t(inp[arch]["prompt"])
    Bp, Sp = tokens.shape
    model = Model(cfg)
    pre = S.build_prefill_step(cfg, ShapeSpec("p", "prefill", Sp + 4, Bp), mesh)
    logits, cache = S.run_built(pre, mesh, params, {"tokens": tokens})
    want, want_cache = model.prefill(params, {"tokens": tokens}, Sp + 4)
    dec = S.build_decode_step(cfg, ShapeSpec("d", "decode", Sp + 4, Bp), mesh)
    nxt = torch.argmax(want, -1)[:, None].to(torch.int32)
    logits2, cache = S.run_built(dec, mesh, params, cache, nxt)
    want2, want_cache = model.decode_step(params, want_cache, nxt)
    out[f"{arch}/serve"] = {
        "prefill_gap": float((logits.full_tensor() - want).abs().max()),
        "decode_gap": float((logits2.full_tensor() - want2).abs().max()),
        "cache_gap": _gap(full_tree(cache), want_cache),
        "pos": int(full_tree(cache)["seg0"]["pos"].max()),
    }


def _moe_paths(inp, mesh, out):
    """Each mesh path of ``moe_sharded`` on one MoE block: the output, the
    aux loss and the gradients of ``sum(y * r)`` in the inputs and weights."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import moe_sharded
    from repro_torch.sharding.rules import distribute_tree, param_shardings
    from repro_torch.launch.steps import _with_act_sharding
    from repro_torch.models import Model

    for case in inp["moe"]:
        moe = case["moe"]
        base = get_reduced("mixtral-8x7b").replace(dtype="float32", param_dtype="float32")
        cfg = _with_act_sharding(base.replace(moe=dataclasses.replace(base.moe, **moe)), mesh)
        specs = param_shardings(Model(cfg).abstract_params(), Model(cfg).param_axes(), mesh)
        bspecs = {k: tuple(s[1:]) for k, s in specs["seg0"]["mlp"].items()}  # drop "layers"
        p = distribute_tree({k: _t(v) for k, v in case["p"].items()}, bspecs, mesh)
        p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        x_np = case["x"]
        B, Sq, _ = x_np.shape
        path = moe_sharded.pick_moe_path(cfg, B, Sq)
        x = distribute_tree(_t(x_np), ("data", "model" if Sq % 2 == 0 else None, None),
                            mesh).detach().requires_grad_(True)
        r = _t(case["r"])
        fn = {"ep_a2a": moe_sharded.moe_forward_ep_a2a, "ep_local": moe_sharded.moe_forward_ep_local,
              "local": moe_sharded.moe_forward_local}[path]
        with mesh_context(mesh), implicit_replication():
            y, aux = fn(cfg, p, x)
            loss = (y * r).sum() + aux
            loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
            grads = torch.autograd.grad(loss, [x] + [p[k] for k in sorted(p)])
        out[f"moe/{case['name']}"] = {
            "path": path,
            "y": y.full_tensor().detach().cpu().numpy(),
            "aux": float(aux.full_tensor().detach()),
            "grads": {k: g.full_tensor().cpu().numpy() for k, g in zip(["x"] + sorted(p), grads)},
        }


def _split_vocab_loss(inp, mesh, out):
    """``loss_from_hidden`` on the mesh for each case of ``inp["xent"]``:
    h split over "data", the unembedding laid out as the production rules
    lay it out ("data", "model"), the vocab split over "model". Returns the
    loss, the accuracy and the gradients in h and the unembedding, whole."""
    from repro_torch.configs import get_reduced
    from repro_torch.models.lm import loss_from_hidden
    from repro_torch.sharding.rules import distribute_tree

    for case in inp["xent"]:
        cfg = get_reduced("qwen3-8b").replace(**case["cfg"])
        h = distribute_tree(_t(case["h"]), ("data", None, None), mesh).requires_grad_(True)
        w = distribute_tree(_t(case["unembed"]), ("data", "model"), mesh).requires_grad_(True)
        batch = distribute_tree({k: _t(v) for k, v in case["batch"].items()},
                                {k: ("data", None) for k in case["batch"]}, mesh)
        loss, metrics = loss_from_hidden(cfg, {"unembed": w}, h, batch)
        g_h, g_w = torch.autograd.grad(loss, [h, w])
        out[f"xent/{case['name']}"] = {
            "loss": float(loss.detach().full_tensor()),
            "accuracy": float(metrics["accuracy"].detach().full_tensor()),
            "grad_h": g_h.full_tensor().cpu().numpy(),
            "grad_unembed": g_w.full_tensor().cpu().numpy(),
        }


def _local_sgd_and_outer(inp, mesh, rank, out):
    """local-SGD on the pod mesh: both pods take a step, then pod 0 takes a
    second with pod 1 sitting it out (a collective across "pod" would then
    time out); the outer sync, int8 and uncompressed, against plain torch."""
    import torch.distributed as dist

    from repro_torch.configs import TrainConfig, get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps as S
    from repro_torch.optim import nesterov_outer
    from repro_torch.sharding.rules import full_tree
    from repro_torch.utils import tree_map

    cfg = get_reduced("qwen3-8b").replace(dtype="float32", param_dtype="float32", loss_chunk=0,
                                          n_layers=inp["layers"])
    tcfg = TrainConfig(optimizer="adafactor", learning_rate=2e-3, total_steps=6, warmup_steps=1,
                       microbatches=1, outer_lr=0.7, outer_momentum=0.9)
    params = _tree(inp["qwen3-8b"]["params"])
    opt = S.make_optimizer(tcfg)
    batches = [{k: _t(v) for k, v in b.items()} for b in inp["local_sgd"]["batches"]]
    n_pod, B, T = batches[0]["tokens"].shape
    built = S.build_train_step(cfg, tcfg, ShapeSpec("t", "train", T, n_pod * B), mesh,
                               mode="local_sgd")
    one = _state(opt, params)
    stacked = tree_map(lambda t: torch.stack([t, t.clone()]), one)
    pod = rank // 2
    with GroupSpy() as spy:
        stacked, metrics = S.run_built(built, mesh, stacked, batches[0])
        if pod == 0:  # pod 1 sits the second step out
            stacked, _ = S.run_built(built, mesh, stacked, batches[1])
    single = S.build_train_step(cfg, tcfg)
    ref = _state(opt, params)
    for b in batches:
        ref, _ = single(ref, {k: v[0] for k, v in b.items()})
    mine = tree_map(lambda t: t._local_tensor[0], stacked["params"])  # this rank's pod, local shard
    dist.barrier()
    if pod == 0:
        local_ref = _local_like(ref["params"], stacked["params"])
        out["local_sgd"] = {"pod0_gap": _gap(mine, local_ref),
                            "calls": spy.calls, "metrics_shape": tuple(metrics["loss"].shape)}
    # the outer sync, from every pod's params after its steps (the step
    # updates what it is given in place: it gets copies)
    whole = full_tree(stacked["params"])
    anchor = tree_map(torch.clone, params)
    outer = nesterov_outer(tcfg.outer_lr, tcfg.outer_momentum)
    clone = lambda t: tree_map(torch.clone, t)  # noqa: E731
    for comp in ("int8", "none"):
        sync = S.build_outer_sync(cfg, tcfg, mesh, compression=comp)
        want_anchor, want_m = _plain_outer_sync(whole, anchor, outer.init(anchor), comp, tcfg)
        with GroupSpy() as spy:
            new_stacked, new_anchor, new_state = S.run_built(
                sync, mesh, clone(whole), clone(anchor), outer.init(anchor),
                torch.zeros((), dtype=torch.int32, device=DEVICE))
        got = full_tree(new_anchor)
        got_stacked = full_tree(new_stacked)
        pod_calls = [c for c in spy.calls if c[1] in ((0, 2), (1, 3))]
        out[f"outer/{comp}"] = {
            "anchor_equal": all(torch.equal(a, b) for a, b in
                                zip(_leaves(got), _leaves(want_anchor))),
            "m_equal": all(torch.equal(a, b) for a, b in
                           zip(_leaves(full_tree(new_state["m"])), _leaves(want_m))),
            "replicas_reset": all(torch.equal(s[i], a) for s, a in
                                  zip(_leaves(got_stacked), _leaves(got)) for i in range(n_pod)),
            "pod_dtypes": sorted({c[2] for c in pod_calls}),
            "changed": _gap(got, anchor) > 0,
        }


def _leaves(tree):
    from repro_torch.utils import tree_leaves

    return tree_leaves(tree)


def _local_like(whole_tree, stacked_tree):
    """This rank's shard (of a pod slice) of each whole leaf."""
    from repro_torch.utils import tree_map
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    def one(w, st):
        shape, off = compute_local_shape_and_global_offset(st.shape, st.device_mesh, st.placements)
        idx = tuple(slice(o, o + n) for o, n in zip(off[1:], shape[1:]))
        return w[idx]

    return tree_map(one, whole_tree, stacked_tree)


def _plain_outer_sync(stacked, anchor, outer_state, comp, tcfg):
    """The outer sync on whole tensors in plain torch, the reference's
    expressions: per pod int8 (scale over every dim but the pod, half to
    even), the mean over pods, the Nesterov step."""
    from repro_torch.utils import tree_map

    def delta(ps, a):
        d = ps.float() - a.float()[None]
        if comp == "int8":
            scale = torch.clamp(torch.amax(torch.abs(d), dim=tuple(range(1, d.ndim)), keepdim=True),
                                min=1e-12) / 127.0
            d = torch.clamp(torch.round(d / scale), -127, 127).to(torch.int8).float() * scale
        return torch.mean(d, dim=0)

    d = tree_map(delta, stacked, anchor)
    mu, lr = tcfg.outer_momentum, tcfg.outer_lr
    m = tree_map(lambda mm, dd: mu * mm + dd.float(), outer_state["m"], d)
    upd = tree_map(lambda mm, dd: lr * (mu * mm + dd.float()), m, d)
    return tree_map(lambda a, u: (a.float() + u).to(a.dtype), anchor, upd), m


def main(rank: int, root: str, device: str = "cpu"):
    """Rank ``rank`` of the world: ``device`` "cpu" (gloo) or "cuda" (nccl,
    card ``rank``)."""
    global DEVICE
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch.mesh import MeshShape, make_device_mesh

    DEVICE = torch.device("cpu") if device == "cpu" else torch.device("cuda", rank)
    if device != "cpu":
        torch.cuda.set_device(DEVICE)
    dist.init_process_group("gloo" if device == "cpu" else "nccl",
                            store=dist.FileStore(os.path.join(root, "store"), WORLD),
                            rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    with open(os.path.join(root, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    mesh = make_device_mesh(MeshShape(("data", "model"), (2, 2)), device=device)
    for arch in ("qwen3-8b", "phi3-medium-14b"):
        _sync_and_serve(arch, inp, mesh, out)
    _moe_paths(inp, mesh, out)
    _split_vocab_loss(inp, mesh, out)
    pod_mesh = make_device_mesh(MeshShape(("pod", "data", "model"), (2, 2, 1)), device=device)
    _local_sgd_and_outer(inp, pod_mesh, rank, out)
    if rank == 0:
        with open(os.path.join(root, "rank0.pkl"), "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp

    mp.start_processes(main, args=tuple(sys.argv[1:3]), nprocs=WORLD, start_method="spawn")
