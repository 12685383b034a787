"""One rank's cost of a traced step (the port's counterpart of
``repro/launch/hlo_analysis.py``, kept under its name so that a reader
finds it).

The reference reads per-chip FLOPs, bytes and collective bytes from XLA's
compiled per-device HLO, multiplying while-loop bodies by their trip
counts. The port has no HLO: eager torch runs one op at a time. So
``trace(fn, *args)`` records ``fn`` as an FX graph with ``make_fx`` on
``meta`` tensors (shapes and dtypes, no storage, nothing computed), and
``analyze_graph`` counts the graph:

- One rank. A sharded step is traced from its local shards: ``fn`` wraps
  them as DTensors (``DTensor.from_local``) itself, so DTensor's dispatch
  runs inside the trace and the graph holds what one rank runs: its
  shard-shaped aten ops and the collectives (``_c10d_functional`` and
  ``c10d`` ops) that redistribute them. (A ``FlopCounterMode`` above
  DTensor counts the global ops instead.) DTensor's sharding propagation
  runs on its own fake tensors and stays out of the graph; it reuses one
  fake mode for the whole trace, which it would otherwise make anew for
  every op.
- Loops. Python loops (the layer stack, microbatches) are traced unrolled:
  the counterpart of the reference's trip-count multiplication.
- The hand kernels. ``repro_torch::flash_attention`` and
  ``repro_torch::swiglu`` are leaves of the graph: on meta tensors they run
  their fake implementations, so the graph is the card's program (the
  kernels, not their CPU plain versions) on any host. Their FLOPs come
  from the formulas ``register_kernel_flops`` gives
  ``torch.utils.flop_counter``; their backward is plain torch and is
  traced as aten ops.

What is counted (every record's ``notes`` repeats the bytes rule):

- flops: the FLOP counter's formulas (matmuls, batched matmuls,
  convolutions) and the two kernels' (attention over every query-key
  pair, as the reference's jnp attention computes it; the kernel skips
  masked tiles). Elementwise FLOPs are not counted, as in the reference.
- bytes: each op's tensor inputs read once and outputs written once. Eager
  torch has no fusion, so this is the traffic of running the ops one by
  one, not the reference's fusion-boundary count. Views (outputs that
  alias an input without writing it, the collectives' waits among them)
  move nothing.
- collective_bytes: the payload (operand) bytes of each collective, by the
  reference's kind names (``COLLECTIVES``).
- peak_bytes: the largest sum of storages alive at once, a storage living
  from the op that makes it to its last use (graph inputs and outputs
  throughout); views and in-place results share their input's storage.
"""

from __future__ import annotations

import contextlib
import operator
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

BYTES_NOTE = ("bytes: each aten op's tensor inputs read once and outputs written once "
              "(eager torch, no fusion); views move nothing")

# the collectives the port issues -> (kind, index of their payload argument):
# DTensor's functional ones, and torch.distributed's (the optimizers' and
# the outer sync's sums and gathers, the MoE's all-to-all)
_COLLECTIVE_OPS = {
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "c10d._allgather_base_": ("all-gather", 1),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "c10d.alltoall_base_": ("all-to-all", 1),
}


@dataclass
class TraceCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    n_ops: int = 0
    peak_bytes: float = 0.0
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    flops_by_op: Dict[str, float] = field(default_factory=dict)


_REGISTERED: List[bool] = []


def register_kernel_flops() -> None:
    """FLOP formulas of the two kernels' custom ops (once per process):
    attention 2 * BH * Sq * Skv * (D + Dv) (q k^T and p v over every pair),
    SwiGLU 6 * M * d * F (its three products)."""
    if _REGISTERED:
        return
    import repro_torch.kernels.flash_attention  # noqa: F401  (defines the ops)
    import repro_torch.kernels.swiglu  # noqa: F401
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _flash_flop(q_shape, k_shape, v_shape, *args, out_shape=None, **kwargs):
        BH, Sq, D = q_shape
        Skv, Dv = v_shape[1], v_shape[2]
        return 2 * BH * Sq * Skv * (D + Dv)

    @register_flop_formula(torch.ops.repro_torch.swiglu)
    def _swiglu_flop(x_shape, wg_shape, *args, out_shape=None, **kwargs):
        M, d = x_shape
        return 6 * M * d * wg_shape[1]

    _REGISTERED.append(True)


def trace(fn: Callable, *args) -> torch.fx.GraphModule:
    """``fn(*args)`` as an FX graph of aten (and collective, and kernel)
    ops. ``args`` are tensors, ``meta`` ones for a step that would not fit
    on this host; ``fn`` runs once on them. A boolean mask (a decode
    step's write of the cache rows a rank holds) is traced as selecting
    every element: its size depends on the data, and this is the most the
    step can move."""
    import torch.fx.experimental._config as fx_config
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    register_kernel_flops()
    patch = (fx_config.patch(meta_nonzero_assume_all_nonzero=True)
             if hasattr(fx_config, "meta_nonzero_assume_all_nonzero") else contextlib.nullcontext())
    # one fake mode for DTensor's sharding propagation over the whole trace
    fake = tracing(TracingContext(FakeTensorMode(allow_non_fake_inputs=True)))
    with fake, patch:
        return make_fx(fn)(*args)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> list:
    return [t for t in torch.utils._pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


def _nodes(x) -> list:
    return [n for n in torch.utils._pytree.tree_leaves(x) if isinstance(n, torch.fx.Node)]


def _op_name(target) -> str:
    return str(target.overloadpacket) if isinstance(target, torch._ops.OpOverload) else str(target)


def _alias_arg(node) -> Optional[tuple]:
    """(argument, writes) if the op's output aliases one of its arguments
    (a view, a list of views such as ``split``'s, an in-place op, an out=
    op, a collective's wait), else None."""
    target = node.target
    if not isinstance(target, torch._ops.OpOverload):
        return None
    if _op_name(target) == "_c10d_functional.wait_tensor":  # returns its argument
        return node.args[0], False
    schema = target._schema
    for r in schema.returns:
        info = r.alias_info
        if info is None:
            continue
        for i, a in enumerate(schema.arguments):
            # a list of views (``Tensor(a)[]``) names its set on the elements
            if a.alias_info is not None and (a.alias_info.before_set & info.before_set
                                             or not info.before_set):
                arg = node.args[i] if i < len(node.args) else node.kwargs.get(a.name)
                return arg, bool(info.is_write)
    return None


def analyze_graph(gm: torch.fx.GraphModule, *, breakdown: bool = False) -> TraceCost:
    """One rank's FLOPs, bytes, collective bytes and peak live bytes of a
    graph from ``trace`` (see the module docstring)."""
    from torch.utils.flop_counter import flop_registry

    register_kernel_flops()
    cost = TraceCost()
    storage: Dict[torch.fx.Node, object] = {}  # node -> storage id, or a list of them
    size: Dict[int, int] = {}
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    pinned = set()
    nodes = list(gm.graph.nodes)

    def new(idx, val):
        sid = len(size)
        size[sid] = _nbytes(val)
        first[sid] = last[sid] = idx
        return sid

    def use(sids, idx):
        for sid in (sids if isinstance(sids, list) else [sids]):
            if sid is not None:
                last[sid] = max(last[sid], idx)

    for idx, node in enumerate(nodes):
        val = node.meta.get("val")
        if node.op == "placeholder":
            storage[node] = new(idx, val)
            pinned.add(storage[node])
            continue
        if node.op == "output":
            for n in _nodes(node.args):
                for sid in _flat_sids(storage.get(n)):
                    pinned.add(sid)
            continue
        if node.op != "call_function":
            continue
        for n in _nodes((node.args, node.kwargs)):
            use(_flat_sids(storage.get(n)), idx)
        if node.target is operator.getitem:
            parent = storage.get(node.args[0])
            storage[node] = parent[node.args[1]] if isinstance(parent, list) else parent
            continue
        cost.n_ops += 1
        alias = _alias_arg(node)
        name = _op_name(node.target)
        if alias is not None:
            arg, writes = alias
            base = _flat_sids(storage.get(arg) if isinstance(arg, torch.fx.Node) else
                              [storage.get(a) for a in _nodes(arg)])
            storage[node] = base[0] if len(base) == 1 else base
        elif isinstance(val, (list, tuple)):
            storage[node] = [new(idx, v) if isinstance(v, torch.Tensor) else None for v in val]
        else:
            storage[node] = new(idx, val) if isinstance(val, torch.Tensor) else None
        args_vals = torch.fx.node.map_arg((node.args, node.kwargs),
                                          lambda n: n.meta.get("val"))
        moved = 0
        if alias is None or alias[1]:
            moved = sum(_nbytes(t) for t in _tensors(args_vals)) + sum(
                _nbytes(t) for t in _tensors(val))
        cost.bytes += moved
        if isinstance(node.target, torch._ops.OpOverload):
            fn = flop_registry.get(node.target.overloadpacket)
            if fn is not None:
                f = float(fn(*args_vals[0], **args_vals[1], out_val=val))
                cost.flops += f
                if breakdown:
                    cost.flops_by_op[name] = cost.flops_by_op.get(name, 0.0) + f
        if breakdown:
            cost.bytes_by_op[name] = cost.bytes_by_op.get(name, 0.0) + moved
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            a = args_vals[0]
            payload = sum(_nbytes(t) for t in _tensors(a[kind[1]] if kind[1] < len(a) else ()))
            cost.collective_bytes[kind[0]] = cost.collective_bytes.get(kind[0], 0.0) + payload
    end = len(nodes)
    delta = [0] * (end + 1)
    for sid, n in size.items():
        delta[0 if sid in pinned else first[sid]] += n
        delta[end if sid in pinned else last[sid] + 1] -= n
    live = 0
    for d in delta:
        live += d
        cost.peak_bytes = max(cost.peak_bytes, float(live))
    return cost


def _flat_sids(s) -> list:
    if s is None:
        return []
    if isinstance(s, list):
        out = []
        for x in s:
            out.extend(_flat_sids(x))
        return out
    return [s]
