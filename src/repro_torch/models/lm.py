"""Decoder-LM assembly for training and serving (the port of
``repro/models/lm.py``).

The layer stack is organized as *segments*, runs of structurally identical
blocks whose params are stacked on a leading layer axis, as in the
reference; the port runs a segment as a Python loop over layers and takes
each stacked leaf apart with one ``unbind`` (whose backward stacks the
layers' gradients once). The GQA blocks (full or sliding-window) and the
MLA blocks (DeepSeek-V2) are ported, with RMSNorm or LayerNorm and a
SwiGLU or GELU MLP or a mixture of experts (after ``first_k_dense`` dense
blocks of ``dense_d_ff``, each kind a segment of its own); each block
returns its router's load-balance loss, summed over the layers, and
``lm_loss`` adds ``router_aux_weight * aux / n_layers``. An RWKV6 config
is one segment of RWKV blocks (``models.ssm``'s time mix and channel mix,
each after a norm); its cache holds each layer's f32 state ``S`` and the
last input of each mix (``tm_x``, ``cm_x``). A config with a Mamba2
``ssm`` and no ``hybrid`` is a plain dense model, as the reference builds
it (the hybrid family is ``models.hybrid``).

The vision stub (Phi-3-vision) prepends ``patch_embed @ patch_proj`` to the
token embeddings; the patch positions carry no loss. ``lm_prefill`` sets
each cache's ``pos`` to the length it prefilled, patches included, so the
first decode step writes and ropes at P + S. The reference sets ``pos`` to
the token count S, so its first decode step after P patches overwrites a
live cache slot and ropes the query P positions early (ROADMAP Queue 3,
C6); the two agree wherever there are no patches.

Training differentiates ``lm_loss`` with autograd. ``cfg.remat`` is the
reference's ``_remat`` per block, through ``torch.utils.checkpoint``:
"none" keeps every activation; "full" saves nothing, so the block's forward
runs again in the backward pass; "block" (the default) saves what
``dots_with_no_batch_dims_saveable`` saves, the outputs of the products
without a batch dimension: here the 2-D ``aten.mm``s (the q / k / v / o
projections, the router, the MoE's one-hot dispatch and combine) and the
SwiGLU kernel's output (its three products are such dots in the
reference's ``mlp_forward``); an MLA block's six projections are such
products too. The attention core, the experts' batched
products and the norms are recomputed, so under "block" the flash kernel
launches twice per layer and step and the SwiGLU kernel once; under
"full" both twice. Values are the same at every setting.

On a mesh the loss keeps the unembedding's vocab split over "model", as
the reference's partitioner keeps its logits split on "vocab": each rank
holds its f32 logits shard of a chunk, and the cross entropy's row max,
sum of exp, target logit and argmax are reduced over "model" alone
(``_loss_sharded``); no rank holds a row of the whole vocab.

Caches are updated IN PLACE: ``lm_prefill`` and ``lm_decode_step`` return
the cache they were given (or built), written through, where the
reference returns an updated copy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import functools

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.base import (
    Ctx, _matmul_sharded, apply_norm, dtype_of, embed_lookup, like_shards, linear, norm_params,
    seq_constraint, shard_view,
)
from repro_torch.utils import tree_unstack


# ---------------------------------------------------------------------------
# Segment layout
# ---------------------------------------------------------------------------


def segments(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Return [(block_kind, count), ...] covering cfg.n_layers. As in the
    reference, the frontend plays no part here (an ``audio_stub`` config
    in this family embeds its tokens only), and every attention kind but
    "mla" builds GQA blocks."""
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return [("rwkv", cfg.n_layers)]
    if cfg.moe is not None and cfg.moe.num_experts > 0:
        k = cfg.moe.first_k_dense
        return ([("dense", k)] if k else []) + [("moe", cfg.n_layers - k)]
    return [("dense", cfg.n_layers)]


def _block_params(ctx: Ctx, cfg: ModelConfig, kind: str, count: int):
    if kind == "rwkv":
        return {
            "ln1": norm_params(ctx, cfg, cfg.d_model, stacked=count),
            "ln2": norm_params(ctx, cfg, cfg.d_model, stacked=count),
            "body": ssm_mod.rwkv6_params(ctx, cfg, stacked=count),
        }
    p = {
        "ln1": norm_params(ctx, cfg, cfg.d_model, stacked=count),
        "ln2": norm_params(ctx, cfg, cfg.d_model, stacked=count),
        "attn": (attn.mla_params if cfg.attn_kind == "mla" else attn.gqa_params)(
            ctx, cfg, stacked=count),
    }
    if kind == "moe":
        p["mlp"] = mlp_mod.moe_params(ctx, cfg, stacked=count)
    else:
        d_ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.dense_d_ff:
            d_ff = cfg.moe.dense_d_ff
        p["mlp"] = mlp_mod.mlp_params(ctx, cfg, d_ff=d_ff, stacked=count)
    return p


def _block_apply(cfg, kind, p, x, cache, *, decode, positions):
    """One block. Returns (x, new_cache, aux); aux is None for a dense or
    RWKV block (the reference's 0). The residual stream enters under
    ``seq_constraint``, as the reference's segment body pins it."""
    x = seq_constraint(cfg, x)
    if kind == "rwkv":
        return _rwkv_block(cfg, p, x, cache)
    h = apply_norm(cfg, x, p["ln1"])
    forward = attn.mla_forward if cfg.attn_kind == "mla" else attn.gqa_forward
    y, new_cache = forward(cfg, p["attn"], h, positions=positions, cache=cache, decode=decode)
    x = x + y
    h = apply_norm(cfg, x, p["ln2"])
    aux = None
    if kind == "moe":
        y, aux = mlp_mod.moe_forward(cfg, p["mlp"], h)
    else:
        y = mlp_mod.mlp_forward(cfg, p["mlp"], h)
    return x + y, new_cache, aux


def _rwkv_block(cfg, p, x, cache):
    """Time mix and channel mix, each after a norm. ``cache`` (or None)
    holds S [B,H,hd,hd] f32 and the mixes' last inputs tm_x, cm_x [B,1,d];
    the new ones come back in a new dict."""
    state, tm_x, cm_x = (None, None, None) if cache is None else (
        cache["S"], cache["tm_x"], cache["cm_x"])
    h = apply_norm(cfg, x, p["ln1"])
    y, (state, tm_x) = ssm_mod.rwkv6_time_mix(cfg, p["body"]["tm"], h, state=state, last_x=tm_x)
    x = x + y
    h = apply_norm(cfg, x, p["ln2"])
    y, cm_x = ssm_mod.rwkv6_channel_mix(cfg, p["body"]["cm"], h, last_x=cm_x)
    new_cache = None if cache is None else {"S": state, "tm_x": tm_x, "cm_x": cm_x}
    return x + y, new_cache, None


def _saved_under_block(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="block"``: keep the
    outputs of the products without a batch dimension (see the module
    docstring), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.repro_torch.swiglu.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(cfg):
    if cfg.remat == "full":
        return {}
    return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                            _saved_under_block)}


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _write_back(stacked, index, view, new):
    """Copy into ``stacked[index]`` the leaves of ``new`` that are not the
    leaves of ``view`` (``_index(stacked, index)``, which the block was
    given): a block fills its cache views in place and returns new tensors
    for what it replaces, such as decode's ``pos``."""
    idx = index if isinstance(index, tuple) else (index,)
    n = len(idx)
    for key, val in new.items():
        if val is not view[key]:
            local, off = shard_view(stacked[key])
            assert not any(off[:n]), "the stacked layer dims are never split"
            whole = val.reshape((1,) * n + tuple(val.shape))
            with torch.no_grad():
                local[idx] = like_shards(whole, stacked[key], range(n, n + val.ndim))[(0,) * n]


def _run_segment(cfg, kind, params, x, caches, *, decode, positions):
    """Run one segment layer by layer; returns (x, caches, aux summed over
    its layers, None for a dense segment). ``caches`` (stacked by layer,
    or None) is written in place: each layer's view is filled by the
    block, and a leaf the block replaces (decode's ``pos``) is copied back.
    Without caches, under autograd and ``cfg.remat != "none"``, each block
    is checkpointed (see the module docstring)."""
    layers = tree_unstack(params)
    remat = caches is None and cfg.remat != "none" and torch.is_grad_enabled()
    aux_total = None
    for i, layer_p in enumerate(layers):
        if remat:
            x, aux = checkpoint(_block_train, cfg, kind, layer_p, x, positions,
                                use_reentrant=False, **_remat_kwargs(cfg))
        else:
            layer_cache = _index(caches, i) if caches is not None else None
            x, new_cache, aux = _block_apply(cfg, kind, layer_p, x, layer_cache,
                                             decode=decode, positions=positions)
            if caches is not None:
                _write_back(caches, i, layer_cache, new_cache)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, caches, aux_total


def _block_train(cfg, kind, p, x, positions):
    x, _, aux = _block_apply(cfg, kind, p, x, None, decode=False, positions=positions)
    return x, aux


# ---------------------------------------------------------------------------
# Whole-model params / forward
# ---------------------------------------------------------------------------


def lm_params(ctx: Ctx, cfg: ModelConfig):
    V, d = cfg.padded_vocab, cfg.d_model
    p: Dict[str, Any] = {
        "embed": ctx.param((V, d), ("vocab", "embed"), init="normal", scale=0.02),
        "final_norm": norm_params(ctx, cfg, d),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = ctx.param((d, V), ("embed", "vocab"))
    if cfg.frontend == "vision_stub":
        p["patch_proj"] = ctx.param((d, d), ("embed", "embed2"))
    for i, (kind, count) in enumerate(segments(cfg)):
        p[f"seg{i}"] = _block_params(ctx, cfg, kind, count)
    return p


def _embed_inputs(cfg, params, batch):
    """Token (and, for the vision stub, patch) embedding. Returns x
    [B, P + S, d] in the activation dtype, the P patches first."""
    tokens = batch["tokens"].long()
    x = embed_lookup(params["embed"], tokens).to(dtype_of(cfg.dtype))
    if cfg.frontend == "vision_stub" and "patch_embed" in batch:
        patches = linear(batch["patch_embed"].to(x.dtype), params["patch_proj"])
        x = torch.cat([patches, x], dim=1)
    return x


def lm_forward(cfg, params, batch, *, caches=None, decode=False):
    """Returns (hidden [B,S,d], caches, aux f32 scalar); caches are written
    in place."""
    x = _embed_inputs(cfg, params, batch)
    B, S, _ = x.shape
    positions = None if decode else torch.arange(S, device=x.device)[None, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, count) in enumerate(segments(cfg)):
        seg_cache = caches.get(f"seg{i}") if caches is not None else None
        x, _, aux = _run_segment(cfg, kind, params[f"seg{i}"], x, seg_cache, decode=decode,
                                 positions=positions)
        if aux is not None:
            aux_total = aux_total + aux
    x = apply_norm(cfg, x, params["final_norm"])
    return x, caches, aux_total


def _unembed_weight(cfg, params, dtype):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return w.to(dtype)


def _logits(h, w):
    """h [..., d] @ w [d, V] -> f32 logits, summed in f32; w in h's dtype,
    or in f32 (the sharded loss's weight, upcast once for every chunk).

    A bf16 product on the card takes ``torch.mm(..., out_dtype=float32)``,
    so the logits are not rounded to bf16 and the unembedding is never
    copied to f32. That call has no CPU kernel and no derivative, so on the
    CPU, and under autograd, both operands are upcast instead (exact: bf16
    products are exact in f32). A ``meta`` tensor (the dry-run's) takes the
    card's path."""
    if isinstance(h, DTensor):  # each rank's shards (DTensor has no f32-output product)
        return _matmul_sharded(h, w, local=_logits)
    h2 = h.reshape(-1, h.shape[-1])
    if w.dtype == torch.float32:
        out = torch.mm(h2.float(), w)
    elif h.device.type != "cpu" and not (torch.is_grad_enabled()
                                         and (h.requires_grad or w.requires_grad)):
        out = torch.mm(h2, w, out_dtype=torch.float32)
    else:
        out = torch.mm(h2.float(), w.float())
    return out.reshape(*h.shape[:-1], w.shape[-1])


def unembed(cfg, params, h):
    """h [..., d] -> f32 logits [..., V], summed in f32."""
    return _logits(h, _unembed_weight(cfg, params, h.dtype))


def _xent(logits, targets, mask):
    """Summed masked NLL, mask count and correct count of f32 logits (a
    mesh's loss: ``_loss_sharded``)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None]).squeeze(-1)
    nll = (lse - gold) * mask
    correct = (torch.argmax(logits, -1) == targets).float() * mask
    return torch.sum(nll), torch.sum(mask), torch.sum(correct)


def _all_reduce(t, op, group):
    import torch.distributed._functional_collectives as funcol

    out = funcol.all_reduce(t, op, group)
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) else out


class _SplitVocabXent(torch.autograd.Function):
    """Per-position masked NLL and correct flags of f32 logits [..., Vl]
    holding the vocab columns ``first .. first + Vl`` of a vocab split over
    ``group`` (None: the whole vocab). Over the group go the row max, the
    sum of exp(logit - max), the target's logit (0 off the rank that owns
    its column) and the argmax, ties to the lowest global column as
    ``torch.argmax``'s. The backward is local: (softmax - one-hot(target))
    times the mask and the upstream gradient, on this rank's columns."""

    @staticmethod
    def forward(ctx, logits, targets, mask, group, first):
        idx = targets - first
        own = (idx >= 0) & (idx < logits.shape[-1])
        idx = torch.where(own, idx, 0)
        top = torch.amax(logits, dim=-1)
        arg = torch.argmax(logits, dim=-1)
        big = top if group is None else _all_reduce(top, "max", group)
        e = (logits - big[..., None]).exp_()
        s = torch.sum(e, dim=-1)
        gold = torch.where(own, torch.gather(logits, -1, idx[..., None]).squeeze(-1), 0.0)
        if group is not None:
            s = _all_reduce(s, "sum", group)
            gold = _all_reduce(gold, "sum", group)
            arg = torch.where(top == big, arg + first, torch.iinfo(arg.dtype).max)
            arg = _all_reduce(arg, "min", group)
        nll = (torch.log(s) + big - gold) * mask
        correct = (arg == targets).float() * mask
        e.div_(s[..., None])  # the softmax, kept for the backward
        ctx.save_for_backward(e, idx, own, mask)
        ctx.mark_non_differentiable(correct)
        return nll, correct

    @staticmethod
    def backward(ctx, g_nll, g_correct):
        p, idx, own, mask = ctx.saved_tensors
        w = g_nll * mask
        d = p * w[..., None]
        d.scatter_add_(-1, idx[..., None], torch.where(own, -w, 0.0)[..., None])
        return d, None, None, None, None


def _loss_sharded(h, w, targets, mask, chunk: int):
    """``loss_from_hidden``'s three sums on DTensors, each rank on its
    shards under ``local_map`` (no DTensor rule picks a layout): the
    unembedding keeps its vocab split and is whole on every other mesh axis;
    h, the targets and the mask keep their batch split and are whole on the
    vocab's axis. Each rank upcasts its unembedding shard to f32 once, then
    per chunk of ``chunk`` positions computes its logits shard [b, chunk,
    V / model] in f32 and ``_SplitVocabXent`` over the vocab's axis, so no
    rank holds a row of the whole vocab and the gradients stay on the
    shards: h's a partial sum over the vocab's axis, the unembedding's over
    the batch's, each reduced once after the last chunk. The sums come
    out partial over the batch's axes."""
    from torch.distributed.tensor.experimental import local_map

    mesh = h.device_mesh
    rep = [Replicate()] * mesh.ndim
    w, targets, mask = (t if isinstance(t, DTensor) else DTensor.from_local(t, mesh, rep)
                        for t in (w, targets, mask))
    h_pl, w_pl, o_pl, hg, wg, vocab = [], [], [], [], [], None
    for i, (hp, wp) in enumerate(zip(h.placements, w.placements)):
        if wp.is_shard(1):
            vocab = i
            h_pl.append(Replicate()), w_pl.append(wp), o_pl.append(Replicate())
            hg.append(Partial()), wg.append(wp)
        elif hp.is_shard(0):
            h_pl.append(hp), w_pl.append(Replicate()), o_pl.append(Partial())
            hg.append(hp), wg.append(Partial())
        else:
            for lst in (h_pl, w_pl, o_pl, hg, wg):
                lst.append(Replicate())
    group, first = None, 0
    if vocab is not None and mesh.size(vocab) > 1:
        group = mesh.get_group(vocab)
        first = mesh.get_local_rank(vocab) * (w.shape[1] // mesh.size(vocab))

    def local(h, w, t, m):
        w = w.float()
        tot = None
        for c in range(t.shape[1] // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            nll, correct = _SplitVocabXent.apply(_logits(h[:, sl], w), t[:, sl], m[:, sl],
                                                 group, first)
            sums = (torch.sum(nll), torch.sum(m[:, sl]), torch.sum(correct))
            tot = sums if tot is None else tuple(a + b for a, b in zip(tot, sums))
        return tot

    t_pl = tuple(h_pl)
    h_pl, w_pl, o_pl, hg, wg = (tuple(x) for x in (h_pl, w_pl, o_pl, hg, wg))
    h, w = h.redistribute(mesh, h_pl), w.redistribute(mesh, w_pl)
    targets, mask = targets.redistribute(mesh, t_pl), mask.redistribute(mesh, t_pl)
    return local_map(local, out_placements=(o_pl, o_pl, o_pl),
                     in_placements=(h_pl, w_pl, t_pl, t_pl),
                     in_grad_placements=(hg, wg, t_pl, t_pl), device_mesh=mesh)(
        h, w, targets, mask)


def loss_from_hidden(cfg, params, h, batch):
    """Cross entropy on hidden states, over vocab chunks of
    ``cfg.loss_chunk`` sequence positions when that divides the target
    length and is shorter. Returns (loss, metrics); the chunks' sums are
    accumulated in order, as the reference's scan does."""
    targets = batch["targets"].long()
    mask = batch.get("loss_mask")
    B, S, d = h.shape
    St = targets.shape[1]
    if St < S:  # vlm: patch prefix carries no loss
        h = h[:, S - St:]
    mask = torch.ones(targets.shape, dtype=torch.float32, device=h.device) if mask is None \
        else mask.float()
    w = _unembed_weight(cfg, params, h.dtype)

    chunk = cfg.loss_chunk
    chunked = chunk and St % chunk == 0 and St > chunk
    if isinstance(h, DTensor):
        tot, cnt, corr = _loss_sharded(h, w, targets, mask, chunk if chunked else St)
    elif chunked:
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        tot, cnt, corr = zero, zero, zero
        for c in range(St // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            n, m, k = _xent(_logits(h[:, sl], w), targets[:, sl], mask[:, sl])
            tot, cnt, corr = tot + n, cnt + m, corr + k
    else:
        tot, cnt, corr = _xent(_logits(h, w), targets, mask)

    denom = torch.clamp(cnt, min=1.0)
    loss = tot / denom
    return loss, {"loss": loss, "accuracy": corr / denom}


def lm_loss(cfg, params, batch):
    """Full LM training loss (forward + chunked cross entropy + MoE aux)."""
    h, _, aux = lm_forward(cfg, params, batch)
    loss, metrics = loss_from_hidden(cfg, params, h, batch)
    if cfg.moe is not None and cfg.moe.num_experts:
        loss = loss + cfg.moe.router_aux_weight * aux / max(cfg.n_layers, 1)
    return loss, dict(metrics, loss=loss, aux=aux)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------


def rwkv_cache_init(cfg, batch: int, count: int, device=None):
    """The stacked-by-layer RWKV cache: S [L,B,H,hd,hd] f32, tm_x and cm_x
    [L,B,1,d] in the activation dtype, all zeros."""
    hd, d = cfg.ssm.head_dim, cfg.d_model
    dt = dtype_of(cfg.dtype)
    return {
        "S": torch.zeros((count, batch, d // hd, hd, hd), dtype=torch.float32, device=device),
        "tm_x": torch.zeros((count, batch, 1, d), dtype=dt, device=device),
        "cm_x": torch.zeros((count, batch, 1, d), dtype=dt, device=device),
    }


def lm_cache(cfg, batch: int, max_len: int, device=None):
    """Each segment's cache by block kind (the reference's
    ``_seg_cache_init``)."""
    def init(kind, count):
        if kind == "rwkv":
            return rwkv_cache_init(cfg, batch, count, device=device)
        make = attn.mla_cache_init if cfg.attn_kind == "mla" else attn.gqa_cache_init
        return make(cfg, batch, max_len, count, device=device)

    return {f"seg{i}": init(kind, count) for i, (kind, count) in enumerate(segments(cfg))}


def lm_prefill(cfg, params, batch, max_len: int, caches=None):
    """Run the prompt, fill caches, return (last_logits [B,V] f32, caches).
    ``pos`` becomes the prefilled length, patches included (C6). ``caches``
    (empty, e.g. sharded over a mesh) is filled in place; by default a new
    one is made on the params' device."""
    B = batch["tokens"].shape[0]
    if caches is None:
        caches = lm_cache(cfg, B, max_len, device=params["embed"].device)
    h, caches, _ = lm_forward(cfg, params, batch, caches=caches)
    for c in caches.values():
        if "pos" in c:  # an RWKV cache has none
            with torch.no_grad():
                shard_view(c["pos"])[0].fill_(h.shape[1])
    logits = unembed(cfg, params, h[:, -1:])[:, 0]
    return logits, caches


def lm_decode_step(cfg, params, caches, tokens):
    """tokens [B,1] -> (logits [B,V] f32, caches updated in place)."""
    h, caches, _ = lm_forward(cfg, params, {"tokens": tokens}, caches=caches, decode=True)
    logits = unembed(cfg, params, h)[:, 0]
    return logits, caches
