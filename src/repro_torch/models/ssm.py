"""Recurrent-family blocks: RWKV6 (Finch) and Mamba2 (SSD) (the port of
``repro/models/ssm.py``).

RWKV6's time mix carries the v6 hallmark, a *data-dependent decay* w_t
from a low-rank adapter, and the per-head bonus u. A sequence whose length
T > 1 is a multiple of ``ssm.chunk_len`` runs the chunked form (products
within a chunk, a state carried from chunk to chunk); any other length,
a decode step among them, runs the step-by-step recurrence. Both are the
reference's, in f32. The chunk's decay between positions t and s is the
exp of a difference of cumulative log decays, masked to s < t *before*
the exp: above the diagonal the difference is positive and overflows.

Mamba2 runs the SSD scalar-decay recurrence in chunks of
``min(chunk_len, T)`` (a T that is no multiple of it raises
``ValueError``): a quadratic form within a chunk and a state carried from
chunk to chunk. Its decay within a chunk is masked to s <= t before the exp
as well. The reference masks after the exp, so at a 128-step chunk the
exp overflows above the diagonal and its gradient, 0 * inf, is NaN; the
forward values are the same (ROADMAP Queue 3, C7). ``mamba2_decode`` is the
one-token step with an O(1) state.

Every contraction is written as a product of two operands (``matmul`` or
a broadcast multiply), so that no intermediate wider than the reference's
is materialized; the reference's scans over chunks are Python loops. On a mesh (DTensors)
``_mamba_head_constraint`` pins Mamba2's per-head tensors to batch over
"data" and heads over "model", as the reference's does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _heads
from repro_torch.models.base import Ctx, constrain, linear, per_batch_shard, rms_norm, silu

NEG_INF = -1e30


def _token_shift(x, last=None):
    """RWKV token shift: x_{t-1} (zeros, or the carried ``last``, at t = 0).
    x [B,T,d]."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


def rwkv6_params(ctx: Ctx, cfg, stacked: Optional[int] = None):
    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.ssm.head_dim
    H = d // hd
    lead = () if stacked is None else (stacked,)
    la = () if stacked is None else ("layers",)

    def v(shape, axes, **kw):
        return ctx.param(lead + shape, la + axes, **kw)

    return {
        "tm": {  # time mix
            "mu_r": v((d,), ("embed",), init="uniform", scale=0.5),
            "mu_k": v((d,), ("embed",), init="uniform", scale=0.5),
            "mu_v": v((d,), ("embed",), init="uniform", scale=0.5),
            "mu_g": v((d,), ("embed",), init="uniform", scale=0.5),
            "mu_w": v((d,), ("embed",), init="uniform", scale=0.5),
            "w_r": v((d, H, hd), ("embed", "heads", "head_dim")),
            "w_k": v((d, H, hd), ("embed", "heads", "head_dim")),
            "w_v": v((d, H, hd), ("embed", "heads", "head_dim")),
            "w_g": v((d, d), ("embed", "embed2")),
            "w_o": v((d, d), ("embed2", "embed")),
            "w0": v((d,), ("embed",), init="normal", scale=0.5),
            "w_lora_a": v((d, 64), ("embed", "lora")),
            "w_lora_b": v((64, d), ("lora", "embed")),
            "u": v((H, hd), ("heads", "head_dim"), init="normal", scale=0.5),
            "ln_scale": v((d,), ("embed",), init="ones"),
        },
        "cm": {  # channel mix
            "mu_k": v((d,), ("embed",), init="uniform", scale=0.5),
            "mu_r": v((d,), ("embed",), init="uniform", scale=0.5),
            "w_k": v((d, ff), ("embed", "ffn")),
            "w_v": v((ff, d), ("ffn", "embed")),
            "w_r": v((d, d), ("embed", "embed2")),
        },
    }


def _rwkv6_projections(cfg, p, x, last_x):
    """The projections shared by the chunked and the step-by-step paths.
    x [B,T,d] -> r, k, v [B,T,H,hd] and g [B,T,d] in x's dtype, log_w
    [B,T,H,hd] in f32 (in (-inf, 0))."""
    hd = cfg.ssm.head_dim
    B, T, d = x.shape
    H = d // hd
    xx = _token_shift(x, last_x)

    def mix(mu):
        return x + (xx - x) * mu.to(x.dtype)

    r = _heads(mix(p["mu_r"]), p["w_r"])
    k = _heads(mix(p["mu_k"]), p["w_k"])
    v = _heads(mix(p["mu_v"]), p["w_v"])
    g = silu(linear(mix(p["mu_g"]), p["w_g"]))
    # the data-dependent decay (the RWKV6 signature)
    w_dyn = linear(torch.tanh(linear(mix(p["mu_w"]), p["w_lora_a"])), p["w_lora_b"])
    log_w = -torch.exp(torch.clamp(p["w0"].float() + w_dyn.float(), -8.0, 4.0))
    return r, k, v, g, log_w.reshape(B, T, H, hd)


def rwkv6_time_mix(cfg, p, x, *, state=None, last_x=None):
    """The WKV6 recurrence. x [B,T,d] -> (y [B,T,d], (state, new last_x)).

    ``state`` [B,H,hd,hd] f32 maps the k dim to the v dim (zeros when
    None). T > 1 and a multiple of ``chunk_len`` take the chunked form, any
    other T the step-by-step recurrence."""
    hd = cfg.ssm.head_dim
    B, T, d = x.shape
    H = d // hd
    r, k, v, g, log_w = _rwkv6_projections(cfg, p, x, last_x)
    u = p["u"].float()
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)

    Lc = cfg.ssm.chunk_len
    if T > 1 and Lc > 1 and T % Lc == 0:
        wkv = lambda r, k, v, lw, S, u: _wkv6_chunked(r, k, v, lw, u, S, Lc)  # noqa: E731
    else:
        wkv = lambda r, k, v, lw, S, u: _wkv6_steps(r, k, v, lw, u, S)  # noqa: E731
    # independent per batch row: on a mesh each rank runs its rows
    state, y = per_batch_shard(wkv, (r, k, v, log_w, state), (u,), n_out=2)
    return _rwkv6_out(cfg, p, x, y.to(x.dtype), g), (state, x[:, -1:])


def _wkv6_steps(r, k, v, log_w, u, S):
    """The recurrence one step at a time, in f32:
    out_t = r_t (S + u <*> k_t (x) v_t), S <- w_t <*> S + k_t (x) v_t.
    r, k, v, log_w [B,T,H,hd]; S [B,H,hd,hd]. Returns (S, y [B,T,H*hd])."""
    B, T, H, hd = r.shape
    w = torch.exp(log_w)
    rf, kf, vf = r.float(), k.float(), v.float()
    outs = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # [B,H,hd,hd]
        out = torch.matmul(rf[:, t, :, None, :], S + u[None, :, :, None] * kv)  # [B,H,1,hd]
        outs.append(out[:, :, 0])
        S = w[:, t, :, :, None] * S + kv
    return S, torch.stack(outs, dim=1).reshape(B, T, H * hd)


def _wkv6_chunked(r, k, v, log_w, u, S, Lc):
    """The chunked WKV6: products within each chunk of ``Lc`` steps, the
    state carried from chunk to chunk, in f32.

    Every decay product is the exp of a difference of cumulative log
    decays (<= 0 where it is used, so nothing overflows), taken straight
    from ``log_w`` (no log(exp(.)) round trip: its 1/w gradient overflows
    for strong decays). r, k, v, log_w [B,T,H,hd]; u [H,hd]; S
    [B,H,hd,hd]. Returns (S, y [B,T,H*hd])."""
    B, T, H, hd = r.shape
    nC = T // Lc

    def chunks(a):  # [B,T,H,hd] -> [nC, B, H, Lc, hd]
        return a.float().reshape(B, nC, Lc, H, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = (chunks(a) for a in (r, k, v, log_w))
    below = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=r.device), diagonal=-1)
    outs = []
    for c in range(nC):
        rr, kk, vv, ll = rc[c], kc[c], vc[c], lwc[c]  # [B,H,Lc,hd]
        cum = torch.cumsum(ll, dim=2)  # inclusive
        cum_ex = cum - ll  # exclusive
        total = cum[:, :, -1:, :]  # [B,H,1,hd]

        # within the chunk: decay(t, s) = exp(cum_ex[t] - cum[s]) for s < t,
        # masked before the exp (above the diagonal it is positive)
        dqk = cum_ex[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,H,Lc,Lc,hd]
        dqk = torch.exp(torch.where(below[:, :, None], dqk, NEG_INF))
        tmp = dqk * rr[:, :, :, None, :]
        scores = torch.einsum("bhtsd,bhsd->bhts", tmp, kk)
        # the u bonus on the diagonal: r_t . (u <*> k_t)
        diag = torch.sum(rr * kk * u[None, :, None, :], dim=-1)  # [B,H,Lc]
        scores = scores + torch.diag_embed(diag)
        intra = torch.matmul(scores, vv)

        # from the entering state: r_t decayed to the chunk's start
        inter = torch.matmul(rr * torch.exp(cum_ex), S)

        # S' = exp(total) <*> S + sum_s k_s exp(total - cum[s]) (x) v_s
        k_dec = kk * torch.exp(total - cum)
        S = torch.exp(total).transpose(2, 3) * S + torch.matmul(k_dec.transpose(2, 3), vv)
        outs.append(intra + inter)
    y = torch.stack(outs, dim=0)  # [nC,B,H,Lc,hd]
    return S, y.permute(1, 0, 3, 2, 4).reshape(B, T, H * hd)


def _rwkv6_out(cfg, p, x, y, g):
    """Per-head group norm, gate and output projection."""
    hd = cfg.ssm.head_dim
    B, T, d = x.shape
    H = d // hd
    yh = rms_norm(y.reshape(B, T, H, hd), torch.ones((hd,), device=x.device), cfg.norm_eps)
    y = yh.reshape(B, T, d) * p["ln_scale"].to(x.dtype)
    return linear(y * g, p["w_o"])


def rwkv6_channel_mix(cfg, p, x, *, last_x=None):
    """relu(k)^2 channel mix. x [B,T,d] -> (y [B,T,d], new last_x)."""
    xx = _token_shift(x, last_x)

    def mix(mu):
        return x + (xx - x) * mu.to(x.dtype)

    k = torch.square(torch.relu(linear(mix(p["mu_k"]), p["w_k"])))
    r = torch.sigmoid(linear(mix(p["mu_r"]), p["w_r"]).float()).to(x.dtype)
    return r * linear(k, p["w_v"]), x[:, -1:]


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_params(ctx: Ctx, cfg, stacked: Optional[int] = None):
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.d_state
    lead = () if stacked is None else (stacked,)
    la = () if stacked is None else ("layers",)

    def v(shape, axes, **kw):
        return ctx.param(lead + shape, la + axes, **kw)

    return {
        "w_in": v((d, 2 * d_inner + 2 * s.d_state + H), ("embed", "ffn")),
        "conv_w": v((conv_dim, s.conv_kernel), ("ffn", "conv"), init="normal", scale=0.1),
        "conv_b": v((conv_dim,), ("ffn",), init="zeros"),
        "a_log": v((H,), ("heads",), init="uniform", scale=1.0),
        "dt_bias": v((H,), ("heads",), init="normal", scale=0.5),
        "d_skip": v((H,), ("heads",), init="ones"),
        "norm_scale": v((d_inner,), ("ffn",), init="ones"),
        "w_out": v((d_inner, d), ("ffn", "embed")),
    }


def _mamba2_split(cfg, p, x):
    """x [B,T,d] -> z [B,T,d_inner], xbc [B,T,d_inner + 2N], dt [B,T,H]."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    z, xbc, dt = torch.split(linear(x, p["w_in"]), [d_inner, d_inner + 2 * s.d_state, H], dim=-1)
    return z, xbc, dt, d_inner, H


def _causal_conv(xbc, w, b, conv_state=None):
    """Depthwise causal conv1d, then silu. xbc [B,T,C], w [C,K]; the carried
    ``conv_state`` [B,K-1,C] holds the K - 1 inputs before xbc (zeros when
    None). Returns (out [B,T,C], new state [B,K-1,C]). The K taps are
    summed in order in xbc's dtype, as the reference sums them."""
    K = w.shape[-1]
    T = xbc.shape[1]
    pad = torch.zeros_like(xbc[:, : K - 1]) if conv_state is None else conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # [B,T+K-1,C]
    out = xp[:, 0:T] * w[:, 0].to(xbc.dtype)
    for i in range(1, K):
        out = out + xp[:, i:i + T] * w[:, i].to(xbc.dtype)
    new_state = xp[:, -(K - 1):] if K > 1 else xbc[:, :0]
    return silu(out + b.to(xbc.dtype)), new_state


def _mamba2_out(cfg, p, x, y, z):
    """Gate by silu(z), RMSNorm and the output projection. y [B,T,d_inner]."""
    y = y.to(x.dtype) * silu(z)
    return linear(rms_norm(y, p["norm_scale"], cfg.norm_eps), p["w_out"])


def _mamba_head_constraint(cfg, t):
    """[B, T, H, ...] Mamba2 tensors: batch over "data", heads over "model"
    where each divides; the identity when activation sharding is off."""
    if not (cfg.act_shard_data and cfg.act_shard_model) or t.ndim < 3:
        return t
    B, H = t.shape[0], t.shape[2]
    b = 0 if B % cfg.act_shard_data == 0 else None
    h = 2 if H % cfg.act_shard_model == 0 else None
    if b is None and h is None:
        return t
    return constrain(t, {"data": b, "model": h})


def mamba2_forward(cfg, p, x, *, state=None, conv_state=None):
    """The chunked SSD. x [B,T,d] -> (y [B,T,d], (ssm state [B,H,N,hd] f32,
    conv state [B,K-1,C])). Chunks of ``min(chunk_len, T)`` steps; T must
    be a multiple of that."""
    s = cfg.ssm
    B, T, d = x.shape
    z, xbc, dt, d_inner, H = _mamba2_split(cfg, p, x)
    hd, N = s.head_dim, s.d_state
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    xs = _mamba_head_constraint(cfg, xs.reshape(B, T, H, hd))
    dt = _mamba_head_constraint(cfg, F.softplus(dt.float() + p["dt_bias"].float()))  # [B,T,H]
    A = -torch.exp(p["a_log"].float())  # [H], negative
    Lc = min(s.chunk_len, T)
    if T % Lc:
        raise ValueError(f"mamba2_forward: T={T} is not a multiple of the chunk {Lc}")
    if state is None:
        state = torch.zeros((B, H, N, hd), dtype=torch.float32, device=x.device)
    # independent per batch row: on a mesh each rank runs its rows
    y, state = per_batch_shard(lambda *a: _ssd_chunked(*a, Lc), (xs, Bm, Cm, dt, state), (A,),
                               n_out=2)
    y = y + p["d_skip"].float()[None, None, :, None] * xs
    return _mamba2_out(cfg, p, x, y.reshape(B, T, d_inner), z), (state, new_conv)


def _ssd_chunked(xs, Bm, Cm, dt, state, A, Lc):
    """Mamba2's chunked SSD in f32: xs [B,T,H,hd], Bm / Cm [B,T,N], dt
    [B,T,H] (softplus'd), state [B,H,N,hd], A [H] -> (y [B,T,H,hd], the
    state after the last chunk)."""
    B, T, H, hd = xs.shape
    N = Bm.shape[-1]
    nC = T // Lc
    dA = dt * A  # [B,T,H] log decay per step
    xs_c = xs.float().reshape(B, nC, Lc, H, hd)
    B_c = Bm.float().reshape(B, nC, Lc, N)
    C_c = Cm.float().reshape(B, nC, Lc, N)
    dt_c = dt.reshape(B, nC, Lc, H)
    cum = torch.cumsum(dA.reshape(B, nC, Lc, H), dim=2)  # inclusive log decay

    # within a chunk: the causal decay, masked before the exp (C7)
    decay_qk = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nC,Lt,Ls,H]
    causal = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=xs.device))
    Lmask = torch.exp(torch.where(causal[:, :, None], decay_qk, NEG_INF))
    scores = torch.matmul(C_c, B_c.transpose(-1, -2))  # [B,nC,Lt,Ls]
    w_ts = scores[..., None] * Lmask * dt_c[:, :, None, :, :]  # [B,nC,Lt,Ls,H]
    y_intra = torch.matmul(w_ts.permute(0, 1, 4, 2, 3),  # [B,nC,H,Lt,Ls]
                           xs_c.permute(0, 1, 3, 2, 4))  # [B,nC,H,Ls,hd]
    y_intra = y_intra.permute(0, 1, 3, 2, 4)  # [B,nC,Lt,H,hd]

    # each chunk's own state: sum_s exp(cum_end - cum_s) dt_s B_s (x) x_s
    coef = torch.exp(cum[:, :, -1:, :] - cum) * dt_c  # [B,nC,Ls,H]
    xw = (xs_c * coef[..., None]).reshape(B, nC, Lc, H * hd)
    Sc = torch.matmul(B_c.transpose(-1, -2), xw).reshape(B, nC, N, H, hd).transpose(2, 3)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B,nC,H]

    S_in = []  # the state entering each chunk
    for c in range(nC):
        S_in.append(state)
        state = state * chunk_decay[:, c, :, None, None] + Sc[:, c]
    S_in = torch.stack(S_in, dim=1)  # [B,nC,H,N,hd]

    # from the entering state: C_t . S_in, decayed from the chunk's start
    y_inter = torch.matmul(C_c, S_in.permute(0, 1, 3, 2, 4).reshape(B, nC, N, H * hd))
    y_inter = y_inter.reshape(B, nC, Lc, H, hd) * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(B, T, H, hd), state


def mamba2_decode(cfg, p, x, state, conv_state):
    """One token. x [B,1,d]; state [B,H,N,hd]; conv_state [B,K-1,C]."""
    s = cfg.ssm
    B = x.shape[0]
    z, xbc, dt, d_inner, H = _mamba2_split(cfg, p, x)
    hd, N = s.head_dim, s.d_state
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    xs = xs.reshape(B, H, hd).float()
    Bm, Cm = Bm[:, 0].float(), Cm[:, 0].float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # [B,H]
    dec = torch.exp(dt * -torch.exp(p["a_log"].float()))  # [B,H]
    S_new = state * dec[..., None, None] + (dt[:, :, None, None] * Bm[:, None, :, None]
                                            * xs[:, :, None, :])
    y = torch.matmul(Cm[:, None, None, :], S_new)[:, :, 0]  # [B,H,hd]
    y = y + p["d_skip"].float()[None, :, None] * xs
    return _mamba2_out(cfg, p, x, y.reshape(B, 1, d_inner), z), (S_new, new_conv)
