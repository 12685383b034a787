"""The paper's FL workload, a small MNIST CNN (the port of
``repro/models/cnn.py``).

Architecture: 2x(conv3x3 + relu + maxpool) -> dense 128 -> dense 10.
Layouts are the reference's at every public function: images NHWC, conv
kernels HWIO, params ``{conv1,conv2,fc1,fc2}/{w,b}``, so params and deltas
cross between the packages with no transposes. Gradients come from plain
autograd; only the max-pool carries its own backward, to keep the
reference's tie rule. The reference computes in full f32; the task in
``core/client.py`` runs the CNN under ``utils.f32_math`` on the card.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F


def cnn_init(generator: torch.Generator, num_classes: int = 10, device=None) -> Dict:
    """He-normal weights and zero biases, drawn on the CPU from ``generator``
    (so a seed gives the same params on every device), then moved to
    ``device`` (default: the CPU)."""

    def he(shape, fan_in):
        return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)

    params = {
        "conv1": {"w": he((3, 3, 1, 16), 9), "b": torch.zeros(16)},
        "conv2": {"w": he((3, 3, 16, 32), 144), "b": torch.zeros(32)},
        "fc1": {"w": he((32 * 7 * 7, 128), 32 * 49), "b": torch.zeros(128)},
        "fc2": {"w": he((128, num_classes), 128), "b": torch.zeros(num_classes)},
    }
    if device is None:
        return params
    return {k: {n: t.to(device) for n, t in v.items()} for k, v in params.items()}


class _MaxPool2x2(torch.autograd.Function):
    """2x2/stride-2 max-pool over [..., H, W, ch] whose backward sends the
    cotangent to the FIRST window element attaining the max, in row-major
    window order (XLA's SelectAndScatter rule, which the reference's
    ``reduce_window`` gradient and its stacked custom VJP both follow)."""

    @staticmethod
    def forward(ctx, x):
        a, b, c, d = _pool_parts(x)
        m = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
        ctx.save_for_backward(x, m)
        return m

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        a, b, c, d = _pool_parts(x)
        ea = a >= m
        eb = (b >= m) & ~ea
        ec = (c >= m) & ~ea & ~eb
        ed = (d >= m) & ~ea & ~eb & ~ec
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        dx = torch.empty_like(x)
        dx[..., 0::2, 0::2, :] = torch.where(ea, g, zero)
        dx[..., 0::2, 1::2, :] = torch.where(eb, g, zero)
        dx[..., 1::2, 0::2, :] = torch.where(ec, g, zero)
        dx[..., 1::2, 1::2, :] = torch.where(ed, g, zero)
        return dx


def _pool_parts(x):
    return (
        x[..., 0::2, 0::2, :],
        x[..., 0::2, 1::2, :],
        x[..., 1::2, 0::2, :],
        x[..., 1::2, 1::2, :],
    )


def maxpool2x2(x):
    """2x2/stride-2 max-pool over [..., H, W, ch] (first-max gradient)."""
    return _MaxPool2x2.apply(x)


def _conv(x, w, b):
    """3x3 SAME conv, NHWC input and HWIO kernel, through NCHW/OIHW."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1) + b


def cnn_apply(params, images):
    """images [B, 28, 28, 1] -> logits [B, 10]."""
    x = torch.relu(_conv(images, params["conv1"]["w"], params["conv1"]["b"]))
    x = maxpool2x2(x)
    x = torch.relu(_conv(x, params["conv2"]["w"], params["conv2"]["b"]))
    x = maxpool2x2(x)
    x = x.reshape(x.shape[0], -1)  # (h, w, c) order, as the reference flattens
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


def _nll_and_accuracy(logits, labels):
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    acc = (torch.argmax(logits, -1) == labels).float()
    return nll, acc


def cnn_loss(params, batch):
    """batch: {'images': [B,28,28,1], 'labels': [B]} -> (loss, metrics)."""
    nll, acc = _nll_and_accuracy(cnn_apply(params, batch["images"]), batch["labels"])
    loss = nll.mean()
    return loss, {"loss": loss, "accuracy": acc.mean()}


# ---------------------------------------------------------------------------
# Stacked-cohort forward: the batched FL engine's formulation.
#
# The same CNN evaluated for C clients at once, with a per-client leading
# axis on every parameter leaf. Convolution is im2col + one batched matmul
# with patch channels in (kh, kw, cin) order, the order of an HWIO kernel
# flattened to [9*cin, cout] — the reference's accumulation layout; another
# order drifts the training trajectory off the sequential engine's.
# ---------------------------------------------------------------------------


def _patches3x3(x):
    """[C, B, H, W, cin] -> [C, B, H, W, 9*cin], SAME padding, (kh, kw, cin)."""
    H, W = x.shape[2], x.shape[3]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, :, dy : dy + H, dx : dx + W, :] for dy in range(3) for dx in range(3)]
    return torch.cat(cols, dim=-1)


def _conv_stacked(x, w, b):
    """x [C,B,H,W,cin]; w [C,3,3,cin,cout] — per-client kernels as one
    batched GEMM over gathered patches."""
    C, B, H, W, _ = x.shape
    cout = w.shape[-1]
    p = _patches3x3(x).reshape(C, B * H * W, -1)
    out = torch.bmm(p, w.reshape(C, -1, cout)).reshape(C, B, H, W, cout)
    return out + b[:, None, None, None, :]


def cnn_apply_stacked(params, images):
    """Per-client params (leading axis C) applied to [C, B, 28, 28, 1]."""
    x = torch.relu(_conv_stacked(images, params["conv1"]["w"], params["conv1"]["b"]))
    x = maxpool2x2(x)
    x = torch.relu(_conv_stacked(x, params["conv2"]["w"], params["conv2"]["b"]))
    x = maxpool2x2(x)
    C, B = x.shape[:2]
    x = x.reshape(C, B, -1)
    x = torch.relu(torch.bmm(x, params["fc1"]["w"]) + params["fc1"]["b"][:, None, :])
    return torch.bmm(x, params["fc2"]["w"]) + params["fc2"]["b"][:, None, :]


def cnn_loss_stacked(params, batch):
    """Cohort loss: {'images': [C,B,...], 'labels': [C,B]} ->
    (per-client loss [C], per-client metrics)."""
    nll, acc = _nll_and_accuracy(
        cnn_apply_stacked(params, batch["images"]), batch["labels"]
    )
    loss = nll.mean(dim=-1)  # [C]
    return loss, {"loss": loss, "accuracy": acc.mean(dim=-1)}
