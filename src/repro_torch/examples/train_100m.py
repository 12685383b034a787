"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps
with the full production stack (the port of ``examples/train_100m.py``):
the built train step on a ``DeviceMesh``, the local-update (FL-style)
outer sync, checkpointing and crash-resume, with the flash attention
(heads of 64) and SwiGLU kernels in every step on the card.

  PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300] [--device cpu]

The config is a 100M-scale qwen3-family model (12L, d=512), trained on the
synthetic Markov token stream; loss should fall from ~ln(V) toward the
stream's conditional entropy.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import repro_torch.launch.train as T
from repro_torch.configs import get_reduced
from repro_torch.launch.train import train


def lm_100m_cfg():
    cfg = get_reduced("qwen3-8b").replace(
        name="qwen3-100m",
        n_layers=12,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        d_ff=1536,
        vocab_size=4096,
        loss_chunk=0,
    )
    n = cfg.param_count()
    print(f"[train_100m] model: {cfg.name}, {n/1e6:.1f}M params")
    return cfg


def run(steps=200, batch=8, seq=128, *, ckpt_dir=None, ckpt_every=50, device=None):
    """``train()`` on ``lm_100m_cfg()`` with the local-update outer sync
    every 10 steps; the config is registered for the run by patching the
    trainer's ``get_reduced`` (and restored after), as the reference's
    script does."""
    cfg = lm_100m_cfg()
    orig_get_reduced = T.get_reduced
    T.get_reduced = lambda arch: cfg if arch == "qwen3-100m" else orig_get_reduced(arch)
    try:
        return train(
            "qwen3-100m",
            reduced=True,
            steps=steps,
            inner_steps=10,  # local-update outer sync every 10 steps
            batch=batch,
            seq=seq,
            ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every,
            log_every=20,
            device=device,
        )
    finally:
        T.get_reduced = orig_get_reduced


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    ckpt = tempfile.mkdtemp(prefix="edgefl_100m_")
    try:
        out = run(args.steps, args.batch, args.seq, ckpt_dir=ckpt, ckpt_every=50,
                  device=args.device)
        first = out["losses"][0]
        last = out["final_loss"]
        print(f"[train_100m] loss {first:.3f} -> {last:.3f} over {args.steps} steps")
        if not last < first - 0.5:
            raise AssertionError("loss must fall substantially")
        print("[train_100m] OK")
        return out
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
