"""Batched serving driver: prefill + greedy decode with a request queue
(the port of ``repro/launch/serve.py``).

``Server`` takes the reference's arguments plus ``device`` (CUDA unless the
caller names one). Its loop is the reference's, step for step: a static
batch of ``batch`` requests, prompts left-padded with token 0 to a common
length of at least 8 with no pad mask (pads are attended to, as in the
reference), the prefill's greedy token appended before each decode step,
and at most ``max_len - S - 1`` steps. On the card every prefill runs the
flash-attention and SwiGLU kernels once per layer, and every decode step
the SwiGLU kernel once per layer.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models import Model
from repro_torch.utils import resolve_device


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new: int = 16
    generated: List[int] = field(default_factory=list)
    done: bool = False


class Server:
    """Greedy-decoding batch server. Params are drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``; a caller may
    set ``server.params`` to carried-across params instead."""

    def __init__(self, arch: str, *, reduced: bool = True, batch: int = 4,
                 max_len: int = 128, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = get_reduced(arch) if reduced else get_config(arch)
        self.model = Model(self.cfg)
        self.params = self.model.init(torch.Generator(device=self.device).manual_seed(seed))
        self.batch = batch
        self.max_len = max_len
        self._prefill = lambda p, b: self.model.prefill(p, b, max_len)
        self._decode = self.model.decode_step

    def run(self, requests: List[Request]) -> List[Request]:
        queue = list(requests)
        done: List[Request] = []
        while queue:
            active = queue[: self.batch]
            queue = queue[self.batch :]
            # pad prompts to a common length
            S = max(len(r.prompt) for r in active)
            S = max(S, 8)
            toks = np.zeros((self.batch, S), np.int32)
            for i, r in enumerate(active):
                toks[i, S - len(r.prompt):] = r.prompt  # left-pad
            batch = {"tokens": torch.from_numpy(toks).to(self.device)}
            logits, cache = self._prefill(self.params, batch)
            cur = torch.argmax(logits, -1)[:, None].to(torch.int32)
            max_new = max(r.max_new for r in active)
            for _ in range(min(max_new, self.max_len - S - 1)):
                cur_host = cur.cpu().numpy()
                for i, r in enumerate(active):
                    if not r.done and len(r.generated) < r.max_new:
                        r.generated.append(int(cur_host[i, 0]))
                    elif not r.done:
                        r.done = True
                if all(r.done or len(r.generated) >= r.max_new for r in active):
                    break
                logits, cache = self._decode(self.params, cache, cur)
                cur = torch.argmax(logits, -1)[:, None].to(torch.int32)
            for r in active:
                r.done = True
                done.append(r)
        return done


def example_requests(vocab_size: int, n: int = 8, max_new: int = 12) -> List[Request]:
    """``main``'s traffic: ``n`` prompts of 4-15 tokens drawn with
    ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [
        Request(i, rng.integers(0, vocab_size, size=rng.integers(4, 16)).astype(np.int32),
                max_new=max_new)
        for i in range(n)
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    args = ap.parse_args()

    server = Server(args.arch)
    reqs = example_requests(server.cfg.vocab_size, args.requests, args.max_new)
    t0 = time.time()
    done = server.run(reqs)
    dt = time.time() - t0
    n_tok = sum(len(r.generated) for r in done)
    print(f"[serve] {len(done)} requests, {n_tok} tokens in {dt:.1f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s on {server.device})")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.generated[:8]}...")


if __name__ == "__main__":
    main()
