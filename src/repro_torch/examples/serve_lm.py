"""Batched serving example: continuous batching with KV-cache slots.

Port of ``examples/serve_lm.py``.  Trains nothing: seeds random weights
for a small decoder (the arch's reduced config) and serves a burst of
requests through the slot-based engine (``serve/engine.py``), on the card
unless ``--device cpu`` is given.

    python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_lm",
        description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[Request]:
    """Serves the burst; returns the finished requests."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    model = T.init_params(cfg, seed=0, device=device)
    engine = ServeEngine(cfg, model, slots=args.slots, max_len=128,
                         device=device)

    rng = np.random.default_rng(1)
    reqs = [Request(rid=rid, prompt=rng.integers(0, cfg.vocab, 8).tolist(),
                    max_new=args.max_new,
                    temperature=0.8 if rid % 2 else 0.0)
            for rid in range(args.requests)]
    for r in reqs:
        engine.submit(r)

    t0 = time.time()
    steps = 0
    while engine.queue or any(a is not None for a in engine.active):
        engine.step()
        steps += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in reqs)
    print(f"served {args.requests} requests ({total_tokens} tokens) in "
          f"{dt:.2f}s over {steps} engine steps "
          f"({total_tokens / dt:.1f} tok/s on {device.type})")
    return reqs


if __name__ == "__main__":
    main()
