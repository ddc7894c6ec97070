#!/usr/bin/env python3
"""Per-layer device time of the ResNet trunk's served plans, for one tree
of the port, on one GPU:

    python3 chip_trunk_ab.py [--src DIR] [--train]

Imports ``repro_torch`` from ``DIR`` (default: ``src`` of this checkout),
builds its conv kernels, serves ``chip_smoke.py``'s conv main path on
them (the same requests and checks) and prints
``chip_smoke.layer_breakdown`` at buckets 1, 2, 4 and 8: each layer's plan
time and kernel time, every grain forced, and ``F.conv2d``.  The
measurement code is this checkout's whatever tree ``DIR`` holds, so two
trees (a commit and its parent unpacked with ``git archive``) compare
like for like; run them in one call on one card as A B B A.

``--train`` times the trunk's training plans instead: every layer's
fprop at batch 1 and 8 and its dgrad and wgrad at the training
microbatch (8), each plan's kernel launch (``ConvPlan.kernel_call``; a
split wgrad's second pass included) in device ms, on operands seeded with
numpy, with a SHA-256 of each output: two trees whose kernels sum in one
order print the same digests.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--train", action="store_true",
                    help="time the training plans (fprop, dgrad, wgrad) "
                         "and digest their outputs")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_trunk_ab: no CUDA device is available", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_trunk_ab: no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np

    import chip_smoke
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"tree: {src}; card: {chip_smoke.card_line()}")
    from repro_torch.kernels import cuda_build
    t0 = time.perf_counter()
    cuda_build.load_all(("mg3m_conv.cu",))
    print(f"build: mg3m_conv.cu in {time.perf_counter() - t0:.1f} s")
    if args.train:
        return train_directions(torch, np, chip_smoke)
    sched, chain, _ = chip_smoke.main_path(torch, np, {})
    for bucket in (1, 2, 4, 8):
        chip_smoke.layer_breakdown(torch, sched, chain, bucket)
    return 0


def train_directions(torch, np, chip_smoke) -> int:
    """``--train``: each trunk layer's plans, their kernels' device ms
    and output digests (see the module docstring)."""
    import hashlib

    from repro_torch.models.cnn import cnn_chain_scenes
    from repro_torch.plan import make_plan

    rng = np.random.default_rng(31)
    sums = {}
    for name, sc0 in cnn_chain_scenes(chip_smoke.TRAIN_NET).items():
        for op, batch in (("fprop", 1), ("fprop", chip_smoke.TRAIN_MB),
                          ("dgrad", chip_smoke.TRAIN_MB),
                          ("wgrad", chip_smoke.TRAIN_MB)):
            sc = sc0.with_batch(batch)
            plan = make_plan(sc, op)
            a_shape, b_shape, _ = plan.io_shapes()
            a, b = (torch.from_numpy(rng.standard_normal(s).astype(
                np.float32)).cuda() for s in (a_shape, b_shape))
            fn, inp, flt, blocks = plan.kernel_call(a, b)
            es = plan.exec_scene
            out = fn(inp, flt, es, **blocks)
            digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
            ms = chip_smoke.device_ms(torch, lambda: fn(inp, flt, es,
                                                        **blocks))
            key = f"{op} B={batch}"
            sums[key] = sums.get(key, 0.0) + ms
            print(f"{name} {key}: {plan.describe()} tile "
                  f"{plan.choice.tile} kernel {ms:.4f} ms sha256 "
                  f"{digest[:16]}", flush=True)
    print("trunk sums (kernel device ms): " + "; ".join(
        f"{k} {v:.4f}" for k, v in sums.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
