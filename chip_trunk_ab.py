#!/usr/bin/env python3
"""Per-layer device time of the ResNet trunk's served plans, for one tree
of the port, on one GPU:

    python3 chip_trunk_ab.py [--src DIR]

Imports ``repro_torch`` from ``DIR`` (default: ``src`` of this checkout),
builds its conv kernels, serves ``chip_smoke.py``'s conv main path on
them (the same requests and checks) and prints
``chip_smoke.layer_breakdown`` at buckets 1, 2, 4 and 8: each layer's plan
time and kernel time, every grain forced, and ``F.conv2d``.  The
measurement code is this checkout's whatever tree ``DIR`` holds, so two
trees (a commit and its parent unpacked with ``git archive``) compare
like for like; run them in one call on one card as A B B A.
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
    sched, chain, _ = chip_smoke.main_path(torch, np, {})
    for bucket in (1, 2, 4, 8):
        chip_smoke.layer_breakdown(torch, sched, chain, bucket)
    return 0


if __name__ == "__main__":
    sys.exit(main())
