#!/usr/bin/env python3
"""The LM path's times with and without ``chip_smoke.py``'s train phase run
before it in the same process, on one GPU:

    python3 chip_phase_ab.py [--train]

Builds the port's kernels, runs ``chip_smoke.train_phase`` when ``--train``
is given (the trunk's training, its checks and the small-CNN launcher,
then the clean-up the smoke does after it), then ``chip_smoke``'s LM
kernel checks and LM path (full-width zamba2-7b: prefill, ServeEngine,
decode step, two profiles).  The last line is the LM path's times as
JSON.  Run it as A B B A (without, with, with, without) in one call on
one card to see whether the train phase moves them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true",
                    help="run the smoke's train phase before the LM path")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_phase_ab: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_phase_ab: no repro_torch under {ROOT / 'src'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np

    import chip_smoke
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {chip_smoke.card_line()}; train phase first: {args.train}")
    from repro_torch.kernels import cuda_build
    t0 = time.perf_counter()
    cuda_build.load_all(chip_smoke.SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s")
    if args.train:
        chip_smoke.train_phase(torch)
    chip_smoke.lm_kernel_phase(torch)
    _, times = chip_smoke.lm_path(torch, np)
    print(json.dumps(dict(times, train_first=args.train)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
