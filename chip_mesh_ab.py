#!/usr/bin/env python3
"""The DP ring's host cost before and after a profiler session in one
process, on one GPU:

    python3 chip_mesh_ab.py

Builds the LM kernels, runs ``chip_smoke.mesh_dp`` (qwen2.5-3b at full
width in the DP grain on a (2, 2) ring of the card, against one device),
then one profiled train step (``chip_smoke.lm_train_profile``), then
``mesh_dp`` again; then ``mesh_tp`` and the dry run's model of both rings
(``chip_smoke.mesh_model``).  The last line is the two DP runs' step
times as JSON: if the ring's host cost moves with the profiler session,
the second run's is the larger.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_mesh_ab: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_mesh_ab: no repro_torch under {ROOT / 'src'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import numpy as np

    import chip_smoke
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {chip_smoke.card_line()}")
    from repro_torch.kernels import cuda_build
    t0 = time.perf_counter()
    cuda_build.load_all(("causal_conv1d.cu", "flash_attention.cu"))
    print(f"build: {time.perf_counter() - t0:.1f} s")
    before = chip_smoke.mesh_dp(torch, np)
    chip_smoke.lm_train_profile(torch)
    after = chip_smoke.mesh_dp(torch, np)
    tp = chip_smoke.mesh_tp(torch, np)
    chip_smoke.mesh_model({"dp": after, "tp": tp})
    print(json.dumps({
        k: {"ring_ms": r["ms"], "one_ms": r["one_ms"],
            "host_cost_ms": r["ms"] - r["one_ms"]}
        for k, r in (("before_profile", before), ("after_profile", after))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
