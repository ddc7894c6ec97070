#!/usr/bin/env python3
"""SHA-256 digests of the flash forward kernels' output ``o``, for one tree
of the port, on one GPU:

    python3 chip_flash_ab.py [--src DIR] [--out FILE] [--against FILE]
                             [--changed DTYPE ...] [--time]

Imports ``repro_torch`` from ``DIR`` (default: ``src`` of this checkout),
builds its ``flash_attention.cu`` and launches ``flash_attention_fwd`` on
``chip_smoke.FLASH_SHAPES`` and ``chip_smoke.DENSE_FLASH``, f32 and bf16,
causal and not, on operands seeded with numpy, and prints a digest of each
``o``.  Where the tree's forward can also return the log-sum-exp, the
``o`` of that launch must be bitwise the ``o`` without it.  ``--out``
writes the digests as JSON; ``--against`` compares them with such a file
and exits 1 on any difference, except in the outputs of a dtype named by
``--changed`` (``float32``, ``bfloat16``), which it lists.  ``--time``
also times the tree's f32 forward (device time, CUDA-graph replay) at
``train_lm``'s shape and the training path's (``chip_smoke.
TRAIN_LM_FLASH``, ``TRAIN_FLASH``, causal), SDPA in f32 beside it, into
``--out``'s ``"times"``.  Two trees (a commit and its parent unpacked with
``git archive``) run in one call on one card, parent, commit, commit,
parent, show whether the kernels' ``o`` changed by a single bit and what
the change did to the f32 kernel's time.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--out", help="write the digests to this JSON file")
    ap.add_argument("--against", help="compare with this JSON file")
    ap.add_argument("--changed", nargs="*", default=[],
                    choices=("float32", "bfloat16"),
                    help="dtypes whose outputs may differ from --against's")
    ap.add_argument("--time", action="store_true",
                    help="time the f32 forward at train_lm's and the "
                         "training path's shapes")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_ab: no CUDA device is available", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_flash_ab: no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import numpy as np

    import chip_smoke
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import flash_attention_fwd

    print(f"tree: {src}; card: {chip_smoke.card_line()}")
    t0 = time.perf_counter()
    cuda_build.load_all(("flash_attention.cu",))
    print(f"build: flash_attention.cu in {time.perf_counter() - t0:.1f} s")
    with_lse = "return_lse" in inspect.signature(
        flash_attention_fwd).parameters
    rng = np.random.default_rng(26)
    digests = {}
    for b, s, t, hq, hkv, d in (chip_smoke.FLASH_SHAPES
                                + [chip_smoke.DENSE_FLASH]):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (b * h, n, d), dtype=np.float32)).to("cuda", dtype)
                for h, n in ((hq, s), (hkv, t), (hkv, t)))
            for causal in (True, False):
                o = flash_attention_fwd(q, k, v, causal=causal)
                name = (f"q {tuple(q.shape)} k {tuple(k.shape)} "
                        f"{str(dtype)[6:]} causal={causal}")
                if with_lse:
                    o2, _ = flash_attention_fwd(q, k, v, causal=causal,
                                                return_lse=True)
                    if not torch.equal(o, o2):
                        print(f"BAD {name}: o with the log-sum-exp differs "
                              f"from o without it")
                        return 1
                raw = o.view(torch.int16 if dtype == torch.bfloat16
                             else torch.int32).cpu().numpy().tobytes()
                digests[name] = hashlib.sha256(raw).hexdigest()
                print(f"{name}: {digests[name][:16]}")
    print(f"{len(digests)} outputs digested; o with the log-sum-exp "
          f"{'checked bitwise' if with_lse else 'not offered by this tree'}")
    times = f32_times(torch, chip_smoke, flash_attention_fwd) \
        if args.time else {}
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"digests": digests, "times": times}, indent=1))
    if args.against:
        want = json.loads(Path(args.against).read_text())["digests"]
        if set(digests) != set(want):
            print(f"the outputs differ in name from {args.against}'s")
            return 1
        bad = 0
        for dtype in ("float32", "bfloat16"):
            names = [n for n in want if f" {dtype} " in n]
            differ = [n for n in names if digests[n] != want[n]]
            allowed = dtype in args.changed
            print(f"{dtype}: {len(differ)} of {len(names)} outputs differ "
                  f"from {args.against}'s"
                  f"{' (expected)' if allowed and differ else ''}")
            for n in differ:
                print(f"  changed: {n}")
            bad += 0 if allowed else len(differ)
        if bad:
            return 1
        print(f"every output of a dtype not named by --changed is bitwise "
              f"equal to {args.against}'s")
    return 0


def f32_times(torch, chip_smoke, flash_attention_fwd) -> dict:
    """Device ms of the tree's f32 forward and of SDPA in f32 (TF32 off,
    K and V repeated to the query heads) at ``train_lm``'s and the training
    path's flash shapes, causal, on operands from a fixed seed."""
    F = torch.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(28)
    times = {}
    for label, (b, s, t, h, hkv, d) in (
            ("train_lm", chip_smoke.TRAIN_LM_FLASH),
            ("training", chip_smoke.TRAIN_FLASH)):
        q, k, v = (torch.randn(dims, generator=gen).cuda()
                   for dims in ((b * h, s, d), (b * hkv, t, d),
                                (b * hkv, t, d)))
        q4, k4, v4 = (x.view(b, -1, x.shape[1], d) for x in (q, k, v))
        k4, v4 = (x.repeat_interleave(h // hkv, 1) for x in (k4, v4))
        times[label] = {
            "kernel_ms": chip_smoke.device_ms(
                torch, lambda: flash_attention_fwd(q, k, v, causal=True)),
            "sdpa_ms": chip_smoke.device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True))}
        print(f"time {label}: q {tuple(q.shape)} k {tuple(k.shape)} f32 "
              f"causal: kernel {times[label]['kernel_ms']:.4f} ms, SDPA "
              f"{times[label]['sdpa_ms']:.4f} ms")
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
    return times


if __name__ == "__main__":
    sys.exit(main())
