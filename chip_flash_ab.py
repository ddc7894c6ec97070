#!/usr/bin/env python3
"""SHA-256 digests of the flash kernels' outputs (the forward's ``o``, the
backward's ``dq``, ``dk``, ``dv``), for one tree of the port, on one GPU:

    python3 chip_flash_ab.py [--src DIR] [--out FILE] [--against FILE]
                             [--changed DTYPE ...] [--time]

Imports ``repro_torch`` from ``DIR`` (default: ``src`` of this checkout),
builds its ``flash_attention.cu`` and launches ``flash_attention_fwd`` on
``chip_smoke.FLASH_SHAPES`` and ``chip_smoke.DENSE_FLASH``, f32 and bf16,
causal and not, on operands seeded with numpy, and prints a digest of each
``o``.  Where the tree's forward can also return the log-sum-exp, the
``o`` of that launch must be bitwise the ``o`` without it, and the tree's
``flash_attention_bwd`` runs on that output and log-sum-exp for a seeded
cotangent: a digest of each of ``dq``, ``dk``, ``dv``.  ``--out`` writes
the digests as JSON; ``--against`` compares them with such a file and
exits 1 on any difference, except in the outputs named by ``--changed``:
a dtype (``float32``, ``bfloat16``: all its outputs) or a dtype and a
direction (``float32/fwd``: its ``o``; ``float32/bwd``: its ``dq``,
``dk``, ``dv``), which it lists.  ``--time`` also times the tree's bf16
backward at the training path's shape and zamba2-7b's (``chip_smoke.
TRAIN_FLASH``; q (32, 4096, 112), one query head a kv head; causal):
device time by CUDA-graph replay, each kernel's own under the profiler
(``chip_smoke.bwd_kernel_ms``) and SDPA's backward beside it (whichever
backend SDPA picks, cuDNN on the H100; its forward and backward less its
forward); then the tree's f32 forward and f32 backward at ``train_lm``'s
shape and the training path's (``chip_smoke.TRAIN_LM_FLASH``,
``TRAIN_FLASH``, causal), SDPA in f32 beside them (its backward on the
memory-efficient kernel), all into ``--out``'s ``"times"``.  Two trees
(a commit and its parent unpacked with ``git archive``) run in one call
on one card, parent, commit, commit, parent, show whether the kernels'
outputs changed by a single bit and what the change did to the kernels'
times.
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
DTYPES = ("float32", "bfloat16")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--out", help="write the digests to this JSON file")
    ap.add_argument("--against", help="compare with this JSON file")
    ap.add_argument("--changed", nargs="*", default=[],
                    choices=[f"{d}{k}" for d in DTYPES
                             for k in ("", "/fwd", "/bwd")],
                    help="dtypes (or dtype/direction) whose outputs may "
                         "differ from --against's")
    ap.add_argument("--time", action="store_true",
                    help="time the bf16 backward at the training path's "
                         "and zamba2-7b's shapes, and the f32 forward and "
                         "backward at train_lm's and the training path's")
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
    from repro_torch.kernels import flash_attention as FA

    print(f"tree: {src}; card: {chip_smoke.card_line()}")
    t0 = time.perf_counter()
    cuda_build.load_all(("flash_attention.cu",))
    print(f"build: flash_attention.cu in {time.perf_counter() - t0:.1f} s")
    with_lse = "return_lse" in inspect.signature(
        FA.flash_attention_fwd).parameters
    with_bwd = with_lse and hasattr(FA, "flash_attention_bwd")
    rng = np.random.default_rng(26)
    digests = {}

    def digest(name, x, dtype):
        raw = x.view(torch.int16 if dtype == torch.bfloat16
                     else torch.int32).cpu().numpy().tobytes()
        digests[name] = hashlib.sha256(raw).hexdigest()
        print(f"{name}: {digests[name][:16]}")

    for b, s, t, hq, hkv, d in (chip_smoke.FLASH_SHAPES
                                + [chip_smoke.DENSE_FLASH]):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (b * h, n, d), dtype=np.float32)).to("cuda", dtype)
                for h, n in ((hq, s), (hkv, t), (hkv, t)))
            for causal in (True, False):
                o = FA.flash_attention_fwd(q, k, v, causal=causal)
                name = (f"q {tuple(q.shape)} k {tuple(k.shape)} "
                        f"{str(dtype)[6:]} causal={causal}")
                digest(f"o {name}", o, dtype)
                if not with_lse:
                    continue
                o2, lse = FA.flash_attention_fwd(q, k, v, causal=causal,
                                                 return_lse=True)
                if not torch.equal(o, o2):
                    print(f"BAD {name}: o with the log-sum-exp differs "
                          f"from o without it")
                    return 1
                if with_bwd:
                    dout = torch.from_numpy(rng.standard_normal(
                        tuple(q.shape), dtype=np.float32)).to("cuda", dtype)
                    grads = FA.flash_attention_bwd(q, k, v, o2, lse, dout,
                                                   causal=causal)
                    for g_name, g in zip(("dq", "dk", "dv"), grads):
                        digest(f"{g_name} {name}", g, dtype)
    print(f"{len(digests)} outputs digested; o with the log-sum-exp "
          f"{'checked bitwise' if with_lse else 'not offered by this tree'}"
          f"; the backward {'digested' if with_bwd else 'not offered'}")
    times = {"bf16": bf16_times(torch, chip_smoke, FA),
             **f32_times(torch, chip_smoke, FA)} if args.time else {}
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"digests": digests, "times": times}, indent=1))
    if args.against:
        want = json.loads(Path(args.against).read_text())["digests"]
        if set(digests) != set(want):
            print(f"the outputs differ in name from {args.against}'s")
            return 1
        bad = 0
        for dtype in DTYPES:
            for kind, outs in (("fwd", ("o",)), ("bwd", ("dq", "dk", "dv"))):
                names = [n for n in want if f" {dtype} " in n
                         and n.split()[0] in outs]
                differ = [n for n in names if digests[n] != want[n]]
                allowed = dtype in args.changed or \
                    f"{dtype}/{kind}" in args.changed
                print(f"{dtype}/{kind}: {len(differ)} of {len(names)} "
                      f"outputs differ from {args.against}'s"
                      f"{' (expected)' if allowed and differ else ''}")
                for n in differ:
                    print(f"  changed: {n}")
                bad += 0 if allowed else len(differ)
        if bad:
            return 1
        print(f"every output not named by --changed is bitwise equal to "
              f"{args.against}'s")
    return 0


def bf16_times(torch, chip_smoke, FA) -> dict:
    """Device ms of the tree's bf16 backward (CUDA-graph replay, and each
    kernel's own under the profiler, the process's first session) and of
    SDPA's backward (K and V repeated to the query heads; its forward and
    backward less its forward) at the training path's and zamba2-7b's
    flash shapes, causal, on operands from a fixed seed."""
    from repro_torch.configs.registry import get_config

    F = torch.nn.functional
    z = get_config(chip_smoke.HYBRID_TRAIN_ARCH)
    gen = torch.Generator().manual_seed(30)
    cases = {}
    for label, (b, s, t, h, hkv, d) in (
            ("training", chip_smoke.TRAIN_FLASH),
            (z.name, (1, chip_smoke.LM_TRAIN_SEQ, chip_smoke.LM_TRAIN_SEQ,
                      z.n_heads, z.n_kv_heads, z.d_head))):
        q, k, v, do = (torch.randn(dims, generator=gen).to("cuda",
                                                            torch.bfloat16)
                       for dims in ((b * h, s, d), (b * hkv, t, d),
                                    (b * hkv, t, d), (b * h, s, d)))
        out, lse = FA.flash_attention_fwd(q, k, v, causal=True,
                                          return_lse=True)
        cases[label] = (q, k, v, do, out, lse, (b, s, t, h, hkv, d))
    split = chip_smoke.bwd_kernel_ms(torch, {
        label: (lambda c=c: FA.flash_attention_bwd(*c[:3], c[4], c[5], c[3],
                                                   causal=True),
                "bfloat16", c[6][5]) for label, c in cases.items()})
    times = {}
    for label, (q, k, v, do, out, lse, shape) in cases.items():
        b, s, t, h, hkv, d = shape
        q4, k4, v4 = (x.view(b, -1, x.shape[1], d) for x in (q, k, v))
        k4, v4 = (x.repeat_interleave(h // hkv, 1) for x in (k4, v4))
        leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]
        dref = do.view(b, h, s, d)

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                o = F.scaled_dot_product_attention(*leaves, is_causal=True)
                return torch.autograd.grad(o, leaves, dref)

        times[label] = {
            "bwd_kernel_ms": chip_smoke.device_ms(
                torch, lambda: FA.flash_attention_bwd(q, k, v, out, lse, do,
                                                      causal=True), 5),
            "kernel_ms": split.get(label, {}),
            "sdpa_bwd_ms": chip_smoke.device_ms(torch, sdpa_fwd_bwd, 5)
            - chip_smoke.device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True), 5),
            "sdpa_backend": chip_smoke._sdpa_backend(torch, q4, k4, v4)}
        tm = times[label]
        print(f"time bf16 {label}: q {tuple(q.shape)} k {tuple(k.shape)} "
              f"causal: backward {tm['bwd_kernel_ms']:.4f} ms ("
              + (", ".join(f"{n} {tm['kernel_ms'][n]:.4f}"
                           for n in ("dq", "dkdv", "sum")
                           if n in tm["kernel_ms"]) or "split not measured")
              + f"), SDPA's backward ({tm['sdpa_backend']}) "
              f"{tm['sdpa_bwd_ms']:.4f} ms")
        del q4, k4, v4, leaves, dref
    del cases
    torch.cuda.empty_cache()
    return times


def f32_times(torch, chip_smoke, FA) -> dict:
    """Device ms of the tree's f32 forward and backward and of SDPA in f32
    (TF32 off, K and V repeated to the query heads; its backward on the
    memory-efficient kernel, its forward and backward less its forward) at
    ``train_lm``'s and the training path's flash shapes, causal, on
    operands from a fixed seed."""
    F = torch.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = False
    efficient = torch.nn.attention.SDPBackend.EFFICIENT_ATTENTION
    gen = torch.Generator().manual_seed(28)
    times = {}
    for label, (b, s, t, h, hkv, d) in (
            ("train_lm", chip_smoke.TRAIN_LM_FLASH),
            ("training", chip_smoke.TRAIN_FLASH)):
        iters = 5 if label == "training" else 20
        q, k, v, do = (torch.randn(dims, generator=gen).cuda()
                       for dims in ((b * h, s, d), (b * hkv, t, d),
                                    (b * hkv, t, d), (b * h, s, d)))
        q4, k4, v4 = (x.view(b, -1, x.shape[1], d) for x in (q, k, v))
        k4, v4 = (x.repeat_interleave(h // hkv, 1) for x in (k4, v4))
        out, lse = FA.flash_attention_fwd(q, k, v, causal=True,
                                          return_lse=True)
        leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]
        dref = do.view(b, h, s, d)

        def sdpa_fwd_bwd():
            with torch.enable_grad():
                o = F.scaled_dot_product_attention(*leaves, is_causal=True)
                return torch.autograd.grad(o, leaves, dref)

        with torch.nn.attention.sdpa_kernel(efficient):
            sdpa_bwd = chip_smoke.device_ms(torch, sdpa_fwd_bwd, iters) - \
                chip_smoke.device_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=True), iters)
        times[label] = {
            "kernel_ms": chip_smoke.device_ms(
                torch, lambda: FA.flash_attention_fwd(q, k, v, causal=True)),
            "sdpa_ms": chip_smoke.device_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True)),
            "bwd_kernel_ms": chip_smoke.device_ms(
                torch, lambda: FA.flash_attention_bwd(q, k, v, out, lse, do,
                                                      causal=True), iters),
            "sdpa_bwd_ms": sdpa_bwd}
        tm = times[label]
        print(f"time {label}: q {tuple(q.shape)} k {tuple(k.shape)} f32 "
              f"causal: forward {tm['kernel_ms']:.4f} ms (SDPA "
              f"{tm['sdpa_ms']:.4f}), backward {tm['bwd_kernel_ms']:.4f} ms "
              f"(SDPA's efficient backward {tm['sdpa_bwd_ms']:.4f})")
        del q, k, v, do, q4, k4, v4, out, lse, leaves, dref
        torch.cuda.empty_cache()
    return times


if __name__ == "__main__":
    sys.exit(main())
