#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

  1. card      name and power limit (``nvidia-smi``); no CUDA device or no
               ``src/repro_torch`` next to this script is an error.
  2. build     the MG3M kernels from ``src/repro_torch/csrc`` (nvcc).
  3. kernels   every grain (TB11, TB18, TB88) forced on the reference's
               kernel-test scenes and on the dgrad (lhs-dilated) and wgrad
               (rhs-dilated) plans of two strided scenes, each launch held
               against the grain's plain PyTorch version on the same
               operands: f32 within rtol=atol=1e-4, bf16 within 2e-2.
  4. main path the full-width ResNet trunk (``cnn_chain_scenes("resnet")``,
               224x224x3 in, 10 convs, ReLU between) registered on a
               ``ConvScheduler`` (strict, deadline flush), prewarmed, served
               from the background loop to ModelSession requests of batch
               1 and 2; zero post-warm plan builds, no reference plans, one
               request's output held against the plain-version chain, and
               one request bitwise equal served alone and coalesced.
  5. timing    each trunk layer's device time at batch 1; then per kernel
               at one main-path layer: the kernel, its plain
               version and ``F.conv2d`` (f32, TF32 off; a yardstick the
               port never calls), with CUDA events, beside the kernel's
               bound.

The last three lines of output are the ``kernels`` JSON line, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM datasheet peaks the bounds are taken against (dense, 700 W).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BW = 3.35e12

KERNEL_SOURCE = "src/repro_torch/csrc/mg3m_conv.cu"
REPLACES = {"TB11": "src/repro/kernels/mg3m_conv.py:288",
            "TB18": "src/repro/kernels/mg3m_conv.py:320",
            "TB88": "src/repro/kernels/mg3m_conv.py:352"}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# (B, IC, OC, inHW, flt, pad, std): tests/test_kernels.py's sweep
KERNEL_SCENES = [(8, 16, 24, 10, 3, 1, 1), (4, 8, 8, 7, 1, 0, 1),
                 (16, 32, 48, 12, 5, 2, 2), (3, 5, 7, 9, 3, 0, 2),
                 (1, 1, 1, 4, 3, 1, 1), (2, 64, 16, 8, 3, 1, 1),
                 (128, 16, 8, 6, 2, 0, 2)]
# (B, IC, OC, inH, inW, flt, pad, stdH, stdW): tests/test_dilated.py's
# "stride2" and "asym_stride"
STRIDED_SCENES = [(2, 8, 4, 10, 10, 3, 1, 2, 2), (3, 5, 7, 11, 9, 3, 0, 3, 2)]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """Registers per thread and spill bytes over every compiled kernel,
    from the ``-Xptxas -v`` report."""
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
    spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", log)]
    if not regs:
        return "no report"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers per "
            f"thread, spill stores {min(spills, default=0)}-"
            f"{max(spills, default=0)} bytes")


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` back-to-back calls,
    CUDA events around the run, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(torch, errs):
    """Force every grain on the test scenes; hold each launch against the
    plain version on the same operands.  Returns the number of checks."""
    from repro_torch.core.scene import ConvScene
    from repro_torch.kernels.mg3m_conv import conv_plain
    from repro_torch.plan import ConvOp, make_plan

    gen = torch.Generator().manual_seed(0)
    checks = 0
    for dtype, tol in TOL.items():
        tdt = getattr(torch, dtype)

        def rand(shape):
            return torch.randn(shape, generator=gen).to("cuda", tdt)

        cases = []
        for b, ic, oc, hw, f, pad, std in KERNEL_SCENES:
            sc = ConvScene(B=b, IC=ic, OC=oc, inH=hw, inW=hw, fltH=f, fltW=f,
                           padH=pad, padW=pad, stdH=std, stdW=std,
                           dtype=dtype)
            cases.append((sc, ConvOp.FPROP, rand(sc.in_shape()),
                          rand(sc.flt_shape())))
        for b, ic, oc, h, w, f, pad, sh, sw in STRIDED_SCENES:
            sc = ConvScene(B=b, IC=ic, OC=oc, inH=h, inW=w, fltH=f, fltW=f,
                           padH=pad, padW=pad, stdH=sh, stdW=sw, dtype=dtype)
            x, flt, cot = (rand(sc.in_shape()), rand(sc.flt_shape()),
                           rand(sc.out_shape()))
            cases.append((sc, ConvOp.DGRAD, cot, flt))
            cases.append((sc, ConvOp.WGRAD, x, cot))
        for sc, op, a, b in cases:
            for grain in ("TB11", "TB18", "TB88"):
                try:
                    plan = make_plan(sc, op, policy=grain)
                except ValueError:
                    continue     # the grain does not fit this scene
                fn, inp, flt, blocks = plan.kernel_call(a, b)
                got = fn(inp, flt, plan.exec_scene, **blocks).float()
                want = conv_plain(inp, flt, plan.exec_scene).float()
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if not torch.allclose(got, want, rtol=tol, atol=tol):
                    raise AssertionError(
                        f"{grain} {op.value} {dtype} disagrees with its "
                        f"plain version (max abs err {err}) on "
                        f"{plan.exec_scene.describe()}")
                errs[(grain, dtype)] = max(errs.get((grain, dtype), 0.0),
                                           err)
                # the plan's own execute runs the same launch end to end
                plan.execute(a, b)
                checks += 1
    torch.cuda.synchronize()
    return checks


def he_weights(torch, chain):
    """He-scaled seeded weights, so activations stay O(1) through the
    ReLU trunk."""
    gen = torch.Generator().manual_seed(1)
    return {name: torch.randn(sc.flt_shape(), generator=gen)
            * (2.0 / (sc.fltH * sc.fltW * sc.IC)) ** 0.5
            for name, sc in chain.items()}


def main_path(torch, np):
    from repro_torch.kernels import mg3m_conv as K
    from repro_torch.kernels.mg3m_conv import conv_plain
    from repro_torch.models.cnn import cnn_chain_scenes
    from repro_torch.plan import ConvOp
    from repro_torch.serve.sched import ConvScheduler, SchedConfig

    chain = cnn_chain_scenes("resnet")
    sched = ConvScheduler(max_batch=8, strict=True,
                          config=SchedConfig(max_gather_s=0.005,
                                             flush_margin_s=0.002))
    weights = he_weights(torch, chain)
    sched.register_net("resnet", chain, weights, activation=torch.relu)
    t0 = time.perf_counter()
    built = sched.prewarm(compile=True)
    prewarm_s = time.perf_counter() - t0
    sc0 = chain["resnet/L0"]
    gen = torch.Generator().manual_seed(2)
    sess = sched.session("resnet")

    snap = sched.snapshot()
    K.reset_launch_counts()
    sched.start()
    lat, reqs = [], []
    try:
        # four requests one at a time (deadline flushes at small buckets),
        # then a burst of eight that coalesces
        for i in range(4):
            x = torch.randn(sc0.in_shape()[:3] + (1 + i % 2,), generator=gen)
            t = time.perf_counter()
            r = sess.submit(x, deadline_s=0.05)
            sched.wait([r])
            lat.append(time.perf_counter() - t)
            reqs.append(r)
        burst = []
        for i in range(8):
            x = torch.randn(sc0.in_shape()[:3] + (1 + i % 2,), generator=gen)
            burst.append((time.perf_counter(),
                          sess.submit(x, deadline_s=0.1)))
        for t, r in burst:
            sched.wait([r])
            lat.append(time.perf_counter() - t)
            reqs.append(r)
    finally:
        sched.stop()
    counts = K.launch_counts()
    stats = sched.stats(since=snap)

    if stats["plan_misses"] or stats["plan_builds"]:
        raise AssertionError(f"post-warm plan misses/builds: {stats}")
    plans = sched.registry.plans().values()
    if any(p.uses_reference for p in plans):
        raise AssertionError("a served plan runs the torch reference")
    if stats["requests"] != len(reqs):
        raise AssertionError(f"served {stats['requests']} of {len(reqs)}")

    grains = {}
    for name, sc in chain.items():
        grains[name] = {b: sched.registry.get(sc.with_batch(b), ConvOp.FPROP)
                        .schedule for b in sched.flush_ladders()[name]}
    used = {p.schedule for p in plans}
    for grain in sorted(used):
        if counts[grain] == 0:
            raise AssertionError(f"{grain} was chosen but never launched "
                                 f"on the main path: {counts}")

    # correctness: one request against the plain-version chain on the card
    req = reqs[0]
    z = req.x.float()
    for name, sc in chain.items():
        zp = torch.nn.functional.pad(z, (0, 0, 0, 0, sc.padW, sc.padW,
                                         sc.padH, sc.padH))
        z = torch.relu(conv_plain(zp, sched._layers[name].flt,
                                  sc.with_batch(z.shape[3])))
    out = req.out
    last = list(chain.values())[-1]
    if tuple(out.shape) != last.out_shape()[:3] + (req._b,):
        raise AssertionError(f"output shape {tuple(out.shape)}")
    if not torch.isfinite(out).all():
        raise AssertionError("non-finite output")
    rel = ((out - z).abs().max() / z.abs().max().clamp_min(1e-30)).item()
    if rel > 1e-4:
        raise AssertionError(f"session output vs plain chain: rel err {rel}")
    # a burst request served again alone (another bucket, possibly other
    # grains) is bitwise what it was inside the coalesced dispatch: every
    # kernel sums tap-major, k ascending, whatever the batch or blocking
    alone = sess.serve([reqs[-1].x])[0]
    if not torch.equal(alone, reqs[-1].out):
        raise AssertionError("a request served alone differs bitwise from "
                             "the same request served coalesced")

    ms = np.asarray(lat) * 1e3
    print(f"main path: {len(reqs)} requests, {stats['dispatches']} "
          f"dispatches, prewarm {prewarm_s:.3f} s ({built} plans), "
          f"p50 {np.percentile(ms, 50):.3f} ms, p99 "
          f"{np.percentile(ms, 99):.3f} ms, deadline misses "
          f"{stats['deadline_misses']}, rel err vs plain chain {rel:.3e}")
    for name, by_bucket in grains.items():
        print(f"  {name} {chain[name].describe()[:60]} grain by bucket "
              f"{by_bucket}")
    print(f"  launches on the main path: {counts}")
    return sched, chain, counts


def layer_breakdown(torch, sched, chain, bucket: int = 1) -> float:
    """Device time of each trunk layer's plan (padding, kernel, slicing)
    at ``bucket``, CUDA events, beside every other grain forced on the same
    layer (the data a calibrated selector would rank by); returns the
    trunk's sum for the selector's choices in ms."""
    from repro_torch.plan import ConvOp, make_plan

    gen = torch.Generator().manual_seed(4)
    total = 0.0
    for name, sc in chain.items():
        plan = sched.registry.get(sc.with_batch(bucket), ConvOp.FPROP)
        x = torch.randn(plan.scene.in_shape(), generator=gen).cuda()
        w = sched._layers[name].flt
        ms = time_ms(torch, lambda: plan.execute(x, w))
        total += ms
        forced = {}
        for grain in ("TB11", "TB18", "TB88"):
            try:
                fp = make_plan(plan.scene, policy=grain)
            except ValueError:
                continue
            forced[grain] = round(time_ms(torch, lambda: fp.execute(x, w)), 4)
        print(f"  {name} B={bucket} {plan.schedule}: {ms:.4f} ms, "
              f"{plan.scene.flops / ms / 1e6:.1f} GFLOP/s; forced grains "
              f"ms {forced}")
    print(f"  trunk B={bucket}: {total:.4f} ms of device time per forward")
    return total


def timing_phase(torch, sched, chain, counts, errs):
    """Per kernel, at the first main-path layer whose plan chose it,
    smallest bucket first: kernel, plain version, F.conv2d."""
    from repro_torch.kernels.mg3m_conv import conv_plain
    from repro_torch.plan import ConvOp

    F = torch.nn.functional
    rows = []
    buckets = sorted({b for rungs in sched.flush_ladders().values()
                      for b in rungs})
    for grain in ("TB11", "TB18", "TB88"):
        found = None
        for b in buckets:
            for name, sc in chain.items():
                plan = sched.registry.get(sc.with_batch(b), ConvOp.FPROP)
                if plan.schedule == grain:
                    found = (name, plan)
                    break
            if found:
                break
        if found is None:
            raise AssertionError(f"{grain} serves no main-path layer")
        name, plan = found
        sc = plan.scene
        gen = torch.Generator().manual_seed(3)
        x = torch.randn(sc.in_shape(), generator=gen).cuda()
        w = sched._layers[name].flt
        fn, inp, flt, blocks = plan.kernel_call(x, w)
        got = fn(inp, flt, sc, **blocks)
        want = conv_plain(inp, flt, sc)
        err = (got - want).abs().max().item()
        errs[(grain, "float32")] = max(errs.get((grain, "float32"), 0.0),
                                       err)
        x_nchw = x.permute(3, 2, 0, 1).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            lib_ms = time_ms(torch, lambda: F.conv2d(
                x_nchw, w_oihw, stride=(sc.stdH, sc.stdW),
                padding=(sc.padH, sc.padW)))
        k_ms = time_ms(torch, lambda: fn(inp, flt, sc, **blocks))
        p_ms = time_ms(torch, lambda: conv_plain(inp, flt, sc))
        nbytes = (inp.numel() * inp.element_size()
                  + flt.numel() * flt.element_size()
                  + got.numel() * got.element_size())
        ops_ms = sc.flops / PEAK_FP32_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_HBM_BW * 1e3
        rows.append({
            "name": f"mg3m_{grain.lower()}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[grain],
            "launches": counts[grain],
            "max_abs_err": errs[(grain, "float32")],
            "max_abs_err_bf16": errs.get((grain, "bfloat16")),
            "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms,
            "shape": f"{name} B={sc.B} {plan.describe()}",
            "gflop": sc.flops / 1e9, "mbytes": nbytes / 1e6,
        })
        print(f"  {grain} at {name} B={sc.B}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms, bound "
              f"{max(ops_ms, bytes_ms):.4f} ms")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run this "
              f"script from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.mg3m_conv import SOURCE, library
    t0 = time.perf_counter()
    library()
    print(f"build: {SOURCE} in {time.perf_counter() - t0:.1f} s")
    print(f"ptxas: {ptxas_summary(cuda_build.build_logs.get(SOURCE, ''))}")

    errs = {}
    t0 = time.perf_counter()
    n = kernel_phase(torch, errs)
    print(f"kernels: {n} launches held against their plain versions in "
          f"{time.perf_counter() - t0:.1f} s; max abs err "
          f"{ {f'{g}/{d}': e for (g, d), e in sorted(errs.items())} }")

    sched, chain, counts = main_path(torch, np)
    layer_breakdown(torch, sched, chain)
    rows = timing_phase(torch, sched, chain, counts, errs)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
