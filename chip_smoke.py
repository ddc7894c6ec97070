#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

  1. card      name and power limit (``nvidia-smi``); no CUDA device or no
               ``src/repro_torch`` next to this script is an error.
  2. build     every kernel source of ``src/repro_torch/csrc`` (one nvcc
               each, all started together), with each ptxas summary and
               each library's count of tensor-core instructions (HGMMA,
               HMMA) from ``cuobjdump -sass``; the bf16 flash kernel must
               have some.
  3. kernels   every MG3M grain (TB11, TB18, TB88) forced on the
               reference's kernel-test scenes and on the dgrad
               (lhs-dilated) and wgrad (rhs-dilated) plans of two strided
               scenes, and on trunk layers (TB18 on L7 and L9 at batch 1
               and 2, TB11 on L0 at batch 2, TB88 on L2 at batch 1 and L9
               at batch 8), each launch held against the grain's plain
               PyTorch version on the same operands: f32 within
               rtol=atol=1e-4, bf16 within 2e-2.
  4. conv path the full-width ResNet trunk (``cnn_chain_scenes("resnet")``,
               224x224x3 in, 10 convs, ReLU between) registered on a
               ``ConvScheduler`` (strict, deadline flush), prewarmed, served
               from the background loop to ModelSession requests of batch
               1 and 2 (four alone, a burst of eight, eight of batch 1,
               then eight of batch 1 through ``serve``: one dispatch at
               bucket 8); all three grains must have launched;
               zero post-warm plan builds, no reference plans, every
               served plan's kernel held against its plain version on the
               card, one request's output held against the plain-version
               chain, and one request bitwise equal served alone and
               coalesced.
  5. conv timing  each trunk layer at buckets 1, 2, 4 and 8: its plan's
               time (CUDA events, host included), the selector's modeled
               time, and the device time (a CUDA graph of 20 calls, host
               left out) of its kernel, of every grain forced and of
               ``F.conv2d`` on the same layer (f32, TF32 off; a yardstick
               the port never calls; ``chip_tile_sweep.py`` times every
               compiled tile); then per grain at its layer of PERF.md's
               kernel table (TB11 at L0, TB18 at L2, TB88 at L1, batch 1;
               forced where the selector picks another grain there): the
               kernel, its plain version and ``F.conv2d``, device time,
               beside the kernel's bound; and a second row at the grain's
               served plan of the largest kernel time on the main path.
  6. LM kernels  causal_conv1d on tests/test_kernels.py's shapes and flash
               attention on tests/test_flash_kernel.py's (causal and not,
               plus D = 112), both also at the LM path's shapes, f32 and
               bf16, each held against its plain version: f32 within 1e-4
               (conv) / 2e-4 (attention), bf16 within 2e-2.
  7. LM path   full-width zamba2-7b (81 layers, d_model 3584, 32x112
               heads, bf16, seeded random weights) on the card: the
               reference's cross-form oracle (prefill(255) + decode_step ==
               forward(256) at the last position, within a bf16 tolerance
               relative to max |logit|); then, with the launch counts set to
               0, ``prefill`` of 2 x 2048 tokens and a ``ServeEngine`` (2
               slots) answering 4 greedy requests (prompts of 17, 64, 255
               and 600 tokens, 16 new each, one joining mid-stream); both
               kernels must have launched on it; the joining request's
               neighbour must give the tokens it gives served alone; the
               reduced config's prefill on the card must match the CPU's;
               one decode step and one prefill under ``torch.profiler``
               (device busy time, idle share, time by kernel class).
  8. LM timing  per kernel at the LM path's shapes: the kernel, its plain
               version and one PyTorch call computing the same function
               (``F.conv1d``, ``F.scaled_dot_product_attention``; never
               called by the port), beside the kernel's bound.

In the ``kernels`` line, ``ms`` and ``library_ms`` are device time (20
calls replayed from a CUDA graph, the host's time per call left out);
``plain_ms`` is CUDA-event time of 20 back-to-back calls, the host's
time included.

The last three lines of output are the ``kernels`` JSON line (all five
kernels; each conv grain has a second row, ``<name>_main_path``), the
card's name and power limit, and ``{"ok": true, ...}``.
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
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BW = 3.35e12

KERNEL_SOURCE = "src/repro_torch/csrc/mg3m_conv.cu"
SOURCES = ("mg3m_conv.cu", "causal_conv1d.cu", "flash_attention.cu")
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
# (grain, layer, batch) forced on the trunk in the kernel phase: TB18's
# small-spatial layers at batch 1 and 2, TB11 on the stem, TB88 on a
# batch-1 (column-major) and a batch-8 (k-major) layer
TRUNK_CASES = [("TB18", "resnet/L7", 1), ("TB18", "resnet/L7", 2),
               ("TB18", "resnet/L9", 1), ("TB18", "resnet/L9", 2),
               ("TB11", "resnet/L0", 2), ("TB88", "resnet/L2", 1),
               ("TB88", "resnet/L9", 8)]
# PERF.md's per-grain timing layers (batch 1)
TIMING_LAYERS = {"TB11": "resnet/L0", "TB18": "resnet/L2",
                 "TB88": "resnet/L1"}


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


def tensor_core_counts(lib_path) -> dict:
    """``{function: (HGMMA, HMMA)}`` instruction counts of one built
    library, from ``cuobjdump -sass`` (the toolkit's, next to nvcc)."""
    from repro_torch.kernels import cuda_build
    tool = Path(cuda_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        counts[name] = (part.count("HGMMA"), part.count("HMMA"))
    return counts


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


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn``: ``iters`` calls
    captured in one CUDA graph and replayed between two CUDA events, so
    the host's time per call, longer than a small conv kernel's own, is
    left out (``time_ms`` of back-to-back calls reads it instead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up, outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_phase(torch, errs):
    """Force every grain on the test scenes; hold each launch against the
    plain version on the same operands.  Returns the number of checks."""
    from repro_torch.core.scene import ConvScene
    from repro_torch.kernels.mg3m_conv import conv_plain
    from repro_torch.models.cnn import cnn_chain_scenes
    from repro_torch.plan import ConvOp, make_plan

    chain = cnn_chain_scenes("resnet")
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
        grains = [("TB11", "TB18", "TB88")] * len(cases)
        for grain, name, b in TRUNK_CASES:
            sc = ConvScene(**{**chain[name].with_batch(b).__dict__,
                              "dtype": dtype})
            fan_in = sc.fltH * sc.fltW * sc.IC
            cases.append((sc, ConvOp.FPROP, rand(sc.in_shape()),
                          rand(sc.flt_shape()) * fan_in ** -0.5))
            grains.append((grain,))
        for (sc, op, a, b), names in zip(cases, grains):
            for grain in names:
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


def main_path(torch, np, errs):
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
        # eight requests of batch 1 submitted back to back: bucket 8,
        # where the selector picks TB88 on several layers
        xs = [torch.randn(sc0.in_shape()[:3] + (1,), generator=gen)
              for _ in range(8)]
        burst = [(time.perf_counter(), sess.submit(x, deadline_s=0.1))
                 for x in xs]
        for t, r in burst:
            sched.wait([r])
            lat.append(time.perf_counter() - t)
            reqs.append(r)
    finally:
        sched.stop()
    # and eight of batch 1 through ``serve`` with the loop stopped: one
    # coalesced dispatch at bucket 8 whatever the timing of the bursts
    xs8 = [torch.randn(sc0.in_shape()[:3] + (1,), generator=gen)
           for _ in range(8)]
    t = time.perf_counter()
    outs8 = sess.serve(xs8)
    lat.append(time.perf_counter() - t)
    counts = K.launch_counts()
    stats = sched.stats(since=snap)

    if stats["plan_misses"] or stats["plan_builds"]:
        raise AssertionError(f"post-warm plan misses/builds: {stats}")
    plans = sched.registry.plans().values()
    if any(p.uses_reference for p in plans):
        raise AssertionError("a served plan runs the torch reference")
    if stats["requests"] != len(reqs) + len(xs8):
        raise AssertionError(f"served {stats['requests']} of "
                             f"{len(reqs) + len(xs8)}")

    grains = {}
    for name, sc in chain.items():
        grains[name] = {b: sched.registry.get(sc.with_batch(b), ConvOp.FPROP)
                        .schedule for b in sched.flush_ladders()[name]}
    for grain in ("TB11", "TB18", "TB88"):
        if counts[grain] == 0:
            raise AssertionError(f"{grain} never launched on the main "
                                 f"path: {counts}")
    # every served plan's kernel against its plain version, at the shapes
    # the main path gave it (after the counts were read)
    gen = torch.Generator().manual_seed(5)
    for plan in plans:
        x = torch.randn(plan.scene.in_shape(), generator=gen).cuda()
        w = sched._layers[_layer_of(chain, plan.scene)].flt
        fn, inp, flt, blocks = plan.kernel_call(x, w)
        got = fn(inp, flt, plan.exec_scene, **blocks)
        want = conv_plain(inp, flt, plan.exec_scene)
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=TOL["float32"],
                              atol=TOL["float32"]):
            raise AssertionError(f"{plan.describe()} disagrees with its "
                                 f"plain version (max abs err {err})")
        key = (plan.schedule, "float32")
        errs[key] = max(errs.get(key, 0.0), err)

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
    # a request of the bucket-8 dispatch served again alone (bucket 1,
    # other grains) is bitwise what it was coalesced: every kernel sums
    # tap-major, k ascending, whatever the batch, grain or tile
    alone = sess.serve([xs8[-1]])[0]
    if not torch.equal(alone, outs8[-1]):
        raise AssertionError("a request served alone differs bitwise from "
                             "the same request served coalesced")

    ms = np.asarray(lat) * 1e3
    print(f"main path: {stats['requests']} requests, {stats['dispatches']} "
          f"dispatches, prewarm {prewarm_s:.3f} s ({built} plans), "
          f"p50 {np.percentile(ms, 50):.3f} ms, p99 "
          f"{np.percentile(ms, 99):.3f} ms, deadline misses "
          f"{stats['deadline_misses']}, rel err vs plain chain {rel:.3e}")
    for name, by_bucket in grains.items():
        print(f"  {name} {chain[name].describe()[:60]} grain by bucket "
              f"{by_bucket}")
    print(f"  launches on the main path: {counts}; {len(plans)} served "
          f"plans held against their plain versions")
    return sched, chain, counts


def _layer_of(chain, scene) -> str:
    return next(n for n, sc in chain.items() if sc.with_batch(scene.B)
                == scene)


def layer_breakdown(torch, sched, chain, bucket: int = 1) -> float:
    """Time of each trunk layer's plan (padding, kernel, slicing) at
    ``bucket``, CUDA events around back-to-back calls (so the host's time
    per call counts where it is the longer), and the device time of its
    kernel alone, of every grain's kernel forced on the same layer (the
    data a calibrated selector would rank by) and of ``F.conv2d`` on the
    same input (TF32 off); returns the trunk's plan-time sum in ms."""
    from repro_torch.plan import ConvOp, make_plan

    F = torch.nn.functional
    gen = torch.Generator().manual_seed(4)
    total = k_total = lib_total = 0.0
    for name, sc in chain.items():
        plan = sched.registry.get(sc.with_batch(bucket), ConvOp.FPROP)
        x = torch.randn(plan.scene.in_shape(), generator=gen).cuda()
        w = sched._layers[name].flt
        ms = time_ms(torch, lambda: plan.execute(x, w))
        fn, inp, flt, blocks = plan.kernel_call(x, w)
        k_ms = device_ms(torch, lambda: fn(inp, flt, plan.exec_scene,
                                           **blocks))
        total += ms
        k_total += k_ms
        forced = {}
        for grain in ("TB11", "TB18", "TB88"):
            try:
                fp = make_plan(plan.scene, policy=grain)
            except ValueError:
                continue
            ffn, finp, fflt, fblocks = fp.kernel_call(x, w)
            forced[grain] = round(device_ms(torch, lambda: ffn(
                finp, fflt, fp.exec_scene, **fblocks)), 4)
        sc = plan.scene
        x_nchw = x.permute(3, 2, 0, 1).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            lib_ms = device_ms(torch, lambda: F.conv2d(
                x_nchw, w_oihw, stride=(sc.stdH, sc.stdW),
                padding=(sc.padH, sc.padW)))
        lib_total += lib_ms
        print(f"  {name} B={bucket} {plan.describe()} "
              f"{getattr(plan.choice, 'tile', '')}: {ms:.4f} ms "
              f"(kernel {k_ms:.4f}, modeled "
              f"{plan.choice.predicted_s * 1e3:.4f}, "
              f"{sc.flops / k_ms / 1e6:.1f} GFLOP/s); "
              f"F.conv2d {lib_ms:.4f} ms; forced grains ms {forced}")
    print(f"  trunk B={bucket}: plans {total:.4f} ms per forward (events), "
          f"kernels {k_total:.4f} ms (device), F.conv2d layer by layer "
          f"{lib_total:.4f} ms (device)")
    return total


def timing_phase(torch, sched, chain, counts, errs):
    """Per kernel, at its layer of ``TIMING_LAYERS`` (batch 1): kernel,
    plain version, F.conv2d; where the selector picks another grain
    there, the grain is forced (the row says so).  A second row,
    ``<name>_main_path``, times the grain's served plan whose kernel took
    the longest (device time) and names its layer and bucket."""
    from repro_torch.plan import ConvOp, make_plan

    rows = []
    gen = torch.Generator().manual_seed(10)
    for grain in ("TB11", "TB18", "TB88"):
        name = TIMING_LAYERS[grain]
        plan = sched.registry.get(chain[name].with_batch(1), ConvOp.FPROP)
        where = name
        if plan.schedule != grain:
            plan = make_plan(plan.scene, policy=grain)
            where = f"{name} (forced: off the main path)"
        rows.append(_grain_row(torch, sched, chain, plan, counts, errs,
                               f"mg3m_{grain.lower()}", where))
        served = []
        for p in sched.registry.plans().values():
            if p.schedule != grain:
                continue
            x = torch.randn(p.scene.in_shape(), generator=gen).cuda()
            w = sched._layers[_layer_of(chain, p.scene)].flt
            fn, inp, flt, blocks = p.kernel_call(x, w)
            served.append((device_ms(torch, lambda: fn(
                inp, flt, p.exec_scene, **blocks)), p))
        if not served:
            raise AssertionError(f"{grain} serves no plan on the main path")
        slow = max(served, key=lambda t: t[0])[1]
        rows.append(_grain_row(
            torch, sched, chain, slow, counts, errs,
            f"mg3m_{grain.lower()}_main_path",
            f"{_layer_of(chain, slow.scene)} (served: the longest of "
            f"{len(served)} {grain} plans)"))
    return rows


def _grain_row(torch, sched, chain, plan, counts, errs, row_name, where):
    """One ``kernels`` row: the plan's kernel, its plain version and
    ``F.conv2d`` on one seeded input, beside the kernel's bound."""
    from repro_torch.kernels.mg3m_conv import conv_plain

    F = torch.nn.functional
    grain, sc = plan.schedule, plan.scene
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(sc.in_shape(), generator=gen).cuda()
    w = sched._layers[_layer_of(chain, sc)].flt
    fn, inp, flt, blocks = plan.kernel_call(x, w)
    got = fn(inp, flt, sc, **blocks)
    want = conv_plain(inp, flt, sc)
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=TOL["float32"],
                          atol=TOL["float32"]):
        raise AssertionError(f"{plan.describe()} disagrees with its plain "
                             f"version (max abs err {err})")
    errs[(grain, "float32")] = max(errs.get((grain, "float32"), 0.0), err)
    x_nchw = x.permute(3, 2, 0, 1).contiguous()
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_ms = device_ms(torch, lambda: F.conv2d(
            x_nchw, w_oihw, stride=(sc.stdH, sc.stdW),
            padding=(sc.padH, sc.padW)))
    k_ms = device_ms(torch, lambda: fn(inp, flt, sc, **blocks))
    p_ms = time_ms(torch, lambda: conv_plain(inp, flt, sc))
    nbytes = (inp.numel() * inp.element_size()
              + flt.numel() * flt.element_size()
              + got.numel() * got.element_size())
    ops_ms = sc.flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BW * 1e3
    print(f"  {grain} at {where} B={sc.B}: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms, bound "
          f"{max(ops_ms, bytes_ms):.4f} ms")
    return {
        "name": row_name, "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES[grain],
        "launches": counts[grain],
        "max_abs_err": errs[(grain, "float32")],
        "max_abs_err_bf16": errs.get((grain, "bfloat16")),
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": lib_ms,
        "shape": f"{where} B={sc.B} {plan.describe()}",
        "gflop": sc.flops / 1e9, "mbytes": nbytes / 1e6,
    }


# --------------------------------------------------------------------------
# LM path: full-width zamba2-7b through ServeEngine (causal_conv1d, flash)
# --------------------------------------------------------------------------
LM_ARCH = "zamba2-7b"
LM_KERNELS = {
    "causal_conv1d": ("src/repro_torch/csrc/causal_conv1d.cu",
                      "src/repro/kernels/causal_conv1d.py:38"),
    "flash_attention_fwd": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:75"),
}
LM_TOL = {("causal_conv1d", "float32"): 1e-4,
          ("flash_attention_fwd", "float32"): 2e-4,
          ("causal_conv1d", "bfloat16"): 2e-2,
          ("flash_attention_fwd", "bfloat16"): 2e-2}
# (B, L, D, K): tests/test_kernels.py:88-90
CONV1D_SHAPES = [(2, 32, 16, 4), (1, 7, 5, 3), (3, 100, 64, 4),
                 (2, 16, 16, 2), (1, 64, 128, 4)]
# (B, S, T, Hq, Hkv, D): tests/test_flash_kernel.py:27-32, then D = 112
FLASH_SHAPES = [(2, 64, 64, 4, 4, 32), (2, 64, 64, 8, 2, 32),
                (1, 128, 128, 4, 1, 64), (2, 96, 96, 2, 2, 16),
                (2, 255, 255, 8, 4, 112)]
PREFILL_B, PREFILL_S = 2, 2048
ORACLE_S = 256            # lengths over the SSD chunk (256) must be multiples
# max |decode - forward| / max |logit| in bf16: each layer rounds some ten
# intermediates at 2^-9 relative, which add over 81 layers like a random
# walk to about sqrt(810) * 2^-9 = 0.056 of the hidden state's scale; the
# head carries that to the logits.  Twice that is allowed.
ORACLE_TOL = 0.1
PROMPT_LENS = (17, 64, 255, 600)
MAX_NEW = 16
MAX_LEN = 640


def lm_shapes(cfg):
    """The kernels' operand shapes on the LM path's prefill: causal_conv1d
    x ``[B, L, conv_dim]`` and K; flash q ``(B*H, S, D)``, k/v
    ``(B*Hkv, S, D)``."""
    conv_dim = cfg.ssm.expand * cfg.d_model \
        + 2 * cfg.ssm.n_groups * cfg.ssm.state
    return ((PREFILL_B, PREFILL_S, conv_dim), cfg.ssm.conv_kernel,
            (PREFILL_B * cfg.n_heads, PREFILL_S, cfg.d_head),
            (PREFILL_B * cfg.n_kv_heads, PREFILL_S, cfg.d_head))


def _hold(torch, name, dtype, got, want, errs, what):
    tol = LM_TOL[(name, dtype)]
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{name} {dtype} disagrees with its plain "
                             f"version (max abs err {err}) on {what}")
    errs[(name, dtype)] = max(errs.get((name, dtype), 0.0), err)


def lm_kernel_phase(torch):
    """causal_conv1d and flash attention on the reference's test shapes and
    the LM path's, f32 and bf16, each launch held against the plain
    version on the same operands.  Returns max abs errors."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)

    (b0, l0, c0), k0, (bh, s0, d0), (bhkv, _, _) = lm_shapes(
        get_config(LM_ARCH))
    conv_shapes = CONV1D_SHAPES + [(b0, l0, c0, k0)]
    flash_shapes = FLASH_SHAPES + [(PREFILL_B, s0, s0, bh // PREFILL_B,
                                    bhkv // PREFILL_B, d0)]
    gen = torch.Generator().manual_seed(5)
    errs, checks = {}, 0
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)

        def rand(*shape):
            return torch.randn(shape, generator=gen).to("cuda", tdt)

        for b, l, d, k in conv_shapes:
            x, w = rand(b, l, d), rand(k, d)
            _hold(torch, "causal_conv1d", dtype, causal_conv1d(x, w),
                  causal_conv1d_plain(x, w), errs, f"x {(b, l, d)} K={k}")
            checks += 1
        for b, s, t, hq, hkv, d in flash_shapes:
            q, k, v = rand(b * hq, s, d), rand(b * hkv, t, d), \
                rand(b * hkv, t, d)
            for causal in (True, False):
                _hold(torch, "flash_attention_fwd", dtype,
                      flash_attention_fwd(q, k, v, causal=causal),
                      flash_attention_plain(q, k, v, causal=causal), errs,
                      f"q {tuple(q.shape)} k {tuple(k.shape)} "
                      f"causal={causal}")
                checks += 1
    torch.cuda.synchronize()
    print(f"LM kernels: {checks} launches held against their plain "
          f"versions in {time.perf_counter() - t0:.1f} s; max abs err "
          f"{ {f'{n}/{d}': e for (n, d), e in sorted(errs.items())} }")
    return errs


def _lm_counts():
    from repro_torch.kernels.causal_conv1d import causal_conv1d
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    return {"causal_conv1d": causal_conv1d.launches,
            "flash_attention_fwd": flash_attention_fwd.launches}


def _reset_lm_counts():
    from repro_torch.kernels.causal_conv1d import causal_conv1d
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    causal_conv1d.launches = 0
    flash_attention_fwd.launches = 0


def _serve(torch, cfg, model, prompts, join: bool):
    """Greedy requests through a fresh 2-slot ServeEngine; with ``join``
    the first request decodes one step alone before the rest are
    submitted.  Returns (requests, latency s by rid, decode steps)."""
    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(cfg, model, slots=2, max_len=MAX_LEN)
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    sent, lat = {0: time.perf_counter()}, {}
    eng.submit(reqs[0])
    if join:
        eng.step()
    for r in reqs[1:]:
        sent[r.rid] = time.perf_counter()
        eng.submit(r)
    steps = int(join)
    while eng.queue or any(a is not None for a in eng.active):
        eng.step()                 # ends in a host read of the tokens
        steps += 1
        now = time.perf_counter()
        for r in reqs:
            if r.done and r.rid not in lat:
                lat[r.rid] = now - sent[r.rid]
    return reqs, lat, steps


def _kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash_attention"
    if "causal_conv1d" in low:
        return "causal_conv1d"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet", "sm90")):
        return "matmul"
    if "reduce" in low or "softmax" in low or "scan" in low:
        return "reduction"
    if "elementwise" in low or "copy" in low or "cat" in low:
        return "elementwise/copy"
    return "other"


def lm_profile(torch, fn, label: str) -> None:
    """One call of ``fn`` under ``torch.profiler``: wall time, the
    device's busy time (the sum of kernel times; one stream) and idle
    share, and device time by kernel class.  Profiling adds host time, so
    the idle share is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print(f"  profile {label}: wall {wall_ms:.1f} ms; the profiler saw "
              f"no device time (device busy time not measured)")
        return
    by_class = {}
    for e in kernels:
        c = _kernel_class(e.key)
        ms, n = by_class.get(c, (0.0, 0))
        by_class[c] = (ms + e.self_device_time_total / 1e3, n + e.count)
    parts = ", ".join(f"{c} {ms:.1f} ms ({ms / busy_ms:.0%}, {n} launches)"
                      for c, (ms, n) in sorted(by_class.items(),
                                               key=lambda kv: -kv[1][0]))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    print(f"  profile {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle {1 - busy_ms / wall_ms:.0%}; {parts}; "
          f"top kernels: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms "
              f"x{e.count}" for e in top))


def lm_path(torch, np):
    """Full-width zamba2-7b on the card: the cross-form oracle, then the
    main path (prefill 2 x 2048, ServeEngine) with launch counts read
    around it, the isolation check and the card-vs-CPU check on the
    reduced config.  Returns the main path's launch counts."""
    import copy

    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.models.transformer import init_params

    F = torch.nn.functional
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)                 # device None: the card
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"LM path: {cfg.name} ({cfg.n_layers} layers: "
          f"{len(model.groups)} groups of {cfg.attn_every} + "
          f"{len(model.tail)} tail; d_model {cfg.d_model}, {cfg.n_heads}x"
          f"{cfg.d_head} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, SSM "
          f"state {cfg.ssm.state}, {cfg.dtype}), {n_params / 1e9:.3f} B "
          f"params, {n_bytes / 1e9:.2f} GB, seeded init "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator().manual_seed(6)

    def tokens(b, s):
        return torch.randint(0, cfg.vocab, (b, s), generator=gen).cuda()

    with torch.no_grad():
        # the reference's cross-form oracle (tests/test_models.py:47-72)
        toks = tokens(2, ORACLE_S)
        full, _ = model(tokens=toks)
        _, cache = model.prefill(tokens=toks[:, :-1])
        cache["kv"] = {k: F.pad(v, (0, 0, 0, 0, 0, 1))
                       for k, v in cache["kv"].items()}
        dec, _ = model.decode_step(
            cache, torch.full((2,), ORACLE_S - 1, device="cuda"),
            tokens=toks[:, -1:])
        want, got = full[:, -1], dec[:, 0]
        if not (torch.isfinite(want).all() and torch.isfinite(got).all()):
            raise AssertionError("non-finite logits in the oracle")
        rel = ((got - want).abs().max() / want.abs().max()).item()
        agree = (got.argmax(-1) == want.argmax(-1)).tolist()
        print(f"  oracle prefill({ORACLE_S - 1}) + decode_step vs forward("
              f"{ORACLE_S}): max |diff| / max |logit| = {rel:.3e} (tol "
              f"{ORACLE_TOL}), max |logit| {want.abs().max().item():.3f}, "
              f"argmax agrees {agree}")
        if rel > ORACLE_TOL:
            raise AssertionError(f"decode does not match forward: {rel}")
        del full, cache, dec, want, got

        # the main path, launch counts read around it
        prompt_rng = np.random.default_rng(7)
        prompts = [prompt_rng.integers(0, cfg.vocab, n).tolist()
                   for n in PROMPT_LENS]
        ptoks = tokens(PREFILL_B, PREFILL_S)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_lm_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(tokens=ptoks)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        reqs, lat, steps = _serve(torch, cfg, model, prompts, join=True)
        counts = _lm_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if tuple(logits.shape) != (PREFILL_B, PREFILL_S, cfg.vocab) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 f"not finite or misshapen")
        kv_shape = tuple(cache["kv"]["k"].shape)
        if kv_shape != (len(model.groups), PREFILL_B, PREFILL_S,
                        cfg.n_kv_heads, cfg.d_head):
            raise AssertionError(f"prefill KV cache {kv_shape}")
        del logits, cache
        for r in reqs:
            if not (r.done and len(r.out) == MAX_NEW
                    and all(0 <= t < cfg.vocab for t in r.out)):
                raise AssertionError(f"request {r.rid} not served: {r}")
        for name, n in counts.items():
            if n == 0:
                raise AssertionError(f"{name} never launched on the LM "
                                     f"path: {counts}")

        # isolation: the joining request's neighbour, served alone
        solo, _, _ = _serve(torch, cfg, model, prompts[:1], join=False)
        if solo[0].out != reqs[0].out:
            raise AssertionError(f"request 0 served alone gave "
                                 f"{solo[0].out}, beside a joining request "
                                 f"{reqs[0].out}")

        # decode step time at the engine's batch (2 slots)
        cache = model.init_cache(2, MAX_LEN)
        pos = torch.full((2,), PROMPT_LENS[-1], device="cuda")
        tok = tokens(2, 1)
        dec_ms = time_ms(torch, lambda: model.decode_step(cache, pos,
                                                          tokens=tok),
                         iters=10)
        lm_profile(torch, lambda: model.decode_step(cache, pos, tokens=tok),
                   "decode step, 2 slots")
        del cache
        lm_profile(torch, lambda: model.prefill(tokens=ptoks),
                   f"prefill {PREFILL_B}x{PREFILL_S}")

        # the card against the CPU on the reduced config (f32)
        small = reduced(cfg)
        cpu_model = init_params(small, seed=1, device="cpu")
        card_model = copy.deepcopy(cpu_model).to("cuda")
        stoks = torch.randint(0, small.vocab, (2, 32), generator=gen)
        lc, cc = cpu_model.prefill(tokens=stoks)
        lg, cg = card_model.prefill(tokens=stoks.cuda())
        small_err = (lg.cpu() - lc).abs().max().item()
        if small_err > 1e-3:
            raise AssertionError(f"reduced {small.name}: card prefill logits "
                                 f"differ from the CPU's by {small_err}")

    ms = np.asarray([lat[r.rid] for r in reqs]) * 1e3
    print(f"  prefill {PREFILL_B}x{PREFILL_S} tokens: {prefill_s:.3f} s, "
          f"{PREFILL_B * PREFILL_S / prefill_s:.0f} tokens/s")
    print(f"  ServeEngine: {len(reqs)} requests (prompts {PROMPT_LENS}, "
          f"{MAX_NEW} new each) in {steps} steps; request latency p50 "
          f"{np.percentile(ms, 50):.1f} ms, max {ms.max():.1f} ms "
          f"({ {r.rid: round(lat[r.rid] * 1e3, 1) for r in reqs} }); "
          f"decode step at 2 slots {dec_ms:.2f} ms")
    print(f"  isolation: request 0 gives {reqs[0].out[:6]}... alone and "
          f"beside a joining request; reduced {small.name} card vs CPU "
          f"prefill logits max abs err {small_err:.3e}; peak memory "
          f"{peak_gb:.1f} GB")
    print(f"  launches on the LM path: {counts}")
    del model
    torch.cuda.empty_cache()
    return counts


def lm_timing_phase(torch, counts, errs):
    """Per kernel at the LM path's prefill shapes (bf16): kernel, plain
    version and one PyTorch call computing the same function."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.causal_conv1d import (causal_conv1d,
                                                   causal_conv1d_plain)
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)

    F = torch.nn.functional
    bf = torch.bfloat16
    (b, l, c), k, qshape, kvshape = lm_shapes(get_config(LM_ARCH))
    gen = torch.Generator().manual_seed(8)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", bf)

    def row(name, fn, plain, lib, lib_out, flops, nbytes, shape):
        source, replaces = LM_KERNELS[name]
        got = fn()
        _hold(torch, name, "bfloat16", got, plain(), errs, shape)
        lib_err = (lib_out(lib()).float() - got.float()).abs().max().item()
        k_ms = device_ms(torch, fn)
        p_ms = time_ms(torch, plain)
        lib_ms = device_ms(torch, lib)
        nbytes += got.numel() * got.element_size()
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_HBM_BW * 1e3
        print(f"  {name} at {shape}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, library {lib_ms:.4f} ms (max abs diff to the "
              f"kernel {lib_err:.3e}), bound {max(ops_ms, bytes_ms):.4f} ms")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": errs[(name, "float32")],
                "max_abs_err_bf16": errs[(name, "bfloat16")],
                "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": lib_ms, "shape": shape,
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6}

    x, w = rand(b, l, c), rand(k, c, scale=0.2)
    xt, wt = x.transpose(1, 2).contiguous(), w.t().contiguous()[:, None, :]
    rows = [row("causal_conv1d", lambda: causal_conv1d(x, w),
                lambda: causal_conv1d_plain(x, w),
                lambda: F.conv1d(xt, wt, padding=k - 1, groups=c)[..., :l],
                lambda y: y.transpose(1, 2), 2 * k * b * l * c,
                (x.numel() + w.numel()) * 2,
                f"x [{b}, {l}, {c}] bf16, K={k}")]
    del x, w, xt, wt
    q, kk, v = rand(*qshape), rand(*kvshape), rand(*kvshape)
    bh, s, d = qshape
    h = bh // PREFILL_B
    q4, k4, v4 = (t.view(PREFILL_B, -1, s, d) for t in (q, kk, v))
    k4, v4 = (t.repeat_interleave(h // t.shape[1], 1) for t in (k4, v4))
    rows.append(row(
        "flash_attention_fwd",
        lambda: flash_attention_fwd(q, kk, v, causal=True),
        lambda: flash_attention_plain(q, kk, v, causal=True),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        lambda o: o.reshape(bh, s, d), 4 * bh * s * s * d // 2,
        (q.numel() + kk.numel() + v.numel()) * 2,
        f"q ({bh}, {s}, {d}) bf16 causal, {h} heads x {PREFILL_B}"))
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
    t0 = time.perf_counter()
    cuda_build.load_all(SOURCES)
    print(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for src in SOURCES:
        print(f"ptxas: {src}: "
              f"{ptxas_summary(cuda_build.build_logs.get(src, ''))}")
        counts = tensor_core_counts(cuda_build.build(src)[0])
        hg = sum(c[0] for c in counts.values())
        hm = sum(c[1] for c in counts.values())
        print(f"sass: {src}: {len(counts)} kernels, HGMMA {hg}, HMMA {hm}")
        if src == "flash_attention.cu":
            bf16 = {n: c for n, c in counts.items()
                    if "flash_fwd_bf16_kernel" in n}
            if not bf16 or not all(sum(c) for c in bf16.values()):
                raise AssertionError(f"the bf16 flash kernel issues no "
                                     f"tensor-core instruction: {bf16}")

    errs = {}
    t0 = time.perf_counter()
    n = kernel_phase(torch, errs)
    print(f"kernels: {n} launches held against their plain versions in "
          f"{time.perf_counter() - t0:.1f} s; max abs err "
          f"{ {f'{g}/{d}': e for (g, d), e in sorted(errs.items())} }")

    sched, chain, counts = main_path(torch, np, errs)
    for bucket in (1, 2, 4, 8):
        layer_breakdown(torch, sched, chain, bucket)
    rows = timing_phase(torch, sched, chain, counts, errs)

    lm_errs = lm_kernel_phase(torch)
    lm_counts = lm_path(torch, np)
    rows += lm_timing_phase(torch, lm_counts, lm_errs)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
