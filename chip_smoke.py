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
  6. train    the full-width ResNet trunk (``cnn_chain_scenes("resnet",
               8)``, a 10-class head) trained in f32 at a global batch of
               16 in 2 microbatches of 8: its 30 fprop/dgrad/wgrad plans
               built on a fresh registry (no reference plan), then, with
               the launch counts set to 0, one warm-up step and five
               inside a ``resolution_guard``; the loss must fall and each
               grain's launches must equal what the plans route to it
               (every direction but the first layer's dgrad, which the
               images do not need).  Step ms (CUDA events), images/s,
               peak memory; on each microbatch, the kernels' forward
               against ``F.conv2d``'s on the same ReLU branches (within
               2e-5 of max |z| per layer, at most 1e-6 of the
               pre-activations flipping branch between the two forwards)
               and every parameter's gradient against autograd of the
               same network on ``F.conv2d`` (TF32 off) on those branches
               within 2e-4 of max |g|, and the step's gradient norm
               against the norm of the oracle's mean over the
               microbatches within 2e-4; each (layer, direction) plan's kernel
               against its plain version (the first layer's dgrad too),
               then its device time beside the plan's, the bound and the
               PyTorch call for the same function (``F.conv2d``,
               ``conv2d_input``, ``conv2d_weight``); and the small-CNN
               launcher ``python -m repro_torch.launch.train_cnn
               --check-loss`` run in-process on the card.
  7. tune     ``repro_torch.tune`` on the card: the trunk's 10 fprop
               scenes at buckets 1, 2, 4 and 8 and the train step's 19
               dgrad/wgrad exec scenes (batch 8; the first layer's dgrad,
               never launched, left out), each exact (no proxy caps) through
               ``autotune_scene`` (top 4 of the analytic ranking, device
               time of 5 replays of a 3-execute CUDA graph) into a fresh
               ``ScheduleCache``, no measurement allowed to fail; a
               calibration fitted to the cache, saved and reloaded (median
               relative error per class before -> after).  Then a second
               ``ConvScheduler`` over the same trunk and weights under
               ``policy="tuned"``: every plan a tune-cache hit, the same
               requests at each bucket bitwise equal to the analytic
               session's, no measurement, plan build or resolution while
               serving, trunk kernel device time per bucket beside the
               analytic plans'; and phase 6's trainer under
               ``policy="tuned"``: its losses bitwise equal to phase 6's,
               step ms of both (interleaved), wgrad kernel ms per layer of
               both.  The tune cache and the calibration live in a
               temporary directory (``REPRO_TORCH_TUNE_CACHE``,
               ``REPRO_TORCH_CALIBRATION``, set before the port is
               imported and removed at exit), so no artifact of an earlier
               run changes this run's picks; phases 3-6 run under the
               analytic model.
  8. LM kernels  causal_conv1d on tests/test_kernels.py's shapes and flash
               attention on tests/test_flash_kernel.py's (causal and not,
               plus D = 112, and all of them again at D = 128), both also
               at the LM path's shapes, f32 and bf16, each held against its
               plain version: f32 within 1e-4 (conv) / 2e-4 (attention),
               bf16 within 2e-2.
  9. LM path   full-width zamba2-7b (81 layers, d_model 3584, 32x112
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
 10. LM timing  per kernel at the LM path's shapes: the kernel, its plain
               version and one PyTorch call computing the same function
               (``F.conv1d``, ``F.scaled_dot_product_attention``; never
               called by the port), beside the kernel's bound; and the
               flash kernels' D = 128 instance at q (64, 2048, 128) bf16
               causal, reported as the ``d128`` entry of the
               ``flash_attention_fwd`` row (zamba2-7b's head dim is 112:
               that instance is not on the LM path).
 11. train profile  one more train step of phase 6 under
               ``torch.profiler`` (device busy time and idle share), last
               so that no timed phase runs after a profiler session.

In the ``kernels`` line, ``ms`` and ``library_ms`` are device time (20
calls replayed from a CUDA graph, the host's time per call left out);
``plain_ms`` is CUDA-event time of 20 back-to-back calls (of the one
checking call on the ``_train_path`` rows), the host's time included.

The last three lines of output are the ``kernels`` JSON line (all five
kernels; each conv grain has a second row, ``<name>_main_path``, and each
grain the train step launches a row ``<name>_train_path`` at its longest
plan of the step), the card's name and power limit, and ``{"ok": true,
...}``.
"""
from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# Train path: the full-width ResNet trunk trained on the MG3M kernels
# --------------------------------------------------------------------------
TRAIN_NET = "resnet"
TRAIN_MB = 8               # microbatch: the plans' batch
TRAIN_N_MB = 2             # microbatches per step: a global batch of 16
TRAIN_STEPS = 5            # steps inside the resolution guard, after one
# Adam at 1e-3 or more throws this 10-layer plain trunk off in its first
# steps; 1e-4 descends monotonically (probed with F.conv2d on a CPU).
TRAIN_LR = 1e-4
# max |g - g_oracle| / max |g_oracle| per parameter: tests/test_autodiff.py's
# 2e-4 (the kernels and cuDNN sum in different orders)
GRAD_TOL = 2e-4
# max |z_kernel - z| / max |z| per layer of the forward, z the F.conv2d
# pre-activation on the kernels' ReLU branches: f32 sums of K <= 4608 terms
# in two orders differ by about sqrt(K) 2^-24 of the terms' scale (4e-6),
# and each layer passes the earlier ones' differences on; five times one
# layer's is allowed.  A flipped pre-activation lies within this of 0.
FWD_TOL = 2e-5
# ReLU branch flips between the two forwards, as a share of all
# pre-activations of the microbatch
FLIP_SHARE = 1e-6
TRAIN_LIBRARY = {"fprop": "F.conv2d", "dgrad": "conv2d_input",
                 "wgrad": "conv2d_weight"}


def train_path(torch, policy: str = "analytic"):
    """The trunk's 30 plans (under ``policy``) on a fresh registry, then
    one warm-up step and ``TRAIN_STEPS`` steps inside a
    ``resolution_guard``, with the launch counts set to 0 just before and
    read just after.  Every step trains on
    the stream's batch 0: i.i.d. class prototypes give nearly the same
    pooled features at 224 x 224 after ten random-init layers, so fresh
    batches show no learning within six steps, while a fixed batch's loss
    falls (probed with F.conv2d on a CPU).  Returns the run's state."""
    from repro_torch.core.autodiff import make_model_plans
    from repro_torch.data.pipeline import SyntheticImages
    from repro_torch.kernels import mg3m_conv as K
    from repro_torch.models.cnn import cnn_chain_scenes, init_cnn_from_scenes
    from repro_torch.plan import PlanRegistry
    from repro_torch.train import cnn as tc
    from repro_torch.train.optimizer import AdamWConfig

    scenes = cnn_chain_scenes(TRAIN_NET, TRAIN_MB)
    reg = PlanRegistry(device="cuda")
    t0 = time.perf_counter()
    plans = make_model_plans(scenes, registry=reg, policy=policy)
    plan_s = time.perf_counter() - t0
    walk = list(plans.plans())
    distinct = {(p.scene, p.op) for _, _, p in walk}
    if len(walk) != 3 * len(scenes) or len(reg) != len(distinct):
        raise AssertionError(f"{len(walk)} plans walked, {len(reg)} in the "
                             f"registry, for {len(scenes)} layers")
    if plans.reference_ops:
        raise AssertionError(f"trunk plans run the torch reference: "
                             f"{plans.reference_ops}")
    snap = reg.snapshot()
    params = init_cnn_from_scenes(torch.Generator().manual_seed(0), scenes,
                                  device="cuda")
    cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                      total_steps=1 + TRAIN_STEPS)
    pure_step = tc.build_cnn_train_step(
        plans, cfg, n_microbatches=TRAIN_N_MB,
        buckets=tc.make_grad_buckets(params), layer_order=plans.names())
    step = tc.jit_train_step(pure_step)
    state = tc.init_train_state(params)
    data = SyntheticImages(TRAIN_MB * TRAIN_N_MB, scenes[
        f"{TRAIN_NET}/L0"].inH, 3, 10, seed=0, noise=0.3)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in data.batch_at(0).items()}

    losses, event_ms, wall_ms = [], [], []

    def run():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        _, metrics = step(state, batch)
        end.record()
        losses.append(float(metrics["loss"]))   # waits for the step
        wall_ms.append((time.perf_counter() - t) * 1e3)
        event_ms.append(start.elapsed_time(end))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    run()                                       # warm-up
    with tc.resolution_guard():
        for _ in range(TRAIN_STEPS):
            run()
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = reg.stats(since=snap)

    if stats["misses"] or stats["builds"]:
        raise AssertionError(f"plans built or missed during training: "
                             f"{stats}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    # launches attributed by the plans' routing: each microbatch runs
    # every plan once but the first layer's dgrad (images need no
    # gradient); the wrappers' per-grain counts must equal the sums
    first = plans.names()[0]
    by_dir = {}
    for name, op, plan in walk:
        if (name, op) != (first, "dgrad"):
            key = (op, plan.schedule)
            by_dir[key] = by_dir.get(key, 0) + len(losses) * TRAIN_N_MB
    want = {g: sum(n for (_, gg), n in by_dir.items() if gg == g)
            for g in counts}
    if counts != want:
        raise AssertionError(f"launches {counts} differ from the plans' "
                             f"routing {want} ({by_dir})")
    for layer, triple in plans.items():
        print(f"  {layer}: " + "; ".join(
            f"{p.op.value} {p.schedule}{p.choice.tile} modeled "
            f"{p.predicted_s * 1e3:.3f} ms" for p in
            (triple.fprop, triple.dgrad, triple.wgrad)))
    steady = sorted(event_ms[1:])
    med = steady[len(steady) // 2]
    print(f"train path ({policy}): {len(scenes)} layers x 3 directions = "
          f"{len(walk)} "
          f"kernel plans ({len(reg)} distinct) built in {plan_s:.2f} s, "
          f"zero resolutions over "
          f"{TRAIN_STEPS} guarded steps; global batch "
          f"{TRAIN_MB * TRAIN_N_MB} in {TRAIN_N_MB} microbatches; losses "
          f"{[round(x, 4) for x in losses]}")
    print(f"  step ms (CUDA events): warm-up {event_ms[0]:.2f}, steady "
          f"{[round(x, 2) for x in event_ms[1:]]} (median {med:.2f}, "
          f"{TRAIN_MB * TRAIN_N_MB / med * 1e3:.1f} images/s); host wall "
          f"per step with the loss read {[round(x, 2) for x in wall_ms]}; "
          f"peak memory {peak_gb:.2f} GB")
    print(f"  launches by grain {counts}; by (direction, grain) "
          f"{ {f'{o}/{g}': n for (o, g), n in sorted(by_dir.items())} }")
    return {"plans": plans, "walk": walk, "state": state, "batch": batch,
            "step": step, "pure_step": pure_step, "scenes": scenes,
            "counts": counts, "step_ms": med, "losses": losses}


def _forward_branches(torch, run, mb):
    """The kernels' forward of one microbatch beside ``F.conv2d``'s on the
    kernels' ReLU branches: the branches (NCHW masks), and per layer
    max |dz| / max |z|, the branch flips and the largest flipped |z| /
    max |z|.  Raises if a layer's forward differs by more than
    ``FWD_TOL`` or the flips exceed ``FLIP_SHARE``."""
    from repro_torch.models.cnn import nhwc_to_plan

    F = torch.nn.functional
    plans, scenes, params = run["plans"], run["scenes"], run["state"].params
    masks, fwd, n_pre = {}, {}, 0
    with torch.no_grad():
        zk, zo = nhwc_to_plan(mb["images"]), mb["images"].permute(0, 3, 1, 2)
        for name in plans.names():
            sc = scenes[name]
            pre = plans[name].fprop.execute(zk, params[name])
            zk = torch.relu(pre)
            pre = pre.permute(3, 2, 0, 1)
            zo = F.conv2d(zo, params[name].permute(3, 2, 0, 1),
                          stride=(sc.stdH, sc.stdW),
                          padding=(sc.padH, sc.padW))
            scale = zo.abs().max()
            masks[name] = pre > 0
            flip = masks[name] != (zo > 0)
            n = int(flip.sum())
            fwd[name] = (((zo - pre).abs().max() / scale).item(), n,
                         (zo[flip].abs().max() / scale).item() if n else 0.0)
            n_pre += zo.numel()
            zo = zo * masks[name]
    worst = max(fwd, key=lambda k: fwd[k][0])
    flips = sum(v[1] for v in fwd.values())
    if fwd[worst][0] > FWD_TOL or flips > FLIP_SHARE * n_pre:
        raise AssertionError(
            f"the kernels' forward differs from F.conv2d's: {worst} "
            f"{fwd[worst][0]:.3e} of max |z| (tol {FWD_TOL}), {flips} ReLU "
            f"branch flips of {n_pre} (at most {FLIP_SHARE:g} of them); "
            f"(max |dz|, flips, max flipped |z|) by layer {fwd}")
    return masks, fwd, flips, n_pre


def train_grad_oracle(torch, run):
    """Every parameter's gradient on each microbatch through the kernels
    and through autograd of the same network on ``F.conv2d`` (TF32 off),
    and the step's gradient norm against the oracle's mean over the
    microbatches.

    Two f32 forwards that sum in different orders differ in the last bits,
    and a pre-activation within that of zero takes the other ReLU branch
    in one of them: its whole term then enters one gradient sum and not
    the other, so free-running forwards disagree by far more than
    rounding.  The oracle therefore takes each ReLU's branch from the
    kernels' forward, after ``_forward_branches`` has held that forward to
    ``F.conv2d``'s and bounded the flips; the free-running comparison and
    both sides against the branch-aligned oracle in f64 are printed for
    the first microbatch."""
    from repro_torch.train import cnn as tc
    from repro_torch.train.optimizer import global_norm

    F = torch.nn.functional
    plans, scenes = run["plans"], run["scenes"]
    params = run["state"].params

    def grads(loss_of, dtype=torch.float32):
        leaves = {k: p.detach().to(dtype).requires_grad_(True)
                  for k, p in params.items()}
        g = torch.autograd.grad(loss_of(leaves), list(leaves.values()))
        return dict(zip(leaves, g))

    def oracle_loss(p, mb, masks):
        z = mb["images"].to(p["head"].dtype).permute(0, 3, 1, 2)
        for name in plans.names():
            sc = scenes[name]
            z = F.conv2d(z, p[name].permute(3, 2, 0, 1),
                         stride=(sc.stdH, sc.stdW), padding=(sc.padH, sc.padW))
            z = torch.relu(z) if masks is None else z * masks[name]
        return tc.softmax_cross_entropy(z.mean(dim=(2, 3)) @ p["head"],
                                        mb["labels"])

    def rel(a, b):
        return {k: ((a[k].double() - b[k].double()).abs().max()
                    / b[k].double().abs().max().clamp_min(1e-30)).item()
                for k in a}

    mean = {k: torch.zeros_like(p) for k, p in params.items()}
    for i in range(TRAIN_N_MB):
        mb = {k: v[i * TRAIN_MB:(i + 1) * TRAIN_MB]
              for k, v in run["batch"].items()}
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            masks, fwd, flips, n_pre = _forward_branches(torch, run, mb)
            got = grads(lambda p: tc.cnn_loss_fn(p, mb, plans,
                                                 plans.names())[0])
            want = grads(lambda p: oracle_loss(p, mb, masks))
            if i == 0:
                free = grads(lambda p: oracle_loss(p, mb, None))
                f64 = grads(lambda p: oracle_loss(p, mb, masks),
                            torch.float64)
        for k in mean:
            mean[k] += want[k] / TRAIN_N_MB
        aligned = rel(got, want)
        worst = max(aligned, key=aligned.get)
        print(f"  microbatch {i}: gradients vs the F.conv2d oracle (the "
              f"kernels' ReLU branches): max |dg| / max |g| worst {worst} "
              f"{aligned[worst]:.3e} (tol {GRAD_TOL}); "
              f"{ {k: float(f'{v:.2e}') for k, v in aligned.items()} }; "
              f"forward max |dz| / max |z| worst "
              f"{max(v[0] for v in fwd.values()):.3e} (tol {FWD_TOL}), "
              f"{flips} ReLU branch flips of {n_pre} (largest flipped |z| / "
              f"max |z| {max(v[2] for v in fwd.values()):.3e})")
        if i == 0:
            print(f"  against the same oracle in f64: kernels worst "
                  f"{max(rel(got, f64).values()):.3e}, cuDNN f32 worst "
                  f"{max(rel(want, f64).values()):.3e}; free-running f32 "
                  f"oracle: worst {max(rel(got, free).values()):.3e}; "
                  f"(max |dz|, flips, max flipped |z|) by layer {fwd}")
            del free, f64
        if aligned[worst] > GRAD_TOL:
            raise AssertionError(f"microbatch {i}: gradient of {worst} "
                                 f"differs from the F.conv2d oracle: "
                                 f"{aligned[worst]:.3e} relative (all: "
                                 f"{aligned})")
    # the accumulated step: its (pre-clip) gradient norm is the norm of
    # the microbatches' mean gradient
    _, metrics = run["pure_step"](run["state"], run["batch"])
    step_norm = float(metrics["grad_norm"])
    want_norm = float(global_norm(mean))
    err = abs(step_norm - want_norm) / want_norm
    print(f"  step gradient norm {step_norm:.6e}, the oracle's over "
          f"{TRAIN_N_MB} microbatches {want_norm:.6e}: relative "
          f"{err:.3e} (tol {GRAD_TOL})")
    if err > GRAD_TOL:
        raise AssertionError(f"the step's gradient norm {step_norm} is not "
                             f"the oracle's mean-gradient norm {want_norm}")


def train_kernel_phase(torch, run):
    """Each (layer, direction) plan's kernel held against its plain version
    once on seeded operands (the first layer's dgrad too, though the step
    skips it), then timed: the kernel's and the plan's device time, the
    bound, and the PyTorch call computing the same function.  Returns the
    ``<grain>_train_path`` rows: each launched grain at its longest plan."""
    from repro_torch.kernels.mg3m_conv import conv_plain

    F = torch.nn.functional
    grad = torch.nn.grad
    gen = torch.Generator().manual_seed(12)
    errs, timed = {}, []
    sums = {"fprop": [0.0, 0.0, 0.0], "dgrad": [0.0, 0.0, 0.0],
            "wgrad": [0.0, 0.0, 0.0]}
    first = run["plans"].names()[0]
    t0 = time.perf_counter()
    for name, op, plan in run["walk"]:
        sc = plan.scene
        a_shape, b_shape, _ = plan.io_shapes()
        es = plan.exec_scene
        scale = (es.fltH * es.fltW * es.K) ** -0.5   # outputs O(1)
        a = torch.randn(a_shape, generator=gen).cuda()
        b = (torch.randn(b_shape, generator=gen) * scale).cuda()
        fn, inp, flt, blocks = plan.kernel_call(a, b)
        got = fn(inp, flt, es, **blocks)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = conv_plain(inp, flt, es)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, rtol=TOL["float32"],
                              atol=TOL["float32"]):
            raise AssertionError(f"{name} {plan.describe()} disagrees with "
                                 f"its plain version (max abs err {err})")
        errs[plan.schedule] = max(errs.get(plan.schedule, 0.0), err)
        del got, want
        k_ms = device_ms(torch, lambda: fn(inp, flt, es, **blocks))
        p_ms = device_ms(torch, lambda: plan.execute(a, b))
        stride, pad = (sc.stdH, sc.stdW), (sc.padH, sc.padW)
        nchw = lambda t: t.permute(3, 2, 0, 1).contiguous()   # noqa: E731
        if op == "fprop":
            xa, wb = nchw(a), nchw(b)
            lib = lambda: F.conv2d(xa, wb, stride=stride,      # noqa: E731
                                   padding=pad)
        elif op == "dgrad":
            ga, wb = nchw(a), nchw(b)
            in_nchw = (sc.B, sc.IC, sc.inH, sc.inW)
            lib = lambda: grad.conv2d_input(                  # noqa: E731
                in_nchw, wb, ga, stride=stride, padding=pad)
        else:
            xa, gb = nchw(a), nchw(b)
            w_oihw = (sc.OC, sc.IC, sc.fltH, sc.fltW)
            lib = lambda: grad.conv2d_weight(                 # noqa: E731
                xa, w_oihw, gb, stride=stride, padding=pad)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            lib_ms = device_ms(torch, lib)
        out_numel = 1
        for d in plan.io_shapes()[2]:
            out_numel *= d
        nbytes = 4 * (a.numel() + b.numel() + out_numel)
        ops_ms = sc.flops / PEAK_FP32_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_HBM_BW * 1e3
        bound = max(ops_ms, bytes_ms)
        in_step = (name, op) != (first, "dgrad")
        if in_step:
            for i, v in enumerate((k_ms, p_ms, lib_ms)):
                sums[op][i] += v
        print(f"  {name} {op} {plan.schedule}{plan.choice.tile} "
              f"{'' if in_step else '(not in the step) '}kernel "
              f"{k_ms:.4f} ms, plan {p_ms:.4f} ms (device), modeled "
              f"{plan.predicted_s * 1e3:.4f}, bound {bound:.4f} "
              f"({'operations' if ops_ms >= bytes_ms else 'bytes'}), "
              f"{TRAIN_LIBRARY[op]} {lib_ms:.4f} ms, plain {plain_ms:.1f} "
              f"ms, max abs err {err:.2e}")
        timed.append({"name": name, "op": op, "plan": plan, "k_ms": k_ms,
                      "plain_ms": plain_ms, "lib_ms": lib_ms,
                      "bound": bound, "ops_ms": ops_ms,
                      "bytes_ms": bytes_ms, "nbytes": nbytes,
                      "in_step": in_step})
        del a, b, inp, flt
    print(f"  per microbatch, device ms summed over the step's plans "
          f"(kernel / plan / library): "
          + "; ".join(f"{op} {k:.3f} / {p:.3f} / {lb:.3f}"
                      for op, (k, p, lb) in sums.items())
          + f"; all {sum(v[0] for v in sums.values()):.3f} / "
          f"{sum(v[1] for v in sums.values()):.3f} / "
          f"{sum(v[2] for v in sums.values()):.3f}; checks and timing "
          f"{time.perf_counter() - t0:.1f} s")

    rows = []
    for grain in ("TB11", "TB18", "TB88"):
        if run["counts"][grain] == 0:
            continue
        mine = [t for t in timed if t["plan"].schedule == grain
                and t["in_step"]]
        t = max(mine, key=lambda r: r["k_ms"])
        plan = t["plan"]
        rows.append({
            "name": f"mg3m_{grain.lower()}_train_path", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES[grain],
            "launches": run["counts"][grain], "max_abs_err": errs[grain],
            "ms": t["k_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound"],
            "bound_by": ("operations" if t["ops_ms"] >= t["bytes_ms"]
                         else "bytes"),
            "library_ms": t["lib_ms"],
            "library": TRAIN_LIBRARY[t["op"]],
            "shape": f"{t['name']} {t['op']} (the longest of {len(mine)} "
                     f"{grain} plans of the step) {plan.describe()}",
            "gflop": plan.scene.flops / 1e9, "mbytes": t["nbytes"] / 1e6})
    return rows


def train_profile(torch, run):
    """One more train step under ``torch.profiler``: its device busy and
    idle share.  Run last, after every timed phase, since a profiler
    session leaves the rest of its process's host work slower (the LM
    path's host-bound decode step was measured slower after one)."""
    return lm_profile(torch, lambda: run["step"](run["state"], run["batch"]),
                      f"train step (global batch {TRAIN_MB * TRAIN_N_MB})")


def train_phase(torch):
    """Train the trunk, check its gradients and kernels, time them, run the
    small-model launcher, then drop what the launcher left in the
    process-wide defaults; returns the ``<grain>_train_path`` rows and the
    trunk's run (for ``train_profile``)."""
    import gc

    from repro_torch import obs
    from repro_torch.launch import train_cnn
    from repro_torch.plan.registry import set_default_registry

    t0 = time.perf_counter()
    run = train_path(torch)
    train_grad_oracle(torch, run)
    rows = train_kernel_phase(torch, run)
    losses = train_cnn.main(["--check-loss"])      # device: the card
    print(f"  launcher (small CNN, defaults, on the card): {len(losses)} "
          f"steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    set_default_registry(None)
    obs.set_default_metrics(None)
    obs.set_default_tracer(None)
    obs.set_default_monitor(None)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train phase: {time.perf_counter() - t0:.1f} s; step "
          f"{run['step_ms']:.2f} ms")
    return rows, run


# --------------------------------------------------------------------------
# Tune phase: repro_torch.tune on the trunk's exact scenes, a calibration
# fitted to them, then policy="tuned" served and trained beside the
# analytic runs
# --------------------------------------------------------------------------
TUNE_BUCKETS = (1, 2, 4, 8)
TUNE_TOP_K = 4
TUNE_ITERS = 5


def tune_scenes(chain, run):
    """``{label: scene}``: the trunk's fprop scenes at every bucket of
    ``TUNE_BUCKETS`` and the train step's dgrad and wgrad exec scenes (the
    first layer's dgrad, never launched, left out)."""
    scenes = {f"{name} fprop B={b}": sc.with_batch(b)
              for name, sc in chain.items() for b in TUNE_BUCKETS}
    first = run["plans"].names()[0]
    for name, op, plan in run["walk"]:
        if op != "fprop" and (name, op) != (first, "dgrad"):
            scenes[f"{name} {op} B={TRAIN_MB}"] = plan.exec_scene
    return scenes


def tune_and_calibrate(torch, chain, run):
    """Tune every scene of ``tune_scenes`` on the card into a fresh
    ``ScheduleCache`` (at ``$REPRO_TORCH_TUNE_CACHE``, the smoke's
    temporary directory), with no measurement allowed to fail or to run
    out of time; then fit, save and reload a calibration from it.  Returns
    the cache."""
    from repro_torch import tune
    from repro_torch.core.mapping import select_schedule, smem_budget
    from repro_torch.obs.metrics import default_metrics

    m = default_metrics()
    n0 = m.value("repro.tune.measurements")
    f0 = m.value("repro.tune.measure_failures")
    o0 = m.value("repro.tune.measure_timeouts")
    cache = tune.ScheduleCache()
    tune.set_default_cache(cache)
    backend = tune.default_backend("cuda")
    budget = smem_budget("cuda")
    scenes = tune_scenes(chain, run)
    t0 = time.perf_counter()
    agree = 0
    for label, sc in scenes.items():
        a = select_schedule(sc, budget=budget)
        t = tune.autotune_scene(sc, cache=cache, top_k=TUNE_TOP_K,
                                iters=TUNE_ITERS, device="cuda")
        agree += (t.choice.schedule, t.choice.tile) == (a.schedule, a.tile)
        print(f"  {label}: analytic {a.schedule}{a.tile} modeled "
              f"{a.predicted_s * 1e3:.4f} ms, measured "
              f"{t.analytic_measured_us * 1e-3:.4f} ms; tuned "
              f"{t.choice.schedule}{t.choice.tile} "
              f"{t.measured_us * 1e-3:.4f} ms ({t.n_candidates} timed)")
    tune_s = time.perf_counter() - t0
    measured = m.value("repro.tune.measurements") - n0
    failures = m.value("repro.tune.measure_failures") - f0
    timeouts = m.value("repro.tune.measure_timeouts") - o0
    path = cache.save()
    distinct = len(set(scenes.values()))   # a dgrad scene may be an fprop's
    print(f"tune: {len(scenes)} exact scenes ({distinct} distinct), "
          f"{int(measured)} candidates "
          f"measured, {int(failures)} failures, {int(timeouts)} timeouts, "
          f"tuned pick = analytic pick "
          f"on {agree}; {tune_s:.1f} s; backend {backend!r}, "
          f"{tune.CODE_VERSION}, cache {path}")
    if failures or timeouts or len(cache) != distinct:
        raise AssertionError(f"{int(failures)} measurements failed, "
                             f"{int(timeouts)} timed out; "
                             f"{len(cache)} of {distinct} scenes cached")

    report = tune.fit_calibration(cache, backend=backend)
    calib = tune.save_calibration(report)
    if tune.load_calibration(calib, backend=backend).corrections != \
            report.cost_model().corrections:
        raise AssertionError("calibration artifact round trip differs")
    for f in report.classes:
        print(f"  class {f.cls}: {f.n_samples} samples, {f.method}, median "
              f"|pred - meas| / meas {f.median_err_before:.3f} -> "
              f"{f.median_err_after:.3f}")
    print(f"calibrate: {report.n_records} samples ({report.n_skipped} "
          f"skipped); median |pred - meas| / meas "
          f"{report.median_err_before:.3f} -> {report.median_err_after:.3f};"
          f" artifact {calib}")
    if not report.n_records:
        raise AssertionError("no calibration samples")
    return cache


def _trunk_kernel_ms(torch, sched, chain, bucket: int) -> float:
    """Device time of the trunk's kernels at ``bucket`` under ``sched``'s
    plans (one seeded input per layer)."""
    from repro_torch.plan import ConvOp

    gen = torch.Generator().manual_seed(21)
    total = 0.0
    for name, sc in chain.items():
        plan = sched.registry.get(sc.with_batch(bucket), ConvOp.FPROP,
                                  policy=sched.policy)
        x = torch.randn(plan.scene.in_shape(), generator=gen).cuda()
        fn, inp, flt, blocks = plan.kernel_call(x, sched._layers[name].flt)
        total += device_ms(torch, lambda: fn(inp, flt, plan.exec_scene,
                                             **blocks))
    return total


def tuned_serve(torch, sched, chain, cache):
    """A second scheduler over the same trunk and weights under
    ``policy="tuned"``: every plan from the tune cache, then the same
    requests at each bucket served by both sessions, bitwise equal, with
    no measurement, plan build or resolution while serving."""
    from repro_torch.obs.metrics import default_metrics
    from repro_torch.plan import ConvOp
    from repro_torch.serve.sched import ConvScheduler, SchedConfig

    m = default_metrics()
    tsched = ConvScheduler(max_batch=8, strict=True, policy="tuned",
                           device="cuda",
                           config=SchedConfig(max_gather_s=0.005,
                                              flush_margin_s=0.002))
    tsched.register_net("resnet", chain,
                        {n: sched._layers[n].flt for n in chain},
                        activation=torch.relu)
    h0, miss0 = cache.hits, cache.misses
    tsched.prewarm(compile=True)
    n_plans = len(tsched.registry)
    if cache.hits - h0 != n_plans or cache.misses != miss0:
        raise AssertionError(f"{n_plans} tuned plans built with "
                             f"{cache.hits - h0} tune-cache hits and "
                             f"{cache.misses - miss0} misses")
    asess, tsess = sched.session("resnet"), tsched.session("resnet")
    sc0 = chain["resnet/L0"]
    gen = torch.Generator().manual_seed(20)
    snap = tsched.snapshot()
    meas0 = m.value("repro.tune.measurements")
    res0 = m.value("repro.plan.resolutions")
    n_out = 0
    for b in TUNE_BUCKETS:
        xs = [torch.randn(sc0.in_shape()[:3] + (1,), generator=gen)
              for _ in range(b)]
        want, got = asess.serve(xs), tsess.serve(xs)
        for w, g in zip(want, got):
            if not torch.equal(w, g):
                raise AssertionError(
                    f"bucket {b}: the tuned session's output differs from "
                    f"the analytic session's (max abs diff "
                    f"{(w - g).abs().max().item()})")
            n_out += 1
    stats = tsched.stats(since=snap)
    resolutions = m.value("repro.plan.resolutions") - res0
    measured = m.value("repro.tune.measurements") - meas0
    if resolutions or measured or stats["plan_builds"] or \
            stats["plan_misses"]:
        raise AssertionError(f"tuned serving resolved {resolutions}, "
                             f"measured {measured}: {stats}")
    grains = {name: {b: tsched.registry.get(sc.with_batch(b), ConvOp.FPROP,
                                            policy="tuned").schedule
                     for b in TUNE_BUCKETS} for name, sc in chain.items()}
    print(f"tuned serve: {n_plans} plans, all {cache.hits - h0} from the "
          f"tune cache; {n_out} outputs at buckets {TUNE_BUCKETS} bitwise "
          f"equal to the analytic session's; 0 resolutions, 0 measurements "
          f"while serving; grains {grains}")
    for b in TUNE_BUCKETS:
        a_ms = _trunk_kernel_ms(torch, sched, chain, b)
        t_ms = _trunk_kernel_ms(torch, tsched, chain, b)
        print(f"  trunk kernels per forward, B={b}: analytic {a_ms:.4f} ms, "
              f"tuned {t_ms:.4f} ms (device)")


def _wgrad_kernel_ms(torch, run) -> dict:
    """Device ms of each layer's wgrad kernel in ``run`` (seeded
    operands)."""
    gen = torch.Generator().manual_seed(22)
    out = {}
    for name, op, plan in run["walk"]:
        if op != "wgrad":
            continue
        a_shape, b_shape, _ = plan.io_shapes()
        a = torch.randn(a_shape, generator=gen).cuda()
        b = torch.randn(b_shape, generator=gen).cuda()
        fn, inp, flt, blocks = plan.kernel_call(a, b)
        out[name] = (device_ms(torch, lambda: fn(inp, flt, plan.exec_scene,
                                                 **blocks)),
                     f"{plan.schedule}{plan.choice.tile}")
    return out


def _step_ms(torch, run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run["step"](run["state"], run["batch"])
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def tuned_train(torch, run):
    """The trainer of ``train_path`` again, its plans under
    ``policy="tuned"``: its losses must equal the analytic run's bitwise,
    with no measurement; then step ms of both runs, interleaved, and each
    layer's wgrad kernel ms beside the analytic run's."""
    from repro_torch.obs.metrics import default_metrics

    m = default_metrics()
    meas0 = m.value("repro.tune.measurements")
    tuned = train_path(torch, policy="tuned")
    if m.value("repro.tune.measurements") != meas0:
        raise AssertionError("the tuned trainer measured")
    if tuned["losses"] != run["losses"]:
        raise AssertionError(f"tuned losses {tuned['losses']} differ from "
                             f"the analytic run's {run['losses']}")
    times = {"analytic": [], "tuned": []}
    for _ in range(5):
        for key, r in (("analytic", run), ("tuned", tuned)):
            times[key].append(_step_ms(torch, r))
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    wa, wt = _wgrad_kernel_ms(torch, run), _wgrad_kernel_ms(torch, tuned)
    print(f"tuned train: {len(tuned['losses'])} losses bitwise equal to the "
          f"analytic run's; step ms (CUDA events, median of 5, "
          f"interleaved): analytic {med['analytic']:.2f}, tuned "
          f"{med['tuned']:.2f}; wgrad kernels per microbatch: analytic "
          f"{sum(v[0] for v in wa.values()):.3f} ms, tuned "
          f"{sum(v[0] for v in wt.values()):.3f} ms (device)")
    for name in wa:
        print(f"  {name} wgrad: analytic {wa[name][1]} {wa[name][0]:.4f} "
              f"ms, tuned {wt[name][1]} {wt[name][0]:.4f} ms")
    del tuned


def tune_phase(torch, sched, chain, run):
    """Tune, calibrate, then serve and train under ``policy="tuned"``."""
    import gc

    t0 = time.perf_counter()
    cache = tune_and_calibrate(torch, chain, run)
    tuned_serve(torch, sched, chain, cache)
    tuned_train(torch, run)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tune phase: {time.perf_counter() - t0:.1f} s")


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
# (B, S, T, Hq, Hkv, D): tests/test_flash_kernel.py:27-32, then D = 112,
# then those shapes at D = 128 (the dense configs' head dim) and a ragged one
FLASH_SHAPES = [(2, 64, 64, 4, 4, 32), (2, 64, 64, 8, 2, 32),
                (1, 128, 128, 4, 1, 64), (2, 96, 96, 2, 2, 16),
                (2, 255, 255, 8, 4, 112)]
FLASH_SHAPES += [shape[:5] + (128,) for shape in FLASH_SHAPES]
# the D = 128 timing: q (B*H = 64, 2048, 128), 4 query heads per kv head
FLASH128_B, FLASH128_H, FLASH128_HKV = 2, 32, 8
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


def _hold(torch, name, dtype, got, want, errs, what, key=None):
    """Hold ``got`` to the plain version's ``want`` at ``LM_TOL``; the
    error is kept under ``(key or name, dtype)``."""
    tol = LM_TOL[(name, dtype)]
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        raise AssertionError(f"{name} {dtype} disagrees with its plain "
                             f"version (max abs err {err}) on {what}")
    k = (key or name, dtype)
    errs[k] = max(errs.get(k, 0.0), err)


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
                got = flash_attention_fwd(q, k, v, causal=causal)
                want = flash_attention_plain(q, k, v, causal=causal)
                what = (f"q {tuple(q.shape)} k {tuple(k.shape)} "
                        f"causal={causal}")
                _hold(torch, "flash_attention_fwd", dtype, got, want, errs,
                      what)
                if d == 128:
                    _hold(torch, "flash_attention_fwd", dtype, got, want,
                          errs, what, key="flash_d128")
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
    if "mg3m" in low:
        return "mg3m_conv"
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


def lm_profile(torch, fn, label: str):
    """One call of ``fn`` under ``torch.profiler``: wall time, the
    device's busy time (the sum of kernel times; one stream) and idle
    share, and device time by kernel class.  Profiling adds host time, so
    the idle share is an upper bound.  Returns ``{"wall_ms", "busy_ms",
    "idle"}``, or None when the profiler saw no device time."""
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
        return None
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
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle": 1 - busy_ms / wall_ms}


def lm_path(torch, np):
    """Full-width zamba2-7b on the card: the cross-form oracle, then the
    main path (prefill 2 x 2048, ServeEngine) with launch counts read
    around it, the isolation check and the card-vs-CPU check on the
    reduced config.  Returns the main path's launch counts and its times
    (prefill s, decode step ms, request latency p50/max ms, the two
    profiles)."""
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
        dec_prof = lm_profile(
            torch, lambda: model.decode_step(cache, pos, tokens=tok),
            "decode step, 2 slots")
        del cache
        pre_prof = lm_profile(torch, lambda: model.prefill(tokens=ptoks),
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
    return counts, {"prefill_s": prefill_s, "decode_ms": dec_ms,
                    "p50_ms": float(np.percentile(ms, 50)),
                    "max_ms": float(ms.max()), "decode_profile": dec_prof,
                    "prefill_profile": pre_prof}


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
    del q, kk, v, q4, k4, v4
    rows[-1]["d128"] = flash128_row(torch, row, rand, errs)
    return rows


def flash128_row(torch, row, rand, errs):
    """The flash kernels' D = 128 instance (bf16) at q (64, 2048, 128),
    causal, 4 query heads per kv head: kernel, plain version and
    ``scaled_dot_product_attention``, beside the bound; returned as the
    ``d128`` entry of the ``flash_attention_fwd`` row (off the LM path:
    zamba2-7b's head dim is 112)."""
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)

    F = torch.nn.functional
    b, h, hkv, s, d = (FLASH128_B, FLASH128_H, FLASH128_HKV, PREFILL_S,
                       128)
    q, kk, v = rand(b * h, s, d), rand(b * hkv, s, d), rand(b * hkv, s, d)
    q4, k4, v4 = (t.view(b, -1, s, d) for t in (q, kk, v))
    k4, v4 = (t.repeat_interleave(h // hkv, 1) for t in (k4, v4))
    got = row("flash_attention_fwd",
              lambda: flash_attention_fwd(q, kk, v, causal=True),
              lambda: flash_attention_plain(q, kk, v, causal=True),
              lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                     is_causal=True),
              lambda o: o.reshape(b * h, s, d), 4 * b * h * s * s * d // 2,
              (q.numel() + kk.numel() + v.numel()) * 2,
              f"q ({b * h}, {s}, {d}) bf16 causal, {h} heads x {b}, "
              f"{hkv} kv heads")
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "shape", "gflop", "mbytes")
    out = {k: got[k] for k in keep}
    out["max_abs_err"] = errs[("flash_d128", "float32")]
    out["max_abs_err_bf16"] = errs[("flash_d128", "bfloat16")]
    return out


def isolate_tune_artifacts() -> str:
    """Point the tune cache and the calibration artifact at a fresh
    temporary directory before anything imports the port, so that no
    earlier tuning run changes this run's picks; returns the directory."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = os.path.join(tmp,
                                                        "tune_cache.json")
    os.environ["REPRO_TORCH_CALIBRATION"] = os.path.join(tmp,
                                                         "calibration.json")
    return tmp


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run this "
              f"script from a checkout of the repository", file=sys.stderr)
        return 2
    tmp = isolate_tune_artifacts()
    try:
        return smoke(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def smoke(torch, tmp: str) -> int:
    sys.path.insert(0, str(SRC))
    import numpy as np

    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}; tune "
          f"artifacts in {tmp}")
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
    train_rows, train_run = train_phase(torch)
    rows += train_rows
    tune_phase(torch, sched, chain, train_run)

    lm_errs = lm_kernel_phase(torch)
    lm_counts, _ = lm_path(torch, np)
    rows += lm_timing_phase(torch, lm_counts, lm_errs)
    train_profile(torch, train_run)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
