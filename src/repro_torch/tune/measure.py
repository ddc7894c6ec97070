"""Measurement harness: time one candidate schedule through the real plan
dispatch (port of ``repro.tune.measure``).

What ``measure_choice`` times, and why it differs from the reference's
wall clock:

  * One ``ConvPlan`` pinned to the candidate (``make_plan(scene,
    policy=choice)``) and the seeded operands are built before the clock:
    schedule resolution and plan building are host work the hot path never
    repeats, so they are not the candidate's time.
  * On the card, the plan's ``execute`` (padding, the grain's kernel,
    slice-back) is timed on the device: after ``warmup`` eager calls,
    ``REPS`` back-to-back executes are captured in one CUDA graph, and each
    of ``iters`` replays is timed between two CUDA events; the result is the
    median replay over ``REPS``.  The host's time per execute (0.1-0.2 ms of
    Python per plan on the trunk) is longer than many of the kernels
    (0.007-0.3 ms) and would otherwise bury the ranking in host noise.
  * On the CPU the same function times the plain PyTorch version with
    ``perf_counter`` (``REPS`` calls per iteration); those timings are
    keyed under their own backend tag (``cache.default_backend``) and never
    stand for the card's.
  * The CUDA library is loaded (built on first use) before any candidate's
    ``timeout_s`` budget starts, so a cold build cannot score every
    candidate ``inf``.

Failures are counted, not hidden: a candidate that raises scores ``inf``
and increments ``repro.tune.measure_failures``.  A CUDA error that leaves
the context unusable (``torch.cuda.synchronize`` raises after the
failure) is re-raised after counting, so a launch fault can never become
a tuned pick.  Proxy mode (channel/batch/spatial caps, ``proxy_scene``)
measures a shrunken stand-in of the scene; every use is recorded in the
tuned artifact.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional, Tuple

import torch

from repro_torch.core.mapping import ScheduleChoice
from repro_torch.core.scene import ConvScene, ceil_div
from repro_torch.device import DeviceSpec, resolve_device, torch_dtype
from repro_torch.obs.metrics import default_metrics
from repro_torch.obs.trace import default_tracer

# A candidate that cannot produce one timed call inside this budget is
# scored inf, like an infeasible one, rather than hanging a batch tune.
DEFAULT_TIMEOUT_S = 120.0
# Executes per timed iteration (one CUDA graph on the card).
REPS = 3


def proxy_scene(scene: ConvScene, *, measure_batch: Optional[int] = None,
                measure_max_ch: Optional[int] = None,
                measure_max_hw: Optional[int] = None) -> ConvScene:
    """Channel/batch/spatial-capped stand-in for measurement.

    Caps shrink the grid a candidate runs over; the autotuner clips each
    candidate's blocks to the capped dims and dedups on the clipped
    execution before measuring.  The cap keeps the filter window valid:
    the *dilated* input plus padding must still cover the *dilated* filter
    footprint, and a proxy is never larger than the scene it stands in
    for."""
    d = dict(scene.__dict__)
    if measure_batch:
        d["B"] = min(scene.B, measure_batch)
    if measure_max_ch:
        d["IC"] = min(scene.IC, measure_max_ch)
        d["OC"] = min(scene.OC, measure_max_ch)
    if measure_max_hw:
        need_h = scene.dilated_fltH - 2 * scene.padH - scene.apadH
        need_w = scene.dilated_fltW - 2 * scene.padW - scene.apadW
        min_h = 1 + max(ceil_div(need_h - 1, scene.dilH), 0)
        min_w = 1 + max(ceil_div(need_w - 1, scene.dilW), 0)
        d["inH"] = min(scene.inH, max(measure_max_hw, min_h))
        d["inW"] = min(scene.inW, max(measure_max_hw, min_w))
    return dataclasses.replace(scene, **d)   # a WgradScene stays one


def make_operands(scene: ConvScene, seed: int = 0,
                  device: DeviceSpec = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random IN/FLT in the scene's paper layouts and dtype on ``device``
    (default the card), from a ``torch.Generator`` of that device seeded
    by ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = torch_dtype(scene.dtype)
    inp = torch.randn(scene.in_shape(), generator=gen, device=dev).to(dt)
    flt = torch.randn(scene.flt_shape(), generator=gen, device=dev).to(dt)
    return inp, flt


def _sticky_cuda_error(dev: torch.device) -> bool:
    """True when the CUDA context no longer works after a failure."""
    if dev.type != "cuda":
        return False
    try:
        torch.cuda.synchronize(dev)
    except RuntimeError:
        return True
    return False


def _time_cuda(fn, dev: torch.device, iters: int, warmup: int, t0: float,
               timeout_s: float) -> Optional[list]:
    """Per-execute device seconds of ``iters`` graph replays, or None when
    the budget ran out before the first timed replay."""
    for _ in range(max(warmup, 1)):
        fn()
        torch.cuda.synchronize(dev)
        if time.perf_counter() - t0 > timeout_s:
            return None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize(dev)
    if time.perf_counter() - t0 > timeout_s:
        return None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(max(iters, 1)):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3 / REPS)
        if time.perf_counter() - t0 > timeout_s:
            break
    return times


def _time_cpu(fn, iters: int, warmup: int, t0: float, timeout_s: float) -> Optional[list]:
    for _ in range(max(warmup, 1)):
        fn()
        if time.perf_counter() - t0 > timeout_s:
            return None
    times = []
    for _ in range(max(iters, 1)):
        t1 = time.perf_counter()
        for _ in range(REPS):
            fn()
        times.append((time.perf_counter() - t1) / REPS)
        if time.perf_counter() - t0 > timeout_s:
            break
    return times


def measure_choice(scene: ConvScene, choice: ScheduleChoice, *,
                   device: DeviceSpec = None, iters: int = 3,
                   warmup: int = 1,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> float:
    """Median time (µs) of one execute of a plan pinned to ``choice`` on
    ``device`` (default the card): device time on the card, wall time of
    the plain version on the CPU (see the module docstring).

    The ``timeout_s`` budget covers the warm-up (and the graph capture):
    a candidate that spends it before one timed iteration scores ``inf``
    and counts in ``repro.tune.measure_timeouts``.  A candidate that
    raises scores ``inf`` and counts in ``repro.tune.measure_failures``
    (re-raised when the CUDA context is left unusable)."""
    from repro_torch.kernels import mg3m_conv  # local: keeps tune light

    dev = resolve_device(device)
    held = mg3m_conv.workspace_keys()
    try:
        return _measure(scene, choice, dev, iters, warmup, timeout_s)
    finally:   # a candidate's split partials go with its plan
        mg3m_conv.release_workspaces(keep=held)


def _measure(scene: ConvScene, choice: ScheduleChoice, dev: torch.device,
             iters: int, warmup: int, timeout_s: float) -> float:
    from repro_torch.kernels import mg3m_conv  # local: keeps tune light
    from repro_torch.plan import build as plan_build

    m = default_metrics()
    m.counter("repro.tune.measurements").inc()
    with default_tracer().span("repro.tune.measure",
                               schedule=choice.schedule, bm=choice.bm,
                               bn=choice.bn, bk=choice.bk,
                               tile=tuple(choice.tile),
                               scene=scene.describe()) as sp:
        try:
            if dev.type == "cuda":
                mg3m_conv.library()      # build/load before the clock
            plan = plan_build.make_plan(scene, plan_build.ConvOp.FPROP,
                                        policy=choice, device=dev)
            inp, flt = make_operands(scene, device=dev)
            fn = lambda: plan.execute(inp, flt)   # noqa: E731
            t0 = time.perf_counter()
            if dev.type == "cuda":
                times = _time_cuda(fn, dev, iters, warmup, t0, timeout_s)
            else:
                times = _time_cpu(fn, iters, warmup, t0, timeout_s)
        except Exception as exc:  # noqa: BLE001 — failure = infeasible point
            m.counter("repro.tune.measure_failures").inc()
            sp.set(outcome="infeasible", error=repr(exc))
            if _sticky_cuda_error(dev):
                raise
            return math.inf
        if times is None:
            m.counter("repro.tune.measure_timeouts").inc()
            sp.set(outcome="timeout")
            return math.inf
        times.sort()
        us = times[len(times) // 2] * 1e6
        m.histogram("repro.tune.measure_s").observe(us * 1e-6)
        sp.set(outcome="ok", measured_us=us)
        return us
