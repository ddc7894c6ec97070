"""Scene-bucketed micro-batching conv serving engine with plan prewarming
(port of ``repro.serve.conv``).

The paper's claim is *adaptability across convolution scenes*; a serving
process meets traffic that varies only along one axis the selector already
understands — batch.  ``ConvServer`` turns that into the execution shape the
multi-grained selector scores best:

  * each registered layer defines a scene *family* (``ConvScene.family_key``,
    B-agnostic); concurrent requests against one layer differ only in batch
    size, so they coalesce along the B axis (the MM_unit N dim — independent
    GEMM columns, bitwise-safe to pack and slice) into one batched
    ``ConvPlan.execute``;
  * coalesced batches pad up to a **bucket ladder** of batch sizes chosen
    per scene family from the ``CostModel``: a ladder rung is dropped when
    the model predicts the next rung costs no more to run
    (``predicted_s`` within ``ladder_slack``), i.e. the rung sits below the
    chosen schedule's granularity sweet spot and the kernel tiles would
    burn the quantized work anyway — padding up is free, and fewer buckets
    mean fewer plans and fatter batches;
  * at startup the server prewarms every (layer x op x bucket) plan into a
    thread-safe ``PlanRegistry`` (``PlanRegistry.warm``) from a model's
    scene list (``models.cnn.cnn_layer_scenes``) or a saved registry
    artifact, so steady-state serving is pure kernel dispatch: zero plan
    builds, zero schedule resolutions (``stats()['plan_misses']`` stays 0,
    assertable; ``on_dispatch`` is the audit hook).

Padding lanes are zeros: a zero batch column produces a zero output column
for FPROP/DGRAD (both are linear in the batched operand), sliced off before
the request completes, so coalesced output matches per-request execution.
WGRAD *contracts over* B — batching requests along B would sum their
gradients — so the server refuses it; use ``ConvPlan`` directly.

Device: a server runs on one backend (``device``, default the card; no
card raises unless ``device="cpu"``).  A result is *ready* when its
``done`` flag is set: each dispatch records a CUDA event on the stream it
launched on and synchronizes it before completing its requests (the
reference's ``jax.block_until_ready``).  A request tensor copied to the
card on the submitter's stream carries an event the dispatching thread's
stream waits on, so the background loop of ``serve.sched`` may run on
another thread (PyTorch's current stream is per thread).

``mesh=`` extends the same argument one level up: a coalesced bucket's B
axis is exactly the independent-GEMM-column axis the mesh's data
dimension partitions, so in mesh mode every (layer x op x bucket)
prewarms a ``ShardedConvPlan`` (``repro_torch.shard``, ``axes=("batch",)``)
across the mesh's data-axis device ring (``launch.mesh.data_devices``,
which may repeat a device) instead of a one-device plan; the server's
device is the ring's first.  The joint selector still owns the decision
— a bucket too small to pay for the shard dispatch falls back to
``n_shards == 1`` — and the chosen partition tag per (layer, op, bucket)
is recorded at prewarm, so steady state stays a zero-resolution registry
lookup (tag dict hit + shard-keyed ``get``).  A sharded plan already in
the registry for a (scene, op) — loaded from a prewarm artifact over this
ring — satisfies the warm with its own partition, so a restarted mesh
server re-selects nothing.

Observability: every server owns a ``MetricRegistry`` (``repro.serve.*``
counters + queue-wait/dispatch histograms; ``stats(since=snapshot())``
windows them) and dispatches under a ``repro.serve.dispatch`` span when the
tracer is enabled — ``DispatchRecord`` emission is a *subscriber of the span
stream*, so anything ``on_dispatch`` sees is definitionally in the exported
trace; with tracing off, records are published directly and the hot path
pays one branch.  A hook that raises is counted
(``repro.serve.dispatch_hook_errors``) and never fails the dispatch.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import threading
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.mapping import (CostModel, predicted_efficiency,
                                      select_schedule)
from repro_torch.core.scene import ConvScene
from repro_torch.device import DeviceSpec, resolve_device, torch_dtype
from repro_torch.obs import drift as drift_mod
from repro_torch.obs.metrics import (DEFAULT_RATIO_BUCKETS, MetricRegistry,
                                     snapshot_delta, snapshot_value)
from repro_torch.obs.trace import _NOOP as _NOOP_SPAN
from repro_torch.obs.trace import Span, Tracer, default_tracer
from repro_torch.plan import ConvOp, ConvPlan, PlanRegistry
from repro_torch.plan.build import PolicySpec, _active_cost_model, policy_tag


# --------------------------------------------------------------------------
# bucket ladder — batch buckets per scene family, chosen by the cost model
# --------------------------------------------------------------------------
def bucket_ladder(scene: ConvScene, max_batch: int, *, min_bucket: int = 1,
                  slack: float = 1.15, model: Optional[CostModel] = None,
                  device: DeviceSpec = None) -> Tuple[int, ...]:
    """Batch buckets for one scene family: power-of-two rungs from
    ``min_bucket`` up, capped by ``max_batch`` (always the top rung), pruned
    bottom-up by the cost model.

    A rung ``b`` is dropped when the model predicts the next *surviving*
    rung runs within ``slack`` of it
    (``predicted_s(next_kept) <= slack * predicted_s(b)``): below the
    selected schedule's granularity sweet spot the kernels' tile
    quantization burns the bigger batch's work anyway (a compute-bound
    scene costs the same at B=8 and B=64), so padding those requests up to
    the rung they will actually execute at is ~free and the ladder should
    not hold a plan below it.  The comparison is deliberately against the
    kept rung, not the adjacent one — pairwise-adjacent pruning would let
    sub-``slack`` ratios compound (seven 1.12x steps ≈ 2.2x) and collapse
    ladders whose cumulative padding cost is far from free.  Memory-bound
    families, whose time scales with B, keep the full ladder.
    ``model=None`` uses ``device``'s active cost model (calibrated when an
    artifact of its backend exists), like plan building does.
    """
    if max_batch < 1 or min_bucket < 1:
        raise ValueError("max_batch and min_bucket must be positive")
    if min_bucket > max_batch:
        raise ValueError(f"min_bucket {min_bucket} exceeds max_batch "
                         f"{max_batch}")
    model = model if model is not None else _active_cost_model(device)
    rungs = []
    b = min_bucket
    while b < max_batch:
        rungs.append(b)
        b *= 2
    rungs.append(max_batch)
    if slack <= 0:
        return tuple(rungs)   # pruning is provably a no-op: skip the
        # per-rung schedule resolutions entirely
    times = {b: select_schedule(scene.with_batch(b), model=model).predicted_s
             for b in rungs}
    # top-down: keep a rung iff padding it up to the lowest kept rung above
    # it is NOT within slack (the invariant holds against the bucket a
    # request would actually execute at, never a pruned intermediate)
    kept = [rungs[-1]]
    for b in reversed(rungs[:-1]):
        if times[kept[0]] > slack * times[b]:
            kept.insert(0, b)
    return tuple(kept)


# --------------------------------------------------------------------------
# requests and dispatch records
# --------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class ConvRequest:
    """One unit of per-request conv work: an input tensor against a
    registered layer.  ``x`` is in the paper layout with a trailing batch
    axis — ``[inH, inW, IC, b]`` for FPROP, ``[outH, outW, OC, b]`` for
    DGRAD — or 3-D (no batch axis) meaning ``b = 1``, in which case the
    result comes back 3-D too.  ``out``, ``done``, and (on a failed
    dispatch) ``error`` are filled by the server on completion.

    ``deadline_s`` is an optional latency budget in seconds, relative to
    submission.  The base ``ConvServer`` dispatches on demand and merely
    records it; the scheduling layer (``repro.serve.sched``) uses it to
    flush partial buckets before the budget expires and to order the queue
    under overload (EDF shed policy).

    ``eq=False``: requests are identity objects.  A value ``__eq__`` would
    compare the tensors (ambiguous truth value) and would let two
    requests with equal fields alias each other in the queue."""

    rid: int
    layer: str
    x: torch.Tensor
    op: ConvOp = ConvOp.FPROP
    deadline_s: Optional[float] = None
    out: Optional[torch.Tensor] = None
    done: bool = False
    error: Optional[BaseException] = None
    # internal: batch width, whether to squeeze the result (3-D input),
    # submission timestamp (queue-wait metric), the absolute deadline
    # (perf_counter clock, derived from deadline_s at submit), and the
    # completion signal serve() waits on (set by whichever thread's step()
    # dispatches the batch containing this request)
    _b: int = dataclasses.field(default=0, repr=False)
    _squeeze: bool = dataclasses.field(default=False, repr=False)
    _t_submit: float = dataclasses.field(default=0.0, repr=False)
    _t_deadline: Optional[float] = dataclasses.field(default=None, repr=False)
    _event: Optional[threading.Event] = dataclasses.field(default=None,
                                                          repr=False)
    # CUDA event recorded on the submitter's stream after ``x`` was placed
    # on the card; the dispatching stream waits on it before reading ``x``
    _ready: Optional["torch.cuda.Event"] = dataclasses.field(default=None,
                                                             repr=False)


@dataclasses.dataclass(frozen=True)
class DispatchRecord:
    """One coalesced kernel dispatch — the audit unit of the serving layer
    (``on_dispatch`` receives these)."""

    layer: str
    op: ConvOp
    bucket: int        # padded batch the plan executed
    occupied: int      # real request lanes in the bucket
    requests: int      # how many requests were coalesced
    schedule: Optional[str]


@dataclasses.dataclass(frozen=True)
class _Family:
    """One registered layer: its B-agnostic scene family, weight, ladder."""

    layer: str
    base: ConvScene               # canonical B=1 member of the family
    flt: torch.Tensor
    ops: Tuple[ConvOp, ...]
    ladder: Tuple[int, ...]

    def a_spatial(self, op: ConvOp) -> Tuple[int, int, int]:
        """Expected leading (non-batch) dims of a request tensor."""
        if op is ConvOp.FPROP:
            return (self.base.inH, self.base.inW, self.base.IC)
        return (self.base.outH, self.base.outW, self.base.OC)


# --------------------------------------------------------------------------
# the server
# --------------------------------------------------------------------------
_SERVER_SEQ = itertools.count()   # unique per-process ids for span filtering


class ConvServer:
    """Scene-bucketed micro-batching conv server over a prewarmed
    ``PlanRegistry``.

    Lifecycle: ``register_layer`` every (scene, weight) the model serves,
    ``prewarm()`` once (optionally from a saved registry artifact), then
    ``submit``/``drain`` — or ``serve(requests)`` for both — from any number
    of threads.  ``step()`` coalesces the longest eligible run of queued
    requests for one (layer, op) along the B axis, pads to the family's
    bucket ladder, executes the prewarmed plan, and slices each request's
    lanes back out.

    ``strict=True`` turns any post-warm plan miss into a ``RuntimeError``
    (production posture: steady state must be pure dispatch); the default
    builds the missing plan and counts it in ``stats()['plan_builds']``.

    ``mesh`` (a ``launch.mesh.Mesh``) serves over its data-axis device
    ring (see the module docstring); it takes the place of ``device`` and
    requires ``use_kernels=True``.
    """

    def __init__(self, *, registry: Optional[PlanRegistry] = None,
                 policy: PolicySpec = "analytic", device: DeviceSpec = None,
                 use_kernels: bool = True, max_batch: int = 32,
                 min_bucket: int = 1, ladder_slack: float = 1.15,
                 cost_model: Optional[CostModel] = None, strict: bool = False,
                 on_dispatch: Optional[Callable[[DispatchRecord], None]]
                 = None, metrics: Optional[MetricRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 drift: Optional["drift_mod.DriftMonitor"] = None,
                 mesh=None):
        self.mesh = mesh
        # mesh mode: the shard ring, and the chosen partition tag per
        # (layer, op, bucket), recorded at prewarm so steady state never
        # re-runs the joint selector
        self._ring: Optional[Tuple[torch.device, ...]] = None
        self._shard_tags: Dict[Tuple[str, ConvOp, int], str] = {}
        if mesh is not None:
            if not use_kernels:
                raise ValueError(
                    "mesh serving requires use_kernels=True: sharded plans "
                    "always dispatch the kernels per shard")
            if device is not None:
                raise ValueError("pass device or mesh, not both: a mesh "
                                 "server runs on its ring's first device")
            from repro_torch.launch.mesh import data_devices
            from repro_torch.shard.plan import device_pool
            self._ring = device_pool(data_devices(mesh))
            self.device = self._ring[0]
        else:
            self.device = resolve_device(device)
        if registry is not None and registry.backend != self.device.type:
            raise ValueError(f"registry serves {registry.device}, the server "
                             f"{self.device}")
        self.registry = (registry if registry is not None
                         else PlanRegistry(device=self.device))
        self.policy = policy
        self.use_kernels = use_kernels
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        self.ladder_slack = ladder_slack
        self.cost_model = cost_model
        self.strict = strict
        self.on_dispatch = on_dispatch
        self._lock = threading.RLock()
        self._layers: Dict[str, _Family] = {}
        self._queue: "collections.deque[ConvRequest]" = collections.deque()
        self._seq = itertools.count()
        self._warmed = False
        # serving metrics (post-warm steady state); per-instance registry so
        # two servers in one process never mix counters — pass ``metrics``
        # to aggregate several servers into one registry instead
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self.tracer = tracer if tracer is not None else default_tracer()
        self.drift = drift if drift is not None else drift_mod.default_monitor()
        self._c_requests = self.metrics.counter("repro.serve.requests")
        self._c_dispatches = self.metrics.counter("repro.serve.dispatches")
        self._c_occupied = self.metrics.counter("repro.serve.occupied_lanes")
        self._c_bucket = self.metrics.counter("repro.serve.bucket_lanes")
        self._c_plan_misses = self.metrics.counter("repro.serve.plan_misses")
        self._c_plan_builds = self.metrics.counter("repro.serve.plan_builds")
        self._c_hook_errors = self.metrics.counter(
            "repro.serve.dispatch_hook_errors")
        self._g_queue = self.metrics.gauge("repro.serve.queue_depth")
        self._h_wait = self.metrics.histogram("repro.serve.queue_wait_s")
        self._h_dispatch = self.metrics.histogram("repro.serve.dispatch_s")
        self._h_occupancy = self.metrics.histogram(
            "repro.serve.occupancy", bounds=DEFAULT_RATIO_BUCKETS)
        # DispatchRecord emission rides the span stream when tracing is on:
        # the sink below filters this server's finished dispatch spans, so
        # the audit hook and the exported trace can never disagree.  The id
        # is a process-unique sequence number (id() could be reused).
        self._sid = next(_SERVER_SEQ)
        self.tracer.subscribe(self._span_sink)

    # -- setup -------------------------------------------------------------
    def register_layer(self, layer: str, scene: ConvScene, flt: torch.Tensor,
                       ops: Sequence[ConvOp] = (ConvOp.FPROP,)) -> _Family:
        """Register one servable layer: scene family + weight (moved to the
        server's device in the scene's dtype).  Layers whose scenes share a
        ``family_key`` automatically share ladder plans in the registry
        (identical rebatched scenes produce identical plan signatures) —
        weights stay per-layer, so only the *plans* dedup."""
        ops = tuple(ConvOp(op) for op in ops)
        if ConvOp.WGRAD in ops:
            raise ValueError(
                "wgrad contracts over the batch axis — coalescing requests "
                "along B would sum their gradients; serve wgrad through "
                "ConvPlan directly")
        if tuple(flt.shape) != scene.flt_shape():
            raise ValueError(
                f"layer {layer!r} weight shape {tuple(flt.shape)} does not "
                f"match the scene's FLT layout {scene.flt_shape()}")
        flt = torch.as_tensor(flt).to(device=self.device,
                                      dtype=torch_dtype(scene.dtype))
        flt = flt.contiguous()
        base = scene.with_batch(1)
        ladder = bucket_ladder(base, self.max_batch,
                               min_bucket=self.min_bucket,
                               slack=self.ladder_slack, model=self.cost_model,
                               device=self.device)
        fam = _Family(layer=layer, base=base, flt=flt, ops=ops, ladder=ladder)
        with self._lock:
            if layer in self._layers:
                raise ValueError(f"layer {layer!r} already registered")
            self._layers[layer] = fam
            self._warmed = False
        return fam

    def prewarm(self, artifact: Optional[str] = None, *,
                compile: bool = False) -> int:
        """Build every (layer x op x bucket) plan the server can dispatch;
        returns how many plans were built (0 = everything was already
        pinned).  ``artifact`` loads a saved registry first, so a restarted
        server re-resolves nothing — loaded plans are pinned choices and
        ``warm`` only fills genuine gaps.  ``compile=True`` additionally
        executes each servable plan once on zeros, paying first launches before
        traffic instead of inside the first request's latency (on the card:
        the kernel library build and first launches)."""
        if artifact and os.path.exists(artifact):
            self.registry.load(artifact, devices=self._ring)
        built = 0
        with self._lock:
            families = list(self._layers.values())
        for fam in families:
            if self._ring is not None:
                built += self._prewarm_sharded(fam)
            else:
                built += self.registry.warm(
                    [fam.base], ops=fam.ops, buckets=fam.ladder,
                    policy=self.policy, use_kernels=self.use_kernels)
        if compile:
            for fam in families:
                for op, bucket in itertools.product(fam.ops, fam.ladder):
                    self._run_zeros(fam, op, bucket)
        with self._lock:
            self._warmed = True
        return built

    def _run_zeros(self, fam: _Family, op: ConvOp, bucket: int) -> None:
        """Execute one prewarmed plan on zeros and wait for it."""
        a_shape = fam.a_spatial(op) + (bucket,)
        self._sync(self._plan(fam, op, bucket).execute(
            torch.zeros(a_shape, dtype=fam.flt.dtype, device=self.device),
            fam.flt))

    def _sync(self, out: torch.Tensor) -> torch.Tensor:
        """Block until ``out`` is ready: a CUDA event recorded on this
        thread's current stream after the launches, then synchronized."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()
        return out

    def _await_inputs(self, group: Sequence["ConvRequest"]) -> None:
        """Order this thread's stream after each request's placement on
        the card (the submitter may have used another stream)."""
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        for r in group:
            if r._ready is not None:
                stream.wait_event(r._ready)

    def _place(self, req: "ConvRequest", x: torch.Tensor,
               dtype: str) -> None:
        """Move a validated request tensor to the server's device and
        dtype, recording the event the dispatching stream will wait on."""
        req.x = x.to(device=self.device, dtype=torch_dtype(dtype))
        req._ready = None
        if self.device.type == "cuda":
            req._ready = torch.cuda.Event()
            req._ready.record(torch.cuda.current_stream(self.device))

    def save(self, path: str) -> str:
        """Persist the plan repository as the prewarm artifact of the next
        server process (see ``prewarm(artifact=...)``)."""
        return self.registry.save(path)

    # -- request intake ----------------------------------------------------
    def submit(self, req: ConvRequest) -> ConvRequest:
        """Enqueue one request (thread-safe).  Validates the tensor against
        the registered family up front so bad requests fail loudly at
        submission, not inside a coalesced batch."""
        with self._lock:
            fam = self._layers.get(req.layer)
            warmed = self._warmed
        if fam is None:
            raise KeyError(f"unknown layer {req.layer!r}; registered: "
                           f"{sorted(self._layers)}")
        if not warmed:
            self.prewarm()
        req.op = ConvOp(req.op)
        if req.op not in fam.ops:
            raise ValueError(f"layer {req.layer!r} serves ops "
                             f"{[o.value for o in fam.ops]}, not "
                             f"{req.op.value}")
        x = torch.as_tensor(req.x)
        if x.ndim == 3:
            x = x[..., None]
            req._squeeze = True
        want = fam.a_spatial(req.op)
        if x.ndim != 4 or tuple(x.shape[:3]) != want:
            raise ValueError(
                f"request {req.rid} for layer {req.layer!r} ({req.op.value}) "
                f"expects a [{want[0]}, {want[1]}, {want[2]}, b] tensor, "
                f"got {tuple(req.x.shape)}")
        if x.shape[3] > fam.ladder[-1]:
            raise ValueError(
                f"request {req.rid} batch {x.shape[3]} exceeds the top "
                f"ladder bucket {fam.ladder[-1]} of layer {req.layer!r}; "
                f"split it or raise max_batch")
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(f"request {req.rid} deadline_s must be "
                             f"positive, got {req.deadline_s}")
        self._place(req, x, fam.base.dtype)
        req._b = x.shape[3]
        req.out, req.done, req.error = None, False, None
        req._event = threading.Event()
        req._t_submit = time.perf_counter()
        req._t_deadline = (req._t_submit + req.deadline_s
                           if req.deadline_s is not None else None)
        with self._lock:
            self._enqueue(req)
            self._g_queue.set(len(self._queue))
        return req

    def _enqueue(self, req: ConvRequest) -> None:
        """Append a validated request to the queue.  Called under
        ``self._lock``.  The scheduling layer overrides this with bounded
        admission control and deadline-ordered insertion."""
        self._queue.append(req)

    # -- dispatch ----------------------------------------------------------
    def _take_batch(self) -> List[ConvRequest]:
        """Pop the head request plus every queued request of the same
        (layer, op) that still fits under the family's top bucket — FIFO
        fairness across families, maximal coalescing within one."""
        with self._lock:
            if not self._queue:
                return []
            head = self._queue.popleft()
            cap = self._layers[head.layer].ladder[-1]
            group, total = [head], head._b
            for r in list(self._queue):
                if (r.layer == head.layer and r.op == head.op
                        and total + r._b <= cap):
                    self._queue.remove(r)
                    group.append(r)
                    total += r._b
            self._g_queue.set(len(self._queue))
            return group

    def _prewarm_sharded(self, fam: _Family) -> int:
        """Mesh-mode warm: for every (op x bucket), the sharded plan already
        registered over this ring (an artifact's), else one built by the
        joint (grain x partition) selector over the mesh's data-axis ring
        (``axes=("batch",)`` — the bucket's B axis is the coalescing axis,
        provably safe to split); register it and pin its partition tag.
        Like ``PlanRegistry.warm`` this bumps no hit/miss counters."""
        built = 0
        for op in fam.ops:
            for bucket in fam.ladder:
                scene = fam.base.with_batch(bucket)
                plan = self._registered_sharded(scene, op)
                if plan is None:
                    plan = self._build_sharded(scene, op)
                    built += 1
                self.registry.put(plan)
                with self._lock:
                    self._shard_tags[(fam.layer, op, bucket)] = plan.shard_tag
        return built

    def _registered_sharded(self, scene: ConvScene, op: ConvOp):
        """The most recently used sharded plan of the registry for
        ``(scene, op)`` under this server's policy over this ring, or
        None.  A peek: no hit/miss traffic."""
        pol = policy_tag(self.policy)
        found = None
        for plan in self.registry.plans().values():
            if (plan.shard_tag is not None and plan.op is op
                    and plan.scene == scene and plan.policy == pol
                    and plan.devices == self._ring[:plan.n_shards]):
                found = plan
        return found

    def _build_sharded(self, scene: ConvScene, op: ConvOp):
        from repro_torch.shard.plan import make_sharded_plan
        return make_sharded_plan(scene, op, policy=self.policy,
                                 devices=self._ring, axes=("batch",),
                                 model=self.cost_model)

    def _plan(self, fam: _Family, op: ConvOp, bucket: int):
        scene = fam.base.with_batch(bucket)
        if self._ring is not None:
            with self._lock:
                tag = self._shard_tags.get((fam.layer, op, bucket))
            plan = (self.registry.get(scene, op, policy=self.policy,
                                      use_kernels=self.use_kernels,
                                      shard=tag)
                    if tag else None)
        else:
            plan = self.registry.get(scene, op, policy=self.policy,
                                     use_kernels=self.use_kernels)
        if plan is None:
            self._c_plan_misses.inc()
            if self.strict:
                raise RuntimeError(
                    f"post-warm plan miss: layer {fam.layer!r} {op.value} "
                    f"bucket {bucket} is not in the registry (strict mode "
                    f"forbids steady-state plan builds)")
            # build + put directly: re-entering get_or_build would record
            # the same miss twice and deflate the registry's hit_rate
            if self._ring is not None:
                plan = self._build_sharded(scene, op)
                with self._lock:
                    self._shard_tags[(fam.layer, op, bucket)] = plan.shard_tag
            else:
                plan = self.registry._build(scene, op, self.policy,
                                            self.use_kernels)
            self.registry.put(plan)
            self._c_plan_builds.inc()
        return plan

    def step(self) -> int:
        """Coalesce and dispatch one micro-batch; returns requests served
        (0 = queue empty).

        Every dispatch waits for its result before completing its requests
        (``done`` means ready, so another thread may read ``out`` on any
        stream).  With tracing enabled the dispatch runs under a
        ``repro.serve.dispatch`` span and streams the plan's (predicted,
        measured) pair into the drift monitor; the finished span's args
        carry everything a ``DispatchRecord`` holds and the span sink
        publishes it.  With tracing disabled the record is published
        directly — no span object is allocated on that path."""
        return self._dispatch(self._take_batch())

    def _bucket_for(self, fam: _Family, op: ConvOp, total: int) -> int:
        """Padded batch for a coalesced group of ``total`` lanes: the
        smallest ladder rung that fits.  The scheduling layer overrides
        this to also consider sub-rung flush buckets, priced by the cost
        model's per-bucket predictions."""
        return next(b for b in fam.ladder if b >= total)

    def _dispatch(self, group: List[ConvRequest]) -> int:
        """Execute one coalesced group (see ``step`` for the tracing
        contract); returns requests served."""
        enabled = self.tracer.enabled
        if not group:
            return 0
        t_start = time.perf_counter()
        for r in group:
            if r._t_submit:
                self._h_wait.observe(t_start - r._t_submit)
        sp = (self.tracer.span("repro.serve.dispatch", server=self._sid)
              if enabled else _NOOP_SPAN)
        with sp:
            try:
                fam = self._layers[group[0].layer]
                op = group[0].op
                total = sum(r._b for r in group)
                bucket = self._bucket_for(fam, op, total)
                self._await_inputs(group)
                x = (group[0].x if len(group) == 1
                     else torch.cat([r.x for r in group], dim=3))
                if bucket > total:
                    x = F.pad(x, (0, bucket - total))
                plan = self._plan(fam, op, bucket)
                t_exec = time.perf_counter()
                out = self._sync(plan.execute(x, fam.flt))
            except BaseException as e:  # noqa: BLE001 — propagated to every
                # waiter in the group (r.error below), not swallowed
                # the group is already off the queue: complete it with the
                # error so a serve() waiting in another thread unblocks
                for r in group:
                    r.error, r.done = e, True
                    if r._event is not None:
                        r._event.set()
                raise
            exec_s = time.perf_counter() - t_exec
            off = 0
            for r in group:
                sl = out[..., off:off + r._b]
                off += r._b
                r.out = sl[..., 0] if r._squeeze else sl
                r.done = True
                if r._event is not None:
                    r._event.set()
            self._c_requests.inc(len(group))
            self._c_dispatches.inc()
            self._c_occupied.inc(total)
            self._c_bucket.inc(bucket)
            self._h_dispatch.observe(time.perf_counter() - t_start)
            self._h_occupancy.observe(total / bucket)
            if (enabled and plan.choice is not None
                    and plan.exec_scene is not None):
                # synchronized above, so exec_s is an honest kernel
                # wall-clock: audit the cost model with it (plan.predicted_s:
                # a sharded plan predicts the whole dispatch, collective and
                # launch terms included, which is what exec_s measures)
                self.drift.observe(
                    drift_mod.scene_class(plan.exec_scene, plan.choice),
                    plan.predicted_s, exec_s)
            # args only on success: a failed dispatch leaves the span with
            # its error tag and never becomes a DispatchRecord
            sp.set(layer=fam.layer, op=op.value, bucket=bucket,
                   occupied=total, requests=len(group),
                   schedule=plan.schedule, exec_s=exec_s)
        if not enabled:
            self._publish(DispatchRecord(
                layer=fam.layer, op=op, bucket=bucket, occupied=total,
                requests=len(group), schedule=plan.schedule))
        return len(group)

    def _span_sink(self, span: Span) -> None:
        """Span-stream subscriber: this server's finished dispatch spans
        become ``DispatchRecord``s (tracing-enabled path)."""
        a = span.args
        if (span.name != "repro.serve.dispatch"
                or a.get("server") != self._sid or "layer" not in a):
            return
        self._publish(DispatchRecord(
            layer=a["layer"], op=ConvOp(a["op"]), bucket=a["bucket"],
            occupied=a["occupied"], requests=a["requests"],
            schedule=a.get("schedule")))

    def _publish(self, rec: DispatchRecord) -> None:
        """Deliver one record to ``on_dispatch``; a raising hook is counted
        and swallowed — an audit sink must never take serving down."""
        if self.on_dispatch is None:
            return
        try:
            self.on_dispatch(rec)
        except Exception:  # noqa: BLE001 — hook bug != dispatch failure
            self._c_hook_errors.inc()

    def drain(self) -> int:
        """Serve until the queue is empty; returns requests served."""
        served = 0
        while True:
            n = self.step()
            if n == 0:
                return served
            served += n

    def serve(self, requests: Sequence[ConvRequest]) -> List[torch.Tensor]:
        """Submit a burst, drain it, return outputs in request order.

        Waits on each request's completion signal, not merely on an empty
        queue: with several threads draining one server, this burst's
        requests may be mid-``execute`` inside *another* thread's step when
        our drain sees no queued work.  A request completed with an error
        (a concurrent step failed its batch) re-raises here."""
        for req in requests:
            self.submit(req)
        self.drain()
        for req in requests:
            if req._event is not None:
                req._event.wait()
            if req.error is not None:
                raise RuntimeError(
                    f"request {req.rid} failed in a coalesced dispatch"
                ) from req.error
        return [r.out for r in requests]

    # -- introspection -----------------------------------------------------
    def ladders(self) -> Dict[str, Tuple[int, ...]]:
        with self._lock:
            return {name: fam.ladder for name, fam in self._layers.items()}

    def snapshot(self) -> Dict[str, Dict]:
        """Point-in-time metric snapshot (server + registry; their metric
        names never collide) — feed it back as ``stats(since=...)`` for a
        windowed view, or persist it via ``MetricRegistry.dump``."""
        snap = dict(self.metrics.snapshot())
        snap.update(self.registry.snapshot())
        return snap

    def reset_stats(self) -> None:
        """Zero the serving and registry metrics (registrations kept)."""
        self.metrics.reset()
        self.registry.reset_stats()

    def stats(self, since: Optional[Dict] = None) -> Dict[str, float]:
        """Serving counters + the registry's.  ``occupancy`` is real lanes /
        padded lanes over all dispatches (1.0 = no pad waste);
        ``pad_waste_pct`` is its complement; ``plan_misses`` must stay 0 on
        a prewarmed server.  ``since`` (an earlier ``snapshot()``) windows
        every counter-derived field to the interval since it — this replaces
        the manual before/after arithmetic callers used to do.  ``queued``
        is instantaneous either way."""
        snap = self.snapshot()
        if since is not None:
            snap = snapshot_delta(since, snap)
        v = lambda name: int(snapshot_value(snap, f"repro.serve.{name}"))
        requests, dispatches = v("requests"), v("dispatches")
        occupied, bucket = v("occupied_lanes"), v("bucket_lanes")
        occ = occupied / bucket if bucket else 0.0
        with self._lock:
            queued = len(self._queue)
        return {
            "requests": requests,
            "dispatches": dispatches,
            "mean_batch": requests / dispatches if dispatches else 0.0,
            "occupancy": occ,
            "pad_waste_pct": 100.0 * (1.0 - occ) if bucket else 0.0,
            "occupied_lanes": occupied,
            "bucket_lanes": bucket,
            "plan_misses": v("plan_misses"),
            "plan_builds": v("plan_builds"),
            "dispatch_hook_errors": v("dispatch_hook_errors"),
            "queued": queued,
            "registry": self.registry.stats(since=since),
        }

    def describe(self) -> str:
        """One line per family: ladder and per-rung predicted efficiency."""
        model = (self.cost_model if self.cost_model is not None
                 else _active_cost_model(self.device))
        lines = []
        with self._lock:
            families = sorted(self._layers.items())
        for name, fam in families:
            effs = []
            for b in fam.ladder:
                sc = fam.base.with_batch(b)
                ch = select_schedule(sc, model=model)
                effs.append(f"{b}:{ch.schedule}"
                            f"@{predicted_efficiency(sc, ch, model):.2f}")
            lines.append(f"{name}: family[{fam.base.family_key()}] "
                         f"ladder[{' '.join(effs)}]")
        return "\n".join(lines)


def seeded_weights(scenes: Mapping[str, ConvScene],
                   weights: Optional[Mapping[str, torch.Tensor]] = None,
                   *, seed: int = 0,
                   device: DeviceSpec = None) -> Dict[str, torch.Tensor]:
    """One FLT-layout weight per scene on ``device``: the caller's where
    given, seeded random otherwise (standard normal from a CPU
    ``torch.Generator`` seeded ``seed + i``, so every device gets the same
    numbers) — the serving layer only needs *a* weight per layer to route
    traffic; real deployments pass trained ones."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for i, (layer, scene) in enumerate(scenes.items()):
        if weights is not None and layer in weights:
            out[layer] = torch.as_tensor(weights[layer]).to(dev)
        else:
            gen = torch.Generator().manual_seed(seed + i)
            out[layer] = torch.randn(
                scene.flt_shape(), generator=gen, dtype=torch.float32).to(
                    device=dev, dtype=torch_dtype(scene.dtype))
    return out


def server_from_scenes(scenes: Mapping[str, ConvScene],
                       weights: Optional[Mapping[str, torch.Tensor]] = None,
                       *, seed: int = 0, ops: Sequence[ConvOp]
                       = (ConvOp.FPROP,), **kwargs) -> ConvServer:
    """Build a ``ConvServer`` straight from a layer->scene map (e.g.
    ``models.cnn.cnn_layer_scenes``); see ``seeded_weights`` for the
    missing-weight convention."""
    server = ConvServer(**kwargs)
    flts = seeded_weights(scenes, weights, seed=seed, device=server.device)
    for layer, scene in scenes.items():
        server.register_layer(layer, scene, flts[layer], ops=ops)
    return server
