"""Latency-aware continuous-batching scheduler over the conv serving engine
(port of ``repro.serve.sched``).

``ConvServer`` optimizes exactly one operating point: steady-state
throughput.  It drains on demand, pads every dispatch up to a cost-model
bucket rung, and has no notion of latency, overload, or whole-model
requests.  ``ConvScheduler`` keeps that engine — the families, ladders,
prewarmed registry, and slice-back parity argument are unchanged — and adds
the three mechanisms production traffic needs:

**Deadline flush.**  Requests may carry ``deadline_s``.  The scheduler's
``_take_batch`` no longer fires whenever the queue is non-empty: a group
waits for its family's occupancy target (the pruned ladder's smallest kept
rung — the granularity sweet spot below which padding up is ~free), *unless*
the most urgent deadline in the group is about to expire, in which case the
group flushes at a **partial bucket**: the cheapest prewarmed power-of-two
bucket that fits, priced by the cost model's per-bucket ``predicted_s``
(the pad-waste vs. wait tradeoff made explicit — waiting longer would buy
occupancy the deadline cannot afford; padding to a pruned-away rung costs
exactly the predicted delta the pruning decision measured).  Flush buckets
come from a full (slack=0) power-of-two ladder warmed at prewarm, so a
deadline flush is still a zero-resolution registry hit — sub-rung execution
never rebuilds a plan (``PlanRegistry.warmed_buckets`` is the introspection
probe).  Deadline-less requests are bounded by ``max_gather_s`` instead, so
nothing waits forever.

**Admission control.**  The queue is bounded (``max_queue``); an arrival
beyond the bound is shed and counted (``repro.serve.shed_total``).  Policy
``"reject-newest"`` raises ``Overloaded`` at the submitter;``"edf"`` keeps
the queue earliest-deadline-first and sheds the *least urgent* request
(latest deadline, deadline-less last) — completing the victim with an
``Overloaded`` error so its waiter unblocks — which under overload converts
unbounded queue_wait growth into bounded, targeted loss.

**Whole-model sessions.**  ``register_net`` registers a *chained* scene
list (``models.cnn.cnn_chain_scenes`` / ``validate_scene_chain``) as one
pipeline; a ``ModelSession`` submits one image/batch against the net and
the scheduler carries the coalesced activation through every layer in plan
layout — layer i's coalesced OUT feeds layer i+1's IN directly, never
returning to the queue — the CNN analogue of a slot-based LM serving loop.
One bucket is chosen at entry (priced by the summed per-layer prediction),
and because B is the independent-GEMM-column axis for every layer, the
padded lanes stay zero through the whole chain and each request's columns
are bitwise identical (f32) to serving it layer-by-layer.

Deadline accounting is honest-by-construction: every dispatch
synchronizes a CUDA event recorded after its launches before it completes
its requests (``ConvServer._sync``), so a "met deadline" means the tensor
was ready, not merely enqueued.  The background loop launches from its own
thread on that thread's current stream; the completion event is recorded
on the same stream, and each request's input carries an event that stream
waits on (``ConvServer._await_inputs``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import time
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch
import torch.nn.functional as F

from repro_torch.core.scene import ConvScene
from repro_torch.models.cnn import validate_scene_chain
from repro_torch.obs import drift as drift_mod
from repro_torch.obs.metrics import snapshot_delta, snapshot_value
from repro_torch.obs.trace import _NOOP as _NOOP_SPAN
from repro_torch.obs.trace import Span
from repro_torch.plan import ConvOp
from repro_torch.serve.conv import (ConvRequest, ConvServer, DispatchRecord,
                                    _Family, bucket_ladder, seeded_weights)

__all__ = ["Overloaded", "SchedConfig", "ModelRequest", "ModelSession",
           "ConvScheduler", "scheduler_from_scenes"]


class Overloaded(RuntimeError):
    """Typed admission-control rejection: the scheduler's queue is full and
    this request was shed.  Catch it at the client and back off — the
    request was never (or is no longer) queued."""


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Scheduling knobs (the server-level ones — ladders, strictness,
    buckets — stay on ``ConvServer``).

    ``max_queue``        bounded-queue admission limit; 0 disables shedding.
    ``shed_policy``      ``"reject-newest"`` raises ``Overloaded`` at the
                         submitter; ``"edf"`` keeps the queue earliest-
                         deadline-first and sheds the least urgent entry.
    ``occupancy_target`` lanes to gather before a throughput flush; None
                         uses each family's granularity sweet spot (the
                         pruned ladder's smallest rung).
    ``max_gather_s``     how long a deadline-less group may wait for
                         occupancy before it flushes anyway.
    ``flush_margin_s``   safety margin subtracted from a deadline when
                         deciding to flush (covers dispatch overhead the
                         cost model does not price).
    ``poll_s``           idle sleep of ``drain``/the background loop when
                         nothing is flush-ready.
    """

    max_queue: int = 256
    shed_policy: str = "reject-newest"
    occupancy_target: Optional[int] = None
    max_gather_s: float = 0.05
    flush_margin_s: float = 0.002
    poll_s: float = 0.001

    def __post_init__(self):
        if self.shed_policy not in ("reject-newest", "edf"):
            raise ValueError(f"unknown shed_policy {self.shed_policy!r}; "
                             f"use 'reject-newest' or 'edf'")
        if self.max_queue < 0:
            raise ValueError("max_queue must be >= 0 (0 disables shedding)")
        if not (self.max_gather_s > 0 and math.isfinite(self.max_gather_s)):
            raise ValueError("max_gather_s must be positive and finite "
                             "(it bounds how long any request can wait)")
        if self.flush_margin_s < 0:
            raise ValueError("flush_margin_s must be >= 0")
        if self.poll_s <= 0:
            raise ValueError("poll_s must be positive")


@dataclasses.dataclass(eq=False)
class ModelRequest(ConvRequest):
    """One whole-model request: an input batch against a registered net.
    ``layer`` is the net's pseudo-family ``"@<net>"`` (so queue grouping,
    records, and metrics treat the pipeline as one family); ``x`` is the
    first layer's IN layout, ``out`` comes back in the last layer's OUT
    layout."""

    net: str = ""


@dataclasses.dataclass(frozen=True)
class _NetChain:
    """One registered net: its ordered layer names (each a registered
    family) and the optional inter-layer activation."""

    name: str
    layers: Tuple[str, ...]
    activation: Optional[Callable[[torch.Tensor], torch.Tensor]]


def _urgency(r: ConvRequest) -> Tuple[float, float]:
    """EDF sort key: earliest deadline first, deadline-less requests last,
    FIFO within ties."""
    return (r._t_deadline if r._t_deadline is not None else math.inf,
            r._t_submit)


class ModelSession:
    """Client handle for whole-model requests against one registered net.
    Obtained from ``ConvScheduler.session``; thread-safe (submission goes
    through the scheduler's lock)."""

    def __init__(self, sched: "ConvScheduler", net: str):
        self._sched = sched
        self.net = net

    def submit(self, x: torch.Tensor, *,
               deadline_s: Optional[float] = None) -> ModelRequest:
        """Enqueue one input batch (``[inH, inW, IC, b]``, or 3-D for
        ``b = 1``); returns the live request — wait on it via
        ``ConvScheduler.wait`` or read ``.out`` after a drain."""
        req = ModelRequest(rid=next(self._sched._seq),
                           layer="@" + self.net, x=x,
                           deadline_s=deadline_s, net=self.net)
        return self._sched.submit(req)

    def serve(self, xs: Sequence[torch.Tensor], *,
              deadline_s: Optional[float] = None) -> List[torch.Tensor]:
        """Submit a burst, drain, and return outputs in request order."""
        reqs = [self.submit(x, deadline_s=deadline_s) for x in xs]
        self._sched.drain()
        return self._sched.wait(reqs)


class ConvScheduler(ConvServer):
    """Deadline-aware continuous-batching scheduler (see module docstring).

    Everything a ``ConvServer`` does still works — ``register_layer``,
    ``submit``/``drain``/``serve``, strict mode, artifacts — plus:
    ``register_net`` + ``session`` for whole-model pipelines, deadline
    flush, bounded-queue admission control, and an optional background
    loop (``start``/``stop``) for true continuous batching."""

    def __init__(self, *, config: Optional[SchedConfig] = None, **kwargs):
        super().__init__(**kwargs)
        self.config = config if config is not None else SchedConfig()
        self._nets: Dict[str, _NetChain] = {}
        # full (slack=0) power-of-two flush ladder per layer, warmed at
        # prewarm, and the cost model's prediction per (layer, op, bucket):
        # the data behind partial-bucket pricing
        self._flush_rungs: Dict[str, Tuple[int, ...]] = {}
        self._pred_s: Dict[Tuple[str, ConvOp, int], float] = {}
        self._c_shed = self.metrics.counter("repro.serve.shed_total")
        self._c_deadline_reqs = self.metrics.counter(
            "repro.serve.deadline_requests")
        self._c_deadline_miss = self.metrics.counter(
            "repro.serve.deadline_misses")
        self._c_flush = {
            "deadline": self.metrics.counter("repro.serve.deadline_flushes"),
            "occupancy": self.metrics.counter(
                "repro.serve.occupancy_flushes"),
            "gather": self.metrics.counter(
                "repro.serve.gather_timeout_flushes"),
        }
        self._h_slack = self.metrics.histogram("repro.serve.deadline_slack_s")
        self._h_layer = self.metrics.histogram(
            "repro.serve.layer_dispatch_s")
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- net registration ----------------------------------------------------
    def register_net(self, net: str, scenes: Mapping[str, ConvScene],
                     weights: Optional[Mapping[str, torch.Tensor]] = None, *,
                     activation: Optional[Callable[[torch.Tensor],
                                                   torch.Tensor]] = None,
                     seed: int = 0) -> _NetChain:
        """Register a whole-model pipeline: ``scenes`` must chain
        (``validate_scene_chain`` — ``models.cnn.cnn_chain_scenes`` builds
        chains from the paper CNNs), each scene becomes a registered layer
        family, and ``session(net)`` then serves one-shot model requests
        through all of them.  ``activation`` (e.g. ``torch.relu``) is
        applied between layers; None keeps the chain linear, which makes
        session outputs bitwise comparable to per-layer serving."""
        validate_scene_chain(scenes)
        with self._lock:
            if net in self._nets:
                raise ValueError(f"net {net!r} already registered")
        flts = seeded_weights(scenes, weights, seed=seed, device=self.device)
        for lname, scene in scenes.items():
            self.register_layer(lname, scene, flts[lname],
                                ops=(ConvOp.FPROP,))
        chain = _NetChain(name=net, layers=tuple(scenes),
                          activation=activation)
        with self._lock:
            self._nets[net] = chain
            self._warmed = False
        return chain

    def session(self, net: str) -> ModelSession:
        """Client handle for one registered net."""
        with self._lock:
            if net not in self._nets:
                raise KeyError(f"unknown net {net!r}; registered: "
                               f"{sorted(self._nets)}")
        return ModelSession(self, net)

    def nets(self) -> Dict[str, Tuple[str, ...]]:
        with self._lock:
            return {name: chain.layers
                    for name, chain in self._nets.items()}

    # -- prewarm: flush ladders ride along -----------------------------------
    def prewarm(self, artifact: Optional[str] = None, *,
                compile: bool = False) -> int:
        """Base prewarm (every pruned-ladder plan), then warm the full
        power-of-two *flush ladder* of every family and record the cost
        model's per-bucket prediction — a deadline flush at any sub-rung
        bucket is then a pure registry hit, and partial-bucket choice is a
        dict lookup.  ``compile=True`` runs the flush rungs once too, so a
        deadline flush never pays a first launch inside a latency budget."""
        built = super().prewarm(artifact, compile=compile)
        with self._lock:
            families = list(self._layers.values())
        for fam in families:
            rungs = bucket_ladder(fam.base, self.max_batch,
                                  min_bucket=self.min_bucket, slack=0.0,
                                  device=self.device)
            built += self.registry.warm(
                [fam.base], ops=fam.ops, buckets=rungs,
                policy=self.policy, use_kernels=self.use_kernels)
            for op in fam.ops:
                for b in rungs:
                    plan = self.registry.get(
                        fam.base.with_batch(b), op, policy=self.policy,
                        use_kernels=self.use_kernels)
                    self._pred_s[(fam.layer, op, b)] = plan.predicted_s or 0.0
            with self._lock:
                self._flush_rungs[fam.layer] = rungs
        if compile:
            for fam in families:
                extra = [b for b in self._flush_rungs[fam.layer]
                         if b not in fam.ladder]
                for op, b in itertools.product(fam.ops, extra):
                    self._run_zeros(fam, op, b)
        with self._lock:
            self._warmed = True
        return built

    # -- admission control ---------------------------------------------------
    def _enqueue(self, req: ConvRequest) -> None:
        # called under self._lock (see ConvServer.submit)
        cfg = self.config
        if cfg.max_queue and len(self._queue) >= cfg.max_queue:
            victim = req
            if cfg.shed_policy == "edf":
                victim = max(itertools.chain(self._queue, (req,)),
                             key=_urgency)
            self._c_shed.inc()
            err = Overloaded(
                f"queue full ({cfg.max_queue} requests): shed request "
                f"{victim.rid} under policy {cfg.shed_policy!r}")
            if victim is req:
                raise err
            self._queue.remove(victim)
            victim.error, victim.done = err, True
            if victim._event is not None:
                victim._event.set()
        self._queue.append(req)
        if req._t_deadline is not None:
            self._c_deadline_reqs.inc()
        if cfg.shed_policy == "edf":
            ordered = sorted(self._queue, key=_urgency)
            self._queue.clear()
            self._queue.extend(ordered)

    # -- model request intake ------------------------------------------------
    def submit(self, req: ConvRequest) -> ConvRequest:
        if isinstance(req, ModelRequest):
            return self._submit_model(req)
        return super().submit(req)

    def _submit_model(self, req: ModelRequest) -> ModelRequest:
        with self._lock:
            chain = self._nets.get(req.net)
            warmed = self._warmed
        if chain is None:
            raise KeyError(f"unknown net {req.net!r}; registered: "
                           f"{sorted(self._nets)}")
        if not warmed:
            self.prewarm()
        req.layer = "@" + req.net
        req.op = ConvOp.FPROP
        fam = self._layers[chain.layers[0]]
        x = torch.as_tensor(req.x)
        if x.ndim == 3:
            x = x[..., None]
            req._squeeze = True
        want = fam.a_spatial(ConvOp.FPROP)
        if x.ndim != 4 or tuple(x.shape[:3]) != want:
            raise ValueError(
                f"model request {req.rid} for net {req.net!r} expects a "
                f"[{want[0]}, {want[1]}, {want[2]}, b] tensor, got "
                f"{tuple(req.x.shape)}")
        if x.shape[3] > self.max_batch:
            raise ValueError(
                f"model request {req.rid} batch {x.shape[3]} exceeds "
                f"max_batch {self.max_batch}; split it")
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

    # -- flush decision ------------------------------------------------------
    def _group_cap(self, head: ConvRequest) -> int:
        if isinstance(head, ModelRequest):
            return self.max_batch
        return self._layers[head.layer].ladder[-1]

    def _occupancy_target(self, head: ConvRequest) -> int:
        if self.config.occupancy_target:
            return self.config.occupancy_target
        if isinstance(head, ModelRequest):
            # the chain runs every layer at the chosen bucket, so gather to
            # the most demanding layer's sweet spot — padding is only free
            # when it is free for every layer in the pipeline
            chain = self._nets[head.net]
            return max(self._layers[l].ladder[0] for l in chain.layers)
        return self._layers[head.layer].ladder[0]

    def _flush_bucket(self, head: ConvRequest, total: int) -> int:
        first = (self._nets[head.net].layers[0]
                 if isinstance(head, ModelRequest) else head.layer)
        rungs = self._flush_rungs.get(first, ())
        return next((b for b in rungs if b >= total), total)

    def _predicted_dispatch_s(self, head: ConvRequest, bucket: int) -> float:
        if isinstance(head, ModelRequest):
            chain = self._nets[head.net]
            return sum(self._pred_s.get((l, ConvOp.FPROP, bucket), 0.0)
                       for l in chain.layers)
        return self._pred_s.get((head.layer, head.op, bucket), 0.0)

    def _peek_group(self, head: ConvRequest
                    ) -> Tuple[List[ConvRequest], int]:
        # called under self._lock; non-destructive coalescing preview
        cap = self._group_cap(head)
        group, total = [head], head._b
        for r in self._queue:
            if r is head:
                continue
            if (r.layer == head.layer and r.op == head.op
                    and total + r._b <= cap):
                group.append(r)
                total += r._b
        return group, total

    def _flush_reason(self, head: ConvRequest, group: List[ConvRequest],
                      total: int, now: float) -> Optional[str]:
        """Why this group should dispatch now — or None to keep gathering.
        ``"occupancy"``: the family's sweet-spot rung is filled (the
        throughput path, identical to what drain-on-demand would batch).
        ``"deadline"``: the most urgent deadline cannot afford to wait for
        the predicted flush-bucket execution plus margin.  ``"gather"``:
        deadline-less requests have waited ``max_gather_s``."""
        cfg = self.config
        if total >= min(self._occupancy_target(head), self._group_cap(head)):
            return "occupancy"
        deadlines = [r._t_deadline for r in group
                     if r._t_deadline is not None]
        if deadlines:
            pred = self._predicted_dispatch_s(
                head, self._flush_bucket(head, total))
            if min(deadlines) - now <= pred + cfg.flush_margin_s:
                return "deadline"
        if now - min(r._t_submit for r in group) >= cfg.max_gather_s:
            return "gather"
        return None

    def _take_batch(self) -> List[ConvRequest]:
        """First flush-ready group in queue order (EDF policy keeps the
        queue deadline-ordered, so "queue order" is urgency order there);
        empty list when nothing should dispatch yet."""
        now = time.perf_counter()
        with self._lock:
            if not self._queue:
                return []
            seen = set()
            for head in list(self._queue):
                key = (head.layer, head.op)
                if key in seen:
                    continue
                seen.add(key)
                group, total = self._peek_group(head)
                why = self._flush_reason(head, group, total, now)
                if why is None:
                    continue
                for r in group:
                    self._queue.remove(r)
                self._g_queue.set(len(self._queue))
                self._c_flush[why].inc()
                return group
            return []

    # -- dispatch ------------------------------------------------------------
    def _bucket_for(self, fam: _Family, op: ConvOp, total: int) -> int:
        """Cheapest warmed bucket that fits, by the cost model's per-bucket
        prediction (ties to the smaller pad).  Compute-bound rungs predict
        flat, so this picks the smallest power-of-two fit; a memory-bound
        family pays per lane and likewise prefers minimal padding — either
        way a sub-rung flush never pays for lanes the deadline didn't buy."""
        rungs = [b for b in self._flush_rungs.get(fam.layer, ())
                 if b >= total]
        if not rungs:
            return super()._bucket_for(fam, op, total)
        return min(rungs,
                   key=lambda b: (self._pred_s.get((fam.layer, op, b), 0.0),
                                  b))

    def step(self) -> int:
        """One scheduling decision + dispatch; returns requests served
        (0 = nothing flush-ready)."""
        group = self._take_batch()
        if not group:
            return 0
        if isinstance(group[0], ModelRequest):
            served = self._dispatch_model(group)
        else:
            served = self._dispatch(group)
        self._account_deadlines(group)
        return served

    def _account_deadlines(self, group: List[ConvRequest]) -> None:
        deadlined = [r for r in group if r._t_deadline is not None]
        if not deadlined:
            return
        # the dispatch synchronized before completing the group, so this
        # clock reads completion, not enqueue
        now = time.perf_counter()
        for r in deadlined:
            slack = r._t_deadline - now
            self._h_slack.observe(slack)
            if slack < 0:
                self._c_deadline_miss.inc()

    def _model_bucket(self, chain: _NetChain, total: int) -> int:
        rungs = [b for b in self._flush_rungs.get(chain.layers[0], ())
                 if b >= total]
        if not rungs:
            raise RuntimeError(
                f"net {chain.name!r} has no warmed flush bucket >= {total}; "
                f"prewarm() the scheduler before serving model requests")
        cost = lambda b: sum(
            self._pred_s.get((l, ConvOp.FPROP, b), 0.0)
            for l in chain.layers)
        return min(rungs, key=lambda b: (cost(b), b))

    def _dispatch_model(self, group: List[ConvRequest]) -> int:
        """Execute one coalesced whole-model group: concat + pad once,
        carry the activation through every layer in plan layout, slice
        lanes back at the end.  Mirrors ``ConvServer._dispatch``'s tracing
        and completion contract."""
        enabled = self.tracer.enabled
        t_start = time.perf_counter()
        for r in group:
            if r._t_submit:
                self._h_wait.observe(t_start - r._t_submit)
        chain = self._nets[group[0].net]
        sp = (self.tracer.span("repro.serve.model_dispatch",
                               server=self._sid)
              if enabled else _NOOP_SPAN)
        with sp:
            try:
                total = sum(r._b for r in group)
                bucket = self._model_bucket(chain, total)
                self._await_inputs(group)
                z = (group[0].x if len(group) == 1
                     else torch.cat([r.x for r in group], dim=3))
                if bucket > total:
                    z = F.pad(z, (0, bucket - total))
                for lname in chain.layers:
                    fam = self._layers[lname]
                    plan = self._plan(fam, ConvOp.FPROP, bucket)
                    t_l = time.perf_counter()
                    lsp = (self.tracer.span("repro.serve.layer_dispatch",
                                            server=self._sid, net=chain.name,
                                            layer=lname, bucket=bucket)
                           if enabled else _NOOP_SPAN)
                    with lsp:
                        z = plan.execute(z, fam.flt)
                        if chain.activation is not None:
                            z = chain.activation(z)
                        if enabled:
                            self._sync(z)
                    layer_s = time.perf_counter() - t_l
                    self._h_layer.observe(layer_s)
                    if (enabled and plan.choice is not None
                            and plan.exec_scene is not None):
                        self.drift.observe(
                            drift_mod.scene_class(plan.exec_scene,
                                                  plan.choice),
                            plan.predicted_s, layer_s)
                self._sync(z)
            except BaseException as e:  # noqa: BLE001 — propagated to every
                # waiter in the group (r.error below), not swallowed
                for r in group:
                    r.error, r.done = e, True
                    if r._event is not None:
                        r._event.set()
                raise
            off = 0
            for r in group:
                sl = z[..., off:off + r._b]
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
            sp.set(layer=group[0].layer, op=ConvOp.FPROP.value,
                   bucket=bucket, occupied=total, requests=len(group),
                   schedule=None, net=chain.name, layers=len(chain.layers))
        if not enabled:
            self._publish(DispatchRecord(
                layer=group[0].layer, op=ConvOp.FPROP, bucket=bucket,
                occupied=total, requests=len(group), schedule=None))
        return len(group)

    def _span_sink(self, span: Span) -> None:
        a = span.args
        if (span.name == "repro.serve.model_dispatch"
                and a.get("server") == self._sid and "layer" in a):
            self._publish(DispatchRecord(
                layer=a["layer"], op=ConvOp(a["op"]), bucket=a["bucket"],
                occupied=a["occupied"], requests=a["requests"],
                schedule=a.get("schedule")))
            return
        super()._span_sink(span)

    # -- serving loops -------------------------------------------------------
    def drain(self) -> int:
        """Serve until the queue is empty.  Unlike the base server an
        unflushed queue is not an empty one: when nothing is flush-ready
        yet, sleep ``poll_s`` and retry — ``max_gather_s`` bounds how long
        any group can sit unflushed, so this terminates."""
        served = 0
        while True:
            n = self.step()
            served += n
            if n:
                continue
            with self._lock:
                if not self._queue:
                    return served
            time.sleep(self.config.poll_s)

    def wait(self, requests: Sequence[ConvRequest], *,
             raise_on_error: bool = True) -> List[Optional[torch.Tensor]]:
        """Block until every request completes; returns outputs in request
        order.  ``raise_on_error=False`` returns None for failed/shed
        requests instead of re-raising (bulk clients inspect ``.error``)."""
        outs: List[Optional[torch.Tensor]] = []
        for r in requests:
            if r._event is not None:
                r._event.wait()
            if r.error is not None and raise_on_error:
                raise RuntimeError(
                    f"request {r.rid} failed in a coalesced dispatch"
                ) from r.error
            outs.append(r.out)
        return outs

    def start(self) -> None:
        """Run the scheduling loop in a daemon thread — continuous
        batching: clients just ``submit`` and ``wait``."""
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("scheduler loop already running")
            warmed = self._warmed
        if not warmed:
            self.prewarm()
        self._stop_evt.clear()
        t = threading.Thread(target=self._loop, name="repro-serve-sched",
                             daemon=True)
        with self._lock:
            self._thread = t
        t.start()

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                if self.step() == 0:
                    time.sleep(self.config.poll_s)
            except Exception:  # noqa: BLE001 — the failed group's waiters
                # already carry the error (step completed them before
                # re-raising); the loop must keep serving everyone else
                continue

    def stop(self) -> None:
        """Stop the background loop (queued work stays queued)."""
        self._stop_evt.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join()

    # -- introspection -------------------------------------------------------
    def stats(self, since: Optional[Dict] = None) -> Dict[str, float]:
        """Base serving stats plus scheduler health: shed/deadline counters
        and the flush-reason breakdown (same ``since`` windowing)."""
        s = super().stats(since=since)
        snap = self.snapshot()
        if since is not None:
            snap = snapshot_delta(since, snap)
        v = lambda name: int(snapshot_value(snap, f"repro.serve.{name}"))
        dl = v("deadline_requests")
        s.update({
            "shed": v("shed_total"),
            "deadline_requests": dl,
            "deadline_misses": v("deadline_misses"),
            "deadline_miss_rate": v("deadline_misses") / dl if dl else 0.0,
            "deadline_flushes": v("deadline_flushes"),
            "occupancy_flushes": v("occupancy_flushes"),
            "gather_timeout_flushes": v("gather_timeout_flushes"),
        })
        return s

    def flush_ladders(self) -> Dict[str, Tuple[int, ...]]:
        """Per-layer warmed flush rungs (the sub-rung dispatch menu)."""
        with self._lock:
            return dict(self._flush_rungs)


def scheduler_from_scenes(scenes: Mapping[str, ConvScene],
                          weights: Optional[Mapping[str, torch.Tensor]] = None,
                          *, seed: int = 0,
                          ops: Sequence[ConvOp] = (ConvOp.FPROP,),
                          config: Optional[SchedConfig] = None,
                          **kwargs) -> ConvScheduler:
    """``server_from_scenes`` for the scheduler: build a ``ConvScheduler``
    from a layer -> scene map, seeding missing weights."""
    sched = ConvScheduler(config=config, **kwargs)
    flts = seeded_weights(scenes, weights, seed=seed, device=sched.device)
    for layer, scene in scenes.items():
        sched.register_layer(layer, scene, flts[layer], ops=ops)
    return sched
