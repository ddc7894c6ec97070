"""Plan-driven CNN training — every fprop/dgrad/wgrad is a prewarmed
ConvPlan (port of ``repro.train.cnn``).

  * ``build_cnn_train_step``: ``(TrainState, batch) -> (TrainState,
    metrics)`` over a ``ModelPlans`` — forward through
    ``models.cnn.cnn_forward_planned`` (activations in plan layout across
    the stack), backward through each layer's prewarmed dgrad/wgrad plans
    (``core.autodiff.conv_with_plans``; a ``ModelPlans`` built over a
    device ring dispatches ``shard.sharded_conv_with_plans``, whose
    sharded plans return global gradients on the ring's first device, so
    the step is the same), update through
    ``optimizer.adamw_update``.  Microbatches accumulate in a Python loop
    (the reference's ``lax.scan``) into ``GradBuckets``, a few flat f32
    buffers rather than one per parameter.
  * ``jit_train_step`` / ``build_cnn_train_loop`` keep the reference's
    names for what the eager port does in their place (an in-place state
    update; a loop over stacked batches).
  * host-side instrumentation: ``observe_step`` / ``observe_plan_hit_rate``
    / ``profile_step_breakdown`` record the ``repro.train.*`` metrics, and
    ``feed_drift_from_plans`` streams each plan's (predicted, measured)
    seconds into the cost-model drift monitor.  Times on the card are CUDA
    events around synchronized work.

Zero steady-state resolutions is the contract: ``resolution_guard``
snapshots the ``repro.plan.resolutions`` counter and raises if a guarded
step resolved a schedule.

Batches are ``{"images": NHWC tensor, "labels": int tensor}`` on the
plans' device; parameters and optimizer state are flat ``{name: tensor}``
dicts.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.models.cnn import cnn_forward_planned
from repro_torch.obs.metrics import MetricRegistry, default_metrics
from repro_torch.train import optimizer as opt

F32 = torch.float32


class TrainState(NamedTuple):
    """Parameters and optimizer state (the reference's
    ``train/step.py`` ``TrainState``)."""

    params: Dict[str, torch.Tensor]
    opt: opt.OptState


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean CE of integer labels — mask and sum instead of a gather, the
    reference's class-parallel-safe shape."""
    logits = logits.to(F32)
    lse = torch.logsumexp(logits, -1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    picked = torch.where(iota == labels[..., None].long(), logits,
                         0.0).sum(-1)
    return (lse - picked).mean()


def cnn_loss_fn(params, batch: Mapping[str, torch.Tensor], plans,
                layer_order: Sequence[str] = ()
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE loss of the plan-layout forward, and the batch accuracy."""
    logits = cnn_forward_planned(params, batch["images"], plans,
                                 layer_order=layer_order)
    loss = softmax_cross_entropy(logits, batch["labels"])
    acc = (logits.argmax(-1) == batch["labels"].long()).to(F32).mean()
    return loss, {"accuracy": acc}


# ---------------------------------------------------------------------------
# flat-buffer gradient bucketing
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GradBuckets:
    """Greedy size-capped packing of the parameters into contiguous f32
    buffers.  ``flatten`` ravels a gradient dict into ``n_buckets`` 1-D
    buffers (leaves in sorted-name order, the reference's tree order);
    ``unflatten`` inverts it with views."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    edges: Tuple[int, ...]      # bucket b covers leaves[edges[b]:edges[b+1]]
    device: torch.device

    @property
    def n_buckets(self) -> int:
        return len(self.edges) - 1

    def _leaves(self, b: int) -> range:
        return range(self.edges[b], self.edges[b + 1])

    def zeros(self) -> Tuple[torch.Tensor, ...]:
        """Zeroed accumulator buffers."""
        return tuple(torch.zeros(sum(self.sizes[i] for i in self._leaves(b)),
                                 dtype=F32, device=self.device)
                     for b in range(self.n_buckets))

    def flatten(self, grads: Mapping[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.cat([grads[self.names[i]].to(F32).reshape(-1)
                                for i in self._leaves(b)])
                     for b in range(self.n_buckets))

    def unflatten(self, bufs: Sequence[torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        out = {}
        for b in range(self.n_buckets):
            off = 0
            for i in self._leaves(b):
                n = self.sizes[i]
                out[self.names[i]] = bufs[b][off:off + n].view(self.shapes[i])
                off += n
        return out


def make_grad_buckets(params: Mapping[str, torch.Tensor], *,
                      bucket_mb: float = 4.0) -> GradBuckets:
    """Pack the parameters, in sorted-name order, into buckets of at most
    ``bucket_mb`` MiB of f32 gradient each (a leaf larger than the cap gets
    its own bucket), on the parameters' device."""
    if bucket_mb <= 0:
        raise ValueError(f"bucket_mb must be positive, got {bucket_mb}")
    names = tuple(sorted(params))
    shapes = tuple(tuple(params[k].shape) for k in names)
    sizes = tuple(int(params[k].numel()) for k in names)
    cap = int(bucket_mb * 2 ** 20 / 4)          # f32 elements per bucket
    edges = [0]
    filled = 0
    for i, n in enumerate(sizes):
        if filled and filled + n > cap:
            edges.append(i)
            filled = 0
        filled += n
    edges.append(len(sizes))
    return GradBuckets(names=names, shapes=shapes, sizes=sizes,
                       edges=tuple(edges),
                       device=params[names[0]].device)


# ---------------------------------------------------------------------------
# step / loop builders
# ---------------------------------------------------------------------------
def _value_and_grad(lfn: Callable, params: Mapping[str, torch.Tensor],
                    batch):
    """(loss, stats, grads) of ``lfn(params, batch)`` by autograd, the
    parameters detached from any earlier graph."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with torch.enable_grad():
        loss, stats = lfn(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), {k: v.detach() for k, v in stats.items()},
            dict(zip(leaves, grads)))


def build_cnn_train_step(plans, opt_cfg: opt.AdamWConfig, *,
                         n_microbatches: int = 1,
                         buckets: Optional[GradBuckets] = None,
                         layer_order: Sequence[str] = (),
                         loss_fn: Optional[Callable] = None):
    """Build ``train_step(state, batch) -> (state, metrics)`` over a
    ``ModelPlans``.

    Plans are fixed-geometry: build them for the *microbatch* size
    (``global_batch // n_microbatches``).  Gradients accumulate over
    ``n_microbatches`` consecutive slices of the batch into the flat f32
    buffers of ``buckets`` (packed from the parameters when None), then are
    divided by their count.  ``metrics`` holds 0-d tensors: loss,
    accuracy, grad_norm (before clipping), lr."""
    if n_microbatches < 1:
        raise ValueError(
            f"n_microbatches must be >= 1, got {n_microbatches}")
    lfn = loss_fn if loss_fn is not None else functools.partial(
        cnn_loss_fn, plans=plans, layer_order=tuple(layer_order))

    def train_step(state: TrainState, batch):
        n_mb = n_microbatches
        if (loss_fn is None and hasattr(plans, "scenes")
                and isinstance(batch, Mapping) and "images" in batch):
            plan_b = next(iter(plans.scenes().values())).B
            if batch["images"].shape[0] != plan_b * n_mb:
                raise ValueError(
                    f"batch of {batch['images'].shape[0]} images does not "
                    f"match plans built for microbatch B={plan_b} x "
                    f"{n_mb} microbatches — build the plans for the "
                    f"microbatch size (global_batch // n_microbatches)")
        packing = (buckets if buckets is not None
                   else make_grad_buckets(state.params))
        bufs = packing.zeros()
        grads = packing.unflatten(bufs)         # views of the buffers
        l_acc, all_stats = 0.0, []
        for i in range(n_mb):
            mb = {k: v.reshape(n_mb, v.shape[0] // n_mb, *v.shape[1:])[i]
                  for k, v in batch.items()}
            loss, stats, g = _value_and_grad(lfn, state.params, mb)
            for k, acc in grads.items():
                acc.add_(g[k])
            l_acc = l_acc + loss
            all_stats.append(stats)
        for b in bufs:
            b.div_(n_mb)
        loss = l_acc / n_mb
        stats = {k: torch.stack([s[k] for s in all_stats]).mean()
                 for k in all_stats[0]}
        new_params, new_opt, om = opt.adamw_update(
            opt_cfg, state.params, grads, state.opt)
        metrics = dict(om, loss=loss, **stats)
        return TrainState(new_params, new_opt), metrics

    return train_step


def jit_train_step(step_fn):
    """The reference jits the step with the ``TrainState`` donated, so
    parameters and moments update in place.  PyTorch runs eagerly and has
    nothing to compile: the returned step runs ``step_fn`` and copies the
    new parameters, moments and step count into the given state's own
    tensors, so the state a caller holds advances in place (and is
    returned)."""
    def step(state: TrainState, batch):
        new, metrics = step_fn(state, batch)
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(new.params[k])
            for old, fresh in ((state.opt.m, new.opt.m),
                               (state.opt.v, new.opt.v)):
                for k, t in old.items():
                    t.copy_(fresh[k])
            state.opt.step.copy_(new.opt.step)
        return state, metrics

    return step


def build_cnn_train_loop(step_fn):
    """The reference fuses K steps into one ``lax.scan`` dispatch over
    stacked batches (leaves ``[K, ...]``).  Eagerly, the returned
    ``train_loop(state, data) -> (state, stacked_metrics)`` loops over the
    K batches in order."""
    def train_loop(state: TrainState, data):
        n = next(iter(data.values())).shape[0]
        history = []
        for i in range(n):
            state, metrics = step_fn(state, {k: v[i]
                                             for k, v in data.items()})
            history.append(metrics)
        return state, {k: torch.stack([m[k] for m in history])
                       for k in history[0]}

    return train_loop


def init_train_state(params: Mapping[str, torch.Tensor], *,
                     moments_dtype: str = "float32") -> TrainState:
    return TrainState(params=dict(params),
                      opt=opt.init_opt_state(params,
                                             moments_dtype=moments_dtype))


# ---------------------------------------------------------------------------
# instrumentation (host side)
# ---------------------------------------------------------------------------
def observe_step(seconds: float, loss: float, n_examples: int,
                 metrics: Optional[MetricRegistry] = None) -> None:
    """Record one optimizer step into the ``repro.train.*`` metrics."""
    m = metrics if metrics is not None else default_metrics()
    m.histogram("repro.train.step_s").observe(seconds)
    m.counter("repro.train.steps").inc()
    m.counter("repro.train.examples").inc(n_examples)
    m.gauge("repro.train.loss").set(float(loss))


def observe_plan_hit_rate(registry=None,
                          metrics: Optional[MetricRegistry] = None,
                          device=None) -> float:
    """Record the plan registry's lifetime hit rate (``registry``, else the
    default registry of ``device``) as ``repro.train.plan_hit_rate`` (1.0
    = every training dispatch after prewarm was a cache hit) and return
    it."""
    from repro_torch.plan.registry import default_registry
    reg = registry if registry is not None else default_registry(device)
    rate = reg.stats()["hit_rate"]
    m = metrics if metrics is not None else default_metrics()
    m.gauge("repro.train.plan_hit_rate").set(rate)
    return rate


def timed_s(fn: Callable[[], Any], device: torch.device) -> float:
    """Seconds of one ``fn()`` call: CUDA events around it on the card
    (after a synchronize, so earlier work is not counted), the host clock
    on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def profile_step_breakdown(state: TrainState, batch, plans,
                           opt_cfg: opt.AdamWConfig, *,
                           layer_order: Sequence[str] = (),
                           metrics: Optional[MetricRegistry] = None
                           ) -> Dict[str, float]:
    """Time the two halves of a step on one batch — the gradients (forward
    and both backward plan walks) and the AdamW update — after one warm-up
    call each, and record them as ``repro.train.grads_s`` /
    ``repro.train.update_s``."""
    m = metrics if metrics is not None else default_metrics()
    lfn = functools.partial(cnn_loss_fn, plans=plans,
                            layer_order=tuple(layer_order))
    device = batch["images"].device
    out = {}

    def grads_fn():
        out["grads"] = _value_and_grad(lfn, state.params, batch)[2]

    def update_fn():
        opt.adamw_update(opt_cfg, state.params, out["grads"], state.opt)

    grads_fn()
    grads_s = timed_s(grads_fn, device)
    update_fn()
    update_s = timed_s(update_fn, device)
    m.histogram("repro.train.grads_s").observe(grads_s)
    m.histogram("repro.train.update_s").observe(update_s)
    return {"grads_s": grads_s, "update_s": update_s}


def feed_drift_from_plans(plans, monitor=None) -> int:
    """Stream a timed dispatch of every non-reference plan of a
    ``ModelPlans`` (zero operands, after a warm-up call) into the
    cost-model drift monitor; returns the number of (predicted, measured)
    pairs observed."""
    from repro_torch.device import torch_dtype
    from repro_torch.obs.drift import default_monitor, scene_class
    mon = monitor if monitor is not None else default_monitor()
    fed = 0
    for _layer, _opname, plan in plans.plans():
        if plan.uses_reference or plan.choice is None:
            continue
        dev = torch.device(plan.backend)
        dt = torch_dtype(plan.scene.dtype)
        a_shape, b_shape, _ = plan.io_shapes()
        a = torch.zeros(a_shape, dtype=dt, device=dev)
        b = torch.zeros(b_shape, dtype=dt, device=dev)
        plan.execute(a, b)                                  # warm-up
        measured = timed_s(lambda: plan.execute(a, b), dev)
        mon.observe(scene_class(plan.exec_scene, plan.choice),
                    plan.predicted_s, measured)
        fed += 1
    return fed


class resolution_guard:
    """Context manager asserting the plan-once contract: zero schedule
    resolutions inside the guarded region.  Enter after warm-up, wrap the
    steady-state steps; raises ``ValueError`` naming the count otherwise.

        with resolution_guard():
            for _ in range(n_steps):
                state, ms = step(state, batch)
    """

    def __init__(self, metrics: Optional[MetricRegistry] = None):
        self._m = metrics if metrics is not None else default_metrics()
        self._before = 0.0

    def __enter__(self) -> "resolution_guard":
        self._before = self._m.value("repro.plan.resolutions")
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            after = self._m.value("repro.plan.resolutions")
            if after > self._before:
                raise ValueError(
                    f"plan-once contract violated: "
                    f"{int(after - self._before)} schedule resolution(s) "
                    f"occurred inside a resolution_guard (expected zero "
                    f"after warmup)")
        return False
