"""Ring-sharded ConvPlan execution — per-shard plans over a device ring
(port of ``repro.shard.plan``).

``ShardedConvPlan`` is the ring-aware sibling of ``plan.build.ConvPlan``:
same frozen plan-once / execute-many contract, same global-tensor
``execute(a, b)`` signature and op semantics, but the dispatch runs the
per-shard ``ConvPlan`` once per ring position, with the reference's
collectives mapped onto copies between the ring's devices:

  batch / oc   pure data decomposition over independent GEMM columns /
               rows — no collective, bitwise-identical to the unsharded
               plan;
  h            the globally pre-padded input is split into per-shard row
               chunks; each shard takes its halo rows from the next
               shard(s) by ring rotation (the reference's ``ppermute``: a
               copy to the receiving shard's device; rows past the
               partitioned extent ride a small replicated tail buffer) —
               bitwise-identical, because every output row is still
               produced by one shard's ordinary kernel accumulation;
  ic           every shard convolves its reduction slice into a full-size
               partial output and the partials are summed on the first
               ring device in shard order 0..n-1 (the reference's
               ``psum``) — within tolerance (float addition reorders
               across shards).

The ring is a tuple of ``torch.device``s driven by this one process (the
reference's ``shard_map`` is single-controller too), and it may repeat a
device: ``(cuda:0,) * 4`` runs every partition's sub-scenes through the
real kernels on one card, as the reference's forced 8-device CPU host
does.  With distinct devices each shard launches under its own device's
guard and each distinct device has its own inner plan; cross-device
copies are ``Tensor.to(dev, non_blocking=True)``, which PyTorch orders
against both devices' current streams.

All three directions route through the same wrapper: DGRAD and WGRAD
reuse the operand transforms of the one-device executors
(``plan.build.dgrad_operands`` / ``wgrad_operands`` / ``wgrad_finish``),
so the per-shard plan is always an *fprop-form* plan over the
partition's sub-exec-scene and the partition axes mean the same thing for
every op.  A WGRAD plan's inner plans split their reduction as the
one-device plan does: the sub-scene of a split wgrad exec scene is a
``WgradScene`` too, and a batch, oc or h partition keeps its reduction,
and so its segments.  ``sharded_conv_with_plans``
(``repro_torch.shard.autodiff``) closes the loop: an autograd Function
whose backward passes are themselves sharded plans.

Uneven partitions zero-pad the partitioned dim up to ``n * sub_dim`` and
slice the result back — zero lanes are linear-safe (the serving layer's
bucket-padding argument), so remainder shards cost padding, not a
special-cased geometry.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.mapping import (SHARD_LAUNCH_OVERHEAD_S, SCHEDULES,
                                      CostModel, ScheduleChoice, smem_budget)
from repro_torch.core.scene import ConvScene
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import default_metrics
from repro_torch.obs.trace import default_tracer
from repro_torch.plan.build import (_IO_SHAPES, _OPERANDS, ConvOp, ConvPlan,
                                    PolicySpec, _active_cost_model,
                                    _pad_axis, grad_filter_scene,
                                    grad_input_scene, make_plan, policy_tag,
                                    wgrad_finish)
from repro_torch.shard.spec import (PARTITION_AXES, UNSHARDED_AXIS,
                                    ShardSpec, collective_bytes,
                                    collective_seconds, halo_geometry,
                                    select_shard_spec, shard_sub_scene)


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev``: itself when already there, else an asynchronous
    copy (the reference's ring transfer)."""
    return t if t.device == dev else t.to(dev, non_blocking=True)


def _guard(dev: torch.device):
    """The device guard a shard's launches run under."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


@dataclasses.dataclass(frozen=True)
class ShardedConvPlan:
    """Frozen ring-sharded plan for one (scene, op, policy, partition).

    ``execute`` takes and returns *global* (unsharded) tensors with the
    same shapes as the equivalent ``ConvPlan`` — callers swap one in
    without touching their data flow — and returns its result on the
    ring's first device.  ``inners`` holds the per-shard plan of each ring
    position (one plan per distinct device): an fprop-form ``ConvPlan``
    over ``spec.sub_scene`` (which equals the exec scene when the selector
    fell back to ``n_shards == 1``); ``inner`` is the first.
    """

    scene: ConvScene                  # the *forward* scene the plan serves
    op: ConvOp
    policy: str                       # canonical tag (requested policy)
    spec: ShardSpec
    exec_scene: ConvScene             # the full (unpartitioned) exec scene
    devices: Tuple[torch.device, ...]  # the shard ring, len == n_shards
    inners: Tuple[ConvPlan, ...]      # fprop-form plan per ring position
    out_hw: Tuple[int, int] = (0, 0)  # wgrad spatial slice-back (0,0 = none)

    # -- execution ---------------------------------------------------------
    def execute(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Run the planned op on global tensors: (inp, flt) for FPROP,
        (d_out, flt) for DGRAD, (inp, d_out) for WGRAD."""
        a_shape, b_shape, _ = self.io_shapes()
        if tuple(a.shape) != a_shape or tuple(b.shape) != b_shape:
            raise ValueError(
                f"sharded {self.op.value} plan for {self.scene.describe()} "
                f"expects operands {a_shape} x {b_shape}, got "
                f"{tuple(a.shape)} x {tuple(b.shape)}")
        m = default_metrics()
        m.counter("repro.shard.executes").inc()
        if self.spec.collective_bytes:
            m.counter("repro.shard.collective_bytes").inc(
                self.spec.collective_bytes)
        outs = []
        for inner, dev, (ai, bi) in zip(self.inners, self.devices,
                                        self.shard_operands(a, b)):
            with _guard(dev):
                outs.append(inner.execute(ai, bi))
        out = self._combine(outs)
        if self.op is ConvOp.WGRAD:
            out = wgrad_finish(out[:self.out_hw[0], :self.out_hw[1]])
        return out

    __call__ = execute

    def shard_operands(self, a: torch.Tensor, b: torch.Tensor
                       ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """The fprop-form ``(inp, flt)`` of every shard, in ring order,
        each on its ring device: what ``execute(a, b)`` hands the inner
        plans (``inner.kernel_call`` on them gives each shard's launch)."""
        a, b = _OPERANDS[self.op.value](a, b)
        spec, E, ring = self.spec, self.exec_scene, self.devices
        n, sub = spec.n_shards, spec.sub_scene
        if n == 1:
            return [(_to(a, ring[0]), _to(b, ring[0]))]
        if spec.axis == "batch":
            a = _pad_axis(a, 3, n * sub.B)
            return [(_to(a[..., i * sub.B:(i + 1) * sub.B], d).contiguous(),
                     _to(b, d)) for i, d in enumerate(ring)]
        if spec.axis == "oc":
            b = _pad_axis(b, 3, n * sub.OC)
            return [(_to(a, d), _to(b[..., i * sub.OC:(i + 1) * sub.OC],
                                    d).contiguous())
                    for i, d in enumerate(ring)]
        if spec.axis == "ic":
            k = sub.IC
            a, b = _pad_axis(a, 2, n * k), _pad_axis(b, 2, n * k)
            return [(_to(a[:, :, i * k:(i + 1) * k], d).contiguous(),
                     _to(b[:, :, i * k:(i + 1) * k], d).contiguous())
                    for i, d in enumerate(ring)]
        return self._halo_slabs(a, b)

    def _halo_slabs(self, a: torch.Tensor, b: torch.Tensor
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Spatial-H operands: pre-pad the global input once (top ``padH``
        and zeros out to the last row any shard's window can touch; the
        sub-scene has ``padH = 0``, so shard-local windows never re-pad H),
        place chunk i on ring device i and the tail rows on every device,
        then give shard i its chunk and ``hops`` rotated chunks — the
        tail block where the rotation ran past the partitioned extent.
        The slice after the pad handles scenes whose stride remainder
        leaves real input rows no window reads."""
        E, ring, n = self.exec_scene, self.devices, self.spec.n_shards
        geo = halo_geometry(E, n)
        ch, T = geo.ch, n * geo.ch
        bot = max(0, geo.total - E.padH - E.inH)
        pin = F.pad(a, (0, 0, 0, 0, 0, 0, E.padH, bot))[:geo.total]
        chunks = [_to(pin[i * ch:(i + 1) * ch], d) for i, d in enumerate(ring)]
        tails = {d: _to(pin[T:], d) for d in ring}
        out = []
        for i, d in enumerate(ring):
            parts = [chunks[i]]
            if geo.halo > 0:
                for k in range(1, geo.hops + 1):
                    if i + k < n:
                        parts.append(_to(chunks[i + k], d))
                    else:
                        off = min(i + k - n, max(geo.hops - 1, 0)) * ch
                        parts.append(tails[d][off:off + ch])
            slab = torch.cat(parts, dim=0)[:geo.slab].contiguous()
            out.append((slab, _to(b, d)))
        return out

    def _combine(self, outs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The exec-form global output on the first ring device."""
        spec, E, dev = self.spec, self.exec_scene, self.devices[0]
        outs = [_to(o, dev) for o in outs]
        if spec.n_shards == 1:
            return outs[0]
        if spec.axis == "ic":
            acc = outs[0]
            for o in outs[1:]:
                acc = acc + o
            return acc
        if spec.axis == "batch":
            return torch.cat(outs, dim=3)[..., :E.N].contiguous()
        if spec.axis == "oc":
            return torch.cat(outs, dim=2)[:, :, :E.M].contiguous()
        return torch.cat(outs, dim=0)[:E.outH].contiguous()

    def kernel_calls(self, a: torch.Tensor, b: torch.Tensor) -> list:
        """``(wrapper, inp, flt, blocks)`` of every shard's launch, in ring
        order (``ConvPlan.kernel_call`` of each inner plan on its
        operands)."""
        return [inner.kernel_call(ai, bi) for inner, (ai, bi)
                in zip(self.inners, self.shard_operands(a, b))]

    # -- introspection -----------------------------------------------------
    def io_shapes(self) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                                 Tuple[int, ...]]:
        """(arg-a shape, arg-b shape, result shape) of ``execute`` — global
        shapes, identical to the unsharded plan's."""
        names = _IO_SHAPES[self.op]
        return tuple(getattr(self.scene, nm)() for nm in names)

    @property
    def inner(self) -> ConvPlan:
        """The per-shard plan of the ring's first device."""
        return self.inners[0]

    @property
    def n_shards(self) -> int:
        return self.spec.n_shards

    @property
    def choice(self) -> ScheduleChoice:
        return self.spec.choice

    @property
    def schedule(self) -> str:
        return self.spec.choice.schedule

    @property
    def predicted_s(self) -> float:
        """Whole-dispatch model: per-shard schedule time + collective term
        + shard launch overhead (= ``spec.predicted_s``)."""
        return self.spec.predicted_s

    @property
    def shard_tag(self) -> str:
        """Partition fragment of the registry signature (``axis:n``)."""
        return self.spec.tag

    @property
    def backend(self) -> str:
        return self.devices[0].type

    @property
    def use_kernels(self) -> bool:
        return self.inner.use_kernels

    @property
    def uses_reference(self) -> bool:
        return self.inner.uses_reference

    @property
    def notes(self) -> Tuple[str, ...]:
        return self.inner.notes

    def describe(self) -> str:
        return (f"sharded-plan({self.op.value} {self.spec.tag} "
                f"{self.spec.choice.schedule} policy={self.policy} "
                f"coll={self.spec.collective_bytes}B "
                f"{self.scene.describe()})")


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------
def _exec_scene_for(scene: ConvScene, op: ConvOp
                    ) -> Tuple[ConvScene, Tuple[int, int]]:
    """(exec scene, wgrad slice-back) of one op.  Raises ``ValueError`` for
    the ops with no MG3M exec scene (apad scenes, over-padded dgrad) — the
    sharded wrapper has no reference route; use ``make_plan`` there."""
    if op is ConvOp.FPROP:
        return scene, (0, 0)
    if op is ConvOp.DGRAD:
        return grad_input_scene(scene), (0, 0)
    return grad_filter_scene(scene), (scene.fltH, scene.fltW)


def _allowed_schedules(tag: str) -> Tuple[str, ...]:
    """Schedules the joint selector may use under a policy tag.  A forced
    grain ("forced:TB18") restricts the sub-scene selection the way it
    restricts unsharded selection; exact forced blockings
    ("forced:TB88@8/8/8") cannot transfer to a sub-scene whose dims the
    partition changed — refuse instead of silently re-blocking."""
    if not tag.startswith("forced:"):
        return SCHEDULES
    name = tag[len("forced:"):]
    if "@" in name:
        raise ValueError(
            f"policy {tag!r} pins exact blocks for the *unsharded* scene; "
            f"a sharded plan re-selects blocks for each sub-scene — force "
            f"the schedule alone (e.g. 'TB88') instead")
    return (name,)


def device_pool(devices: Optional[Sequence] = None
                ) -> Tuple[torch.device, ...]:
    """The shard ring pool as ``torch.device``s: ``devices`` (which may
    repeat a device; one device type throughout), or every visible CUDA
    device when None — raising without a card, as ``resolve_device``
    does.  A CUDA device without an index means the current one."""
    if devices is None:
        resolve_device(None)
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("empty device pool")
    if len({d.type for d in devs}) != 1 or devs[0].type == "meta":
        raise ValueError(f"a shard ring holds CUDA devices or CPU devices, "
                         f"not {[str(d) for d in devs]}")
    return tuple(torch.device("cuda", torch.cuda.current_device())
                 if d.type == "cuda" and d.index is None else d
                 for d in devs)


def make_sharded_plan(scene: ConvScene, op: Union[ConvOp, str] = ConvOp.FPROP,
                      *, policy: PolicySpec = "analytic",
                      devices: Optional[Sequence] = None,
                      max_shards: Optional[int] = None,
                      axes: Sequence[str] = PARTITION_AXES,
                      model: Optional[CostModel] = None,
                      spec: Optional[ShardSpec] = None) -> ShardedConvPlan:
    """Build a frozen ``ShardedConvPlan``: derive the op's exec scene, pick
    (partition x grain) jointly (``select_shard_spec``), build the
    per-shard fprop-form plan with its choice pinned.

    ``devices`` is the shard ring pool (default: every visible CUDA
    device; see ``device_pool``); ``max_shards`` additionally caps the
    ring (default: the pool size).  ``axes`` restricts the candidate
    partitions — ``("batch",)`` is the serving layer's data-parallel
    mode.  ``spec`` pins a partition exactly (the registry's reload path
    and the "force a partition" knob); it is re-validated against the
    exec scene, never trusted blindly.  ``model=None`` uses the first
    ring device's active (calibrated if an artifact exists) cost model,
    like unsharded plan building does.
    """
    op = ConvOp(op)
    tag = policy_tag(policy)
    if isinstance(policy, ScheduleChoice):
        raise ValueError(
            "make_sharded_plan cannot pin an exact ScheduleChoice: the "
            "joint selector re-blocks for each candidate sub-scene; force "
            "a schedule name, or pin a full ShardSpec via spec=")
    allowed = _allowed_schedules(tag)
    devs = device_pool(devices)
    if model is None:
        model = _active_cost_model(devs[0])
    cap = len(devs) if max_shards is None else min(max_shards, len(devs))
    t0 = time.perf_counter()
    with default_tracer().span("repro.shard.make_plan", op=op.value,
                               policy=tag, scene=scene.describe()):
        exec_scene, out_hw = _exec_scene_for(scene, op)
        if spec is None:
            spec = select_shard_spec(exec_scene, max_shards=cap, axes=axes,
                                     allowed=allowed, model=model,
                                     budget=smem_budget(devs[0]))
        else:
            _validate_spec(spec, exec_scene, len(devs))
        ring = devs[:spec.n_shards]
        by_dev: Dict[torch.device, ConvPlan] = {}
        for d in ring:
            if d not in by_dev:
                by_dev[d] = make_plan(spec.sub_scene, ConvOp.FPROP,
                                      policy=spec.choice, device=d)
        m = default_metrics()
        m.counter("repro.shard.plans").inc()
        if not spec.is_sharded:
            m.counter("repro.shard.fallbacks").inc()
        m.histogram("repro.shard.plan_build_s").observe(
            time.perf_counter() - t0)
        return ShardedConvPlan(scene=scene, op=op, policy=tag, spec=spec,
                               exec_scene=exec_scene, devices=ring,
                               inners=tuple(by_dev[d] for d in ring),
                               out_hw=out_hw)


def _validate_spec(spec: ShardSpec, exec_scene: ConvScene,
                   n_devices: int) -> None:
    if spec.n_shards > n_devices:
        raise ValueError(
            f"spec wants {spec.n_shards} shards but only {n_devices} "
            f"device(s) are available")
    want = (exec_scene if not spec.is_sharded
            else shard_sub_scene(exec_scene, spec.axis, spec.n_shards))
    if spec.sub_scene != want:
        raise ValueError(
            f"pinned ShardSpec sub-scene {spec.sub_scene.describe()} does "
            f"not re-derive from {exec_scene.describe()} under "
            f"{spec.tag} (expected {want.describe()})")


def pinned_shard_spec(scene: ConvScene, op: Union[ConvOp, str], axis: str,
                      n_shards: int, choice: ScheduleChoice) -> ShardSpec:
    """Rebuild a ``ShardSpec`` from its persisted identity (axis, count,
    sub-scene choice) — cost terms are recomputed, the choice is pinned.
    The registry's deserialization path and the "force a partition" knob.
    """
    exec_scene, _ = _exec_scene_for(scene, ConvOp(op))
    if n_shards == 1:
        return ShardSpec(axis=UNSHARDED_AXIS, n_shards=1,
                         sub_scene=exec_scene, choice=choice,
                         predicted_s=choice.predicted_s,
                         collective_s=0.0, collective_bytes=0)
    sub = shard_sub_scene(exec_scene, axis, n_shards)
    coll_s = collective_seconds(exec_scene, axis, n_shards)
    return ShardSpec(
        axis=axis, n_shards=n_shards, sub_scene=sub, choice=choice,
        predicted_s=choice.predicted_s + coll_s + SHARD_LAUNCH_OVERHEAD_S,
        collective_s=coll_s,
        collective_bytes=collective_bytes(exec_scene, axis, n_shards))


def assemble_sharded_plan(scene: ConvScene, op: Union[ConvOp, str],
                          policy: str, axis: str, n_shards: int,
                          choice: ScheduleChoice, *,
                          devices: Optional[Sequence] = None
                          ) -> ShardedConvPlan:
    """Rebuild a sharded plan from stored identity without re-running the
    joint selector (the registry's artifact path).  Raises ``ValueError``
    when the device pool is smaller than the stored ring — the loader
    skips such entries the way it skips any stale plan."""
    spec = pinned_shard_spec(scene, op, axis, n_shards, choice)
    return make_sharded_plan(scene, op, policy=policy, devices=devices,
                             spec=spec)
