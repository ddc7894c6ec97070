"""Differentiable MG3MConv: a ``torch.autograd.Function`` built from
``repro_torch.plan`` plans (port of ``repro.core.autodiff``).

All three directions are plan ops (``ConvOp.FPROP`` / ``DGRAD`` /
``WGRAD``): the backward convolutions are MG3M scenes of their own whose
grain the selector picks independently of the forward (dOUT has OC
channels where IN had IC; wgrad contracts the batch).  Scene derivation
lives in ``plan/build.py`` (``grad_input_scene`` / ``grad_filter_scene``);
strided forwards stay on the kernels in all three directions (the
backward scenes are dilated).  A direction with no MG3M scene (padding
beyond the dilated filter extent minus one blocks dgrad only) runs the
exact torch adjoint alone — see ``TrainingPlans.reference_ops``.

Three APIs, smallest to largest scope, as in the reference:

  * ``make_training_plans`` + ``conv_with_plans``: the (fprop, dgrad,
    wgrad) triple of one layer, then every call is pure dispatch;
  * ``make_model_plans`` + ``apply_conv``: one ``ModelPlans`` holds every
    layer's triple, prewarmed through ``PlanRegistry.warm``, so a whole
    training step resolves no schedule (``train/cnn.py`` builds on it);
  * ``mg3m_conv_trainable``: the per-call signature, fetching plans from
    the default registry of its device.

Where the reference's ``jax.custom_vjp`` always returns both cotangents
and leaves XLA to drop an unused one, ``conv_with_plans`` reads
``ctx.needs_input_grad`` and launches only the directions autograd asks
for: a first layer over images that need no gradient runs no dgrad.
``make_model_plans(devices=)`` builds ring-sharded triples instead
(``repro_torch.shard.autodiff``), and ``apply_conv`` dispatches either
flavour.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import (Dict, Iterator, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch

from repro_torch.core.mapping import ScheduleChoice
from repro_torch.core.scene import ConvScene
from repro_torch.device import DeviceSpec
from repro_torch.plan.build import ConvOp, ConvPlan, make_plan
from repro_torch.plan.registry import PlanRegistry, default_registry


@dataclasses.dataclass(frozen=True)
class TrainingPlans:
    """The (fprop, dgrad, wgrad) plan triple of one trainable conv layer."""

    fprop: ConvPlan
    dgrad: ConvPlan
    wgrad: ConvPlan

    @property
    def scene(self) -> ConvScene:
        return self.fprop.scene

    @property
    def uses_reference(self) -> bool:
        """True when *any* direction bypasses the kernels — an aggregate;
        the per-op truth is ``reference_ops``."""
        return bool(self.reference_ops)

    @property
    def reference_ops(self) -> tuple:
        """Names of the directions that run the torch reference, e.g.
        ``("dgrad",)``."""
        return tuple(p.op.value for p in (self.fprop, self.dgrad, self.wgrad)
                     if p.uses_reference)

    def describe(self) -> str:
        return " | ".join(p.describe() for p in (self.fprop, self.dgrad,
                                                 self.wgrad))


def backward_policy(policy: Union[None, str, ScheduleChoice]) -> str:
    """Policy the backward directions resolve under for a given fprop
    policy: "tuned" follows fprop into the schedule cache; everything else
    — analytic *and* forced — selects analytically, because a grain forced
    for the forward is not forced on the backward scenes."""
    return "tuned" if policy in ("auto", "tuned") else "analytic"


def make_training_plans(scene: ConvScene, *,
                        policy: Union[None, str, ScheduleChoice] = "analytic",
                        device: DeviceSpec = None, use_kernels: bool = True,
                        registry: Optional[PlanRegistry] = None
                        ) -> TrainingPlans:
    """Plan all three directions of one layer, each through the selector,
    on ``registry`` (its device) or else built afresh for ``device``
    (default the card).  ``policy`` applies to fprop; the backward plans
    resolve under ``backward_policy(policy)``: under "tuned"/"auto" the
    dgrad and wgrad plans resolve their exec scenes from the tune cache
    too."""
    bwd_policy = backward_policy(policy)
    if registry is not None:
        _check_device(registry, device)
        build = functools.partial(registry.get_or_build, scene,
                                  use_kernels=use_kernels)
    else:
        build = functools.partial(make_plan, scene, device=device,
                                  use_kernels=use_kernels)
    return TrainingPlans(fprop=build(ConvOp.FPROP, policy=policy),
                         dgrad=build(ConvOp.DGRAD, policy=bwd_policy),
                         wgrad=build(ConvOp.WGRAD, policy=bwd_policy))


def _check_device(registry: PlanRegistry, device: DeviceSpec) -> None:
    if device is not None and torch.device(device).type != registry.backend:
        raise ValueError(f"registry serves {registry.device}, not {device}")


class _ConvWithPlans(torch.autograd.Function):
    """fprop plan forward; dgrad and wgrad plans backward, each launched
    only where autograd needs its gradient."""

    @staticmethod
    def forward(ctx, inp, flt, plans):
        ctx.plans = plans
        ctx.save_for_backward(inp, flt)
        return plans.fprop.execute(inp, flt)

    @staticmethod
    def backward(ctx, d_out):
        inp, flt = ctx.saved_tensors
        plans = ctx.plans
        d_out = d_out.contiguous()     # pooling's backward is a broadcast
        d_in = d_flt = None
        if ctx.needs_input_grad[0]:
            d_in = plans.dgrad.execute(d_out, flt)
        if ctx.needs_input_grad[1]:
            d_flt = plans.wgrad.execute(inp, d_out)
        return d_in, d_flt, None


def conv_with_plans(inp: torch.Tensor, flt: torch.Tensor,
                    plans: TrainingPlans) -> torch.Tensor:
    """Differentiable convolution over a pre-built plan triple, operands in
    plan layout (IN ``[H, W, C, B]``, FLT ``[h, w, IC, OC]``): every
    direction is a zero-resolution dispatch."""
    return _ConvWithPlans.apply(inp, flt, plans)


# --------------------------------------------------------------------------
# whole-model plans
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelPlans:
    """Per-layer (fprop, dgrad, wgrad) plan triples for a whole CNN — the
    plan-once unit of ``train/cnn.py``: every layer's triple is built
    before the first step (``make_model_plans`` prewarms them through one
    ``PlanRegistry.warm`` pass per policy), then a training step is pure
    dispatch end to end."""

    # (name, triple) in order; a triple is a TrainingPlans, or a
    # ShardedTrainingPlans when built over a device ring
    layers: Tuple[Tuple[str, TrainingPlans], ...]

    def __getitem__(self, name: str) -> TrainingPlans:
        for n, triple in self.layers:
            if n == name:
                return triple
        raise KeyError(name)

    def __iter__(self) -> Iterator[str]:
        return (n for n, _ in self.layers)

    def __len__(self) -> int:
        return len(self.layers)

    def __contains__(self, name: str) -> bool:
        return any(n == name for n, _ in self.layers)

    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.layers)

    def items(self) -> Tuple[Tuple[str, TrainingPlans], ...]:
        return self.layers

    def scenes(self) -> Dict[str, ConvScene]:
        """The forward scene of every layer, in layer order."""
        return {n: triple.scene for n, triple in self.layers}

    @property
    def reference_ops(self) -> Dict[str, Tuple[str, ...]]:
        """``{layer: (op, ...)}`` for layers where any direction runs the
        torch reference — empty when the whole model runs the kernels."""
        return {n: triple.reference_ops for n, triple in self.layers
                if triple.reference_ops}

    def plans(self) -> Iterator[Tuple[str, str, ConvPlan]]:
        """Flat (layer, op, plan) walk over every direction of every
        layer."""
        for n, triple in self.layers:
            for p in (triple.fprop, triple.dgrad, triple.wgrad):
                yield n, p.op.value, p

    def describe(self) -> str:
        return "\n".join(f"{n}: {triple.describe()}"
                         for n, triple in self.layers)


def make_model_plans(scenes: Mapping[str, ConvScene], *,
                     policy: Union[None, str, ScheduleChoice] = "analytic",
                     device: DeviceSpec = None, use_kernels: bool = True,
                     registry: Optional[PlanRegistry] = None,
                     devices: Optional[Sequence] = None,
                     max_shards: Optional[int] = None) -> ModelPlans:
    """Plan a whole CNN: one (fprop, dgrad, wgrad) triple per layer.

    One device (``devices=None``): every (scene x op) plan is prewarmed
    through ``registry.warm`` (default: the process-wide registry of
    ``device``, itself defaulting to the card) — a pass that bumps
    neither hits nor misses — and the triples then assemble from pure
    registry hits, so "zero resolutions after warm-up" is assertable
    from the ``repro.plan.resolutions`` counter.

    With ``devices`` (a ring, e.g. ``launch.mesh.data_devices(mesh)``,
    which may repeat a device): each layer builds ring-sharded triples
    via ``repro_torch.shard.autodiff.make_sharded_training_plans``
    (``max_shards`` caps the ring), whose joint (partition x grain)
    selector falls back to ``n_shards=1`` per direction whenever
    partitioning is a predicted loss; ``device`` and ``registry`` do not
    apply there (the sharded plans build outside the registry)."""
    if devices is not None:
        from repro_torch.shard.autodiff import make_sharded_training_plans
        return ModelPlans(layers=tuple(
            (name, make_sharded_training_plans(
                sc, policy=policy if isinstance(policy, str) else "analytic",
                devices=devices, max_shards=max_shards))
            for name, sc in scenes.items()))
    if registry is not None:
        _check_device(registry, device)
        reg = registry
    else:
        reg = default_registry(device)
    scene_list = list(scenes.values())
    reg.warm(scene_list, ops=(ConvOp.FPROP,), policy=policy,
             use_kernels=use_kernels)
    reg.warm(scene_list, ops=(ConvOp.DGRAD, ConvOp.WGRAD),
             policy=backward_policy(policy), use_kernels=use_kernels)
    return ModelPlans(layers=tuple(
        (name, make_training_plans(sc, policy=policy,
                                   use_kernels=use_kernels, registry=reg))
        for name, sc in scenes.items()))


def apply_conv(inp: torch.Tensor, flt: torch.Tensor, plans) -> torch.Tensor:
    """Differentiable dispatch for either plan flavour of one layer —
    operands in plan layout.  The one entry the model forwards call, so a
    model built sharded and one built on one device share the same
    forward code."""
    if isinstance(plans, TrainingPlans):
        return conv_with_plans(inp, flt, plans)
    from repro_torch.shard.autodiff import (ShardedTrainingPlans,
                                            sharded_conv_with_plans)
    if isinstance(plans, ShardedTrainingPlans):
        return sharded_conv_with_plans(inp, flt, plans)
    raise ValueError(
        f"apply_conv expects a TrainingPlans or ShardedTrainingPlans, "
        f"got {type(plans).__name__}")


# --------------------------------------------------------------------------
# per-call shims (the reference's signatures, ``device`` for ``interpret``)
# --------------------------------------------------------------------------
def grad_input(d_out: torch.Tensor, flt: torch.Tensor, scene: ConvScene, *,
               device: DeviceSpec = None,
               use_kernels: bool = True) -> torch.Tensor:
    """dL/dIN via the scene's DGRAD plan from the default registry of
    ``device`` (the kernels even on strided forwards; see the plan's
    ``uses_reference``/``notes`` for the rare fallback)."""
    plan = default_registry(device).get_or_build(scene, ConvOp.DGRAD,
                                                 use_kernels=use_kernels)
    return plan.execute(d_out, flt)


def grad_filter(inp: torch.Tensor, d_out: torch.Tensor, scene: ConvScene,
                *, device: DeviceSpec = None) -> torch.Tensor:
    """dL/dFLT via the scene's WGRAD plan (f32-accumulated either way)."""
    return default_registry(device).get_or_build(
        scene, ConvOp.WGRAD).execute(inp, d_out)


def mg3m_conv_trainable(inp: torch.Tensor, flt: torch.Tensor,
                        scene: ConvScene, schedule=None, *,
                        device: DeviceSpec = None) -> torch.Tensor:
    """Differentiable MG3MConv — kernel forward, MG3M-scene backward.  Plans
    come from the default registry of ``device`` (default the card), so
    repeated calls on one scene reuse the same frozen plans."""
    plans = make_training_plans(scene, policy=schedule,
                                registry=default_registry(device))
    return conv_with_plans(inp, flt, plans)
