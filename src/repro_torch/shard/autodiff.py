"""Differentiable ring-sharded MG3MConv: an autograd Function over sharded
plans (port of ``repro.shard.autodiff``).

Mirror of ``repro_torch.core.autodiff`` with ``ShardedConvPlan`` in every
slot: the backward convolutions are themselves sharded dispatches, each
with its own jointly-selected (partition x grain), because the backward
exec scenes have different M/N/K and therefore different best partitions
(dgrad swaps IC/OC; wgrad contracts batch, so a "batch" partition of the
*forward* corresponds to an "ic" reduction partition of the wgrad exec
scene — the joint selector discovers that, nobody hand-maps it).

The rare direction with no MG3M exec scene (apad scenes block both
backwards; over-padded forwards block dgrad) falls back to the *unsharded*
reference plan for that direction alone — a sharded wrapper around a
torch reference conv would shard nothing worth sharding.

As ``conv_with_plans`` does, the backward launches only the directions
autograd asks for (``ctx.needs_input_grad``), where the reference's
``custom_vjp`` returns both cotangents and leaves XLA to drop one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.mapping import CostModel
from repro_torch.core.scene import ConvScene
from repro_torch.plan.build import ConvOp, ConvPlan, make_plan
from repro_torch.shard.plan import (ShardedConvPlan, device_pool,
                                    make_sharded_plan)
from repro_torch.shard.spec import PARTITION_AXES

#: either flavour of plan — both expose execute(a, b) on global tensors
AnyPlan = Union[ShardedConvPlan, ConvPlan]


@dataclasses.dataclass(frozen=True)
class ShardedTrainingPlans:
    """The (fprop, dgrad, wgrad) triple of one ring-sharded conv layer.

    ``fprop`` is always sharded (possibly the ``n_shards == 1`` fallback);
    a backward slot holds a plain unsharded ``ConvPlan`` only when its
    direction has no MG3M exec scene at all (see ``reference_ops``).
    """

    fprop: ShardedConvPlan
    dgrad: AnyPlan
    wgrad: AnyPlan

    @property
    def scene(self) -> ConvScene:
        return self.fprop.scene

    @property
    def reference_ops(self) -> Tuple[str, ...]:
        return tuple(p.op.value for p in (self.fprop, self.dgrad, self.wgrad)
                     if p.uses_reference)

    @property
    def shard_tags(self) -> Tuple[str, ...]:
        """Per-direction partition tags, "-" for unsharded fallbacks."""
        return tuple(p.shard_tag or "-"
                     for p in (self.fprop, self.dgrad, self.wgrad))

    def describe(self) -> str:
        return " | ".join(p.describe() for p in (self.fprop, self.dgrad,
                                                 self.wgrad))


def make_sharded_training_plans(scene: ConvScene, *, policy: str = "analytic",
                                devices: Optional[Sequence] = None,
                                max_shards: Optional[int] = None,
                                axes: Sequence[str] = PARTITION_AXES,
                                model: Optional[CostModel] = None
                                ) -> ShardedTrainingPlans:
    """Jointly select (partition x grain) for all three directions over the
    ring pool ``devices`` (default every visible CUDA device).

    Each direction runs the selector on its *own* exec scene, so the three
    plans may land on three different partition axes (or fall back to
    ``n_shards == 1`` independently).  Directions whose exec scene doesn't
    exist (``grad_*_scene`` raises) get the unsharded plan's reference
    route on the ring's first device instead.
    """
    devs = device_pool(devices)
    kw = dict(policy=policy, devices=devs, max_shards=max_shards, axes=axes,
              model=model)

    def build(op: ConvOp) -> AnyPlan:
        try:
            return make_sharded_plan(scene, op, **kw)
        except ValueError:
            # no MG3M exec scene for this direction: unsharded fallback
            # (make_plan routes it to the torch reference and records why)
            return make_plan(scene, op, policy="analytic", device=devs[0])

    return ShardedTrainingPlans(
        fprop=make_sharded_plan(scene, ConvOp.FPROP, **kw),
        dgrad=build(ConvOp.DGRAD),
        wgrad=build(ConvOp.WGRAD))


class _ShardedConvWithPlans(torch.autograd.Function):
    """Sharded fprop forward; sharded dgrad and wgrad backward, each
    launched only where autograd needs its gradient."""

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


def sharded_conv_with_plans(inp: torch.Tensor, flt: torch.Tensor,
                            plans: ShardedTrainingPlans) -> torch.Tensor:
    """Differentiable convolution over a pre-built sharded plan triple,
    operands in plan layout: forward and both backwards are
    zero-resolution sharded dispatches."""
    return _ShardedConvWithPlans.apply(inp, flt, plans)
