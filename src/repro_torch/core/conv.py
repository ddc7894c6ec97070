"""Public MG3MConv API (port of ``repro.core.conv``).

Two usage modes, as in the reference:

  * plan-once / execute-many: build a frozen ``ConvPlan`` with
    ``make_plan(scene, op, policy=..., device=...)`` and call
    ``plan.execute`` per batch (see ``repro_torch.plan``);
  * the per-call functions below, thin shims over the same plans.

Every entry point runs on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import torch

from repro_torch.core.mapping import (ClassCorrection, CostModel,
                                      ScheduleChoice, predicted_efficiency,
                                      select_schedule)
from repro_torch.core.scene import ConvScene, dtype_name
from repro_torch.device import DeviceSpec
from repro_torch.kernels import ops
from repro_torch.kernels.ops import ScheduleSpec
from repro_torch.plan import (ConvOp, ConvPlan, PlanRegistry,
                              default_registry, get_plan, make_plan,
                              set_default_registry)

__all__ = ["ConvScene", "CostModel", "ClassCorrection", "ScheduleChoice",
           "ScheduleSpec", "select_schedule",
           "ConvOp", "ConvPlan", "PlanRegistry", "make_plan", "get_plan",
           "default_registry", "set_default_registry",
           "mg3m_conv", "mg3m_conv_nhwc", "mg3m_conv_trainable",
           "predicted_efficiency"]


def __getattr__(name):
    if name == "mg3m_conv_trainable":   # lazy: core.autodiff imports plans
        from repro_torch.core.autodiff import mg3m_conv_trainable
        return mg3m_conv_trainable
    raise AttributeError(name)


def mg3m_conv(inp: torch.Tensor, flt: torch.Tensor, scene: ConvScene, *,
              schedule: ScheduleSpec = None, device: DeviceSpec = None,
              use_kernels: bool = True) -> torch.Tensor:
    """Convolution in the paper's layouts IN ``[H, W, IC, B]``, FLT ``[h,
    w, IC, OC]``.  ``schedule``: None (analytic selection), a forced
    "TB11"/"TB18"/"TB88", or an exact ``ScheduleChoice``.  Per-call shim —
    see ``make_plan`` to amortize resolution over many executions."""
    return ops.mg3m_conv_op(inp, flt, scene, schedule=schedule,
                            device=device, use_kernels=use_kernels)


def mg3m_conv_nhwc(x: torch.Tensor, flt: torch.Tensor, *, stride=(1, 1),
                   padding=(0, 0), schedule: ScheduleSpec = None,
                   device: DeviceSpec = None,
                   use_kernels: bool = True) -> torch.Tensor:
    """NHWC entry point (x ``[B, H, W, C]``, flt ``[h, w, IC, OC]``):
    into the paper's ``[H, W, C, B]`` layout, MG3MConv, and back to NHWC.
    Differentiable through autograd when ``use_kernels=False`` (the torch
    reference); the kernels' gradient path is ``mg3m_conv_trainable``."""
    b, h, w, c = x.shape
    fh, fw, ic, oc = flt.shape
    if ic != c:
        raise ValueError(
            f"filter expects {ic} input channels but x has {c} "
            f"(x {tuple(x.shape)}, flt {tuple(flt.shape)})")
    scene = ConvScene(B=b, IC=c, OC=oc, inH=h, inW=w, fltH=fh, fltW=fw,
                      padH=padding[0], padW=padding[1],
                      stdH=stride[0], stdW=stride[1],
                      dtype=dtype_name(x.dtype))
    out = mg3m_conv(x.permute(1, 2, 3, 0), flt, scene, schedule=schedule,
                    device=device, use_kernels=use_kernels)
    return out.permute(3, 0, 1, 2)   # [B, outH, outW, OC]
