"""Public op wrappers around the port's kernels (port of
``repro.kernels.ops``).

``mg3m_conv_op`` is the per-call convolution shim over ``repro_torch.plan``:
every call builds a frozen ``ConvPlan`` (schedule resolution, spatial
pre-padding, channel/batch alignment) and executes it, as the reference's
does; build plans once with ``plan.make_plan`` / ``PlanRegistry`` to
amortize resolution.

``causal_conv1d_op``: the reference pads x and w up to whole ``(block_l,
block_d)`` blocks before its Pallas call and slices the result back
(ops.py:86-94); the CUDA kernel masks its own ragged edges, so the op is
the kernel wrapper itself.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.core.mapping import ScheduleChoice
from repro_torch.core.scene import ConvScene
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.kernels.causal_conv1d import causal_conv1d
from repro_torch.plan import build as plan_build

ScheduleSpec = Union[None, str, ScheduleChoice]


def resolve_choice(scene: ConvScene, schedule: ScheduleSpec,
                   device: DeviceSpec = None) -> ScheduleChoice:
    """Schedule-spec resolution shared by every conv entry point, against
    the shared-memory budget of ``device`` (default the card):

      None          multi-grained selection under the active cost model
                    (calibrated when an artifact exists);
      "auto"        tuned-cache resolution for the device's backend, the
                    active model on a miss — never measures (see
                    ``repro_torch.tune``);
      "TB11"/...    forced schedule, model-chosen blocks; raises if the
                    forced grain cannot fit shared memory;
      ScheduleChoice  used exactly as given.

    Delegates to ``plan.build.resolve_policy`` — the resolution a
    ``ConvPlan`` runs once at build time."""
    return plan_build.resolve_policy(scene, schedule,
                                     device=resolve_device(device))


def mg3m_conv_op(inp: torch.Tensor, flt: torch.Tensor, scene: ConvScene, *,
                 schedule: ScheduleSpec = None, device: DeviceSpec = None,
                 use_kernels: bool = True) -> torch.Tensor:
    """Multi-grained convolution in the paper's layouts (per-call shim).

    ``inp`` ``[inH, inW, IC, B]``, ``flt`` ``[fltH, fltW, IC, OC]`` on
    ``device`` (default the card); returns ``[outH, outW, OC, B]``.
    ``schedule`` forces "TB11"/"TB18"/"TB88" or pins a ``ScheduleChoice``;
    None selects analytically; "auto" resolves from the tune cache.  ``use_kernels=False`` runs the torch
    reference.  Resolution runs on every call (the reference's contract)."""
    if tuple(inp.shape) != scene.in_shape():
        raise ValueError(
            f"input shape {tuple(inp.shape)} does not match the scene's IN "
            f"layout {scene.in_shape()} for {scene.describe()}")
    if tuple(flt.shape) != scene.flt_shape():
        raise ValueError(
            f"filter shape {tuple(flt.shape)} does not match the scene's "
            f"FLT layout {scene.flt_shape()} for {scene.describe()}")
    plan = plan_build.make_plan(scene, plan_build.ConvOp.FPROP,
                                policy=schedule, device=device,
                                use_kernels=use_kernels)
    return plan.execute(inp, flt)


def causal_conv1d_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d (Mamba2's conv), x ``[B, L, D]``, w
    ``[K, D]``: the CUDA kernel on a card tensor, its plain version on a
    CPU one — see ``kernels/causal_conv1d.py``."""
    return causal_conv1d(x, w)
