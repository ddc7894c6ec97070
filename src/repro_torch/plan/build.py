"""Plan construction — schedule resolution, backward-scene derivation, and
padded-shape precomputation, all performed exactly once per plan.

Port of ``repro.plan.build``.  The plan-once / execute-many contract:

  * ``make_plan(scene, op, policy=..., device=...)`` runs the
    multi-grained selector once (analytic model or a forced grain),
    derives every padded/aligned shape into a frozen ``ExecSpec``, and —
    for the backward ops — derives the backward convolution's own
    ``ConvScene`` so dgrad and wgrad go through the same selector;
  * ``ConvPlan.execute(a, b)`` dispatches straight into the kernels with
    the precomputed spec.

The reference's ``interpret`` flag becomes the plan's *backend*: a plan
built for ``cuda`` launches the CUDA kernels and takes only CUDA tensors; a
plan built for ``cpu`` runs the kernels' plain PyTorch versions and takes
only CPU tensors.

Backward ops as scenes (as in the reference):

  DGRAD  dIN = conv(dOUT, rot180(FLT) with IC/OC swapped); a strided
         forward's adjoint is that conv with dOUT *lhs-dilated* by the
         stride plus ``apad`` high-side zeros for a stride remainder.  The
         kernels read the compact dOUT and mask the hole taps.
  WGRAD  dFLT is the batch-contracted conv of IN (IC, B swapped) with dOUT
         (OC, B swapped) as the filter, *rhs-dilated* by the stride; the
         executor slices a stride remainder back off (``ExecSpec.out_h``).

  Padding beyond the dilated filter extent minus one has no MG3M adjoint:
  that dgrad records ``uses_reference=True`` and runs the exact autograd
  adjoint of the PyTorch oracle.

``policy="tuned"`` (alias ``"auto"``) resolves through the tune cache
(``tune.autotune.resolve_schedule``, keyed by the plan's device) and never
measures; a cache miss, like ``"analytic"``, selects under the active cost
model — calibrated when a ``tune/calibrate.py`` artifact exists.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.mapping import (ScheduleChoice, select_schedule,
                                      smem_budget)
from repro_torch.core.scene import ConvScene, round_up
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.kernels import mg3m_conv as kernels
from repro_torch.kernels import ref
from repro_torch.obs.metrics import default_metrics
from repro_torch.obs.trace import default_tracer

PolicySpec = Union[None, str, ScheduleChoice]


class ConvOp(enum.Enum):
    """The three convolution directions a plan can execute."""

    FPROP = "fprop"   # execute(inp, flt)   -> out
    DGRAD = "dgrad"   # execute(d_out, flt) -> d_in
    WGRAD = "wgrad"   # execute(inp, d_out) -> d_flt


# --------------------------------------------------------------------------
# policy resolution (once per plan)
# --------------------------------------------------------------------------
def _active_cost_model(device: DeviceSpec = None):
    """The cost model selection on ``device`` runs under: the installed
    model, else the calibrated model when an artifact of the device's
    backend exists, else the analytic default."""
    from repro_torch.tune.calibrate import active_cost_model  # avoids a cycle
    return active_cost_model(device)


def policy_tag(policy: PolicySpec) -> str:
    """Canonical policy label (registry keys, plan metadata).  Idempotent."""
    if isinstance(policy, ScheduleChoice):
        return (f"forced:{policy.schedule}"
                f"@{policy.bm}/{policy.bn}/{policy.bk}")
    if policy in (None, "analytic"):
        return "analytic"
    if policy in ("auto", "tuned"):
        return "tuned"
    if isinstance(policy, str) and policy.startswith("forced:"):
        return policy
    return f"forced:{policy}"


def resolve_policy(scene: ConvScene, policy: PolicySpec,
                   device: DeviceSpec = None) -> ScheduleChoice:
    """One-time schedule resolution for a plan on ``device`` (default the
    card), within the device's shared memory per block.

      None / "analytic"     multi-grained selection under the device's
                            active cost model (calibrated when an artifact
                            of its backend exists);
      "auto" / "tuned"      the tune cache for the device's backend first,
                            selection under the active model on a miss —
                            never measures (see ``repro_torch.tune``);
      "TB11"/"TB18"/"TB88"  forced schedule, model-chosen blocks; raises if
                            the forced grain cannot fit shared memory;
      ScheduleChoice        used exactly as given.
    """
    if isinstance(policy, ScheduleChoice):
        return policy
    budget = smem_budget(device)
    m = default_metrics()
    m.counter("repro.plan.resolutions").inc()
    t0 = time.perf_counter()
    try:
        if policy in ("auto", "tuned"):
            from repro_torch.tune.autotune import resolve_schedule
            return resolve_schedule(scene, device=device)
        if policy in (None, "analytic"):
            return select_schedule(scene, model=_active_cost_model(device),
                                   budget=budget)
        return select_schedule(scene, allowed=(policy,),
                               model=_active_cost_model(device),
                               budget=budget)
    finally:
        m.histogram("repro.plan.resolve_s").observe(time.perf_counter() - t0)


# --------------------------------------------------------------------------
# padded/aligned shape derivation (once per plan)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ExecSpec:
    """Everything ``execute`` needs, precomputed: clipped blocks, spatial
    pre-padding (or the compact lhs-dilated route), channel/batch
    alignment targets, slice-back extents.  Field for field the
    reference's, so one ``ScheduleChoice`` derives equal specs in both."""

    schedule: str
    bm: int                # clipped blocks actually passed to the kernel
    bn: int
    bk: int
    pad_h: int             # spatial pre-padding (scene padH/padW)
    pad_w: int
    mp: int                # aligned OC target (flt minor-dim padding)
    np_: int               # aligned B target (in minor-dim padding)
    kp: int                # aligned IC target (reduction-dim padding)
    m: int                 # slice-back extents of the true output
    n: int
    apad_h: int = 0        # extra high-side spatial pre-padding
    apad_w: int = 0
    sentinel: bool = False  # lhs-dilated: compact input, masked hole taps
    out_h: int = 0         # spatial slice-back extents (0 = full output;
    out_w: int = 0         # wgrad trims stride-remainder rows/cols)


def derive_exec_spec(scene: ConvScene, choice: ScheduleChoice,
                     out_hw: Optional[Tuple[int, int]] = None) -> ExecSpec:
    """Precompute every padded/aligned dim the kernel dispatch needs.
    ``out_hw`` overrides the spatial slice-back extents (the wgrad scene's
    conv output can exceed the true dFLT dims by the stride remainder)."""
    m, n, k = scene.M, scene.N, scene.K
    oh, ow = out_hw if out_hw is not None else (scene.outH, scene.outW)
    extra = dict(apad_h=scene.apadH, apad_w=scene.apadW,
                 sentinel=scene.dilH > 1 or scene.dilW > 1,
                 out_h=oh, out_w=ow)
    if choice.schedule == "TB11":
        return ExecSpec("TB11", m, n, k, scene.padH, scene.padW, m, n, k,
                        m, n, **extra)
    if choice.schedule == "TB18":
        bm = min(choice.bm, m)
        return ExecSpec("TB18", bm, n, k, scene.padH, scene.padW,
                        round_up(m, bm), n, k, m, n, **extra)
    bm, bn, bk = min(choice.bm, m), min(choice.bn, n), min(choice.bk, k)
    return ExecSpec("TB88", bm, bn, bk, scene.padH, scene.padW,
                    round_up(m, bm), round_up(n, bn), round_up(k, bk),
                    m, n, **extra)


def launched_shapes(scene: ConvScene, spec: ExecSpec
                    ) -> Tuple[Tuple[int, int, int, int],
                               Tuple[int, int, int, int]]:
    """(input, filter) shapes exactly as ``_conv_body`` launches them:
    spatial pre-padding on the dense route (the compact input on the
    lhs-dilated one: no sentinel row or column, the kernels mask those
    taps), channel/batch alignment per schedule.  The static verifier
    rebuilds the launch from these, so what it proves is what executes."""
    if spec.sentinel:
        ih, iw = scene.inH, scene.inW
    else:
        ih = scene.inH + 2 * spec.pad_h + spec.apad_h
        iw = scene.inW + 2 * spec.pad_w + spec.apad_w
    if spec.schedule == "TB11":
        return ((ih, iw, scene.K, scene.N),
                (scene.fltH, scene.fltW, scene.K, scene.M))
    if spec.schedule == "TB18":
        return ((ih, iw, scene.K, scene.N),
                (scene.fltH, scene.fltW, scene.K, spec.mp))
    return ((ih, iw, spec.kp, spec.np_),
            (scene.fltH, scene.fltW, spec.kp, spec.mp))


# --------------------------------------------------------------------------
# backward-scene derivation (exact copies of the reference's arithmetic)
# --------------------------------------------------------------------------
def _stride_remainders(scene: ConvScene) -> Tuple[int, int]:
    """Spatial slack the forward's floor-div discards: input rows/cols past
    the last window position, re-grown by the adjoint's high-side pad."""
    rh = (scene.dilated_inH + 2 * scene.padH
          - scene.dilated_fltH) % scene.stdH
    rw = (scene.dilated_inW + 2 * scene.padW
          - scene.dilated_fltW) % scene.stdW
    return rh, rw


def grad_input_scene(scene: ConvScene) -> ConvScene:
    """The dIN convolution's scene (stride and lhs dilation swap roles;
    filter dilation carries over).  Raises ``ValueError`` when padding
    exceeds the dilated filter extent minus one."""
    why = _dgrad_blocker(scene)
    if why:
        raise ValueError(f"dgrad of {scene.describe()} has no MG3M scene: {why}")
    rh, rw = _stride_remainders(scene)
    return ConvScene(
        B=scene.B, IC=scene.OC, OC=scene.IC,
        inH=scene.outH, inW=scene.outW,
        fltH=scene.fltH, fltW=scene.fltW,
        padH=scene.dilated_fltH - 1 - scene.padH,
        padW=scene.dilated_fltW - 1 - scene.padW,
        stdH=scene.dilH, stdW=scene.dilW,
        dilH=scene.stdH, dilW=scene.stdW,
        fdilH=scene.fdilH, fdilW=scene.fdilW,
        apadH=rh, apadW=rw, dtype=scene.dtype)


def grad_filter_scene(scene: ConvScene) -> ConvScene:
    """The dFLT convolution's scene: batch-contracted conv with filter
    spatial = outHxoutW, rhs-dilated by the forward stride."""
    why = _wgrad_blocker(scene)
    if why:
        raise ValueError(f"wgrad of {scene.describe()} has no MG3M scene: {why}")
    return ConvScene(
        B=scene.IC, IC=scene.B, OC=scene.OC,
        inH=scene.inH, inW=scene.inW,
        fltH=scene.outH, fltW=scene.outW,
        padH=scene.padH, padW=scene.padW,
        stdH=scene.fdilH, stdW=scene.fdilW,
        dilH=scene.dilH, dilW=scene.dilW,
        fdilH=scene.stdH, fdilW=scene.stdW,
        dtype=scene.dtype)


def _dgrad_blocker(scene: ConvScene) -> Optional[str]:
    if scene.apadH or scene.apadW:
        return ("asymmetric extra padding: the adjoint of an apad scene "
                "is not itself an MG3M scene")
    if (scene.padH > scene.dilated_fltH - 1
            or scene.padW > scene.dilated_fltW - 1):
        return ("padding exceeds dilated-filter-extent-1: adjoint padding "
                "would be negative")
    return None


def _wgrad_blocker(scene: ConvScene) -> Optional[str]:
    if scene.apadH or scene.apadW:
        return ("asymmetric extra padding: the weight-gradient of an apad "
                "scene is not itself an MG3M scene")
    return None


# --------------------------------------------------------------------------
# executors — plain functions of the frozen (scene, spec)
# --------------------------------------------------------------------------
def _pad_axis(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    cur = x.shape[axis]
    if cur == to:
        return x
    shape = list(x.shape)
    shape[axis] = to - cur
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def dgrad_operands(d_out: torch.Tensor, flt: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inp, flt) of the dgrad exec conv: dOUT against the rot180'd,
    IC/OC-swapped filter."""
    return d_out, flt.flip((0, 1)).transpose(2, 3).contiguous()


def wgrad_operands(inp: torch.Tensor, d_out: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inp, flt) of the wgrad exec conv: IN with (IC, B) swapped against
    dOUT with (OC, B) swapped."""
    return (inp.transpose(2, 3).contiguous(),
            d_out.transpose(2, 3).contiguous())


def wgrad_finish(out: torch.Tensor) -> torch.Tensor:
    """Wgrad exec-conv output -> FLT layout."""
    return out.permute(0, 1, 3, 2).contiguous()


def _launch_operands(inp: torch.Tensor, flt: torch.Tensor, spec: ExecSpec
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operands exactly as the grain's wrapper takes them: spatial
    pre-padding on the dense route (the compact input on the lhs-dilated
    one), channel/batch alignment per schedule."""
    if spec.sentinel:
        inp = inp.contiguous()
    else:
        inp = F.pad(inp, (0, 0, 0, 0, spec.pad_w, spec.pad_w + spec.apad_w,
                          spec.pad_h, spec.pad_h + spec.apad_h))
    flt = flt.contiguous()
    if spec.schedule == "TB11":
        return inp, flt
    if spec.schedule == "TB18":
        return inp, _pad_axis(flt, 3, spec.mp)
    return (_pad_axis(_pad_axis(inp, 2, spec.kp), 3, spec.np_),
            _pad_axis(_pad_axis(flt, 2, spec.kp), 3, spec.mp))


def _kernel_blocks(spec: ExecSpec, choice: ScheduleChoice) -> dict:
    """The blocking keyword arguments of the grain's wrapper (the
    compiled tile comes from the choice: the exec spec is the
    reference's, field for field)."""
    if spec.schedule == "TB11":
        return {"tile": choice.tile}
    if spec.schedule == "TB18":
        return {"bm": spec.bm, "tile": choice.tile}
    return {"bm": spec.bm, "bn": spec.bn, "bk": spec.bk,
            "tile": choice.tile}


def _conv_body(inp: torch.Tensor, flt: torch.Tensor, scene: ConvScene,
               spec: ExecSpec, choice: ScheduleChoice) -> torch.Tensor:
    """Kernel dispatch from a precomputed spec: launch operands, the
    grain's wrapper, slice-back to the true output."""
    inp_a, flt_a = _launch_operands(inp, flt, spec)
    out = kernels.WRAPPERS[spec.schedule](inp_a, flt_a, scene,
                                          **_kernel_blocks(spec, choice))
    out = out[:, :, :spec.m, :spec.n]
    if (spec.out_h, spec.out_w) not in ((0, 0), (scene.outH, scene.outW)):
        out = out[:spec.out_h, :spec.out_w]
    return out.contiguous()


# Each op as an fprop-shaped conv over its exec scene (the dgrad scene of
# grad_input_scene, the wgrad scene of grad_filter_scene).
_OPERANDS = {"fprop": lambda a, b: (a, b), "dgrad": dgrad_operands,
             "wgrad": wgrad_operands}


# Reference executors (use_kernels=False and the recorded fallbacks).
def _ref_fprop(inp, flt, scene: ConvScene):
    return ref.conv_ref(inp, flt, scene)


def _ref_adjoint(primal_shape, d_out, fn):
    """Exact adjoint of a linear ``fn`` at cotangent ``d_out`` (the primal
    point is irrelevant: zeros)."""
    zero = torch.zeros(primal_shape, dtype=d_out.dtype, device=d_out.device,
                       requires_grad=True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(fn(zero), zero, d_out)
    return g


def _ref_dgrad(d_out, flt, scene: ConvScene):
    return _ref_adjoint(scene.in_shape(), d_out,
                        lambda i: ref.conv_ref(i, flt, scene))


def _ref_wgrad(inp, d_out, scene: ConvScene):
    return _ref_adjoint(scene.flt_shape(), d_out,
                        lambda f: ref.conv_ref(inp, f, scene))


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------
_IO_SHAPES = {
    ConvOp.FPROP: ("in_shape", "flt_shape", "out_shape"),
    ConvOp.DGRAD: ("out_shape", "flt_shape", "in_shape"),
    ConvOp.WGRAD: ("in_shape", "out_shape", "flt_shape"),
}
_REF = {ConvOp.FPROP: _ref_fprop, ConvOp.DGRAD: _ref_dgrad,
        ConvOp.WGRAD: _ref_wgrad}


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Frozen, executable convolution plan for one (scene, op, policy,
    backend).  ``uses_reference`` + ``notes`` surface when the plan
    bypasses the kernels."""

    scene: ConvScene                    # the *forward* scene the plan serves
    op: ConvOp
    policy: str                         # canonical tag (see ``policy_tag``)
    backend: str                        # "cuda" or "cpu"
    use_kernels: bool
    uses_reference: bool
    notes: Tuple[str, ...] = ()
    exec_scene: Optional[ConvScene] = None   # scene actually dispatched
    choice: Optional[ScheduleChoice] = None  # None on reference plans
    spec: Optional[ExecSpec] = None

    def execute(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Run the planned op: (inp, flt) for FPROP, (d_out, flt) for DGRAD,
        (inp, d_out) for WGRAD.  Operands must lie on the plan's backend."""
        a_shape, b_shape, _ = self.io_shapes()
        if tuple(a.shape) != a_shape or tuple(b.shape) != b_shape:
            raise ValueError(
                f"{self.op.value} plan for {self.scene.describe()} expects "
                f"operands {a_shape} x {b_shape}, got {tuple(a.shape)} x "
                f"{tuple(b.shape)}")
        if a.device.type != self.backend or b.device.type != self.backend:
            raise ValueError(
                f"{self.op.value} plan built for backend {self.backend!r} "
                f"got operands on {a.device} and {b.device}")
        if self.uses_reference:
            return _REF[self.op](a, b, self.scene)
        out = _conv_body(*_OPERANDS[self.op.value](a, b), self.exec_scene,
                         self.spec, self.choice)
        return wgrad_finish(out) if self.op is ConvOp.WGRAD else out

    __call__ = execute

    def kernel_call(self, a: torch.Tensor, b: torch.Tensor):
        """``(wrapper, inp, flt, blocks)``: the grain's kernel wrapper and
        the exact operands and blocking ``execute(a, b)`` launches it with
        — for holding a kernel against its plain version
        (``kernels.mg3m_conv.conv_plain(inp, flt, plan.exec_scene)``) at
        the shapes this plan serves."""
        if self.uses_reference:
            raise ValueError(f"{self.describe()} runs no kernel")
        a, b = _OPERANDS[self.op.value](a, b)
        inp, flt = _launch_operands(a, b, self.spec)
        return (kernels.WRAPPERS[self.spec.schedule], inp, flt,
                _kernel_blocks(self.spec, self.choice))

    def io_shapes(self) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                                 Tuple[int, ...]]:
        """(arg-a shape, arg-b shape, result shape) of ``execute``."""
        names = _IO_SHAPES[self.op]
        return tuple(getattr(self.scene, nm)() for nm in names)

    @property
    def schedule(self) -> Optional[str]:
        return self.choice.schedule if self.choice else None

    @property
    def predicted_s(self) -> Optional[float]:
        return self.choice.predicted_s if self.choice else None

    def describe(self) -> str:
        how = ("torch-reference" if self.uses_reference else
               f"{self.choice.schedule}"
               f"({self.spec.bm}/{self.spec.bn}/{self.spec.bk})")
        return (f"plan({self.op.value} {how} policy={self.policy} "
                f"be={self.backend} {self.scene.describe()})")


def make_plan(scene: ConvScene, op: Union[ConvOp, str] = ConvOp.FPROP, *,
              policy: PolicySpec = "analytic", device: DeviceSpec = None,
              use_kernels: bool = True) -> ConvPlan:
    """Build a frozen ``ConvPlan``: resolve the schedule once, derive the
    backward scene (DGRAD/WGRAD), precompute every padded/aligned shape.

    ``device`` picks the backend (default: the card; raises without one
    unless ``device="cpu"``).  ``policy``: "analytic", "tuned" (alias
    "auto": the tune cache of the device's backend), a forced
    "TB11"/"TB18"/"TB88", or an exact ``ScheduleChoice``; ``None`` aliases
    "analytic".  A forced policy on an op that cannot dispatch to the
    kernels raises ``ValueError`` naming that op."""
    op = ConvOp(op)
    dev = resolve_device(device)
    tag = policy_tag(policy)
    with default_tracer().span("repro.plan.make_plan", op=op.value,
                               policy=tag, scene=scene.describe()):
        return _make_plan_inner(scene, op, policy, tag, dev, use_kernels)


def _make_plan_inner(scene: ConvScene, op: ConvOp, policy: PolicySpec,
                     tag: str, dev: torch.device,
                     use_kernels: bool) -> ConvPlan:
    t_build = time.perf_counter()
    notes = []
    uses_reference = not use_kernels
    if not use_kernels:
        notes.append(f"{op.value}: use_kernels=False; torch reference")

    out_hw = None
    exec_scene: Optional[ConvScene] = scene if op is ConvOp.FPROP else None
    if op is ConvOp.DGRAD:
        why = _dgrad_blocker(scene)
        if why is None:
            exec_scene = grad_input_scene(scene)
        elif use_kernels:
            if tag.startswith("forced:"):
                raise ValueError(
                    f"dgrad of {scene.describe()} requires a reference "
                    f"fallback ({why}); the forced policy {tag!r} cannot "
                    f"be honored for this op")
            uses_reference = True
            notes.append(f"dgrad: {why}; exact torch adjoint instead of "
                         f"the kernels")
    elif op is ConvOp.WGRAD:
        why = _wgrad_blocker(scene)
        if why is None:
            exec_scene = grad_filter_scene(scene)
            out_hw = (scene.fltH, scene.fltW)   # trim stride-remainder rows
        elif use_kernels:
            if tag.startswith("forced:"):
                raise ValueError(
                    f"wgrad of {scene.describe()} requires a reference "
                    f"fallback ({why}); the forced policy {tag!r} cannot "
                    f"be honored for this op")
            uses_reference = True
            notes.append(f"wgrad: {why}; exact torch adjoint instead of "
                         f"the kernels")

    choice = spec = None
    if not uses_reference:
        choice = resolve_policy(exec_scene, policy, device=dev)
        spec = derive_exec_spec(exec_scene, choice, out_hw)
    m = default_metrics()
    m.counter("repro.plan.builds").inc()
    if uses_reference:
        m.counter("repro.plan.reference_fallbacks").inc()
    m.histogram("repro.plan.build_s").observe(time.perf_counter() - t_build)
    return ConvPlan(scene=scene, op=op, policy=tag, backend=dev.type,
                    use_kernels=use_kernels, uses_reference=uses_reference,
                    notes=tuple(notes),
                    exec_scene=None if uses_reference else exec_scene,
                    choice=choice, spec=spec)


def assemble_plan(scene: ConvScene, op: Union[ConvOp, str], policy: str,
                  choice: Optional[ScheduleChoice], *,
                  device: DeviceSpec = None,
                  use_kernels: bool = True) -> ConvPlan:
    """Rebuild a plan from a stored (scene, op, policy-tag, choice) without
    re-running resolution (the registry's deserialization path).  Raises
    ``ValueError`` when the stored choice no longer matches what the op can
    execute."""
    op = ConvOp(op)
    if choice is None:
        plan = make_plan(scene, op, policy="analytic", device=device,
                         use_kernels=use_kernels)
        if not plan.uses_reference:
            raise ValueError(
                f"stored {op.value} plan for {scene.describe()} has no "
                f"schedule choice but the op does not require a reference "
                f"fallback")
        return dataclasses.replace(plan, policy=policy)
    plan = make_plan(scene, op, policy=choice, device=device,
                     use_kernels=use_kernels)
    if plan.uses_reference:
        raise ValueError(
            f"stored {op.value} plan for {scene.describe()} pins "
            f"{choice.schedule} but the op requires a reference fallback")
    return dataclasses.replace(plan, policy=policy)
