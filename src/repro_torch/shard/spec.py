"""Partition specification — the paper's grain selection, lifted one level
(port of ``repro.shard.spec``).

MG3MConv picks a thread-block granularity per convolution scene; a device
ring adds one more granularity axis: *how to partition the scene across
devices* before each device runs its own multi-grained schedule.  A
``ShardSpec`` freezes that decision the way ``ScheduleChoice`` freezes the
grain: partition axis, shard count, the per-shard sub-scene, and the
schedule the selector picked *for that sub-scene* — grain and partition
are scored jointly (``select_shard_spec``), never sequentially, because
the best grain of a 1/8th-size sub-scene is generally not the best grain
of the whole scene (paper Fig. 14: the granularity map is not
scale-invariant).

Partition axes, on the *executed* scene's MM_unit dims (every op —
fprop/dgrad/wgrad — is dispatched as an fprop-shaped conv over its exec
scene, so one axis vocabulary covers all three directions):

  batch  split N (the B axis).  GEMM columns are independent: no
         collective, bitwise-identical to the unsharded plan.
  oc     split M (the OC axis).  Each shard owns an output-channel slab
         of FLT and OUT: no collective, bitwise-identical.
  h      split the output rows.  Each shard needs ``slab`` input rows to
         produce its ``ceil(outH/n)`` output rows; the rows beyond its
         own chunk come from the next shard(s) (the halo exchange).
         Requires a dense-row exec scene (no lhs dilation).
  ic     split K (the IC axis) — the channel-reduction partition (a dgrad
         exec scene's K is the forward's OC; a wgrad exec scene's K is
         the forward's B, so ``ic`` there is batch-gradient reduction).
         Each shard computes a full-size partial output and the partials
         are summed: float addition reorders, so parity is within
         tolerance, not bitwise.

The collective cost terms are closed forms over the exec scene, charged
against the interconnect constants in ``core.mapping`` — halo bytes for
``h`` (exactly the rows the ring rotations move, hops * chunk, not the
idealized ``dfh - std`` minimum), reduction ring bytes for ``ic``, zero
for ``batch``/``oc`` — plus a fixed per-dispatch launch overhead so an
equal-cost partition loses to shards=1.  The arithmetic is the
reference's exactly; only the constants are the port's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.core.mapping import (ICI_BW, ICI_LATENCY_S,
                                      SHARD_LAUNCH_OVERHEAD_S, SCHEDULES,
                                      SMEM_BUDGET, CostModel, ScheduleChoice,
                                      select_schedule)
from repro_torch.core.scene import ConvScene, ceil_div
from repro_torch.device import torch_dtype

#: Partition axes the joint selector enumerates, in preference order for
#: cost ties (earlier axes have no collective and stay bitwise-exact).
PARTITION_AXES = ("batch", "oc", "h", "ic")

#: The degenerate single-shard "partition" every selection can fall back to.
UNSHARDED_AXIS = "none"


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """Frozen partition decision for one exec scene on an ``n_shards`` ring.

    ``predicted_s`` is the whole-dispatch model: the slowest shard's
    schedule time (all shards are symmetric, so = ``choice.predicted_s``)
    plus ``collective_s`` plus the shard launch overhead.  ``n_shards == 1``
    means the selector kept the scene whole (``axis == "none"``) and
    ``predicted_s`` is exactly the unsharded schedule's prediction.
    """

    axis: str                    # "none" | "batch" | "oc" | "h" | "ic"
    n_shards: int
    sub_scene: ConvScene         # the per-shard exec scene
    choice: ScheduleChoice       # grain selected for the sub-scene
    predicted_s: float           # per-shard compute + collective + overhead
    collective_s: float
    collective_bytes: int

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if self.n_shards == 1 and self.axis != UNSHARDED_AXIS:
            raise ValueError(
                f"a single-shard spec must use axis={UNSHARDED_AXIS!r}, "
                f"got {self.axis!r}")
        if self.n_shards > 1 and self.axis not in PARTITION_AXES:
            raise ValueError(f"unknown partition axis {self.axis!r}; "
                             f"expected one of {PARTITION_AXES}")

    @property
    def is_sharded(self) -> bool:
        return self.n_shards > 1

    @property
    def tag(self) -> str:
        """Canonical ``axis:n`` fragment for shard-aware plan signatures."""
        return f"{self.axis}:{self.n_shards}"

    def describe(self) -> str:
        return (f"shard({self.tag} {self.choice.schedule} "
                f"coll={self.collective_bytes}B/{self.collective_s:.2e}s "
                f"pred={self.predicted_s:.2e}s {self.sub_scene.describe()})")


# --------------------------------------------------------------------------
# halo geometry (shared by sub-scene derivation, the plan wiring, and cost)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HaloGeometry:
    """Row bookkeeping of a spatial-H partition of one exec scene.

    The globally pre-padded input (``padH`` top zeros, zeros to ``total``
    rows at the bottom) is split into ``n`` chunks of ``ch`` rows; each
    shard's conv window needs ``slab`` consecutive rows starting at its
    chunk, i.e. ``halo = slab - ch`` rows owned by the next shard(s),
    fetched in ``hops`` ring rotations of one chunk each.  Rows in
    ``[n*ch, total)`` exist only in the replicated tail buffer (the last
    shards' windows run past the partitioned extent).
    """

    oh_sub: int    # output rows per shard: ceil(outH / n)
    ch: int        # partitioned chunk rows: oh_sub * stdH
    slab: int      # input rows one shard's windows touch
    halo: int      # rows beyond the own chunk: slab - ch (can be <= 0)
    hops: int      # ring rotations needed: ceil(halo / ch)
    total: int     # padded global rows: n*ch + hops*ch


def halo_geometry(scene: ConvScene, n: int) -> HaloGeometry:
    """Spatial-H partition geometry for ``n`` shards of ``scene``."""
    oh_sub = ceil_div(scene.outH, n)
    ch = oh_sub * scene.stdH
    slab = (oh_sub - 1) * scene.stdH + scene.dilated_fltH
    halo = slab - ch
    hops = ceil_div(max(halo, 0), ch)
    return HaloGeometry(oh_sub=oh_sub, ch=ch, slab=slab, halo=halo,
                        hops=hops, total=n * ch + hops * ch)


# --------------------------------------------------------------------------
# sub-scene derivation
# --------------------------------------------------------------------------
def shard_blocker(scene: ConvScene, axis: str, n: int) -> Optional[str]:
    """Why ``scene`` cannot be partitioned ``n``-way along ``axis`` (None =
    feasible).  The joint selector skips blocked candidates; the plan
    builder raises on them."""
    if n < 2:
        return f"n_shards={n}: partitioning starts at 2 (use axis='none')"
    if axis == "batch":
        if n > scene.N:
            return f"batch partition {n}-way exceeds N={scene.N}"
        return None
    if axis == "oc":
        if n > scene.M:
            return f"oc partition {n}-way exceeds M={scene.M}"
        return None
    if axis == "ic":
        if n > scene.K:
            return f"ic partition {n}-way exceeds K={scene.K}"
        return None
    if axis == "h":
        if scene.dilH > 1 or scene.dilW > 1:
            return ("spatial-H partition needs dense input rows; "
                    "lhs-dilated scenes take the sentinel route")
        if n > scene.outH:
            return f"h partition {n}-way exceeds outH={scene.outH}"
        return None
    return f"unknown partition axis {axis!r}"


def shard_sub_scene(scene: ConvScene, axis: str, n: int) -> ConvScene:
    """The per-shard exec scene of an ``n``-way ``axis`` partition.

    Uneven dims are handled by the executor zero-padding the partitioned
    operand dim up to ``n * sub_dim`` and slicing the result back — zero
    lanes are linear-safe, the same trick the serving layer's bucket
    padding uses — so the sub-scene always uses the ceil-divided extent.
    For ``h`` the sub-scene is the halo slab with *no* H padding: the
    wrapper pre-pads the global input once, so shard-local windows never
    re-pad (W padding stays per-plan, untouched by an H partition).
    """
    why = shard_blocker(scene, axis, n)
    if why:
        raise ValueError(
            f"cannot shard {scene.describe()} {axis}:{n}: {why}")
    if axis == "batch":
        return dataclasses.replace(scene, B=ceil_div(scene.B, n))
    if axis == "oc":
        return dataclasses.replace(scene, OC=ceil_div(scene.OC, n))
    if axis == "ic":
        return dataclasses.replace(scene, IC=ceil_div(scene.IC, n))
    geo = halo_geometry(scene, n)
    return dataclasses.replace(scene, inH=geo.slab, padH=0, apadH=0)


# --------------------------------------------------------------------------
# collective cost terms
# --------------------------------------------------------------------------
def collective_bytes(scene: ConvScene, axis: str, n: int) -> int:
    """Inter-device bytes one shard moves per dispatch.

    ``h``: the ring rotations move ``hops`` chunks of ``ch`` rows each —
    the *implemented* halo traffic, deliberately not the idealized
    ``dilated_fltH - stdH`` minimum (a one-row-per-shard partition of a
    tall filter really does rotate many chunks).  ``ic``: a ring
    all-reduce of the full-size partial output moves ``2(n-1)/n`` of its
    bytes per device.  ``batch``/``oc`` partition independent GEMM
    columns/rows: zero.
    """
    if n <= 1 or axis in ("batch", "oc", UNSHARDED_AXIS):
        return 0
    it = torch_dtype(scene.dtype).itemsize
    if axis == "h":
        geo = halo_geometry(scene, n)
        row = scene.inW * scene.K * scene.N * it
        return geo.hops * geo.ch * row
    if axis == "ic":
        out = scene.outH * scene.outW * scene.M * scene.N * it
        return 2 * (n - 1) * out // n
    raise ValueError(f"unknown partition axis {axis!r}")


def collective_seconds(scene: ConvScene, axis: str, n: int) -> float:
    """Modeled collective time of one dispatch: bytes over the link
    bandwidth plus a latency term per collective round (``hops`` rounds
    for the halo exchange, ``n - 1`` ring steps for the reduction)."""
    if n <= 1 or axis in ("batch", "oc", UNSHARDED_AXIS):
        return 0.0
    rounds = halo_geometry(scene, n).hops if axis == "h" else (n - 1)
    return collective_bytes(scene, axis, n) / ICI_BW + rounds * ICI_LATENCY_S


# --------------------------------------------------------------------------
# joint grain x partition selection
# --------------------------------------------------------------------------
def _shard_counts(max_shards: int) -> Tuple[int, ...]:
    """Candidate shard counts: powers of two up to ``max_shards``, plus
    ``max_shards`` itself (a 6-device ring is a legal partition)."""
    counts = []
    n = 2
    while n <= max_shards:
        counts.append(n)
        n *= 2
    if max_shards >= 2 and max_shards not in counts:
        counts.append(max_shards)
    return tuple(sorted(counts))


def unsharded_spec(scene: ConvScene, *,
                   allowed: Tuple[str, ...] = SCHEDULES,
                   model: Optional[CostModel] = None,
                   budget: int = SMEM_BUDGET) -> ShardSpec:
    """The shards=1 baseline every selection is scored against.
    ``budget`` is the shared memory per block of the ring's device."""
    choice = select_schedule(scene, allowed=allowed, model=model,
                             budget=budget)
    return ShardSpec(axis=UNSHARDED_AXIS, n_shards=1, sub_scene=scene,
                     choice=choice, predicted_s=choice.predicted_s,
                     collective_s=0.0, collective_bytes=0)


def score_partition(scene: ConvScene, axis: str, n: int, *,
                    allowed: Tuple[str, ...] = SCHEDULES,
                    model: Optional[CostModel] = None,
                    budget: int = SMEM_BUDGET) -> Optional[ShardSpec]:
    """Score one (axis, n) candidate: per-shard MG3M cost from the existing
    closed forms (``select_schedule`` on the sub-scene) + the collective
    term + the shard launch overhead.  None when the candidate is blocked
    or no schedule fits the sub-scene."""
    if shard_blocker(scene, axis, n):
        return None
    sub = shard_sub_scene(scene, axis, n)
    try:
        choice = select_schedule(sub, allowed=allowed, model=model,
                                 budget=budget)
    except ValueError:
        return None
    coll_s = collective_seconds(scene, axis, n)
    total = choice.predicted_s + coll_s + SHARD_LAUNCH_OVERHEAD_S
    return ShardSpec(axis=axis, n_shards=n, sub_scene=sub, choice=choice,
                     predicted_s=total, collective_s=coll_s,
                     collective_bytes=collective_bytes(scene, axis, n))


def select_shard_spec(scene: ConvScene, *, max_shards: int,
                      axes: Sequence[str] = PARTITION_AXES,
                      allowed: Tuple[str, ...] = SCHEDULES,
                      model: Optional[CostModel] = None,
                      budget: int = SMEM_BUDGET) -> ShardSpec:
    """Pick (partition x grain) jointly for one exec scene — the paper's
    Fig. 14 selection with one more axis.

    Enumerates every feasible (axis, shard-count) candidate, scores each
    as per-shard schedule time + collective term + launch overhead, and
    returns the strict winner over the shards=1 baseline.  The fallback is
    structural: a candidate must *beat* the unsharded prediction, so
    whenever the collective term makes partitioning a predicted loss (or
    merely a wash), the spec comes back with ``n_shards == 1``.
    """
    if max_shards < 1:
        raise ValueError(f"max_shards must be >= 1, got {max_shards}")
    kw = dict(allowed=allowed, model=model, budget=budget)
    best = unsharded_spec(scene, **kw)
    for axis in axes:
        if axis == UNSHARDED_AXIS:
            continue
        for n in _shard_counts(max_shards):
            cand = score_partition(scene, axis, n, **kw)
            if cand is not None and cand.predicted_s < best.predicted_s:
                best = cand
    return best
