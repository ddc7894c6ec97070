"""Multi-grained mapping selector — the paper's core contribution, on Hopper.

Port of ``repro.core.mapping``.  The three grains keep their meaning; what
changes is the machine they are mapped onto (see ``csrc/mg3m_conv.cu``):

  TB11  the whole filter resident in one block's shared memory; persistent
        blocks walk strips of output-column tiles.  Feasible only while
        ``fh*fw*IC*OC`` fits the shared-memory budget.
  TB18  an OC slice of the filter resident per block; blocks over (slice,
        column strip), on one of the compiled tiles of
        ``footprint.TB18_SHAPES``: the tile is a dimension of the search,
        priced here with the grain and stored in ``ScheduleChoice.tile``.
  TB88  a tiled GEMM: FLT and IN tiles both streamed per (tap, k-chunk).

The selector is an analytic model — compute term (kernel-tile-quantized
MACs over the f32 rate, stretched by how badly the work units fill the
card's SMs and by how few warps a busy SM holds) against a traffic term (the bytes each residency pattern
streams over the HBM rate), plus a per-step overhead.  The constants are
the H100 SXM datasheet's; the per-step overhead is an assumption, not a
measurement.  ``CostModel``/``ClassCorrection`` keep the reference's shape
so a calibration port can fit corrections later.

The port may choose a different grain than the reference for the same
scene: the two machines differ.  Parity between the packages covers
numerics and scene arithmetic, not the grain choice.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Tuple

import torch

from repro_torch.analysis.footprint import (TB11_BM, TB18_KC, RES_BK,
                                            THREADS, col_tile, kernel_bm,
                                            tb18_threads)
from repro_torch.analysis.footprint import vmem_bytes as _vmem_bytes
from repro_torch.core.scene import ConvScene, ceil_div, dtype_itemsize

# H100 SXM datasheet (NVIDIA; dense rates at the 700 W limit).
H100_FP32_FLOPS = 67e12        # H100 SXM datasheet: f32 on the CUDA cores
H100_BF16_FLOPS = 989e12       # H100 SXM datasheet: bf16 tensor cores
H100_HBM_BW = 3.35e12          # H100 SXM datasheet: bytes/s
H100_SMS = 132                 # H100 SXM datasheet: streaming multiprocessors
H100_SMEM_PER_BLOCK = 232448   # H100 SXM datasheet: 227 KB opt-in per block
H100_SMEM_PER_SM = 233472      # H100 SXM datasheet: 228 KB per SM
_THREADS_PER_SM = 2048         # H100 SXM datasheet: resident threads per SM
_BLOCKS_PER_SM = 32            # H100 SXM datasheet: resident blocks per SM
# Assumption, not datasheet: an SM issues f32 FMAs at its full rate only
# with 16 warps resident (four per scheduler, to hide shared-load and FMA
# latency), and in proportion to its warps below that.  It ranks TB18's
# compiled tiles as their chip times did on trunk L5/L7/L9 at batch 1
# and 2 (PERF.md §6, chip_smoke.py's tile sweep).
_FULL_RATE_WARPS = 16
_SMEM_PER_BLOCK_RESERVED = 1024  # the runtime's share per resident block

# Assumption, not measured: the fixed cost of one (tap, k-chunk) step of a
# block (two barriers plus the tile-staging latency the FMAs don't hide).
STEP_OVERHEAD_S = 300e-9

SMEM_BUDGET = H100_SMEM_PER_BLOCK

SCHEDULES = ("TB11", "TB18", "TB88")

# Arithmetic-intensity band edges (FLOPs/byte) for cost-model scene classes.
AI_BAND_EDGES = (8.0, 64.0, 512.0)


@functools.lru_cache(maxsize=None)
def _cuda_props(index: int) -> Tuple[int, int, int]:
    p = torch.cuda.get_device_properties(index)
    return (int(p.shared_memory_per_block_optin),
            int(getattr(p, "shared_memory_per_multiprocessor",
                        H100_SMEM_PER_SM)),
            int(p.multi_processor_count))


def device_limits(device: Optional[torch.device] = None
                  ) -> Tuple[int, int, int]:
    """(shared memory per block, shared memory per SM, SM count): read
    from the card for a CUDA device, the H100 datasheet's otherwise (CPU
    plans are priced as if for the card they stand in for)."""
    if device is not None and torch.device(device).type == "cuda":
        dev = torch.device(device)
        return _cuda_props(dev.index if dev.index is not None
                           else torch.cuda.current_device())
    return H100_SMEM_PER_BLOCK, H100_SMEM_PER_SM, H100_SMS


def smem_budget(device: Optional[torch.device] = None) -> int:
    """Dynamic shared memory one block may use on ``device``."""
    return device_limits(device)[0]


def ai_band(ai: float) -> str:
    """Arithmetic-intensity band label used in cost-model class keys."""
    for i, edge in enumerate(AI_BAND_EDGES):
        if ai < edge:
            return f"ai{i}"
    return f"ai{len(AI_BAND_EDGES)}"


def class_key(schedule: str, bound: str, band: str) -> str:
    """Scene-class key: schedule x bound-type x arithmetic-intensity band."""
    return f"{schedule}|{bound}|{band}"


@dataclasses.dataclass(frozen=True)
class ClassCorrection:
    """Measured correction for one scene class (a calibration port fills
    these): ``compute_scale``/``bw_scale`` scale the datasheet rates into
    effective ones (<1 = slower); ``overhead_s`` replaces the per-step
    overhead (None = keep the model's)."""

    compute_scale: float = 1.0
    bw_scale: float = 1.0
    overhead_s: Optional[float] = None


_IDENTITY_CORRECTION = ClassCorrection()


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Machine constants + per-class corrections behind the model.

    Field names follow the reference so calibration artifacts port as they
    are.  ``mxu_flops_bf16`` is the rate bf16 scenes are priced at: the
    port's kernels run bf16 through f32 FMA on the CUDA cores (no wgmma
    yet), so it defaults to the f32 rate, not ``H100_BF16_FLOPS``.
    Correction lookup falls back exact class -> "schedule|bound|*" ->
    "schedule|*|*" -> "*|*|*" -> identity, as in the reference."""

    mxu_flops_bf16: float = H100_FP32_FLOPS
    mxu_flops_fp32: float = H100_FP32_FLOPS
    hbm_bw: float = H100_HBM_BW
    step_overhead_s: float = STEP_OVERHEAD_S
    corrections: Mapping[str, ClassCorrection] = dataclasses.field(
        default_factory=dict)
    source: str = "analytic"

    def mxu_rate(self, dtype: str) -> float:
        return (self.mxu_flops_bf16 if dtype_itemsize(dtype) <= 2
                else self.mxu_flops_fp32)

    def correction_for(self, schedule: str, bound: str, band: str
                       ) -> ClassCorrection:
        for key in (class_key(schedule, bound, band),
                    class_key(schedule, bound, "*"),
                    class_key(schedule, "*", "*"),
                    class_key("*", "*", "*")):
            corr = self.corrections.get(key)
            if corr is not None:
                return corr
        return _IDENTITY_CORRECTION

    @property
    def is_calibrated(self) -> bool:
        return bool(self.corrections)


DEFAULT_COST_MODEL = CostModel()


@dataclasses.dataclass(frozen=True)
class ScheduleChoice:
    """A concrete schedule for one scene.  ``vmem_bytes`` keeps the
    reference's name and holds the block's shared-memory footprint."""

    schedule: str          # TB11 | TB18 | TB88
    bm: int                # OC block (TB18 slice width / TB88 m-tile)
    bn: int                # batch block (always the whole batch here)
    bk: int                # IC block; TB11/TB18 carry the full IC
    predicted_s: float     # modeled runtime (seconds) on one H100
    compute_s: float
    hbm_s: float
    vmem_bytes: int
    notes: str = ""
    tile: Tuple[int, ...] = ()   # TB18's compiled (BM, BC, TM, TC); () else

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s >= self.hbm_s else "memory"


# --------------------------------------------------------------------------
# the kernels' launch shape, as the model sees it
# --------------------------------------------------------------------------
def blocks_per_sm(smem: int, threads: int,
                  smem_per_sm: int = H100_SMEM_PER_SM) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes one SM holds at
    once (threads, blocks and shared memory all limit residency)."""
    return min(_THREADS_PER_SM // threads, _BLOCKS_PER_SM,
               smem_per_sm // (smem + _SMEM_PER_BLOCK_RESERVED))


def _col_tile(schedule: str, bm: int, tile: Tuple[int, ...]) -> int:
    """Columns of one block tile: TB18's from its compiled tile."""
    if schedule == "TB11":
        return col_tile(TB11_BM)
    if schedule == "TB18":
        return tile[1]
    return col_tile(bm)


def _threads(schedule: str, tile: Tuple[int, ...]) -> int:
    return tb18_threads(tile) if schedule == "TB18" else THREADS


def _units(scene: ConvScene, schedule: str, bm: int,
           tile: Tuple[int, ...] = ()) -> Tuple[int, int]:
    """(column tiles, m-tiles) of the work: a unit is one column tile x one
    m-tile (TB11 counts its whole OC as one m-tile unit per column tile)."""
    cols = scene.num_spatial_tasks * scene.N
    n_ct = ceil_div(cols, _col_tile(schedule, bm, tile))
    if schedule == "TB11":
        return n_ct, 1
    return n_ct, ceil_div(scene.M, bm)


def grid_steps(scene: ConvScene, schedule: str, bm: int, bk: int,
               tile: Tuple[int, ...] = ()) -> int:
    """Total (tap, k-chunk) steps all blocks take.  Counts every
    ``fltH x fltW`` tap, holes included: the kernels walk them all and
    mask the hole loads, exactly as the reference's grid does."""
    n_ct, n_m = _units(scene, schedule, bm, tile)
    taps = scene.fltH * scene.fltW
    if schedule == "TB11":
        return n_ct * ceil_div(scene.M, TB11_BM) * taps * ceil_div(scene.K,
                                                                   RES_BK)
    chunk = TB18_KC if schedule == "TB18" else bk
    return n_ct * n_m * taps * ceil_div(scene.K, chunk)


def _quantized_macs(scene: ConvScene, schedule: str, bm: int, bk: int,
                    tile: Tuple[int, ...] = ()) -> float:
    """MACs the kernel tiles actually issue: rows rounded to the compiled
    m-tile, columns to the tile width, K to the k chunk, all taps."""
    cols = scene.num_spatial_tasks * scene.N
    taps = scene.fltH * scene.fltW
    bc = _col_tile(schedule, bm, tile)
    if schedule == "TB11":
        rows = ceil_div(scene.M, TB11_BM) * TB11_BM
        k = scene.K
    else:
        rows = ceil_div(scene.M, bm) * kernel_bm(bm)
        k = scene.K if schedule == "TB18" else ceil_div(scene.K, bk) * bk
    return rows * ceil_div(cols, bc) * bc * taps * k


def _traffic_bytes(scene: ConvScene, schedule: str, bm: int, slots: int,
                   tile: Tuple[int, ...] = ()) -> int:
    """Bytes each residency pattern streams: the filter once per block
    that loads it, the gathered input window (the implicit GEMM's B
    operand) once per m-tile pass, the output once."""
    it = dtype_itemsize(scene.dtype)
    taps = scene.fltH * scene.fltW
    flt = taps * scene.K * scene.M * it
    in_win = scene.num_spatial_tasks * scene.N * taps * scene.K * it
    out = scene.bytes_out()
    n_ct, n_m = _units(scene, schedule, bm, tile)
    if schedule == "TB11":
        return (flt * min(n_ct, slots)
                + ceil_div(scene.M, TB11_BM) * in_win + out)
    if schedule == "TB18":
        grid_x = min(n_ct, ceil_div(slots, n_m))
        return flt * grid_x + n_m * in_win + out
    return flt * n_ct + n_m * in_win + out


def _score(scene: ConvScene, schedule: str, bm: int, bn: int, bk: int,
           model: Optional[CostModel] = None,
           budget: int = SMEM_BUDGET,
           tile: Tuple[int, ...] = ()) -> Optional[ScheduleChoice]:
    model = model if model is not None else DEFAULT_COST_MODEL
    smem = _vmem_bytes(scene, schedule, bm, bn, bk, tile)
    if smem > budget:
        return None
    threads = _threads(schedule, tile)
    per_sm = max(1, blocks_per_sm(smem, threads))
    slots = H100_SMS * per_sm
    n_ct, n_m = _units(scene, schedule, bm, tile)
    units = n_ct * n_m
    waves = ceil_div(units, slots)
    fill = units / (waves * slots)     # share of the card's slots in use
    # a busy SM issues at the full rate only with enough warps resident:
    # small TB18 blocks on a few-output layer leave it latency-bound
    warps = min(per_sm, ceil_div(units, H100_SMS)) * threads // 32
    issue = min(1.0, warps / _FULL_RATE_WARPS)
    macs = _quantized_macs(scene, schedule, bm, bk, tile)
    raw_compute_s = 2 * macs / model.mxu_rate(scene.dtype) / fill / issue
    raw_hbm_s = _traffic_bytes(scene, schedule, bm, slots,
                               tile) / model.hbm_bw
    # class decided on the raw terms, as calibration buckets them
    bound = "compute" if raw_compute_s >= raw_hbm_s else "memory"
    corr = model.correction_for(schedule, bound,
                                ai_band(scene.arithmetic_intensity))
    compute_s = raw_compute_s / max(corr.compute_scale, 1e-30)
    hbm_s = raw_hbm_s / max(corr.bw_scale, 1e-30)
    per_step = (corr.overhead_s if corr.overhead_s is not None
                else model.step_overhead_s)
    # steps of blocks that run side by side overlap: charge one block's
    # share per wave
    overhead_s = grid_steps(scene, schedule, bm, bk, tile) / min(
        units, slots) * per_step
    total = max(compute_s, hbm_s) + overhead_s
    return ScheduleChoice(schedule, bm, bn, bk, total, compute_s, hbm_s,
                          smem, tile=tuple(tile))


def candidate_blocks(scene: ConvScene, schedule: str
                     ) -> Tuple[Tuple[int, int, int, Tuple[int, ...]], ...]:
    """Kernel-tile ``(bm, bn, bk, tile)`` candidates per schedule: the
    blocks ``tune.space`` enumerates, as in the reference, each with every
    compiled TB18 tile that runs it (``()`` for TB11/TB88, whose tile
    follows from ``bm``)."""
    from repro_torch.tune.space import (block_candidates,  # avoids a cycle
                                        tile_candidates)
    return tuple((bm, bn, bk, tile)
                 for bm, bn, bk in block_candidates(scene, schedule)
                 for tile in tile_candidates(schedule, bm))


def select_schedule(scene: ConvScene,
                    allowed: Tuple[str, ...] = SCHEDULES,
                    model: Optional[CostModel] = None,
                    budget: int = SMEM_BUDGET) -> ScheduleChoice:
    """Pick the best (schedule, blocks, tile) for a scene.

    ``allowed`` restricts the grains considered (a forced schedule passes
    a 1-tuple); when none of them fits the shared-memory ``budget`` at any
    candidate blocking, raises ``ValueError`` — a forced grain never
    silently becomes another one."""
    best: Optional[ScheduleChoice] = None
    for schedule in allowed:
        for bm, bn, bk, tile in candidate_blocks(scene, schedule):
            choice = _score(scene, schedule, bm, bn, bk, model, budget,
                            tile)
            if choice is not None and (best is None
                                       or choice.predicted_s < best.predicted_s):
                best = choice
    if best is None:
        if "TB88" not in allowed:
            raise ValueError(
                f"forced schedule(s) {allowed} do not fit the shared-memory "
                f"budget ({budget} B) at any candidate blocking for "
                f"{scene.describe()}; allow TB88 (or use schedule=None) "
                f"for a tiled fallback")
        choice = _score(scene, "TB88", min(16, scene.M), scene.N,
                        min(8, scene.K), model, budget)
        if choice is None:
            raise ValueError(f"no feasible schedule for {scene.describe()}")
        best = choice
    return best


def predicted_efficiency(scene: ConvScene, choice: ScheduleChoice,
                         model: Optional[CostModel] = None) -> float:
    """Useful FLOPs / (peak FLOPs x modeled time) under the model."""
    model = model if model is not None else DEFAULT_COST_MODEL
    ideal_s = scene.flops / model.mxu_rate(scene.dtype)
    return min(1.0, ideal_s / max(choice.predicted_s, 1e-30))
