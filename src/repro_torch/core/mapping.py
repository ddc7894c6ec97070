"""Multi-grained mapping selector — the paper's core contribution, on Hopper.

Port of ``repro.core.mapping``.  The three grains keep their meaning; what
changes is the machine they are mapped onto (see ``csrc/mg3m_conv.cu``):

  TB11  the whole filter resident in one block's shared memory; persistent
        blocks walk (column tile, m-tile) work items.  Feasible only while
        ``fh*fw*IC*OC`` fits the shared-memory budget.
  TB18  an OC slice of the filter resident per block; blocks over (slice,
        column strip).
  TB88  a tiled GEMM: FLT and IN tiles both streamed per chunk of the
        flattened reduction; blocks over (column tile, m-tile).

Each grain runs one of its compiled tiles ``(BM, BC, TM, TC)``
(``footprint.TB11_SHAPES`` / ``TB18_SHAPES`` / ``TB88_SHAPES``): the tile
is a dimension of the search, priced here with the grain and stored in
``ScheduleChoice.tile``, which the plan launches as is.

The selector is an analytic model: a compute term (the busiest SM's
share of the kernel-tile-quantized MACs at the f32 rate, slowed by how
few warps the SM holds and by the issue slots its threads spend on
shared reads, staging copies and stores beside the FMAs) against a
traffic term (the bytes each residency pattern streams over the HBM
rate), plus per-chunk overhead and the load of a resident filter.  The
machine constants are the H100 SXM datasheet's; the others are
assumptions fitted to chip times, labelled below.  ``CostModel`` /
``ClassCorrection`` keep the reference's shape; ``tune/calibrate.py`` fits
the corrections to measured times on the raw terms of ``cost_terms``.

The port may choose a different grain than the reference for the same
scene: the two machines differ.  Parity between the packages covers
numerics and scene arithmetic, not the grain choice.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Tuple

import torch

from repro_torch.analysis.footprint import (GEMM_KC, TB18_KC,
                                            segment_taps, tile_threads)
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
# Assumptions, not datasheet: fitted for speed alone by
# ``chip_tile_sweep.py --fit`` (``--starts 2 --seed 4``) to forced-grain,
# forced-tile chip times: the whole ResNet trunk (f32 twice, bf16 once)
# and the layers where TB11 fits in the other five CNNs (f32 and bf16),
# buckets 1-8 (PERF.md §6).  The fit minimizes the picks' trunk sums over
# the fastest measured configuration's, served and per forced grain.  On
# the f32 ResNet trunk the served picks come out +2.1 / +4.9 / +5.1 /
# +2.6 % over the fastest at buckets 1 / 2 / 4 / 8; single picks miss by
# up to 18 % (TB11 at L1 B=2).  TB11 and TB88 tie within about 3 %
# wherever TB11's filter fits, so which of them serves the stem is the
# model's guess: the fit serves TB11 on L0-L1 (and L3 at B=8), within 2 %
# of the fastest on L0 but 7-18 % behind it on L1 at B >= 2; TB11 is the
# fastest measured on bf16 stems.  A fit to the f32 ResNet trunk alone
# serves TB11 nowhere, at +2.3 / +4.8 / +5.0 / +2.7 %.
# - An SM issues at its full rate only with _FULL_RATE_WARPS warps
#   resident (to hide shared-load and FMA latency), below it in
#   proportion to (warps / _FULL_RATE_WARPS) ** _ISSUE_EXPONENT.
_FULL_RATE_WARPS = 12
_ISSUE_EXPONENT = 0.6
# - Issue slots a thread spends per 16-byte (or narrower) shared read of
#   its operands, per staging copy (a cp.async and its address) and per
#   global store of its outputs, beside its one slot per FMA.
_ISSUE_PER_READ = 4.0
_ISSUE_PER_COPY = 96.0
_ISSUE_PER_STORE = 128.0
# - The rate at which an SM pulls a resident filter (TB11's whole filter,
#   TB18's slice) from L2 before its first chunk, over all SMs.
L2_TO_SM_BW = 8e12
_SMEM_PER_BLOCK_RESERVED = 1024  # the runtime's share per resident block
_REGS_PER_SM = 65536             # H100 SXM datasheet: 32-bit registers

# Assumption, fitted with the constants above: the fixed cost of one
# reduction chunk of a block (its barrier plus the staging latency the
# FMAs don't hide), overlapped across the SM's resident blocks.
STEP_OVERHEAD_S = 100e-9

# Interconnect constants of ring-sharded execution (``repro_torch.shard``;
# the reference's names): the joint grain x partition selector charges
# every inter-device byte against ICI_BW, every collective round against
# ICI_LATENCY_S and every sharded dispatch SHARD_LAUNCH_OVERHEAD_S, so a
# partition whose collective term erases its per-shard win loses to
# shards=1 by construction.
ICI_BW = 450e9       # H100 SXM5 datasheet: NVLink 4, 900 GB/s both ways
# Measured by chip_smoke.py's shard phase on a ring of 4 x one NVIDIA H100
# 80GB HBM3 at 700 W.  A collective round on that ring is one device copy
# launch: 10.39 us for a 16 KiB copy, host included (a round between two
# cards over NVLink is not measured).  The dispatch is a host loop of n
# inner executes: a batch:4 dispatch of a trunk layer at batch 8 took
# 445.4 us (median of the 10 layers; 62.4-683.6) longer than its four
# shards' kernels, host included (588.8 us in a second call: the host's
# time varies from call to call).
ICI_LATENCY_S = 10.39e-6
SHARD_LAUNCH_OVERHEAD_S = 445.4e-6

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
    """Measured correction for one scene class (``tune/calibrate.py`` fits
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
    bk: int                # IC block; TB11/TB18 carry the full IC; TB88's
                           # only pads IC (the kernel chunks the reduction)
    predicted_s: float     # modeled runtime (seconds) on one H100
    compute_s: float
    hbm_s: float
    vmem_bytes: int
    notes: str = ""
    tile: Tuple[int, ...] = ()   # the compiled (BM, BC, TM, TC) it runs on

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s >= self.hbm_s else "memory"


# --------------------------------------------------------------------------
# the kernels' launch shape, as the model sees it
# --------------------------------------------------------------------------
def wgrad_segments(scene: ConvScene) -> Tuple[Tuple[int, int], ...]:
    """``[r0, r1)`` of each segment of a scene's reduction ``r = tap * K +
    k``, in summation order: whole taps (``scene.seg_taps`` each, from
    ``core.scene.WGRAD_SEGMENT_R``: only a ``WgradScene`` splits), a
    single segment
    where the reduction is not split."""
    bounds, t = [], 0
    for n in segment_taps(scene.fltH * scene.fltW, scene.seg_taps):
        bounds.append((t * scene.K, (t + n) * scene.K))
        t += n
    return tuple(bounds)


def blocks_per_sm(smem: int, threads: int,
                  smem_per_sm: int = H100_SMEM_PER_SM) -> int:
    """Blocks of ``threads`` threads and ``smem`` bytes one SM holds at
    once (threads, blocks and shared memory all limit residency)."""
    return min(_THREADS_PER_SM // threads, _BLOCKS_PER_SM,
               smem_per_sm // (smem + _SMEM_PER_BLOCK_RESERVED))


def _resident_blocks(schedule: str, smem: int, tile: Tuple[int, ...]) -> int:
    """Blocks one SM holds: shared memory and threads, and for TB11/TB88
    the registers their launch bounds size a thread for (csrc
    ``gemm_min_blocks``: 170 for an 8 x 8 thread tile, else 128)."""
    threads = tile_threads(tile)
    n = max(1, blocks_per_sm(smem, threads))
    if schedule != "TB18":
        regs = 170 if tile[2] * tile[3] >= 64 else 128
        n = max(1, min(n, _REGS_PER_SM // (threads * regs)))
    return n


def _copy_elems(scene: ConvScene, schedule: str, tile: Tuple[int, ...]
                ) -> int:
    """Elements per staging copy of the IN tile, as the kernels choose it:
    16 bytes of a column's k values at batch 1 where K allows; at batch
    N > 1 up to 16 bytes of a pixel's N batch entries (TB11/TB88, and
    TB18 in bf16), single elements otherwise."""
    it = dtype_itemsize(scene.dtype)
    v = 16 // it
    if scene.N == 1:
        return v if scene.K % v == 0 else 1
    if schedule == "TB18" and it == 4:
        return 1
    run = scene.N * it
    for nbytes in (16, 8, 4):
        if run % nbytes == 0 and tile[1] % scene.N == 0:
            return nbytes // it
    return 1


def _store_elems(scene: ConvScene, schedule: str,
                 tile: Tuple[int, ...]) -> int:
    """Outputs per store instruction: TB11/TB88 store a thread's rows of a
    column 16 bytes at a time at batch 1, a pixel's batch run (or pairs of
    it at even N) at batch > 1; TB18 stores single elements."""
    if schedule == "TB18":
        return 1
    v = 16 // dtype_itemsize(scene.dtype)
    if scene.N == 1:
        return min(tile[2], v)
    vc = min(tile[3], v)
    if tile[1] % scene.N:
        return 1
    return vc if scene.N % vc == 0 else 2 if scene.N % 2 == 0 else 1


def _fma_share(scene: ConvScene, schedule: str, bm: int, bk: int,
               tile: Tuple[int, ...], n_seg: int = 1) -> float:
    """Share of a thread's issue slots that are FMAs: per reduction value
    it issues TM x TC FMAs, its shared reads of TM filter rows and TC
    columns (16 bytes or its vector at a time; 4 k values of a column at
    once where the IN tile is column-major) and its share of the block's
    staging copies (TB88 also copies its filter tile); per tile (of one of
    ``n_seg`` reduction segments), its stores."""
    bmt, bc, tm, tc = tile
    it = dtype_itemsize(scene.dtype)
    v = 16 // it
    col_major = scene.N == 1 or (schedule == "TB18" and it == 4)
    reads = tm / min(tm, v) + (tc / 4 if col_major else tc / min(tc, v))
    copies = bc / _copy_elems(scene, schedule, tile)
    if schedule == "TB88":
        copies += bmt / (v if scene.M % v == 0 and bm % v == 0 else 1)
    red = (scene.fltH * scene.fltW * scene.K if schedule != "TB88"
           else _reduction(scene, schedule, bk)) / n_seg
    fma = tm * tc * red
    return fma / (fma + red * (_ISSUE_PER_READ * reads
                               + _ISSUE_PER_COPY * copies / tile_threads(tile))
                  + _ISSUE_PER_STORE * tm * tc
                  / _store_elems(scene, schedule, tile))


def _resident_bytes(scene: ConvScene, schedule: str,
                    tile: Tuple[int, ...]) -> int:
    """Filter bytes a block loads before its first chunk: TB11's whole
    padded filter (each reduction segment from a chunk of its own), TB18's
    padded slice; TB88 streams its filter."""
    it = dtype_itemsize(scene.dtype)
    taps = scene.fltH * scene.fltW
    if schedule == "TB11":
        segs = segment_taps(taps, scene.seg_taps)
        return (len(segs) * ceil_div(segs[0] * scene.K, GEMM_KC) * GEMM_KC
                * ceil_div(scene.M, tile[0]) * tile[0] * it)
    if schedule == "TB18":
        return taps * ceil_div(scene.K, 8) * 8 * tile[0] * it
    return 0


def _units(scene: ConvScene, schedule: str, bm: int,
           tile: Tuple[int, ...]) -> Tuple[int, int]:
    """(column tiles, m-tiles) of the work: a unit is one column tile x one
    m-tile (TB11's m-tiles are its compiled BM inside the whole OC)."""
    cols = scene.num_spatial_tasks * scene.N
    n_ct = ceil_div(cols, tile[1])
    return n_ct, ceil_div(scene.M, tile[0] if schedule == "TB11" else bm)


def _reduction(scene: ConvScene, schedule: str, bk: int) -> int:
    """Reduction values TB11/TB88 walk: every ``fltH x fltW`` tap (holes
    included: the kernels mask their loads, exactly as the reference's
    grid walks them) times K, TB88's K padded to the plan's ``bk``."""
    k = ceil_div(scene.K, bk) * bk if schedule == "TB88" else scene.K
    return scene.fltH * scene.fltW * k


def _chunks(scene: ConvScene, schedule: str, bk: int,
            seg_taps: int) -> int:
    """Chunks of ``GEMM_KC`` a TB11/TB88 work item's reduction takes,
    summed over its segments (each walked from its own first value)."""
    k = _reduction(scene, schedule, bk) // (scene.fltH * scene.fltW)
    return sum(ceil_div(n * k, GEMM_KC)
               for n in segment_taps(scene.fltH * scene.fltW, seg_taps))


def grid_steps(scene: ConvScene, schedule: str, bm: int, bk: int,
               tile: Tuple[int, ...], seg_taps: Optional[int] = None) -> int:
    """Total chunk steps all blocks take: TB18 walks (tap, 32-k chunk),
    TB11/TB88 the flattened reduction in chunks of ``GEMM_KC``, each
    segment of a split reduction (every ``seg_taps`` taps, by default the
    scene's) from its own first value."""
    seg_taps = scene.seg_taps if seg_taps is None else seg_taps
    n_ct, n_m = _units(scene, schedule, bm, tile)
    if schedule == "TB18":
        return n_ct * n_m * scene.fltH * scene.fltW * ceil_div(scene.K,
                                                               TB18_KC)
    return n_ct * n_m * _chunks(scene, schedule, bk, seg_taps)


def _quantized_macs(scene: ConvScene, schedule: str, bm: int, bk: int,
                    tile: Tuple[int, ...],
                    seg_taps: Optional[int] = None) -> float:
    """MACs the kernel tiles actually issue: rows rounded to the compiled
    BM per m-tile, columns to the tile width, the reduction to TB18's k
    chunk per tap or to whole TB11/TB88 chunks per segment (every
    ``seg_taps`` taps, by default the scene's)."""
    seg_taps = scene.seg_taps if seg_taps is None else seg_taps
    n_ct, n_m = _units(scene, schedule, bm, tile)
    if schedule == "TB18":
        red = scene.fltH * scene.fltW * scene.K
    else:
        red = _chunks(scene, schedule, bk, seg_taps) * GEMM_KC
    return n_m * tile[0] * n_ct * tile[1] * red


def segsum_bytes(scene: ConvScene) -> int:
    """Bytes the second pass of a split reduction moves: the f32 partials
    read once, the output written once (0 where there is no split)."""
    n_seg = len(wgrad_segments(scene))
    if n_seg == 1:
        return 0
    return n_seg * scene.bytes_out() // dtype_itemsize(scene.dtype) * 4 \
        + scene.bytes_out()


def _traffic_bytes(scene: ConvScene, schedule: str, bm: int, slots: int,
                   tile: Tuple[int, ...]) -> int:
    """Bytes each residency pattern streams: the filter once per block
    that loads it, the gathered input window (the implicit GEMM's B
    operand) once per m-tile pass, the output once (a split reduction's
    f32 partials once per segment instead)."""
    it = dtype_itemsize(scene.dtype)
    taps = scene.fltH * scene.fltW
    flt = taps * scene.K * scene.M * it
    in_win = scene.num_spatial_tasks * scene.N * taps * scene.K * it
    out = scene.bytes_out()
    if segsum_bytes(scene):
        out = segsum_bytes(scene) - out
    n_ct, n_m = _units(scene, schedule, bm, tile)
    if schedule == "TB11":
        return flt * min(n_ct * n_m, slots) + n_m * in_win + out
    if schedule == "TB18":
        grid_x = min(n_ct, ceil_div(slots, n_m))
        return flt * grid_x + n_m * in_win + out
    return flt * n_ct + n_m * in_win + out


@dataclasses.dataclass(frozen=True)
class CostTerms:
    """The raw terms ``_score`` composes for one point, before any class
    correction: ``predicted = max(compute_s / compute_scale, hbm_s /
    bw_scale) + steps * per_step_overhead + fixed_s``.  Calibration fits
    the corrections on exactly these terms (``tune/calibrate.py``)."""

    compute_s: float       # busiest SM's issue time at the datasheet rate
    hbm_s: float           # streamed bytes over the datasheet HBM rate
    steps: float           # chunk steps the per-step overhead is charged on
    fixed_s: float         # resident filter loads and a split
                           # reduction's second pass (no class correction)
    smem: int              # the block's shared-memory footprint

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s >= self.hbm_s else "memory"


def cost_terms(scene: ConvScene, schedule: str, bm: int, bn: int, bk: int,
               model: Optional[CostModel] = None,
               budget: int = SMEM_BUDGET,
               tile: Tuple[int, ...] = ()) -> Optional[CostTerms]:
    """The uncorrected terms of one (schedule, blocks, tile) point, or None
    when its shared memory exceeds ``budget`` or it is TB18 on a split
    reduction; ``model`` supplies the base rates.  A split reduction (a
    ``WgradScene``'s, ``wgrad_segments``) makes each segment a work item
    of its own, plus the second pass's bytes."""
    model = model if model is not None else DEFAULT_COST_MODEL
    n_seg = len(wgrad_segments(scene))
    if n_seg > 1 and schedule == "TB18":
        return None
    smem = _vmem_bytes(scene, schedule, bm, bn, bk, tile)
    if smem > budget:
        return None
    threads = tile_threads(tile)
    per_sm = _resident_blocks(schedule, smem, tile)
    slots = H100_SMS * per_sm
    n_ct, n_m = _units(scene, schedule, bm, tile)
    units = n_ct * n_m * n_seg
    # the busiest SM's share of the units, and the warps it holds while it
    # works through them: a busy SM issues at the full rate only with
    # enough warps resident (few-output layers leave it latency-bound)
    busiest = ceil_div(units, H100_SMS)
    resident = min(per_sm, busiest)
    issue = min(1.0, resident * threads / 32
                / _FULL_RATE_WARPS) ** _ISSUE_EXPONENT
    macs = _quantized_macs(scene, schedule, bm, bk, tile)
    sm_rate = model.mxu_rate(scene.dtype) / H100_SMS
    compute_s = (busiest * 2 * macs / units / sm_rate / issue
                 / _fma_share(scene, schedule, bm, bk, tile, n_seg))
    hbm_s = _traffic_bytes(scene, schedule, bm, slots, tile) / model.hbm_bw
    # the busiest SM's chunk steps, overlapped across its resident blocks,
    # its resident blocks' filter loads, and the second pass of a split
    steps = grid_steps(scene, schedule, bm, bk, tile) / units \
        * busiest / resident
    fixed_s = (resident * _resident_bytes(scene, schedule, tile)
               / (L2_TO_SM_BW / H100_SMS)
               + segsum_bytes(scene) / model.hbm_bw)
    return CostTerms(compute_s, hbm_s, steps, fixed_s, smem)


def _score(scene: ConvScene, schedule: str, bm: int, bn: int, bk: int,
           model: Optional[CostModel] = None,
           budget: int = SMEM_BUDGET,
           tile: Tuple[int, ...] = ()) -> Optional[ScheduleChoice]:
    model = model if model is not None else DEFAULT_COST_MODEL
    terms = cost_terms(scene, schedule, bm, bn, bk, model, budget, tile)
    if terms is None:
        return None
    # class decided on the raw terms, as calibration buckets them
    corr = model.correction_for(schedule, terms.bound,
                                ai_band(scene.arithmetic_intensity))
    compute_s = terms.compute_s / max(corr.compute_scale, 1e-30)
    hbm_s = terms.hbm_s / max(corr.bw_scale, 1e-30)
    per_step = (corr.overhead_s if corr.overhead_s is not None
                else model.step_overhead_s)
    total = max(compute_s, hbm_s) + (terms.steps * per_step + terms.fixed_s)
    return ScheduleChoice(schedule, bm, bn, bk, total, compute_s, hbm_s,
                          terms.smem, tile=tuple(tile))


def candidate_blocks(scene: ConvScene, schedule: str
                     ) -> Tuple[Tuple[int, int, int, Tuple[int, ...]], ...]:
    """Kernel-tile ``(bm, bn, bk, tile)`` candidates per schedule: the
    blocks ``tune.space`` enumerates, as in the reference, each with every
    compiled tile of the grain that runs it."""
    from repro_torch.tune.space import (block_candidates,  # avoids a cycle
                                        tile_candidates)
    return tuple((bm, bn, bk, tile)
                 for bm, bn, bk in block_candidates(scene, schedule)
                 for tile in tile_candidates(schedule, bm))


def split_tb18_error(scene: ConvScene) -> str:
    """Why TB18 cannot run a split reduction (``select_schedule`` and an
    exact TB18 choice on a split plan raise it)."""
    return (f"TB18 walks a whole reduction per block; the split reduction "
            f"of {scene.describe()} (every {scene.seg_taps} taps) runs on "
            f"TB11 or TB88")


def select_schedule(scene: ConvScene,
                    allowed: Tuple[str, ...] = SCHEDULES,
                    model: Optional[CostModel] = None,
                    budget: int = SMEM_BUDGET) -> ScheduleChoice:
    """Pick the best (schedule, blocks, tile) for a scene, its reduction
    split where the scene splits it (a ``WgradScene``).

    ``allowed`` restricts the grains considered (a forced schedule passes
    a 1-tuple); when none of them fits the shared-memory ``budget`` at any
    candidate blocking, raises ``ValueError`` — a forced grain never
    silently becomes another one.  TB18 takes no split reduction: forced
    alone on one, it raises."""
    if len(wgrad_segments(scene)) > 1:
        if tuple(allowed) == ("TB18",):
            raise ValueError(split_tb18_error(scene))
        allowed = tuple(s for s in allowed if s != "TB18")
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
        raise ValueError(f"no feasible schedule for {scene.describe()}")
    return best


def predicted_efficiency(scene: ConvScene, choice: ScheduleChoice,
                         model: Optional[CostModel] = None) -> float:
    """Useful FLOPs / (peak FLOPs x modeled time) under the model."""
    model = model if model is not None else DEFAULT_COST_MODEL
    ideal_s = scene.flops / model.mxu_rate(scene.dtype)
    return min(1.0, ideal_s / max(choice.predicted_s, 1e-30))
