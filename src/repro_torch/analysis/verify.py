"""Static launch-geometry verifier of the MG3M kernels — integer math over
what a launch does, no kernel executed.

Port of ``repro.analysis.verify``.  The reference abstractly evaluates a
Pallas ``KernelGridSpec`` (grid, block shapes, index maps).  The port's
kernels (``csrc/mg3m_conv.cu``) take a ``Geom`` and a grid instead, and a
block walks output tiles of its own: ``KernelLaunch`` holds exactly that
— the ``LaunchSpec`` (``kernels/mg3m_conv.launch_spec``), the ``Geom``
fields the kernel receives (``launch_geom``), the grid (``launch_grid``),
and the walk, column-tile and row maps and the index map written out as
numpy transcriptions of the CUDA loops.  ``check_launch`` evaluates them
and checks:

  (a) output coverage and disjointness: the (segment, column tile,
      m-tile) work items the blocks visit — TB88 one per block of its
      (column tile, m-tile, segment) grid, TB11 and TB18 (persistent)
      ``x, x + grid x, ...`` — are each visited exactly once, the column
      tiles partition the output columns, the m-tiles the output rows and
      the segments the reduction, on whole taps, so every (output
      element, reduction value) is summed exactly once.  An unsplit launch
      is one segment: each block walks an item's whole reduction.  A split
      one (a wgrad plan's, ``Geom.nseg`` > 1) stores per-segment partials
      that ``segment_sum`` adds in segment order, so no order depends on
      the blocks' timing, which the port's bitwise claims rely on;
  (b) the masked-tap predicate: ``in_coord`` as the kernel evaluates it,
      over the Geom's fields on both axes, against a map recomputed here
      from the ``ConvScene`` definition (on purpose, as in the reference,
      not from ``_tap_coords`` or ``_index_params``): every hole or
      out-of-range tap must give -1 (a masked load of zero), every live
      tap its real element of the launched input (pre-padded on the dense
      route, compact on the lhs-dilated one), never one past its extent;
  (c) shared memory: the one ``analysis.footprint`` formula within the
      device's budget (read from the card, the datasheet's on a CPU).
      Given the card's report for the compiled tile
      (``kernels.mg3m_conv.tile_attributes``), also that the block can
      launch at all, and whether the persistent grid, sized from
      ``core.mapping.blocks_per_sm`` (threads, blocks and shared memory;
      registers ignored), exceeds the card's resident slots: a warning
      (``occupancy-overestimate``), not an error, since the walk still
      covers the output;
  (d) the IO dtype is f32 or bf16 and the accumulator f32;
  (e) agreement with the cost model: the chunk steps and the tile-
      quantized MACs the walk issues equal ``core.mapping.grid_steps`` and
      ``_quantized_macs``, and the live taps' MACs ``scene.macs``.

Findings are data (``Finding``), never exceptions.  Entry points:
``check_launch`` (the reference's ``check_spec``), ``verify_point``,
``verify_choice``, ``verify_plan`` (reference plans give no findings) and
``sweep_scene``/``sweep_scenes`` (every feasible point of every op of a
scene list — ``launch/analyze.py``'s gate).  ``device_index_map`` checks
the card's own ``in_coord`` (``mg3m_in_coord_table``) against (b)'s
expected table, bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import (Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.analysis.footprint import (GEMM_KC, TB11_SHAPES, TB18_KC,
                                            tile_threads, tiles)
from repro_torch.core.mapping import (ScheduleChoice, _quantized_macs,
                                      blocks_per_sm, device_limits,
                                      grid_steps, smem_budget)
from repro_torch.core.scene import ConvScene, ceil_div, dtype_name
from repro_torch.kernels import mg3m_conv as mg
from repro_torch.plan.build import (ConvOp, ConvPlan, _dgrad_blocker,
                                    _wgrad_blocker, derive_exec_spec,
                                    grad_filter_scene, grad_input_scene,
                                    launched_shapes)

__all__ = ["Finding", "errors", "KernelLaunch", "kernel_launch",
           "check_launch", "verify_point", "verify_choice", "verify_plan",
           "verify_sharded_plan", "sweep_scene", "sweep_scenes",
           "expected_in_coord", "device_index_map", "in_coord_np"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated property of a launch geometry.

    ``severity`` is "error" (the launch computes a wrong answer or cannot
    run) or "warning" (a documented approximation of the cost model or
    the grid sizing).  ``message`` is self-contained: it names the scene,
    the schedule, the blocking and tile, and the first offending item."""

    code: str
    severity: str
    message: str
    scene: str
    schedule: str
    blocks: Tuple[int, int, int]
    op: str = ""
    tile: Tuple[int, ...] = ()

    @property
    def is_error(self) -> bool:
        return self.severity == "error"


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.is_error]


# --------------------------------------------------------------------------
# the launch as data: numpy transcriptions of csrc/mg3m_conv.cu
# --------------------------------------------------------------------------
def in_coord_np(o, tap, stride: int, fdil: int, pad: int, dil: int,
                extent: int) -> np.ndarray:
    """``in_coord`` (csrc/mg3m_conv.cu) over arrays: the input row (or
    column) output coordinate ``o`` reads at filter tap ``tap``, -1 on a
    dilation hole or outside ``[0, extent)``."""
    q = np.asarray(o, dtype=np.int64) * stride + \
        np.asarray(tap, dtype=np.int64) * fdil - pad
    ok = q >= 0
    if dil != 1:
        ok &= q % dil == 0
        q = q // dil
    ok &= q < extent
    return np.where(ok, q, -1)


def _strided_visits(grid_x: int, stride: int, n_items: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(block x, item) of the persistent loop ``for (w = x; w < n; w +=
    stride)`` over every block x < grid_x."""
    xs = np.arange(grid_x, dtype=np.int64)
    counts = np.maximum(0, -(-(n_items - xs) // max(stride, 1)))
    bx = np.repeat(xs, counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    step = np.arange(bx.size, dtype=np.int64) - first
    return bx, bx + step * stride


def _tb11_items(launch: "KernelLaunch") -> np.ndarray:
    """TB11's visited item numbers ``w``: ``for (w = x; w < n_ct * n_mt *
    nseg; w += stride)`` over every block x (``stride`` is gridDim.x)."""
    n = launch.n_col_tiles * launch.n_m_tiles * launch.segments
    return _strided_visits(launch.grid[0], launch.stride, n)[1]


def kernel_walk(launch: "KernelLaunch") -> Tuple[np.ndarray, np.ndarray]:
    """(column tile, m-tile) of every work item the launch's blocks visit,
    as the kernels loop: TB88 ``tile(blockIdx.x, blockIdx.y, blockIdx.z)``
    for each segment z; TB18 for each grid row y, ``for (ct = x; ct <
    n_ct; ct += stride)``; TB11 item ``w`` (``_tb11_items``) being, of
    ``v = w % (n_ct * n_mt)``, column tile ``v / n_mt``, m-tile ``v %
    n_mt`` (its segment: ``kernel_walk_segments``)."""
    n_ct, n_mt = launch.n_col_tiles, launch.n_m_tiles
    gx, gy = launch.grid
    if launch.spec.schedule == "TB88":
        ct, mt = np.meshgrid(np.arange(gx), np.arange(gy), indexing="ij")
        return (np.tile(ct.ravel(), launch.segments),
                np.tile(mt.ravel(), launch.segments))
    if launch.spec.schedule == "TB18":
        _, ct = _strided_visits(gx, launch.stride, n_ct)
        return np.tile(ct, gy), np.repeat(np.arange(gy), ct.size)
    v = _tb11_items(launch) % (n_ct * n_mt)
    return v // n_mt, v % n_mt


def kernel_walk_segments(launch: "KernelLaunch") -> np.ndarray:
    """The reduction segment of each item ``kernel_walk`` lists: TB88's
    ``blockIdx.z``, TB11's ``w / (n_ct * n_mt)``, 0 for TB18."""
    if launch.spec.schedule == "TB88":
        return np.repeat(np.arange(launch.segments),
                         launch.grid[0] * launch.grid[1])
    if launch.spec.schedule == "TB18":
        return np.zeros(kernel_walk(launch)[0].size, dtype=np.int64)
    return _tb11_items(launch) // (launch.n_col_tiles * launch.n_m_tiles)


def segment_bounds(geom: Mapping[str, int]) -> Tuple[np.ndarray, int]:
    """(first reduction value of each segment, a full segment's length)
    as ``gemm_body`` computes them from its Geom: ``r0 = s * seg_len``,
    ``r1 = min(R, r0 + seg_len)``, ``seg_len`` being ``seg_taps`` taps
    of K (all taps where ``nseg`` is 1)."""
    taps = geom["fh"] * geom["fw"]
    nseg = max(geom["nseg"], 1)
    seg_len = (geom["seg_taps"] if nseg > 1 else taps) * geom["K"]
    return np.arange(nseg, dtype=np.int64) * seg_len, seg_len


@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """One launch of a grain, as the checks evaluate it: ``spec`` (the
    checked operands and blocking), ``geom`` (the Geom fields the kernel
    receives), ``grid`` (blocks in x and y), ``threads``, ``stride`` (the
    persistent walk's step, gridDim.x), ``walk`` (the visited (column
    tile, m-tile) items), ``col0``/``row0`` (the first output column of a
    column tile, the first output row of an m-tile), ``in_coord`` (the
    index map) and the accumulator dtype.  ``dataclasses.replace`` on a
    good launch seeds a bug for the checks to find."""

    spec: mg.LaunchSpec
    geom: Mapping[str, int]
    grid: Tuple[int, int]
    threads: int
    stride: int
    walk: Callable[["KernelLaunch"], Tuple[np.ndarray, np.ndarray]] = \
        kernel_walk
    seg_walk: Callable[["KernelLaunch"], np.ndarray] = kernel_walk_segments
    col0: Optional[Callable[[np.ndarray], np.ndarray]] = None
    row0: Optional[Callable[[np.ndarray], np.ndarray]] = None
    in_coord: Callable = in_coord_np
    acc_dtype: str = "float32"

    @property
    def columns(self) -> int:
        g = self.geom
        return g["outH"] * g["outW"] * g["N"]

    @property
    def n_col_tiles(self) -> int:
        return ceil_div(self.columns, self.geom["bc"])

    @property
    def m_tile(self) -> int:
        """Rows of OC an m-tile spans: the compiled BM for TB11 (it walks
        the whole OC), the plan's ``bm`` (rows past it masked) else."""
        return (self.geom["tbm"] if self.spec.schedule == "TB11"
                else self.geom["bm"])

    @property
    def n_m_tiles(self) -> int:
        return ceil_div(self.geom["M"], self.m_tile)

    @property
    def segments(self) -> int:
        """Reduction segments the kernel walks (``Geom.nseg``)."""
        return max(self.geom["nseg"], 1)

    def col_starts(self, ct: np.ndarray) -> np.ndarray:
        return (self.col0(ct) if self.col0 is not None
                else ct * self.geom["bc"])

    def row_starts(self, mt: np.ndarray) -> np.ndarray:
        return self.row0(mt) if self.row0 is not None else mt * self.m_tile


def kernel_launch(scene: ConvScene, schedule: str, *, in_shape, flt_shape,
                  bm: int = 0, bn: int = 0, bk: int = 0,
                  tile: Tuple[int, ...], device=None,
                  seg_taps: Optional[int] = None) -> KernelLaunch:
    """The ``KernelLaunch`` of one (schedule, blocking, tile) over the
    operands as launched, its reduction split every ``seg_taps`` taps (by
    default the scene's, ``ConvScene.seg_taps``; 0: not split), on
    ``device`` (the datasheet's card when None or a CPU).
    Raises ``ValueError`` where ``launch_spec`` refuses it (the
    shared-memory budget is not applied: that is check (c))."""
    spec = mg.launch_spec(scene, schedule, in_shape=in_shape,
                          flt_shape=flt_shape, bm=bm, bn=bn, bk=bk,
                          tile=tile, seg_taps=(scene.seg_taps
                                               if seg_taps is None
                                               else seg_taps))
    gx, gy, _, threads = mg.launch_grid(spec, device)
    geom = mg.geom_fields(mg.launch_geom(spec, device))
    return KernelLaunch(spec, geom, (gx, gy), threads, gx)


# --------------------------------------------------------------------------
# the specification of the index map, from the scene definition
# --------------------------------------------------------------------------
def expected_in_coord(scene: ConvScene, axis: str
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The specification of the index map along one axis as an ``(n_out,
    n_tap)`` table of (launched-input index or -1, live), recomputed from
    the scene definition.

    Dense route (no lhs dilation on either axis): the launched input is
    pre-padded by ``pad`` (and ``apad`` high), tap ``(o, t)`` reads row
    ``o * std + t * fdil``, live while inside it.  Lhs-dilated route: the
    input is the compact one; a tap is live iff it lands on a stored
    element of the virtually padded and dilated input, reading
    ``(o * std + t * fdil - pad) / dil``; every other tap is masked."""
    if axis == "h":
        n_out, n_tap = scene.outH, scene.fltH
        std, fdil, dil = scene.stdH, scene.fdilH, scene.dilH
        pad, apad, in_real = scene.padH, scene.apadH, scene.inH
    else:
        n_out, n_tap = scene.outW, scene.fltW
        std, fdil, dil = scene.stdW, scene.fdilW, scene.dilW
        pad, apad, in_real = scene.padW, scene.apadW, scene.inW
    o = np.arange(n_out, dtype=np.int64)[:, None]
    t = np.arange(n_tap, dtype=np.int64)[None, :]
    p = o * std + t * fdil
    if scene.dilH == 1 and scene.dilW == 1:
        live = p < in_real + 2 * pad + apad
        return np.where(live, p, -1), live
    q = p - pad
    live = (q >= 0) & (q % dil == 0) & (q < in_real * dil)
    return np.where(live, q // dil, -1), live


# --------------------------------------------------------------------------
# the checks
# --------------------------------------------------------------------------
def _first(mask: np.ndarray) -> Tuple[int, ...]:
    return tuple(int(x) for x in np.argwhere(mask)[0])


def _partition(starts: np.ndarray, width: int, total: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """How many of the intervals ``[s, s + width)`` (clipped to
    ``[0, total)``) hold each of ``0 .. total-1``, and which intervals lie
    outside entirely."""
    lo = np.clip(starts, 0, total)
    hi = np.clip(starts + width, 0, total)
    diff = np.zeros(total + 1, dtype=np.int64)
    np.add.at(diff, lo, 1)
    np.add.at(diff, hi, -1)
    return np.cumsum(diff)[:total], (starts < 0) | (starts >= total)


@functools.lru_cache(maxsize=4096)
def _tile_attributes(schedule: str, tile: Tuple[int, ...], dtype: str,
                     smem: int) -> Dict[str, int]:
    return mg.tile_attributes(schedule, tile, dtype, smem)


def check_launch(launch: KernelLaunch, *, smem_budget_bytes: Optional[int]
                 = None, device=None, attributes: Optional[Mapping[str, int]]
                 = None, op: str = "") -> List[Finding]:
    """Every static property of one launch (see the module docstring).
    ``smem_budget_bytes`` defaults to ``device``'s; ``attributes`` is the
    card's report for the tile (``tile_attributes``), read from the card
    when ``device`` is CUDA and none is given.  Returns all findings."""
    spec, g, sc = launch.spec, launch.geom, launch.spec.scene
    blocks = (spec.bm, spec.bn, spec.bk)
    where = (f"{spec.schedule}@{spec.bm}/{spec.bn}/{spec.bk} tile "
             f"{spec.tile} grid {launch.grid} on {sc.describe()}")

    def finding(code: str, msg: str, severity: str = "error") -> Finding:
        return Finding(code=code, severity=severity,
                       message=f"{msg} [{where}]", scene=sc.describe(),
                       schedule=spec.schedule, blocks=blocks, op=op,
                       tile=tuple(spec.tile))

    out: List[Finding] = []
    in_shape, flt_shape = spec.in_shape, spec.flt_shape

    # -- structure: the Geom is the launch spec's ---------------------------
    if (g["fh"], g["fw"]) != (sc.fltH, sc.fltW):
        out.append(finding(
            "dropped-tap",
            f"the kernel walks {g['fh']}x{g['fw']} taps, the filter has "
            f"{sc.fltH}x{sc.fltW}; the missing taps' contributions are "
            f"dropped"))
    want = {"K": in_shape[2], "N": in_shape[3], "M": flt_shape[3],
            "outH": sc.outH, "outW": sc.outW, "bm": spec.bm,
            "bc": spec.tile[1], "tm": spec.tile[2], "tc": spec.tile[3],
            "tbm": spec.tile[0], "seg_taps": spec.seg_taps}
    for name, value in want.items():
        if g[name] != value:
            out.append(finding(
                "grid-structure",
                f"Geom.{name} = {g[name]}, the launch spec says {value}"))
    if spec.schedule in ("TB18", "TB88") and g["M"] % max(g["bm"], 1):
        out.append(finding(
            "flt-bounds",
            f"m-tile {g['bm']} does not divide M = {g['M']}: the last "
            f"tile's rows read past the filter"))
    if launch.threads != tile_threads(spec.tile):
        out.append(finding(
            "grid-structure",
            f"{launch.threads} threads per block, the tile has "
            f"{tile_threads(spec.tile)}"))
    gx, gy = launch.grid
    n_ct, n_mt = launch.n_col_tiles, launch.n_m_tiles
    if spec.schedule == "TB88" and (gx, gy) != (n_ct, g["M"] // g["bm"]):
        out.append(finding(
            "grid-structure",
            f"launch_grid gives ({gx}, {gy}); the kernel launches "
            f"({n_ct}, {g['M'] // g['bm']}) from its Geom"))
    if spec.schedule != "TB88" and g["grid"] != gx:
        out.append(finding(
            "grid-structure",
            f"Geom.grid = {g['grid']}, the launch has {gx} blocks in x"))
    if spec.schedule == "TB18" and gy != g["M"] // g["bm"]:
        out.append(finding(
            "grid-structure",
            f"{gy} grid rows, one per OC slice would be "
            f"{g['M'] // g['bm']}"))
    if (g["Hl"], g["Wl"]) != tuple(in_shape[:2]):
        out.append(finding(
            "in-bounds",
            f"the kernel indexes an input of {g['Hl']}x{g['Wl']} pixels, "
            f"the launched input has {in_shape[0]}x{in_shape[1]}"))
    if any(f.code == "grid-structure" for f in out):
        return out   # too malformed for the walks below

    # -- (a) every work item once, the tiles partitioning the output -------
    # and the segments the reduction
    ct, mt = launch.walk(launch)
    n_seg = launch.segments
    sg = launch.seg_walk(launch) if n_seg > 1 else np.zeros_like(ct)
    items = n_seg * n_ct * n_mt
    bad = ((ct < 0) | (ct >= n_ct) | (mt < 0) | (mt >= n_mt) | (sg < 0)
           | (sg >= n_seg))
    if bad.any():
        i = int(np.argmax(bad))
        out.append(finding(
            "out-coverage",
            f"a block visits item (segment {int(sg[i])}, column tile "
            f"{int(ct[i])}, m-tile {int(mt[i])}) outside ({n_seg}, {n_ct}, "
            f"{n_mt}); its write lands outside the output"))
    else:
        seen = np.bincount((sg * n_ct + ct) * n_mt + mt, minlength=items)

        def item(c):
            return (f"segment {c // (n_ct * n_mt)}, column tile "
                    f"{c // n_mt % n_ct}, m-tile {c % n_mt}")
        if (seen > 1).any():
            c = int(np.argmax(seen > 1))
            out.append(finding(
                "out-overlap",
                f"{int((seen > 1).sum())} work items visited more than "
                f"once (first: {item(c)}); the blocks' stores race"))
        if (seen == 0).any():
            c = int(np.argmax(seen == 0))
            out.append(finding(
                "out-coverage",
                f"{int((seen == 0).sum())} of {items} work items never "
                f"visited (first: {item(c)}); their outputs stay "
                f"unwritten"))
    r_total = g["fh"] * g["fw"] * g["K"]
    r0s, seg_len = segment_bounds(g)
    cover, outside = _partition(r0s, seg_len, r_total)
    if outside.any() or (cover != 1).any() or (r0s % g["K"]).any():
        out.append(finding(
            "reduction-coverage",
            f"the {n_seg} segments of {seg_len} reduction values leave "
            f"{int((cover == 0).sum())} of {r_total} uncovered, "
            f"{int((cover > 1).sum())} covered twice, "
            f"{int(outside.sum())} segments outside the reduction, "
            f"{int((r0s % g['K'] != 0).sum())} starting inside a tap"))
    for axis, starts, width, total in (
            ("column", launch.col_starts(np.arange(n_ct)), g["bc"],
             launch.columns),
            ("row", launch.row_starts(np.arange(n_mt)), launch.m_tile,
             g["M"])):
        cover, outside = _partition(np.asarray(starts, dtype=np.int64),
                                    width, total)
        if outside.any() or (cover == 0).any():
            where_ = (f"tile {_first(outside)[0]} starts outside"
                      if outside.any() else
                      f"{axis} {_first(cover == 0)[0]} is in no tile")
            out.append(finding(
                "out-coverage",
                f"the {axis} tiles leave {int((cover == 0).sum())} output "
                f"{axis}s unwritten ({where_})"))
        if (cover > 1).any():
            out.append(finding(
                "out-overlap",
                f"{int((cover > 1).sum())} output {axis}s lie in two "
                f"{axis} tiles (first: {_first(cover > 1)[0]}); their "
                f"stores race"))

    # -- (b) the masked-tap predicate, both axes -----------------------------
    tables = {}
    for axis, n_out, taps, ext, args in (
            ("h", sc.outH, g["fh"], in_shape[0],
             (g["stdH"], g["fdilH"], g["padH"], g["dilH"], g["Hl"])),
            ("w", sc.outW, g["fw"], in_shape[1],
             (g["stdW"], g["fdilW"], g["padW"], g["dilW"], g["Wl"]))):
        o = np.arange(n_out)[:, None]
        t = np.arange(taps)[None, :]
        got = np.broadcast_to(launch.in_coord(o, t, *args), (n_out, taps))
        want_tab, live = expected_in_coord(sc, axis)
        k = min(taps, want_tab.shape[1])
        got, want_tab, live = got[:, :k], want_tab[:, :k], live[:, :k]
        tables[axis] = live
        oob = got >= ext
        if oob.any():
            c = _first(oob)
            out.append(finding(
                "in-bounds",
                f"axis {axis}: output {c[0]} tap {c[1]} reads input "
                f"{int(got[c])}, past the launched extent {ext}"))
        dropped = live & (got < 0)
        if dropped.any():
            c = _first(dropped)
            out.append(finding(
                "dropped-tap",
                f"axis {axis}: live tap {c[1]} of output {c[0]} is masked "
                f"(it should read {int(want_tab[c])}); its contribution "
                f"is dropped"))
        hole = ~live & (got >= 0)
        if hole.any():
            c = _first(hole)
            out.append(finding(
                "sentinel-miss",
                f"axis {axis}: tap {c[1]} of output {c[0]} lands on a "
                f"dilation hole or the padding but reads input "
                f"{int(got[c])} instead of a masked zero"))
        mism = live & (got >= 0) & (got != want_tab)
        if mism.any():
            c = _first(mism)
            out.append(finding(
                "index-map-mismatch",
                f"axis {axis}: tap {c[1]} of output {c[0]} reads "
                f"{int(got[c])}, the specification says "
                f"{int(want_tab[c])}"))

    # -- (c) shared memory, and what the card says of the tile -------------
    budget = (smem_budget_bytes if smem_budget_bytes is not None
              else smem_budget(device))
    if spec.smem > budget:
        out.append(finding(
            "smem-overshoot",
            f"the block stages {spec.smem} B of shared memory, the budget "
            f"is {budget} B"))
    elif attributes is None and device is not None and \
            torch.device(device).type == "cuda":
        attributes = _tile_attributes(spec.schedule, tuple(spec.tile),
                                      dtype_name(sc.dtype), spec.smem)
    if attributes is not None and spec.smem <= budget:
        if attributes["blocks_per_sm"] < 1 or \
                launch.threads > attributes["max_threads"]:
            out.append(finding(
                "launch-resources",
                f"the card fits {attributes['blocks_per_sm']} blocks of "
                f"{launch.threads} threads per SM (at most "
                f"{attributes['max_threads']}; {attributes['registers']} "
                f"registers a thread, {spec.smem} B shared): the launch "
                f"fails"))
        elif spec.schedule != "TB88":
            sms = device_limits(device)[2]
            card = sms * attributes["blocks_per_sm"]
            if gx * gy > card:
                model = blocks_per_sm(spec.smem, launch.threads,
                                      device_limits(device)[1])
                out.append(finding(
                    "occupancy-overestimate",
                    f"the persistent grid has {gx * gy} blocks, sized for "
                    f"{model} blocks per SM; the card holds "
                    f"{attributes['blocks_per_sm']} ({attributes['registers']}"
                    f" registers a thread), {card} in all: the tail runs "
                    f"as a second wave", severity="warning"))

    # -- (d) dtypes ---------------------------------------------------------
    io = dtype_name(sc.dtype)
    if io not in ("float32", "bfloat16") or launch.acc_dtype != "float32":
        out.append(finding(
            "dtype-promotion",
            f"IO dtype {io} with a {launch.acc_dtype} accumulator: the "
            f"kernels take f32 or bf16 and accumulate in f32"))

    # -- (e) agreement with the cost model ---------------------------------
    if spec.schedule == "TB18":
        per_item = np.full(ct.size, g["fh"] * g["fw"]
                           * ceil_div(g["K"], TB18_KC), dtype=np.int64)
        red = g["fh"] * g["fw"] * g["K"]
    else:   # each item's segment [r0, r1) in chunks from r0
        r0 = np.clip(sg, 0, n_seg - 1) * seg_len
        per_item = -(-(np.minimum(r_total, r0 + seg_len) - r0) // GEMM_KC)
        red = GEMM_KC
    steps = int(per_item.sum())
    want_steps = grid_steps(sc, spec.schedule, spec.bm, spec.bk, spec.tile,
                            spec.seg_taps)
    if steps != want_steps:
        out.append(finding(
            "grid-steps-disagree",
            f"the blocks walk {steps} chunk steps, the cost model's "
            f"grid_steps says {want_steps}"))
    macs = spec.tile[0] * g["bc"] * red * (
        steps if spec.schedule != "TB18" else int(ct.size))
    want_macs = _quantized_macs(sc, spec.schedule, spec.bm, spec.bk,
                                spec.tile, spec.seg_taps)
    if macs != want_macs:
        out.append(finding(
            "mac-disagree",
            f"the blocks issue {macs} tile MACs, the cost model's "
            f"_quantized_macs says {want_macs}"))
    if "h" in tables and "w" in tables:
        useful = (sc.M * sc.N * sc.K * int(tables["h"].sum())
                  * int(tables["w"].sum()))
        if sc.dilH == 1 and sc.dilW == 1 and useful != sc.macs:
            out.append(finding(
                "mac-disagree",
                f"the live taps make {useful} useful MACs, scene.macs says "
                f"{sc.macs}"))
        elif useful > sc.macs:
            out.append(finding(
                "mac-disagree",
                f"the live taps make {useful} useful MACs, above "
                f"scene.macs {sc.macs}: the cost model undercounts this "
                f"dilated scene", severity="warning"))
    return out


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------
def _invalid(scene: ConvScene, schedule: str, blocks, msg: str, op: str,
             tile=()) -> Finding:
    return Finding(code="spec-invalid", severity="error", message=msg,
                   scene=scene.describe(), schedule=schedule,
                   blocks=tuple(blocks), op=op, tile=tuple(tile))


def verify_choice(scene: ConvScene, choice: ScheduleChoice, *,
                  smem_budget_bytes: Optional[int] = None, device=None,
                  op: str = "") -> List[Finding]:
    """Statically verify one (scene, ScheduleChoice) pair — the launch a
    plan built from this choice would make, on ``choice.tile``, its
    reduction split where the scene splits it."""
    spec = derive_exec_spec(scene, choice)
    in_shape, flt_shape = launched_shapes(scene, spec)
    try:
        launch = kernel_launch(scene, choice.schedule, in_shape=in_shape,
                               flt_shape=flt_shape, bm=spec.bm, bn=spec.bn,
                               bk=spec.bk, tile=choice.tile, device=device)
    except ValueError as e:
        return [_invalid(scene, choice.schedule,
                         (choice.bm, choice.bn, choice.bk), str(e), op,
                         choice.tile)]
    return check_launch(launch, smem_budget_bytes=smem_budget_bytes,
                        device=device, op=op)


def verify_point(scene: ConvScene, schedule: str, bm: int = 0, bn: int = 0,
                 bk: int = 0, tile: Optional[Tuple[int, ...]] = None, *,
                 smem_budget_bytes: Optional[int] = None, device=None,
                 op: str = "") -> List[Finding]:
    """Statically verify a (schedule, blocking) point over ``scene`` on
    ``tile``, or on every compiled tile that runs its m-tile when ``tile``
    is None, the reduction split where the scene splits it.  Blocks default
    to the full MM_unit dims (TB11's)."""
    bm, bn, bk = bm or scene.M, bn or scene.N, bk or scene.K
    if tile is not None:
        run_on = (tuple(tile),)
    else:
        run_bm = scene.M if schedule == "TB11" else min(bm, scene.M)
        try:
            run_on = tiles(schedule, run_bm)
        except ValueError as e:
            return [_invalid(scene, schedule, (bm, bn, bk), str(e), op)]
        if not run_on:
            return [_invalid(scene, schedule, (bm, bn, bk),
                             f"no compiled {schedule} tile runs an m-tile "
                             f"of {run_bm}", op)]
    out: List[Finding] = []
    for t in run_on:
        choice = ScheduleChoice(schedule, bm, bn, bk, 0.0, 0.0, 0.0, 0,
                                tile=t)
        out.extend(verify_choice(scene, choice,
                                 smem_budget_bytes=smem_budget_bytes,
                                 device=device, op=op))
    return out


def verify_plan(plan: ConvPlan, *, smem_budget_bytes: Optional[int] = None,
                device=None) -> List[Finding]:
    """Statically verify a built ``ConvPlan``: its stored ``ExecSpec``
    must re-derive from its choice, and its launch pass every
    ``check_launch`` property.  Reference plans launch no kernel: no
    findings.  ``device`` defaults to the plan's backend."""
    if plan.uses_reference:
        return []
    scene, choice, spec = plan.exec_scene, plan.choice, plan.spec
    if device is None and plan.backend == "cuda":
        device = "cuda"
    out_hw = ((spec.out_h, spec.out_w)
              if (spec.out_h, spec.out_w) != (0, 0) else None)
    want = derive_exec_spec(scene, choice, out_hw)
    if want != spec:
        return [Finding(
            code="spec-mismatch", severity="error",
            message=(f"stored ExecSpec {spec} does not re-derive from its "
                     f"choice (got {want}) for {plan.describe()}"),
            scene=scene.describe(), schedule=choice.schedule,
            blocks=(spec.bm, spec.bn, spec.bk), op=plan.op.value,
            tile=tuple(choice.tile))]
    return verify_choice(scene, choice, smem_budget_bytes=smem_budget_bytes,
                         device=device, op=plan.op.value)


def verify_sharded_plan(plan, *, smem_budget_bytes: Optional[int] = None,
                        device=None) -> List[Finding]:
    """Statically verify a ``repro_torch.shard.ShardedConvPlan``: the
    partition identity must re-derive from the exec scene (sub-scene,
    axis feasibility, halo row coverage — all integer math), and every
    inner per-shard plan must pass every ``verify_plan`` property on the
    sub-scene.  The ring transfers themselves are not statically
    provable here; what *is* provable is that each shard's launch
    geometry is exactly a verified one-device launch and that the shard
    x sub-scene algebra reconstructs the global op."""
    from repro_torch.shard.spec import (halo_geometry, shard_blocker,
                                        shard_sub_scene)
    spec, E = plan.spec, plan.exec_scene
    sch = spec.choice.schedule
    blocks = (spec.choice.bm, spec.choice.bn, spec.choice.bk)

    def finding(code, msg):
        return Finding(code=code, severity="error", message=msg,
                       scene=E.describe(), schedule=sch, blocks=blocks,
                       op=plan.op.value, tile=tuple(spec.choice.tile))

    out: List[Finding] = []
    if spec.is_sharded:
        why = shard_blocker(E, spec.axis, spec.n_shards)
        if why:
            out.append(finding(
                "shard-blocked",
                f"partition {spec.tag} is infeasible for "
                f"{E.describe()}: {why}"))
        else:
            want = shard_sub_scene(E, spec.axis, spec.n_shards)
            if spec.sub_scene != want:
                out.append(finding(
                    "shard-sub-scene-mismatch",
                    f"stored sub-scene {spec.sub_scene.describe()} does not "
                    f"re-derive from {E.describe()} under {spec.tag} "
                    f"(expected {want.describe()})"))
            if spec.axis == "h":
                geo = halo_geometry(E, spec.n_shards)
                if spec.n_shards * geo.oh_sub < E.outH:
                    out.append(finding(
                        "halo-coverage",
                        f"{spec.n_shards} shards x {geo.oh_sub} output rows "
                        f"do not cover outH={E.outH}"))
                if spec.sub_scene.outH != geo.oh_sub:
                    out.append(finding(
                        "halo-sub-outH",
                        f"sub-scene outH {spec.sub_scene.outH} != per-shard "
                        f"row count {geo.oh_sub}: the slab height is wrong"))
    elif spec.sub_scene != E:
        out.append(finding(
            "shard-sub-scene-mismatch",
            f"unsharded fallback must execute the exec scene itself, "
            f"stored sub-scene is {spec.sub_scene.describe()}"))
    for inner in dict.fromkeys(plan.inners):
        if inner.exec_scene != spec.sub_scene:
            out.append(finding(
                "shard-inner-scene",
                f"inner plan executes {inner.exec_scene.describe()}, not "
                f"the partition's sub-scene {spec.sub_scene.describe()}"))
        out.extend(verify_plan(inner, smem_budget_bytes=smem_budget_bytes,
                               device=device))
    return out


def device_index_map(scene: ConvScene, device=None) -> List[Finding]:
    """The card's own ``in_coord`` (``mg3m_in_coord_table``) for the
    launch of ``scene``, on both axes, against ``expected_in_coord``, bit
    for bit: one ``device-index-map`` error per axis that differs."""
    choice = ScheduleChoice("TB11", scene.M, scene.N, scene.K, 0.0, 0.0,
                            0.0, 0, tile=TB11_SHAPES[0])
    spec = derive_exec_spec(scene, choice)
    in_shape, flt_shape = launched_shapes(scene, spec)
    lspec = mg.launch_spec(scene, "TB11", in_shape=in_shape,
                           flt_shape=flt_shape, tile=choice.tile)
    geom = mg.launch_geom(lspec, device)
    out: List[Finding] = []
    for axis in ("h", "w"):
        got = mg.in_coord_table(geom, axis, device).numpy()
        want, _ = expected_in_coord(scene, axis)
        if got.shape != want.shape or (got != want).any():
            where = (_first(got != want) if got.shape == want.shape
                     else f"shape {got.shape} vs {want.shape}")
            out.append(Finding(
                code="device-index-map", severity="error",
                message=(f"axis {axis}: the card's in_coord differs from "
                         f"the specification at {where} on "
                         f"{scene.describe()}"),
                scene=scene.describe(), schedule="", blocks=(0, 0, 0)))
    return out


# --------------------------------------------------------------------------
# sweeps (the gate of launch/analyze.py)
# --------------------------------------------------------------------------
_ALL_OPS = (ConvOp.FPROP, ConvOp.DGRAD, ConvOp.WGRAD)
_BLOCKERS = {ConvOp.DGRAD: _dgrad_blocker, ConvOp.WGRAD: _wgrad_blocker}
_DERIVE = {ConvOp.FPROP: lambda s: s, ConvOp.DGRAD: grad_input_scene,
           ConvOp.WGRAD: grad_filter_scene}


def exec_scenes(scene: ConvScene, ops: Sequence[ConvOp] = _ALL_OPS
                ) -> Dict[ConvOp, ConvScene]:
    """The exec scene of each requested op that has one (reference
    fallbacks left out)."""
    out = {}
    for op in ops:
        blocker = _BLOCKERS.get(op)
        if blocker is None or not blocker(scene):
            out[op] = _DERIVE[op](scene)
    return out


def sweep_scene(scene: ConvScene, ops: Sequence[ConvOp] = _ALL_OPS, *,
                smem_budget_bytes: Optional[int] = None, device=None
                ) -> Tuple[List[Finding], int]:
    """Verify every feasible (schedule, blocking, tile) point of every
    requested op of one forward scene — the tuner's whole search space
    (``tune.space.enumerate_space`` at the device's budget), without
    executing a kernel; a wgrad exec scene with its reduction split as its
    plans split it.  Returns (findings, points checked)."""
    from repro_torch.tune.space import enumerate_space  # mapping imports
    # analysis back
    budget = (smem_budget_bytes if smem_budget_bytes is not None
              else smem_budget(device))
    findings: List[Finding] = []
    checked = 0
    for op, exec_scene in exec_scenes(scene, ops).items():
        for pt in enumerate_space(exec_scene, vmem_budget=budget):
            findings.extend(verify_point(
                exec_scene, pt.schedule, pt.bm, pt.bn, pt.bk, pt.tile,
                smem_budget_bytes=budget, device=device, op=op.value))
            checked += 1
    return findings, checked


def sweep_scenes(scenes: Mapping[str, ConvScene],
                 ops: Sequence[ConvOp] = _ALL_OPS, *,
                 smem_budget_bytes: Optional[int] = None, device=None
                 ) -> Tuple[Dict[str, List[Finding]], int]:
    """``sweep_scene`` over a named scene list (e.g.
    ``models.cnn.cnn_layer_scenes``).  Returns ({name: findings}, total
    points checked); names with no findings are omitted."""
    by_name: Dict[str, List[Finding]] = {}
    total = 0
    for name, scene in scenes.items():
        findings, checked = sweep_scene(scene, ops,
                                        smem_budget_bytes=smem_budget_bytes,
                                        device=device)
        total += checked
        if findings:
            by_name[name] = findings
    return by_name, total
