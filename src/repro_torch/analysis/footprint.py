"""The one shared-memory footprint formula of the port, and the kernels'
compiled tiles.

Every consumer of "does this blocking fit on-chip memory" answers it here:
``core/mapping._score`` rejects over-budget candidates,
``tune/space.enumerate_space`` filters the search space, and
``kernels/mg3m_conv`` refuses to launch an over-budget blocking.

Unlike the reference (``repro.analysis.footprint``, which models Mosaic's
double-buffered VMEM blocks), this counts exactly what the port's CUDA
kernels (``csrc/mg3m_conv.cu``) stage in dynamic shared memory:

  TB18  an OC slice ``[fh, fw, KP, BM]`` in the IO dtype (K padded to a
        multiple of 8, the slice to the compiled m-tile, both with zeros),
        a double-buffered IN tile ``2 x [BC, TB18_KC + 16 B]`` in the IO
        dtype (k contiguous per column, rows padded by 16 bytes so a warp's
        16-byte reads hit distinct banks), and an int32 table of each
        column's input offset at every tap ``[fh * fw, BC]``;
  TB11  the whole filter ``[nq * GEMM_KC, Mp]`` in the IO dtype: the
        flattened reduction ``fh * fw * K`` in ``nq`` whole chunks, OC
        rounded up to the compiled ``BM``, the pads zero; then what TB88
        has past its filter ring.  Where a wgrad exec scene's reduction is
        split into S segments (``segment_taps``), each segment starts on a
        chunk of its own: ``S * nqs`` chunks, ``nqs`` those of a full
        segment;
  TB88  a double-buffered filter tile ``2 x [GEMM_KC, BM]`` in the IO
        dtype, the double-buffered IN tile (TB18's size), two rows of
        ``GEMM_KC`` int4 reduction entries, and int32 tap-row and
        tap-column offset tables ``[fh + fw, BC]``.

Every grain runs one of its compiled tiles ``(BM, BC, TM, TC)``: a block
computes a ``BM x BC`` output tile (``BM`` rows of OC, ``BC`` columns of
the flattened (output pixel, batch) axis), a thread ``TM x TC`` of it, so
``(BM / TM) * (BC / TC)`` threads.  Which tile a scene runs is a
dimension of the selector's search (``core/mapping``), stored in its
``ScheduleChoice.tile`` and launched as is.  The tile lists mirror the
``TB18_SHAPE`` / ``TB11_SHAPE`` / ``TB88_SHAPE`` lists in
``csrc/mg3m_conv.cu`` and hold only tiles the selector picks somewhere on
the ResNet trunk (buckets 1-8, f32 and bf16) or on ``chip_smoke.py``'s
kernel scenes.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.scene import ConvScene, ceil_div, dtype_itemsize

__all__ = ["vmem_bytes", "KERNEL_BM", "TB18_SHAPES", "TB11_SHAPES",
           "TB88_SHAPES", "TB18_KC", "GEMM_KC", "tiles", "tile_threads",
           "tb18_smem", "gemm_smem", "segment_taps"]

KERNEL_BM = (8, 16, 32, 64, 128)   # compiled m-tile widths of TB18

# TB18's compiled tiles (BM, BC, TM, TC): at least one for every m-tile
# of KERNEL_BM
TB18_SHAPES = ((32, 64, 8, 4), (32, 128, 8, 4), (32, 256, 8, 4),
               (64, 128, 8, 4), (128, 64, 8, 4),
               (8, 64, 4, 2), (8, 128, 4, 2), (16, 64, 4, 2),
               (16, 128, 4, 2), (32, 64, 4, 2))
TB11_SHAPES = ((64, 128, 8, 8), (64, 128, 8, 4), (64, 64, 8, 4),
               (64, 64, 4, 4), (64, 32, 4, 4))
TB88_SHAPES = ((128, 64, 8, 8), (64, 128, 8, 8), (64, 128, 8, 4),
               (64, 64, 8, 4), (64, 64, 4, 4), (32, 128, 8, 4),
               (64, 32, 4, 4), (128, 32, 4, 4))
SHAPES = {"TB11": TB11_SHAPES, "TB18": TB18_SHAPES, "TB88": TB88_SHAPES}
TB18_KC = 32               # k chunk of TB18's double-buffered IN tile
GEMM_KC = 32               # reduction chunk of TB11/TB88 (r = tap * K + k)


def _round16(nbytes: int) -> int:
    """The kernels start the IN tiles on a 16-byte boundary after the
    filter."""
    return -(-nbytes // 16) * 16


def tiles(schedule: str, bm: int) -> Tuple[Tuple[int, int, int, int], ...]:
    """The compiled tiles of ``schedule`` that run an m-tile ``bm`` wide:
    TB18's and TB88's of the smallest compiled BM that holds ``bm`` (rows
    past it are masked); every TB11 tile (it walks the whole OC in m-tiles
    of its BM).  Raises ``ValueError`` on an unknown schedule."""
    if schedule not in SHAPES:
        raise ValueError(f"unknown schedule {schedule!r}")
    shapes = SHAPES[schedule]
    if schedule == "TB11":
        return shapes
    fits = sorted({t[0] for t in shapes if t[0] >= bm})
    return tuple(t for t in shapes if fits and t[0] == fits[0])


def tile_threads(tile) -> int:
    """Threads of the block of compiled tile ``(BM, BC, TM, TC)``."""
    bm, bc, tm, tc = tile
    return bm // tm * (bc // tc)


def segment_taps(taps: int, seg_taps: int) -> Tuple[int, ...]:
    """Taps of each segment of a reduction over ``taps`` filter taps cut
    every ``seg_taps`` taps (``seg_taps`` 0, or at least ``taps``: one
    segment)."""
    if not seg_taps or seg_taps >= taps:
        return (taps,)
    return tuple(min(seg_taps, taps - t) for t in range(0, taps, seg_taps))


def tb18_smem(scene: ConvScene, tile) -> int:
    """Dynamic shared-memory bytes of one TB18 block of compiled tile
    ``(BM, BC, TM, TC)`` (see the module docstring)."""
    it = dtype_itemsize(scene.dtype)
    taps = scene.fltH * scene.fltW
    kp = -(-scene.K // 8) * 8
    bc = tile[1]
    return (_round16(taps * kp * tile[0] * it)
            + 2 * bc * (TB18_KC * it + 16) + 4 * taps * bc)


def gemm_smem(scene: ConvScene, tile, resident: bool,
              seg_taps: Optional[int] = None) -> int:
    """Dynamic shared-memory bytes of one TB11 (``resident``) or TB88
    block of compiled tile ``(BM, BC, TM, TC)``, the reduction split every
    ``seg_taps`` taps (by default the scene's, ``ConvScene.seg_taps``; 0:
    not split; see the module docstring)."""
    seg_taps = scene.seg_taps if seg_taps is None else seg_taps
    it = dtype_itemsize(scene.dtype)
    bm, bc = tile[0], tile[1]
    if resident:
        segs = segment_taps(scene.fltH * scene.fltW, seg_taps)
        nq = len(segs) * ceil_div(segs[0] * scene.K, GEMM_KC)
        flt = nq * GEMM_KC * ceil_div(scene.M, bm) * bm
    else:
        flt = 2 * GEMM_KC * bm
    return (_round16(flt * it) + 2 * bc * (GEMM_KC * it + 16)
            + 2 * GEMM_KC * 16 + 4 * (scene.fltH + scene.fltW) * bc)


def vmem_bytes(scene: ConvScene, schedule: str, bm: int, bn: int,
               bk: int, tile: Tuple[int, ...] = (),
               seg_taps: Optional[int] = None) -> int:
    """Dynamic shared-memory bytes one block of ``schedule`` stages at
    blocking ``(bm, bn, bk)`` on compiled ``tile`` over ``scene`` (the
    name mirrors the reference's VMEM formula; on Hopper the budget is
    shared memory).  ``bn`` and ``bk`` do not enter: a tile's columns span
    pixels and batch together, and TB88 walks its reduction in chunks of
    its own.  ``seg_taps``: the reduction split every ``seg_taps`` taps,
    by default the scene's (TB11's resident filter takes a chunk boundary
    at each segment; TB18 takes no split).  Raises ``ValueError`` on an unknown schedule or a
    tile that is not compiled for ``bm``."""
    del bn, bk
    if tuple(tile) not in tiles(schedule, bm):
        raise ValueError(f"{schedule} tile {tuple(tile)} is not a compiled "
                         f"tile for an m-tile of {bm}: "
                         f"{tiles(schedule, bm)}")
    if schedule == "TB18":
        return tb18_smem(scene, tile)
    return gemm_smem(scene, tile, schedule == "TB11", seg_taps)
