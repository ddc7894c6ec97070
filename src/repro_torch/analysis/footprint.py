"""The one shared-memory footprint formula of the port, and the kernels'
compiled tiles.

Every consumer of "does this blocking fit on-chip memory" answers it here:
``core/mapping._score`` rejects over-budget candidates,
``tune/space.enumerate_space`` filters the search space, and
``kernels/mg3m_conv`` refuses to launch an over-budget blocking.

Unlike the reference (``repro.analysis.footprint``, which models Mosaic's
double-buffered VMEM blocks), this counts exactly what the port's CUDA
kernels (``csrc/mg3m_conv.cu``) stage in dynamic shared memory:

  TB11  the whole FLT ``[fh, fw, K, M]`` in the IO dtype, plus one f32 IN
        tile ``[RES_BK, BC]`` and the tile's column table;
  TB18  an OC slice ``[fh, fw, KP, BM]`` in the IO dtype (K padded to a
        multiple of 8, the slice to the compiled m-tile, both with zeros),
        a double-buffered IN tile ``2 x [BC, TB18_KC + 16 B]`` in the IO
        dtype (k contiguous per column, rows padded by 16 bytes so a warp's
        16-byte reads hit distinct banks), and an int32 table of each
        column's input offset at every tap ``[fh * fw, BC]``;
  TB88  an f32 FLT tile ``[bk, BM]`` and an f32 IN tile ``[bk, BC]``,
        plus the column table.

The kernel tile geometry lives here too, so the selector, the search space
and the launch wrappers all read one definition of it.  TB11 and TB88: a
block of ``THREADS`` threads computes a ``BM x BC`` output tile (``BM``
rows of OC, ``BC`` columns of the flattened (output pixel, batch) axis),
4x4 results per thread, so ``BM * BC == TILE_ELEMS``.  TB18 runs one of
the tiles of ``TB18_SHAPES`` ``(BM, BC, TM, TC)``: a thread computes
TM x TC results (8 x 4, or 4 x 2 where a layer has few outputs and needs
more warps), so ``(BM / TM) * (BC / TC)`` threads.  Which tile a scene
runs is a dimension of the selector's search (``core/mapping``), stored
in its ``ScheduleChoice.tile``.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.core.scene import ConvScene, dtype_itemsize

__all__ = ["vmem_bytes", "kernel_bm", "col_tile", "THREADS", "TILE_ELEMS",
           "KERNEL_BM", "TB11_BM", "RES_BK", "BK_MAX", "TB18_SHAPES",
           "TB18_KC", "tb18_tiles", "tb18_threads", "tb18_smem"]

THREADS = 256
TILE_ELEMS = 4096          # BM * BC = THREADS * 4 * 4
KERNEL_BM = (8, 16, 32, 64, 128)   # compiled m-tile widths
TB11_BM = 64               # TB11's m-tile inside its resident filter
RES_BK = 16                # k chunk of the IN tile TB11 stages
BK_MAX = 32                # largest k chunk TB88 stages
_COL_TABLE = 3             # int32 (oh, ow, n) per tile column

# TB18's compiled tiles (BM, BC, TM, TC), mirrored by the TB18_SHAPE list
# in csrc/mg3m_conv.cu: at least one for every m-tile of KERNEL_BM, and
# only tiles the selector picks somewhere on the ResNet trunk (buckets
# 1-8, f32 and bf16) or on chip_smoke.py's kernel scenes
TB18_SHAPES = ((32, 64, 8, 4), (32, 128, 8, 4), (32, 256, 8, 4),
               (64, 128, 8, 4), (128, 64, 8, 4),
               (8, 64, 4, 2), (8, 128, 4, 2), (16, 64, 4, 2),
               (16, 128, 4, 2), (32, 64, 4, 2))
TB18_KC = 32               # k chunk of TB18's double-buffered IN tile


def _round16(nbytes: int) -> int:
    """The kernels start the f32 tiles on a 16-byte boundary after the
    resident filter."""
    return -(-nbytes // 16) * 16


def kernel_bm(bm: int) -> int:
    """The compiled m-tile width that runs a runtime ``bm``: the smallest
    of ``KERNEL_BM`` that holds it (rows past ``bm`` are masked)."""
    for t in KERNEL_BM:
        if bm <= t:
            return t
    raise ValueError(f"m-tile {bm} exceeds the largest compiled tile "
                     f"{KERNEL_BM[-1]}")


def col_tile(bm: int) -> int:
    """Columns (output pixel x batch) of one TB11/TB88 block tile at
    m-tile ``bm``."""
    return TILE_ELEMS // kernel_bm(bm)


def tb18_tiles(bm: int) -> Tuple[Tuple[int, int, int, int], ...]:
    """TB18's compiled tiles that run a slice ``bm`` wide."""
    return tuple(t for t in TB18_SHAPES if t[0] == kernel_bm(bm))


def tb18_threads(tile) -> int:
    """Threads of the TB18 block of compiled tile ``(BM, BC, TM, TC)``."""
    bm, bc, tm, tc = tile
    return bm // tm * (bc // tc)


def tb18_smem(scene: ConvScene, tile) -> int:
    """Dynamic shared-memory bytes of one TB18 block of compiled tile
    ``(BM, BC, TM, TC)`` (see the module docstring)."""
    it = dtype_itemsize(scene.dtype)
    taps = scene.fltH * scene.fltW
    kp = -(-scene.K // 8) * 8
    bc = tile[1]
    return (_round16(taps * kp * tile[0] * it)
            + 2 * bc * (TB18_KC * it + 16) + 4 * taps * bc)


def vmem_bytes(scene: ConvScene, schedule: str, bm: int, bn: int,
               bk: int, tile: Tuple[int, ...] = ()) -> int:
    """Dynamic shared-memory bytes one block of ``schedule`` stages at
    blocking ``(bm, bn, bk)`` over ``scene`` (the name mirrors the
    reference's VMEM formula; on Hopper the budget is shared memory).
    ``bn`` does not enter: a tile's columns span pixels and batch
    together.  TB18 also needs its compiled ``tile``.  Raises
    ``ValueError`` on an unknown schedule, an m-tile beyond the compiled
    ones or a TB18 tile that does not run ``bm``."""
    del bn
    it = dtype_itemsize(scene.dtype)
    taps = scene.fltH * scene.fltW
    if schedule == "TB11":
        bc = col_tile(TB11_BM)
        return (_round16(taps * scene.K * scene.M * it)
                + 4 * (RES_BK * bc + _COL_TABLE * bc))
    if schedule == "TB18":
        if tuple(tile) not in tb18_tiles(bm):
            raise ValueError(f"TB18 tile {tile} is not a compiled tile "
                             f"for a slice of {bm}: {tb18_tiles(bm)}")
        return tb18_smem(scene, tile)
    if schedule == "TB88":
        bc = col_tile(bm)
        return 4 * (bk * kernel_bm(bm) + bk * bc + _COL_TABLE * bc)
    raise ValueError(f"unknown schedule {schedule!r}")
