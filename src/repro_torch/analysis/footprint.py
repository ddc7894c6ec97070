"""The one shared-memory footprint formula of the port.

Every consumer of "does this blocking fit on-chip memory" answers it here:
``core/mapping._score`` rejects over-budget candidates,
``tune/space.enumerate_space`` filters the search space, and
``kernels/mg3m_conv`` refuses to launch an over-budget blocking.

Unlike the reference (``repro.analysis.footprint``, which models Mosaic's
double-buffered VMEM blocks), this counts exactly what the port's CUDA
kernels (``csrc/mg3m_conv.cu``) stage in dynamic shared memory.  Nothing
is double-buffered yet, so there is no x2:

  TB11  the whole FLT ``[fh, fw, K, M]`` in the IO dtype, plus one f32 IN
        tile ``[RES_BK, BC]`` and the tile's column table;
  TB18  an OC slice ``[fh, fw, K, bm]`` in the IO dtype, plus the same;
  TB88  an f32 FLT tile ``[bk, BM]`` and an f32 IN tile ``[bk, BC]``,
        plus the column table.

The kernel tile geometry lives here too, so the selector, the search space
and the launch wrappers all read one definition of it: a block of
``THREADS`` threads computes a ``BM x BC`` output tile (``BM`` rows of OC,
``BC`` columns of the flattened (output pixel, batch) axis), 4x4 results
per thread, so ``BM * BC == TILE_ELEMS``.
"""
from __future__ import annotations

from repro_torch.core.scene import ConvScene, dtype_itemsize

__all__ = ["vmem_bytes", "kernel_bm", "col_tile", "THREADS", "TILE_ELEMS",
           "KERNEL_BM", "TB11_BM", "RES_BK", "BK_MAX"]

THREADS = 256
TILE_ELEMS = 4096          # BM * BC = THREADS * 4 * 4
KERNEL_BM = (8, 16, 32, 64, 128)   # compiled m-tile widths
TB11_BM = 64               # TB11's m-tile inside its resident filter
RES_BK = 16                # k chunk of the IN tile TB11/TB18 stage
BK_MAX = 32                # largest k chunk TB88 stages
_COL_TABLE = 3             # int32 (oh, ow, n) per tile column


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
    """Columns (output pixel x batch) of one block tile at m-tile ``bm``."""
    return TILE_ELEMS // kernel_bm(bm)


def vmem_bytes(scene: ConvScene, schedule: str, bm: int, bn: int,
               bk: int) -> int:
    """Dynamic shared-memory bytes one block of ``schedule`` stages at
    blocking ``(bm, bn, bk)`` over ``scene`` (the name mirrors the
    reference's VMEM formula; on Hopper the budget is shared memory).
    ``bn`` does not enter: a tile's columns span pixels and batch
    together.  Raises ``ValueError`` on an unknown schedule or an m-tile
    beyond the compiled ones."""
    del bn
    it = dtype_itemsize(scene.dtype)
    taps = scene.fltH * scene.fltW
    if schedule == "TB11":
        bc = col_tile(TB11_BM)
        return (_round16(taps * scene.K * scene.M * it)
                + 4 * (RES_BK * bc + _COL_TABLE * bc))
    if schedule == "TB18":
        bc = col_tile(bm)
        return (_round16(taps * scene.K * bm * it)
                + 4 * (RES_BK * bc + _COL_TABLE * bc))
    if schedule == "TB88":
        bc = col_tile(bm)
        return 4 * (bk * kernel_bm(bm) + bk * bc + _COL_TABLE * bc)
    raise ValueError(f"unknown schedule {schedule!r}")
