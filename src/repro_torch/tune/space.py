"""Search-space enumeration (port of ``repro.tune.space``, the part the
selector needs: ``block_candidates`` and ``enumerate_space``).

The candidates are the tile shapes the port's CUDA kernels are compiled
for, not the reference's 128/256/512 TPU ladders (those do not fit
227 KB of shared memory):

  TB11  a single point — the whole filter resident.
  TB18  OC-slice widths from the compiled m-tiles below OC, plus OC
        itself when one slice can hold it.
  TB88  compiled m-tiles of 16..128 x k chunks of 8/16/32, clipped to the
        scene; ``bn`` is the whole batch (a tile's columns span pixels
        and batch together).

Dilated scenes enumerate the same space: the blocks depend only on the
MM_unit dims (M, N, K), which dilation never changes.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from repro_torch.analysis.footprint import BK_MAX, KERNEL_BM, vmem_bytes
from repro_torch.core.mapping import SCHEDULES, SMEM_BUDGET
from repro_torch.core.scene import ConvScene

_TB88_BM = tuple(b for b in KERNEL_BM if b >= 16)
_TB88_BK = tuple(b for b in (8, 16, 32) if b <= BK_MAX)


@dataclasses.dataclass(frozen=True)
class CandidatePoint:
    """One point of the search space."""

    schedule: str
    bm: int
    bn: int
    bk: int

    def key(self) -> Tuple[str, int, int, int]:
        return (self.schedule, self.bm, self.bn, self.bk)


def block_candidates(scene: ConvScene, schedule: str
                     ) -> Tuple[Tuple[int, int, int], ...]:
    """Kernel-tile (bm, bn, bk) candidates for one schedule, deduped but
    not budget-filtered (``mapping._score`` rejects over-budget points)."""
    m, n, k = scene.M, scene.N, scene.K
    if schedule == "TB11":
        return ((m, n, k),)
    if schedule == "TB18":
        cands = [(bm, n, k) for bm in KERNEL_BM if bm < m]
        if m <= KERNEL_BM[-1]:
            cands.append((m, n, k))
        return tuple(dict.fromkeys(cands))
    if schedule != "TB88":
        raise ValueError(f"unknown schedule {schedule!r}")
    return tuple(dict.fromkeys((min(bm, m), n, min(bk, k))
                               for bm in _TB88_BM for bk in _TB88_BK))


def enumerate_space(scene: ConvScene,
                    schedules: Sequence[str] = SCHEDULES,
                    vmem_budget: int = SMEM_BUDGET
                    ) -> Tuple[CandidatePoint, ...]:
    """All feasible points: kernel tiles whose shared memory fits."""
    points = []
    for schedule in schedules:
        for bm, bn, bk in block_candidates(scene, schedule):
            if vmem_bytes(scene, schedule, bm, bn, bk) <= vmem_budget:
                points.append(CandidatePoint(schedule, bm, bn, bk))
    return tuple(points)
