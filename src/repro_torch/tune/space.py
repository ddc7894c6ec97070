"""Search-space enumeration for the selector and the autotuner (port of
``repro.tune.space``): ``block_candidates``, ``enumerate_space`` and the
autotuner's pruning stage ``ranked_space``.

The candidates are the tile shapes the port's CUDA kernels are compiled
for, not the reference's 128/256/512 TPU ladders (those do not fit
227 KB of shared memory):

  TB11  a single point — the whole filter resident.
  TB18  OC-slice widths from the compiled m-tiles below OC, plus OC
        itself when one slice can hold it.
  TB88  the compiled tiles' m-tiles, clipped to the scene; ``bn`` is the
        whole batch (a tile's columns span pixels and batch together).
        The kernel walks its reduction in chunks of its own, so ``bk``
        only pads K in the plan (as in the reference, it must divide the
        launched K): one ``bk`` per m-tile, the one of 8/16/32 (clipped to
        K) that pads K least.

Each block runs on any compiled tile of its grain that holds it
(``tile_candidates``).

Dilated scenes enumerate the same space: the blocks depend only on the
MM_unit dims (M, N, K), which dilation never changes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis.footprint import (KERNEL_BM, TB88_SHAPES, tiles,
                                            vmem_bytes)
from repro_torch.core import mapping
from repro_torch.core.mapping import SCHEDULES, SMEM_BUDGET, ScheduleChoice
from repro_torch.core.scene import ConvScene, round_up

_TB88_BM = tuple(sorted({t[0] for t in TB88_SHAPES}))
_TB88_BK = (8, 16, 32)


@dataclasses.dataclass(frozen=True)
class CandidatePoint:
    """One point of the search space."""

    schedule: str
    bm: int
    bn: int
    bk: int
    tile: Tuple[int, ...] = ()

    def key(self) -> Tuple:
        return (self.schedule, self.bm, self.bn, self.bk, self.tile)


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
    bk = min((min(b, k) for b in _TB88_BK),
             key=lambda b: (round_up(k, b), -b))
    return tuple(dict.fromkeys((min(bm, m), n, bk) for bm in _TB88_BM))


def tile_candidates(schedule: str, bm: int) -> Tuple[Tuple[int, ...], ...]:
    """The compiled tiles (``footprint.TB11_SHAPES`` / ``TB18_SHAPES`` /
    ``TB88_SHAPES``) a ``bm``-wide block of ``schedule`` may run on."""
    return tiles(schedule, bm)


def enumerate_space(scene: ConvScene,
                    schedules: Sequence[str] = SCHEDULES,
                    vmem_budget: int = SMEM_BUDGET
                    ) -> Tuple[CandidatePoint, ...]:
    """All feasible points: kernel tiles whose shared memory fits."""
    points = []
    for schedule in schedules:
        for bm, bn, bk in block_candidates(scene, schedule):
            for tile in tile_candidates(schedule, bm):
                if vmem_bytes(scene, schedule, bm, bn, bk,
                              tile) <= vmem_budget:
                    points.append(CandidatePoint(schedule, bm, bn, bk,
                                                 tile))
    return tuple(points)


def ranked_space(scene: ConvScene,
                 schedules: Sequence[str] = SCHEDULES,
                 top_k: Optional[int] = None,
                 model: Optional[mapping.CostModel] = None,
                 budget: int = SMEM_BUDGET) -> List[ScheduleChoice]:
    """Feasible points scored by the cost model, best-predicted first (ties
    in enumeration order, so the head is ``select_schedule``'s pick).

    The autotuner's pruning stage: the model (or a calibrated ``model``)
    orders the space, measurement decides among the ``top_k`` survivors.
    Where no point fits ``budget`` it raises ``ValueError``, as
    ``select_schedule`` does: a restricted space never substitutes another
    grain, and the port's kernels have no smaller tiles to fall back to.
    """
    scored = []
    for pt in enumerate_space(scene, schedules, budget):
        choice = mapping._score(scene, pt.schedule, pt.bm, pt.bn, pt.bk,
                                model, budget, pt.tile)
        if choice is not None:
            scored.append(choice)
    if not scored:
        raise ValueError(
            f"schedule(s) {tuple(schedules)} have no feasible blocking "
            f"within {budget} B of shared memory for {scene.describe()}")
    scored.sort(key=lambda c: c.predicted_s)
    return scored[:top_k] if top_k else scored
