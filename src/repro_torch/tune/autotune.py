"""Autotune orchestration: analytic pruning -> measurement -> cached pick
(port of ``repro.tune.autotune``).

Per scene:

  1. ``space.ranked_space`` enumerates every feasible (schedule, blocks,
     compiled tile) point within the device's shared memory and ranks it
     with the analytic model (the pruner);
  2. the top-k survivors are timed through the real plan dispatch
     (``measure.measure_choice``: device time on the card), optionally on
     a capped proxy scene;
  3. the measured winner is recorded as a ``TunedChoice`` beside the
     analytic model's favorite, its measured time and the model's
     prediction error, so every tuning run is also an audit of the model.

On a proxy, each candidate is measured as the execution the plan would
launch there: blocks clipped to the proxy's dims, and the tile kept where
it is compiled for the clipped m-tile, else the grain's first tile that
is (a clipped block may fit a smaller compiled m-tile).  Candidates that
clip to the same execution are measured once.  On an exact scene the
clipping is the identity.

``resolve_schedule`` is the hot-path entry behind ``policy="tuned"``:
cache hit -> cached choice, miss -> selection under the active
(calibrated, when an artifact exists) cost model.  It never measures.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.footprint import tiles
from repro_torch.core import mapping
from repro_torch.core.mapping import (ScheduleChoice, select_schedule,
                                      smem_budget)
from repro_torch.core.scene import ConvScene
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.obs import drift as drift_mod
from repro_torch.obs.metrics import default_metrics
from repro_torch.obs.trace import default_tracer
from repro_torch.tune import cache as cache_mod
from repro_torch.tune import measure as measure_mod
from repro_torch.tune import space as space_mod

MeasureFn = Callable[[ConvScene, ScheduleChoice], float]


def error_summary(errors: List[float]) -> Dict[str, float]:
    """Aggregate prediction errors with non-finite rows (an all-failing
    tune) excluded from ``mean``/``max`` and counted instead."""
    finite = [e for e in errors if math.isfinite(e)]
    return {
        "n": len(errors),
        "n_finite": len(finite),
        "n_nonfinite": len(errors) - len(finite),
        "mean": sum(finite) / len(finite) if finite else float("nan"),
        "max": max(finite) if finite else float("nan"),
    }


@dataclasses.dataclass(frozen=True)
class TunedChoice:
    """Outcome of tuning one scene."""

    choice: ScheduleChoice         # measured winner (full-scene blocks)
    measured_us: float             # winner's median time
    analytic_schedule: str         # what the analytic model alone picks
    analytic_predicted_us: float   # its prediction (measurement scene)
    analytic_measured_us: float    # its measured time (measurement scene)
    prediction_error: float        # |measured - predicted| / measured, winner
    n_candidates: int              # how many executions were timed
    backend: str                   # cache-key backend tag
    proxy: Optional[Dict] = None   # caps used for measurement, None = exact

    @property
    def agrees_with_analytic(self) -> bool:
        return self.choice.schedule == self.analytic_schedule

    def to_record(self) -> Dict:
        d = dataclasses.asdict(self)
        d["choice"] = cache_mod.choice_to_dict(self.choice)
        return d

    @classmethod
    def from_record(cls, rec: Dict) -> "TunedChoice":
        d = dict(rec)
        d["choice"] = cache_mod.choice_from_dict(rec["choice"])
        return cls(**d)


def clip_choice(scene: ConvScene, choice: ScheduleChoice
                ) -> Tuple[str, int, int, int, Tuple[int, ...]]:
    """``(schedule, bm, bn, bk, tile)`` that a plan of ``choice`` launches
    on ``scene`` (a proxy may be smaller than the scene the choice was
    made for; see the module docstring)."""
    bm = min(choice.bm, scene.M)
    bn, bk = min(choice.bn, scene.N), min(choice.bk, scene.K)
    ok = tiles(choice.schedule, bm)
    tile = tuple(choice.tile) if tuple(choice.tile) in ok else ok[0]
    return choice.schedule, bm, bn, bk, tile


def clipped(scene: ConvScene, choice: ScheduleChoice,
            budget: int = mapping.SMEM_BUDGET) -> ScheduleChoice:
    """``choice`` as its clipped execution on ``scene``, re-scored there
    (uncalibrated); the choice itself where it does not fit."""
    sched, bm, bn, bk, tile = clip_choice(scene, choice)
    scored = mapping._score(scene, sched, bm, bn, bk, budget=budget,
                            tile=tile)
    if scored is None:
        return dataclasses.replace(choice, bm=bm, bn=bn, bk=bk, tile=tile)
    return scored


def _predicted_us(scene: ConvScene, choice: ScheduleChoice) -> float:
    """Analytic prediction for ``choice``'s execution on the measurement
    scene."""
    return clipped(scene, choice).predicted_s * 1e6


def autotune_scene(scene: ConvScene, *,
                   cache: Optional[cache_mod.ScheduleCache] = None,
                   top_k: int = 4, iters: int = 3, warmup: int = 1,
                   device: DeviceSpec = None,
                   timeout_s: float = measure_mod.DEFAULT_TIMEOUT_S,
                   measure_batch: Optional[int] = None,
                   measure_max_ch: Optional[int] = None,
                   measure_max_hw: Optional[int] = None,
                   force: bool = False,
                   measure_fn: Optional[MeasureFn] = None) -> TunedChoice:
    """Tune one scene on ``device`` (default the card); consults and
    updates ``cache`` (default: the process cache).

    ``measure_fn`` replaces the timing harness (tests inject synthetic
    timings); the default times through ``measure.measure_choice``.  A
    tune whose every candidate failed returns the analytic choice and is
    not cached."""
    dev = resolve_device(device)
    cache = cache if cache is not None else cache_mod.default_cache()
    backend = cache_mod.default_backend(dev)
    if not force:
        rec = cache.get(scene, backend)
        if rec is not None:
            return TunedChoice.from_record(rec)

    budget = smem_budget(dev)
    candidates = space_mod.ranked_space(scene, top_k=max(top_k, 1),
                                        budget=budget)
    analytic = select_schedule(scene, budget=budget)

    msc = measure_mod.proxy_scene(scene, measure_batch=measure_batch,
                                  measure_max_ch=measure_max_ch,
                                  measure_max_hw=measure_max_hw)
    proxy = None
    if msc != scene:
        proxy = {"B": msc.B, "IC": msc.IC, "OC": msc.OC,
                 "inH": msc.inH, "inW": msc.inW}
    if measure_fn is None:
        measure_fn = lambda s, c: measure_mod.measure_choice(  # noqa: E731
            s, c, device=dev, iters=iters, warmup=warmup,
            timeout_s=timeout_s)

    # keep the analytically-best representative of each distinct execution
    distinct: Dict = {}
    for c in candidates:
        distinct.setdefault(clip_choice(msc, c), c)
    with default_tracer().span("repro.tune.scene", scene=scene.describe(),
                               backend=backend,
                               n_candidates=len(distinct)):
        timings = [(measure_fn(msc, clipped(msc, c, budget)), c)
                   for c in distinct.values()]
    best_us, best = min(timings, key=lambda t: t[0])
    default_metrics().counter("repro.tune.scenes_tuned").inc()
    if not math.isfinite(best_us):
        default_metrics().counter("repro.tune.tune_failures").inc()
        # no timing at all: the analytic choice, and nothing cached — a
        # poisoned entry would pin the tuned path to a broken point
        return TunedChoice(
            choice=analytic, measured_us=best_us,
            analytic_schedule=analytic.schedule,
            analytic_predicted_us=_predicted_us(msc, analytic),
            analytic_measured_us=best_us,
            prediction_error=float("inf"), n_candidates=len(timings),
            backend=backend, proxy=proxy)

    # the analytic favorite's time: reuse it where its clipped execution
    # was already timed
    analytic_us = next((us for us, c in timings
                        if clip_choice(msc, c) == clip_choice(msc, analytic)),
                       None)
    if analytic_us is None:
        analytic_us = measure_fn(msc, clipped(msc, analytic, budget))

    executed = clipped(msc, best, budget)
    predicted_us = executed.predicted_s * 1e6
    err = abs(best_us - predicted_us) / best_us if best_us > 0 \
        else float("inf")
    # every tuning run is also a drift observation of the winner's class
    drift_mod.default_monitor().observe(
        drift_mod.scene_class(msc, executed), predicted_us * 1e-6,
        best_us * 1e-6)
    tuned = TunedChoice(
        choice=best, measured_us=best_us,
        analytic_schedule=analytic.schedule,
        analytic_predicted_us=_predicted_us(msc, analytic),
        analytic_measured_us=analytic_us,
        prediction_error=err, n_candidates=len(timings),
        backend=backend, proxy=proxy)
    cache.put(scene, tuned.to_record(), backend)
    return tuned


def resolve_schedule(scene: ConvScene, *,
                     cache: Optional[cache_mod.ScheduleCache] = None,
                     device: DeviceSpec = None) -> ScheduleChoice:
    """``policy="tuned"`` resolution on ``device`` (default the card):
    the tuned cache first; on a miss, selection within the device's shared
    memory under the device's active cost model (calibrated when an
    artifact of its backend exists, see ``tune/calibrate.py``).  Never
    measures: the hot path must not block on a tuning run."""
    dev = resolve_device(device)
    cache = cache if cache is not None else cache_mod.default_cache()
    choice = cache.get_choice(scene, cache_mod.default_backend(dev))
    if choice is not None:
        return choice
    from repro_torch.tune import calibrate as calibrate_mod  # import order
    return select_schedule(scene, model=calibrate_mod.active_cost_model(dev),
                           budget=smem_budget(dev))
