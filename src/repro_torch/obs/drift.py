"""Cost-model drift monitor — the always-on calibration audit.

``scripts/calibrate.py`` fits the cost model from tune-cache records once;
nothing today notices when reality moves afterwards (new backend, thermal
throttling, a kernel change that invalidates the fitted constants).  This
module streams (predicted, measured) pairs — from tuner measurements and
from timed plan executions in the serving layer — into per-scene-class
EWMAs of relative error and flags classes whose error exceeds a threshold:
the signal that a re-fit (or a re-tune) is due, *before* the selector
quietly starts ranking schedules on a stale model.

Scene classes reuse calibration's bucketing (``mapping.class_key``:
schedule x bound-type x arithmetic-intensity band), so a flagged class maps
one-to-one onto the correction entry ``scripts/calibrate.py`` would refit.

Non-finite or non-positive pairs (timed-out measurements score ``inf``) are
*dropped and counted*, never averaged — the same poisoning the tuner's
mean-error reporting had to learn to exclude.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricRegistry, default_metrics

# EWMA weight of the newest observation; 0.2 ≈ a ~10-sample memory.
DEFAULT_ALPHA = 0.2
# Relative-error level that flags a class.  Calibration typically lands
# median |pred-meas|/meas well under 0.5; sustained error above it means
# the fitted constants no longer describe the machine.
DEFAULT_THRESHOLD = 0.5
# A class is only flaggable once its EWMA has seen this many samples —
# one noisy measurement must not page anyone.
DEFAULT_MIN_SAMPLES = 5


def scene_class(scene, choice) -> str:
    """Drift bucket for one (scene, schedule choice): calibration's
    ``class_key`` on the executed scene — flagged classes name the exact
    correction entry a re-fit would replace."""
    from repro_torch.core.mapping import ai_band, class_key  # late: keep obs light
    return class_key(choice.schedule, choice.bound,
                     ai_band(scene.arithmetic_intensity))


@dataclasses.dataclass(frozen=True)
class DriftStat:
    """Per-class drift state at snapshot time."""

    cls: str
    n: int                  # accepted observations
    ewma_err: float         # EWMA of |measured - predicted| / measured
    last_err: float
    last_predicted_s: float
    last_measured_s: float
    flagged: bool


class DriftMonitor:
    """Streaming per-scene-class EWMA of cost-model relative error."""

    def __init__(self, *, alpha: float = DEFAULT_ALPHA,
                 threshold: float = DEFAULT_THRESHOLD,
                 min_samples: int = DEFAULT_MIN_SAMPLES,
                 metrics: Optional[MetricRegistry] = None):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if threshold <= 0:
            raise ValueError(f"threshold must be positive, got {threshold}")
        self.alpha = alpha
        self.threshold = threshold
        self.min_samples = min_samples
        self._lock = threading.Lock()
        self._stats: Dict[str, DriftStat] = {}
        m = metrics if metrics is not None else default_metrics()
        self._c_obs = m.counter("repro.drift.observations")
        self._c_dropped = m.counter("repro.drift.dropped")
        self._g_flagged = m.gauge("repro.drift.flagged_classes")

    def observe(self, cls: str, predicted_s: float,
                measured_s: float) -> Optional[float]:
        """Stream one (predicted, measured) second-pair into class ``cls``;
        returns the relative error, or None when the pair was dropped
        (non-finite / non-positive — timed-out measurements score inf and
        must not poison the EWMA)."""
        if (not math.isfinite(predicted_s) or not math.isfinite(measured_s)
                or predicted_s < 0 or measured_s <= 0):
            self._c_dropped.inc()
            return None
        err = abs(measured_s - predicted_s) / measured_s
        with self._lock:
            prev = self._stats.get(cls)
            if prev is None:
                n, ewma = 1, err
            else:
                n = prev.n + 1
                ewma = self.alpha * err + (1.0 - self.alpha) * prev.ewma_err
            self._stats[cls] = DriftStat(
                cls=cls, n=n, ewma_err=ewma, last_err=err,
                last_predicted_s=predicted_s, last_measured_s=measured_s,
                flagged=(n >= self.min_samples and ewma > self.threshold))
            flagged = sum(1 for s in self._stats.values() if s.flagged)
        self._c_obs.inc()
        self._g_flagged.set(flagged)
        return err

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict[str, DriftStat]:
        with self._lock:
            return dict(self._stats)

    def flagged(self) -> List[str]:
        """Classes whose EWMA error currently exceeds the threshold."""
        with self._lock:
            return sorted(c for c, s in self._stats.items() if s.flagged)

    def snapshot(self) -> Dict:
        """JSON-serializable view (``obsreport`` consumes this via
        ``MetricRegistry.dump(extra={"drift": ...})``)."""
        with self._lock:
            return {
                "threshold": self.threshold,
                "alpha": self.alpha,
                "min_samples": self.min_samples,
                "classes": {
                    c: {"n": s.n, "ewma_err": s.ewma_err,
                        "last_err": s.last_err,
                        "last_predicted_s": s.last_predicted_s,
                        "last_measured_s": s.last_measured_s,
                        "flagged": s.flagged}
                    for c, s in sorted(self._stats.items())},
            }

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()
        self._g_flagged.set(0)


# -- process-global default monitor ------------------------------------------
_default: Optional[DriftMonitor] = None
_default_lock = threading.Lock()


def default_monitor() -> DriftMonitor:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = DriftMonitor()
    return _default


def set_default_monitor(monitor: Optional[DriftMonitor]) -> None:
    """Install (or with None, reset) the process-global monitor — tests."""
    global _default
    _default = monitor
