"""Thread-safe metric registry — the measurement substrate of the stack.

MG3MConv's thesis is that efficiency is won by *measuring* (the paper's
84.78% peak comes from auditing every scheme choice); the serving/tuning
stack earns the same discipline.  A ``MetricRegistry`` holds three metric
kinds under a stable ``repro.<subsystem>.<name>`` naming scheme:

  counter    monotone float (requests served, cache hits, hook errors);
  gauge      last-write-wins level (queue depth);
  histogram  fixed-bucket distribution with p50/p90/p99 summaries
             (queue wait, dispatch wall-clock) — observation is O(log B)
             bucket search + two adds, no per-sample allocation.

Semantics the rest of the stack builds on:

  snapshot   ``snapshot()`` returns a plain JSON-serializable dict — the
             unit of persistence (``dump``) and of windowing;
  delta      ``snapshot_delta(before, after)`` subtracts counters and
             histogram buckets so callers report *windows* (a timed burst,
             one benchmark regime) instead of lifetime aggregates — this
             replaces the manual before/after arithmetic ``PlanRegistry``
             and ``ConvServer`` stats consumers used to do;
  reset      zeroes values but keeps registrations.

Each subsystem instance that needs isolated stats (a ``PlanRegistry``, a
``ConvServer``) owns its own ``MetricRegistry``; module-level code with no
instance (plan builds, tune measurement, cache I/O) records into the
process-global ``default_metrics()``.
"""
from __future__ import annotations

import bisect
import json
import math
import os
import re
import tempfile
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-z0-9_]+(\.[a-z0-9_]+)+$")

# Exponential wall-time buckets: 1 µs .. 100 s in 1/2.5/5 decade steps.
# Wide enough for CPU plain versions and on-card dispatch alike.
DEFAULT_TIME_BUCKETS_S: Tuple[float, ...] = tuple(
    m * (10.0 ** e) for e in range(-6, 3) for m in (1.0, 2.5, 5.0))

# Small-integer buckets (requests coalesced per dispatch, lanes, ...).
DEFAULT_COUNT_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)

# Unit-interval buckets (occupancy, zero-lane fraction).
DEFAULT_RATIO_BUCKETS: Tuple[float, ...] = tuple(
    round(0.05 * i, 2) for i in range(1, 21))


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} does not follow the dotted "
            f"'repro.<subsystem>.<name>' scheme (lowercase, digits, _)")
    return name


class Counter:
    """Monotone counter.  ``inc`` is a lock-guarded add — correct under any
    number of threads, cheap enough for every hot path we instrument."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def _snapshot(self) -> Dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _reset(self) -> None:
        self.set(0.0)

    def _snapshot(self) -> Dict:
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed-bucket histogram: ``bounds`` are inclusive upper bucket edges,
    plus an implicit overflow bucket, so ``counts`` has ``len(bounds) + 1``
    cells.  Percentiles are estimated by linear interpolation inside the
    covering bucket (the overflow bucket reports the observed max) — exact
    enough for p50/p90/p99 reporting, constant memory always."""

    __slots__ = ("name", "bounds", "_counts", "_count", "_sum", "_min",
                 "_max", "_lock")

    def __init__(self, name: str,
                 bounds: Sequence[float] = DEFAULT_TIME_BUCKETS_S):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram {name}: bounds must be a sorted, "
                             f"non-empty sequence")
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        if not math.isfinite(v):
            return  # non-finite samples would poison sum/percentiles
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.bounds) + 1)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def _snapshot(self) -> Dict:
        with self._lock:
            snap = {
                "type": "histogram",
                "count": self._count,
                "sum": self._sum,
                "min": self._min if self._count else 0.0,
                "max": self._max if self._count else 0.0,
                "bounds": list(self.bounds),
                "counts": list(self._counts),
            }
        return summarize_histogram(snap)

    def percentile(self, q: float) -> float:
        return histogram_percentile(self._snapshot(), q)


# --------------------------------------------------------------------------
# snapshot math — module functions so obsreport can run them on loaded JSON
# --------------------------------------------------------------------------
def histogram_percentile(snap: Dict, q: float) -> float:
    """Estimate the ``q``-quantile (0..1) of a histogram snapshot entry by
    linear interpolation inside the covering bucket, clamped to the observed
    [min, max] (interpolation across a wide bucket must not report a tail
    beyond any sample actually seen)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    count = snap.get("count", 0)
    if not count:
        return 0.0
    bounds, counts = snap["bounds"], snap["counts"]
    lo_obs = float(snap.get("min", 0.0))
    hi_obs = float(snap.get("max", bounds[-1]))
    clamp = lambda v: min(max(v, lo_obs), hi_obs)
    target = q * count
    cum = 0.0
    for i, c in enumerate(counts):
        if cum + c >= target and c:
            if i == len(bounds):           # overflow bucket: no upper edge
                return hi_obs
            lo = bounds[i - 1] if i else min(lo_obs, bounds[i])
            frac = (target - cum) / c
            return clamp(lo + (bounds[i] - lo) * frac)
        cum += c
    return hi_obs


def summarize_histogram(snap: Dict) -> Dict:
    """Attach mean/p50/p90/p99 to a histogram snapshot entry (idempotent)."""
    count = snap.get("count", 0)
    snap["mean"] = (snap["sum"] / count) if count else 0.0
    for label, q in (("p50", 0.5), ("p90", 0.9), ("p99", 0.99)):
        snap[label] = histogram_percentile(snap, q)
    return snap


def snapshot_value(snap: Dict, name: str, default: float = 0.0) -> float:
    """Counter/gauge value (or histogram count) of one metric in a snapshot."""
    entry = snap.get(name)
    if entry is None:
        return default
    if entry["type"] == "histogram":
        return float(entry["count"])
    return float(entry["value"])


def snapshot_delta(before: Dict, after: Dict) -> Dict:
    """Windowed view ``after - before``: counters and histogram buckets
    subtract; gauges keep the ``after`` level (a level has no meaningful
    difference); metrics absent from ``before`` count from zero.  Histogram
    min/max are carried from ``after`` (lifetime extremes — a bucket
    histogram cannot recover windowed extremes), which only affects the
    overflow-bucket tail estimate."""
    out: Dict[str, Dict] = {}
    for name, a in after.items():
        b = before.get(name)
        if a["type"] == "counter":
            base = b["value"] if b and b["type"] == "counter" else 0.0
            out[name] = {"type": "counter",
                         "value": max(a["value"] - base, 0.0)}
        elif a["type"] == "gauge":
            out[name] = dict(a)
        else:
            if b and b["type"] == "histogram" and b["bounds"] == a["bounds"]:
                counts = [max(x - y, 0) for x, y in zip(a["counts"],
                                                        b["counts"])]
                d = {"type": "histogram",
                     "count": max(a["count"] - b["count"], 0),
                     "sum": a["sum"] - b["sum"],
                     "min": a["min"], "max": a["max"],
                     "bounds": list(a["bounds"]), "counts": counts}
            else:
                d = {k: (list(v) if isinstance(v, list) else v)
                     for k, v in a.items()}
            out[name] = summarize_histogram(d)
    return out


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------
class MetricRegistry:
    """Thread-safe name -> metric map with get-or-create accessors.

    A name is permanently typed by its first registration: asking for the
    same name as a different kind raises instead of silently shadowing —
    two subsystems colliding on a name is a bug worth failing loudly on.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, kind, *args):
        _check_name(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = kind(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, Gauge)

    def histogram(self, name: str,
                  bounds: Sequence[float] = DEFAULT_TIME_BUCKETS_S
                  ) -> Histogram:
        h = self._get_or_create(name, Histogram, bounds)
        if h.bounds != tuple(float(b) for b in bounds):
            raise ValueError(
                f"histogram {name!r} already registered with different "
                f"bounds")
        return h

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def value(self, name: str, default: float = 0.0) -> float:
        """Current counter/gauge value (histogram: observation count)."""
        with self._lock:
            m = self._metrics.get(name)
        if m is None:
            return default
        return float(m.count if isinstance(m, Histogram) else m.value)

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-serializable point-in-time view of every metric."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m._snapshot() for m in metrics}

    def reset(self) -> None:
        """Zero every metric, keeping registrations (and histogram bounds)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()

    def dump(self, path: str, *, extra: Optional[Dict] = None) -> str:
        """Write the snapshot as a versioned JSON artifact (atomic
        tmp+rename, the repo's artifact convention).  ``extra`` carries
        sibling payloads — e.g. a drift-monitor snapshot — under their own
        top-level keys; ``scripts/obsreport.py`` reads this format."""
        p = os.path.abspath(os.path.expanduser(path))
        doc = {"kind": "repro-obs", "schema": 1,
               "metrics": self.snapshot()}
        if extra:
            doc.update(extra)
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p) or ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, p)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return p


# -- process-global default (module-level instrumentation records here) ------
_default: Optional[MetricRegistry] = None
_default_lock = threading.Lock()


def default_metrics() -> MetricRegistry:
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = MetricRegistry()
    return _default


def set_default_metrics(registry: Optional[MetricRegistry]) -> None:
    """Install (or with None, reset) the process-global registry — tests."""
    global _default
    _default = registry
