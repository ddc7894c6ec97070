"""repro_torch.obs — unified observability: metrics, span tracing, drift.

Copies of ``repro.obs`` (neither ``metrics`` nor ``trace`` touches JAX);
the port keeps its own so it never imports the reference package:

  ``obs.metrics``  thread-safe ``MetricRegistry`` (counters, gauges,
                   fixed-bucket histograms) with snapshot/delta/reset
                   semantics under the ``repro.<subsystem>.<name>`` scheme;
  ``obs.trace``    span tracing (context manager + decorator, per-thread
                   stacks, explicit ``enabled`` gate, subscribable span
                   stream) with Chrome/Perfetto trace-event JSON export;
  ``obs.drift``    cost-model drift monitor — per-scene-class EWMAs over
                   streamed (predicted, measured) pairs.

Instrumented call sites live in ``plan/build.py``, ``plan/registry.py``
and ``serve/conv.py``/``serve/sched.py``.
"""
from repro_torch.obs.drift import (DriftMonitor, DriftStat, default_monitor,
                                   scene_class, set_default_monitor)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricRegistry, default_metrics,
                                     histogram_percentile,
                                     set_default_metrics, snapshot_delta,
                                     snapshot_value, summarize_histogram)
from repro_torch.obs.trace import (Span, Tracer, default_tracer,
                                   set_default_tracer)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "default_metrics",
    "set_default_metrics", "snapshot_delta", "snapshot_value",
    "histogram_percentile", "summarize_histogram",
    "Span", "Tracer", "default_tracer", "set_default_tracer",
    "DriftMonitor", "DriftStat", "default_monitor", "set_default_monitor",
    "scene_class",
]
