"""Render an observability artifact as a human (or machine) report.

Port of ``scripts/obsreport.py``: the same reports from the same
artifacts, which the port's ``obs/`` writes in the reference's formats.

Reads either artifact the obs layer writes and prints what an operator asks
of the serving/tuning stack first — latency quantiles, occupancy, padding
waste, cost-model drift:

  metrics dump   ``MetricRegistry.dump(path)`` JSON ({"kind": "repro-obs"}),
                 optionally carrying a drift-monitor snapshot under "drift";
  trace export   ``Tracer.export(path)`` Chrome trace-event JSON
                 ({"traceEvents": [...]}) — per-span-name duration stats.

Usage:

    python -m repro_torch.launch.obsreport metrics.json
    python -m repro_torch.launch.obsreport trace.json --json

``--json`` emits the computed report as one JSON document instead of text
(the same numbers, for CI assertions and dashboards).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import summarize_histogram


# --------------------------------------------------------------------------
# metrics-dump report
# --------------------------------------------------------------------------
def _fmt_s(v: float) -> str:
    """Seconds, scaled to a readable unit."""
    if v >= 1.0:
        return f"{v:.2f}s"
    if v >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.1f}us"


def metrics_report(doc: Dict) -> Dict:
    """Structured report from a ``repro-obs`` metrics dump."""
    metrics = doc.get("metrics", {})
    by_kind: Dict[str, Dict] = {"counter": {}, "gauge": {}, "histogram": {}}
    for name, entry in sorted(metrics.items()):
        kind = entry.get("type")
        if kind == "histogram":
            h = summarize_histogram(dict(entry))
            by_kind["histogram"][name] = {
                "count": h["count"], "mean": h["mean"], "p50": h["p50"],
                "p90": h["p90"], "p99": h["p99"],
                "min": h["min"], "max": h["max"]}
        elif kind in by_kind:
            by_kind[kind][name] = entry["value"]
    report: Dict = {"kind": "metrics", "counters": by_kind["counter"],
                    "gauges": by_kind["gauge"],
                    "histograms": by_kind["histogram"]}

    # serving derivations: the questions stats() answers, from raw counters
    c = by_kind["counter"]
    lanes = c.get("repro.serve.bucket_lanes", 0.0)
    occupied = c.get("repro.serve.occupied_lanes", 0.0)
    if lanes:
        occ = occupied / lanes
        report["serving"] = {
            "requests": c.get("repro.serve.requests", 0.0),
            "dispatches": c.get("repro.serve.dispatches", 0.0),
            "occupancy": occ,
            "pad_waste_pct": 100.0 * (1.0 - occ),
            "hook_errors": c.get("repro.serve.dispatch_hook_errors", 0.0),
        }

    # scheduler SLO derivations (serve/sched.py): deadline health, shed
    # pressure, flush-reason mix, and the latency quantiles an operator
    # reads before reaching for a raw Perfetto trace
    h = by_kind["histogram"]
    if any(k in c for k in ("repro.serve.deadline_requests",
                            "repro.serve.shed_total",
                            "repro.serve.deadline_flushes")):
        dl = c.get("repro.serve.deadline_requests", 0.0)
        misses = c.get("repro.serve.deadline_misses", 0.0)
        slo: Dict = {
            "deadline_requests": dl,
            "deadline_misses": misses,
            "deadline_miss_rate": misses / dl if dl else 0.0,
            "shed_total": c.get("repro.serve.shed_total", 0.0),
            "flushes": {
                "deadline": c.get("repro.serve.deadline_flushes", 0.0),
                "occupancy": c.get("repro.serve.occupancy_flushes", 0.0),
                "gather_timeout": c.get(
                    "repro.serve.gather_timeout_flushes", 0.0),
            },
        }
        for label, name in (("queue_wait", "repro.serve.queue_wait_s"),
                            ("dispatch", "repro.serve.dispatch_s"),
                            ("layer_dispatch",
                             "repro.serve.layer_dispatch_s"),
                            ("deadline_slack",
                             "repro.serve.deadline_slack_s")):
            if name in h:
                slo[label] = h[name]
        report["slo"] = slo

    drift = doc.get("drift")
    if drift:
        classes = drift.get("classes", {})
        report["drift"] = {
            "threshold": drift.get("threshold"),
            "classes": classes,
            "flagged": sorted(cl for cl, s in classes.items()
                              if s.get("flagged")),
        }
    return report


def print_metrics_report(report: Dict) -> None:
    if report["counters"]:
        print("== counters ==")
        for name, v in report["counters"].items():
            print(f"  {name:<42} {v:.0f}")
    if report["gauges"]:
        print("== gauges ==")
        for name, v in report["gauges"].items():
            print(f"  {name:<42} {v:g}")
    if report["histograms"]:
        print("== histograms ==")
        for name, h in report["histograms"].items():
            unit = _fmt_s if name.endswith("_s") else lambda v: f"{v:.3g}"
            print(f"  {name:<42} n={h['count']:<6.0f} "
                  f"mean={unit(h['mean'])} p50={unit(h['p50'])} "
                  f"p90={unit(h['p90'])} p99={unit(h['p99'])} "
                  f"max={unit(h['max'])}")
    if "serving" in report:
        s = report["serving"]
        print("== serving ==")
        print(f"  requests={s['requests']:.0f} "
              f"dispatches={s['dispatches']:.0f} "
              f"occupancy={s['occupancy']:.3f} "
              f"pad_waste={s['pad_waste_pct']:.1f}% "
              f"hook_errors={s['hook_errors']:.0f}")
    if "slo" in report:
        s = report["slo"]
        fl = s["flushes"]
        print("== slo (scheduler) ==")
        print(f"  deadline_requests={s['deadline_requests']:.0f} "
              f"misses={s['deadline_misses']:.0f} "
              f"miss_rate={s['deadline_miss_rate']:.3f} "
              f"shed={s['shed_total']:.0f}")
        print(f"  flushes: deadline={fl['deadline']:.0f} "
              f"occupancy={fl['occupancy']:.0f} "
              f"gather_timeout={fl['gather_timeout']:.0f}")
        for label in ("queue_wait", "dispatch", "layer_dispatch",
                      "deadline_slack"):
            if label in s:
                q = s[label]
                print(f"  {label:<16} n={q['count']:<6.0f} "
                      f"p50={_fmt_s(q['p50'])} p99={_fmt_s(q['p99'])}")
    if "drift" in report:
        d = report["drift"]
        print(f"== drift (threshold={d['threshold']}) ==")
        for cl, s in sorted(d["classes"].items()):
            flag = "  << FLAGGED" if s.get("flagged") else ""
            print(f"  {cl:<42} n={s['n']:<5} ewma_err={s['ewma_err']:.3f} "
                  f"last_err={s['last_err']:.3f}{flag}")
        if not d["classes"]:
            print("  (no observations)")


# --------------------------------------------------------------------------
# trace-export report
# --------------------------------------------------------------------------
def _percentile(sorted_vals: List[float], q: float) -> float:
    """Exact nearest-rank percentile over raw per-span durations."""
    if not sorted_vals:
        return 0.0
    i = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[i]


def trace_report(doc: Dict) -> Dict:
    """Per-span-name duration stats from Chrome trace-event JSON."""
    events = [e for e in doc.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    by_name: Dict[str, List[float]] = {}
    span: Tuple[float, float] = (float("inf"), 0.0)
    for e in events:
        by_name.setdefault(e["name"], []).append(e["dur"] * 1e-6)
        span = (min(span[0], e["ts"]), max(span[1], e["ts"] + e["dur"]))
    spans = {}
    for name, durs in sorted(by_name.items()):
        durs.sort()
        spans[name] = {
            "count": len(durs), "total_s": sum(durs),
            "mean_s": sum(durs) / len(durs),
            "p50_s": _percentile(durs, 0.5),
            "p90_s": _percentile(durs, 0.9),
            "p99_s": _percentile(durs, 0.99),
            "max_s": durs[-1]}
    report = {"kind": "trace", "events": len(events),
              "dropped_events": doc.get("otherData", {}).get(
                  "dropped_events", 0),
              "wall_s": (span[1] - span[0]) * 1e-6 if events else 0.0,
              "spans": spans}
    # per-layer breakdown of whole-model pipeline dispatches: the
    # scheduler's metrics histograms aggregate across layers, so the
    # per-layer quantiles live here, keyed off the layer span args
    layers: Dict[str, List[float]] = {}
    for e in events:
        if (e["name"] == "repro.serve.layer_dispatch"
                and e.get("args", {}).get("layer")):
            layers.setdefault(e["args"]["layer"], []).append(e["dur"] * 1e-6)
    if layers:
        per_layer = {}
        for lname, durs in sorted(layers.items()):
            durs.sort()
            per_layer[lname] = {
                "count": len(durs), "mean_s": sum(durs) / len(durs),
                "p50_s": _percentile(durs, 0.5),
                "p99_s": _percentile(durs, 0.99), "max_s": durs[-1]}
        report["layers"] = per_layer
    return report


def print_trace_report(report: Dict) -> None:
    print(f"== trace: {report['events']} spans over "
          f"{_fmt_s(report['wall_s'])} "
          f"(dropped={report['dropped_events']}) ==")
    for name, s in report["spans"].items():
        print(f"  {name:<34} n={s['count']:<6} total={_fmt_s(s['total_s'])} "
              f"mean={_fmt_s(s['mean_s'])} p50={_fmt_s(s['p50_s'])} "
              f"p90={_fmt_s(s['p90_s'])} p99={_fmt_s(s['p99_s'])} "
              f"max={_fmt_s(s['max_s'])}")
    if "layers" in report:
        print("== per-layer dispatch (model sessions) ==")
        for lname, s in report["layers"].items():
            print(f"  {lname:<34} n={s['count']:<6} "
                  f"mean={_fmt_s(s['mean_s'])} p50={_fmt_s(s['p50_s'])} "
                  f"p99={_fmt_s(s['p99_s'])} max={_fmt_s(s['max_s'])}")


# --------------------------------------------------------------------------
# entry
# --------------------------------------------------------------------------
def build_report(doc: Dict) -> Dict:
    """Dispatch on artifact shape: metrics dump vs trace export."""
    if doc.get("kind") == "repro-obs":
        return metrics_report(doc)
    if "traceEvents" in doc:
        return trace_report(doc)
    raise ValueError(
        "unrecognized artifact: expected a MetricRegistry.dump() JSON "
        "(kind='repro-obs') or a Tracer.export() trace (traceEvents)")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.obsreport",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("path", help="metrics dump or exported trace JSON")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    args = ap.parse_args(argv)
    with open(args.path) as f:
        doc = json.load(f)
    try:
        report = build_report(doc)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    elif report["kind"] == "metrics":
        print_metrics_report(report)
    else:
        print_trace_report(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
