"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs the mix's driver, reads the per-layer metrics, and assembles the
result line.

Everything that belongs to one configuration, mix or metric lives in a
file of its own:

    bench/configs/<config>.json     a configuration's layer list
    bench/mixes/<traffic>.json      a traffic mix; its "driver" names
    bench/drivers/<driver>.py       the code that drives that kind of mix
    bench/metrics/<metric>.py       one per-layer metric's reader
    bench/limits/<workload>.json    the limits of a cell's compared numbers

A driver's ``run(ctx)`` returns a ``dict`` with the keys ``setup_s``,
``end_to_end`` (``{metric: value}``), ``attempted``, ``failed``,
``numbers`` (``{name: value}``, each held against the cell's limit),
``memory_peak_bytes``, ``notes`` (lines for standard error) and
``record``, the traced run's record that the readers take their numbers
from.  A reader's ``read(record)`` returns a number, or None where it
finds nothing to read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, Iterator, List, Mapping

from bench import count
from bench.reference import compare

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell's files read, the run's arguments, the
    device, and the clock reading of the process's start."""

    workload: str
    config: Dict
    mix: Dict
    seed: int
    seconds: float
    trace: bool
    device: object           # torch.device
    t_start: float           # time.perf_counter() at process start


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell(spec: Mapping, workload: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return dict(w)
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in spec['workloads']]}")


def import_file(path: Path, name: str):
    """A module from a file that may have dots in its name."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def files(w: Mapping, bench: Path = BENCH) -> Dict[str, Path]:
    """The files a cell is made of."""
    mix = load_json(bench / "mixes" / f"{w['traffic']}.json")
    return {"config": bench / "configs" / f"{w['config']}.json",
            "mix": bench / "mixes" / f"{w['traffic']}.json",
            "driver": bench / "drivers" / f"{mix['driver']}.py",
            "limits": bench / "limits" / f"{w['name']}.json"}


def applies(metric: Mapping, workload: str, spec: Mapping) -> bool:
    """Whether a metric is reported in a cell: its ``workloads`` list, or,
    without one, every cell that reports the end-to-end metric it moves
    (every cell, for an end-to-end metric without the list)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    target = next(m for m in spec["end_to_end"] if m["name"] == moves)
    return applies(target, workload, spec)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods
                   if m.split(".")[0] in FORBIDDEN})


def host_range(name: str, enabled: bool):
    """A ``record_function`` range in traced runs, nothing otherwise."""
    if not enabled:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def conv_ranges(config: Mapping, calls: List, enabled: bool) -> Iterator:
    """Wrap the program's conv entry, ``ConvPlan.execute``, in a
    ``bench.conv/<direction>`` profiler range, and note each call's layer
    (matched against the configuration by geometry, -1 for none), direction
    and batch."""
    if not enabled:
        yield
        return
    import torch
    from repro_torch.plan.build import ConvPlan
    orig = ConvPlan.execute

    def execute(self, a, b):
        direction = self.op.value
        with torch.profiler.record_function(f"bench.conv/{direction}"):
            out = orig(self, a, b)
        sc = self.scene
        geom = {k: getattr(sc, k) for k in ("IC", "OC", "inH", "inW", "fltH",
                                             "fltW", "padH", "padW", "stdH",
                                             "stdW")}
        calls.append((count.match_layer(config, geom), direction,
                      int(a.shape[-1])))
        return out

    ConvPlan.execute = execute
    try:
        yield
    finally:
        ConvPlan.execute = orig


def conv_work(config: Mapping, calls) -> Dict[str, float]:
    """The count's bound and operations over the noted conv calls; calls
    that match no layer of the configuration are counted apart."""
    dtype = config["dtype"]
    bound = flops = 0.0
    unmatched = 0
    for i, direction, batch in calls:
        if i < 0:
            unmatched += 1
            continue
        layer = config["layers"][i]
        bound += count.conv_bound_s(layer, direction, batch, dtype)
        flops += count.conv_flops(layer, batch)
    return {"conv_bound_s": bound, "conv_flops": flops,
            "conv_calls": len(calls), "conv_unmatched": unmatched}


def read_metrics(names: List[str], record: Mapping,
                 bench: Path = BENCH) -> Dict[str, float]:
    out = {}
    for name in names:
        mod = import_file(bench / "metrics" / f"{name}.py",
                          f"bench_metric_{name.replace('.', '_')}")
        value = mod.read(record)
        if value is not None:
            out[name] = value
    return out


def finite(x: float) -> float:
    """JSON has no infinity: an infinite or undefined reading prints as
    1e300."""
    return x if math.isfinite(x) else 1e300


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        t_start: float, root: Path = ROOT) -> Dict:
    """Run one cell and return the result line's object."""
    spec = load_spec(root)
    w = cell(spec, workload)
    bench = root / "bench"
    paths = files(w, bench)
    ctx = Ctx(workload=workload, config=load_json(paths["config"]),
              mix=load_json(paths["mix"]), seed=seed, seconds=seconds,
              trace=trace, device=device, t_start=t_start)
    limits = load_json(paths["limits"])["limits"]
    driver = import_file(paths["driver"], f"bench_driver_{ctx.mix['driver']}")
    out = driver.run(ctx)

    if trace:
        names = [m["name"] for m in spec["per_layer"]
                 if applies(m, workload, spec)]
        units = {m["name"]: m["unit"] for m in spec["per_layer"]}
        values = read_metrics(names, out["record"], bench)
    else:
        names = [m["name"] for m in spec["end_to_end"]
                 if applies(m, workload, spec)]
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        e2e = dict(out["end_to_end"], setup_s=out["setup_s"])
        values = {k: e2e[k] for k in names if k in e2e}
    checks = compare.verdict(out["numbers"], limits)
    correct = compare.passed(checks)

    import torch
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": w["chips"],
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]),
              "metrics": {k: {"value": finite(v), "unit": units[k]}
                          for k, v in values.items()},
              "device": device_info}
    result["notes"] = list(out.get("notes", []))
    if trace:
        rec = out["record"]
        tr = rec.get("trace") or {}
        device_info["busy_s"] = tr.get("busy_s", 0.0)
        device_info["window_s"] = tr.get("window_s", 0.0)
        result["breakdown"] = {"device_ops": tr.get("device_ops", []),
                               "idle_gaps": tr.get("idle_gaps", [])}
        result["notes"].append(
            f"trace: conv ranges {tr.get('conv_ranges')}, calls noted "
            f"{rec.get('conv_calls')} ({rec.get('conv_unmatched')} unmatched)"
            f", conv device s {tr.get('conv_device_s')}, mg3m-named device "
            f"s {tr.get('mg3m_named_s')}, attribution "
            f"{tr.get('conv_attribution')}, count bound s "
            f"{rec.get('conv_bound_s')}")
    result["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def emit(result: Mapping) -> None:
    """Notes and then each compared number beside its limit on standard
    error; the result object as the last line of standard output."""
    for line in result.get("notes", []):
        print(line, file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    body = {k: v for k, v in result.items() if k != "notes"}
    print(json.dumps(body), flush=True)
