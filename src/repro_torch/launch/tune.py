"""Batch-tune CNN scene sets and write the schedule-cache artifact (port of
``scripts/tune.py``).

    python -m repro_torch.launch.tune [--device cpu] --nets vgg --batch 8 \
        --limit 2 [--cache PATH]

On the card drop the proxy caps to tune the exact scenes:

    python -m repro_torch.launch.tune --nets all --batch 8 \
        --measure-batch 0 --measure-max-ch 0 --measure-max-hw 0

Each scene is tuned through ``repro_torch.tune.autotune_scene`` (analytic
top-k pruning, then device time of the real plan dispatch on the card, or
the plain versions' wall time with ``--device cpu``) and the winners land
in the JSON cache (``--cache`` / ``$REPRO_TORCH_TUNE_CACHE`` /
``~/.cache/repro_torch/tune_cache.json``), keyed by the device's backend
tag, where ``policy="tuned"`` plans resolve them.  Measured-vs-predicted
error is reported per scene and summarized.  The flags are the
reference's; ``--device`` (default the card) replaces ``--no-interpret``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.core.mapping import select_schedule, smem_budget
from repro_torch.device import resolve_device
from repro_torch.models.cnn import cnn_scenes
from repro_torch.tune import ScheduleCache, autotune_scene
from repro_torch.tune.autotune import error_summary
from repro_torch.tune.cache import default_backend


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.tune",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--nets", default="vgg",
                    help='comma list of CNNs (see models/cnn.py) or "all"')
    ap.add_argument("--batch", type=int, default=8,
                    help="workload batch size for the scene set")
    ap.add_argument("--limit", type=int, default=0,
                    help="max scenes per net (0 = all)")
    ap.add_argument("--cache", default=None,
                    help="cache artifact path (default: env/home resolution)")
    ap.add_argument("--top-k", type=int, default=4,
                    help="measured candidates after analytic pruning")
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--timeout-s", type=float, default=120.0)
    ap.add_argument("--measure-batch", type=int, default=2,
                    help="proxy cap on B for measurement (0 = exact)")
    ap.add_argument("--measure-max-ch", type=int, default=16,
                    help="proxy cap on IC/OC (0 = exact)")
    ap.add_argument("--measure-max-hw", type=int, default=8,
                    help="proxy cap on inH/inW (0 = exact)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the CUDA kernels' device "
                         "time) or cpu (the plain versions' wall time)")
    ap.add_argument("--force", action="store_true",
                    help="re-measure scenes already in the cache")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    all_scenes = cnn_scenes(args.batch)
    nets = list(all_scenes) if args.nets == "all" else args.nets.split(",")
    unknown = [n for n in nets if n not in all_scenes]
    if unknown:
        print(f"error: unknown net(s) {unknown}; known: {list(all_scenes)}",
              file=sys.stderr)
        return 2
    cache = ScheduleCache(args.cache)
    cap = lambda v: v if v > 0 else None   # noqa: E731
    budget = smem_budget(device)

    errors, disagreements, tuned_total = [], 0, 0
    print(f"# cache: {cache.path} (backend={default_backend(device)})")
    print("scene,analytic,tuned,measured_us,analytic_measured_us,"
          "pred_err,n_cand")
    for net in nets:
        scenes = all_scenes[net]
        if args.limit:
            scenes = scenes[:args.limit]
        for i, sc in enumerate(scenes):
            t = autotune_scene(
                sc, cache=cache, top_k=args.top_k, iters=args.iters,
                warmup=args.warmup, device=device, timeout_s=args.timeout_s,
                measure_batch=cap(args.measure_batch),
                measure_max_ch=cap(args.measure_max_ch),
                measure_max_hw=cap(args.measure_max_hw),
                force=args.force)
            tuned_total += 1
            errors.append(t.prediction_error)
            disagreements += 0 if t.agrees_with_analytic else 1
            a = select_schedule(sc, budget=budget)
            tc = t.choice
            print(f"{net}_L{i},{a.schedule}({a.bm}/{a.bn}/{a.bk})"
                  f"{list(a.tile)},{tc.schedule}({tc.bm}/{tc.bn}/{tc.bk})"
                  f"{list(tc.tile)},{t.measured_us:.1f},"
                  f"{t.analytic_measured_us:.1f},"
                  f"{t.prediction_error:.3f},{t.n_candidates}")
    path = cache.save()
    print(f"# wrote {len(cache)} entries -> {path}")
    if errors:
        es = error_summary(errors)
        print(f"# prediction error: mean={es['mean']:.3f} "
              f"max={es['max']:.3f} over {es['n_finite']}/{es['n']} scenes"
              + (f" ({es['n_nonfinite']} unmeasurable, excluded)"
                 if es["n_nonfinite"] else "")
              + f"; analytic disagreed on {disagreements}/{tuned_total} "
              f"scenes")
        print(f"# next: fit the cost model from these records -> "
              f"python -m repro_torch.launch.calibrate --cache {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
