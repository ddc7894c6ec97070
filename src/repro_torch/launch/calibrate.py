"""Fit the calibrated cost model from the tuned schedule cache (port of
``scripts/calibrate.py``).

    python -m repro_torch.launch.calibrate \
        [--cache ~/.cache/repro_torch/tune_cache.json] \
        [--out ~/.cache/repro_torch/calibration.json] [--backend TAG]

Reads every tuned record, re-derives the cost terms of the measured
execution, fits per-scene-class corrections (effective compute rate,
effective HBM rate, per-step overhead — ``repro_torch.tune.calibrate``),
prints the per-class error report (median |predicted-measured|/measured
before -> after) and writes the versioned artifact that ``"analytic"``
plans and ``"tuned"`` cache misses pick up automatically (path: --out /
``$REPRO_TORCH_CALIBRATION`` / ``~/.cache/repro_torch/calibration.json``).

Fit one backend at a time (``--backend "cuda:NVIDIA H100 80GB HBM3"`` or
``cpu+plain``): the plain versions' CPU times say nothing of the card.  A
cache that holds records of several backends is refused unless
``--backend`` picks one; the artifact names its backend and kernel version,
and only a device of that backend running that kernel source uses it.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.tune import cache as cache_mod
from repro_torch.tune import calibrate as calibrate_mod


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.calibrate",
        description=__doc__.splitlines()[0])
    ap.add_argument("--cache", default=None,
                    help="tune cache artifact to fit from "
                         "(default: env/home resolution)")
    ap.add_argument("--out", default=None,
                    help="calibration artifact path (default: "
                         "$REPRO_TORCH_CALIBRATION / ~/.cache/repro_torch/"
                         "calibration.json)")
    ap.add_argument("--backend", default=None,
                    help='only fit records of this backend tag, e.g. '
                         '"cpu+plain" (default: the cache\'s one backend)')
    ap.add_argument("--dry-run", action="store_true",
                    help="fit and report, but do not write the artifact")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    cache = cache_mod.ScheduleCache(args.cache)
    if len(cache) == 0:
        print(f"error: no tuned records in {cache.path}; run "
              f"python -m repro_torch.launch.tune first", file=sys.stderr)
        return 2
    if args.backend is None:
        keys = [cache_mod.parse_signature(k) for k in cache.records()]
        backends = sorted({k.get("be", "") for k in keys
                           if k.get("v") == cache_mod.CODE_VERSION})
        if len(backends) > 1:
            print(f"error: {cache.path} holds records of several backends "
                  f"({', '.join(backends)}); pick one with --backend",
                  file=sys.stderr)
            return 2
    report = calibrate_mod.fit_calibration(cache, backend=args.backend)
    if report.n_records == 0:
        print(f"error: {len(cache)} cache entries but none usable for "
              f"calibration (version/backend mismatch or unmeasurable "
              f"records; skipped {report.n_skipped})", file=sys.stderr)
        return 2

    print(f"# fit from {cache.path}: {report.n_records} records "
          f"({report.n_skipped} skipped"
          + f", backend={report.backend})")
    print("class,n,method,compute_scale,bw_scale,overhead_ns,"
          "median_err_before,median_err_after")
    for f in report.classes:
        print(f"{f.cls},{f.n_samples},{f.method},{f.compute_scale:.4f},"
              f"{f.bw_scale:.4f},{f.overhead_s * 1e9:.2f},"
              f"{f.median_err_before:.3f},{f.median_err_after:.3f}")
    print(f"# overall median |pred-meas|/meas: "
          f"{report.median_err_before:.3f} -> {report.median_err_after:.3f}")

    if args.dry_run:
        print("# dry run: artifact not written")
        return 0
    path = calibrate_mod.save_calibration(report, args.out)
    print(f"# wrote calibration -> {path}")
    # the artifact must reproduce the fit exactly
    loaded = calibrate_mod.load_calibration(path)
    if loaded.corrections != report.cost_model().corrections:
        print("error: artifact round-trip mismatch", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
