"""Run one benchmark cell on the card and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's configuration, mix, driver,
limits and per-layer readers are found by the names in ``BENCHMARK.json``
(see ``bench/harness.py``).  The last line of standard output is the
result object; the numbers compared against the plain reference are the
last lines of standard error.  Exits with 1, and prints no result, when
the card the cell asks for is missing or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout; no cost
    model or tune cache read from outside it; no JAX behind a library."""
    cache = root / ".bench_cache"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(root / "src" / "repro_torch"
                                              / "_build")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    # paths that are never written: selection runs on the analytic model
    os.environ["REPRO_TORCH_CALIBRATION"] = str(cache / "no_calibration.json")
    os.environ["REPRO_TORCH_TUNE_CACHE"] = str(cache / "no_tune_cache.json")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment(ROOT)

    from bench import harness
    spec = harness.load_spec(ROOT)
    chips = harness.cell(spec, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"available={torch.cuda.is_available()} "
              f"count={torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), torch.device("cuda", 0), T_START,
                         ROOT)
    found = harness.forbidden_modules()
    if found:
        print(f"no result: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 1
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
