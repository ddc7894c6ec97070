"""Readings that a cell's limits are set from, on many seeds in one process.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 ... \
        --what program control half_batch answer_altered

For each seed it makes the filters and the pool as a run does, and prints
one JSON line per reading with each direction's gap against the
reference (float64), over one pass on each pool entry:

- ``program``: the program's outputs;
- ``control``: the reference computed in TF32 (``reference.round_tf32``,
  the nearest precision below the configurations' f32) in the program's
  place;
- ``half_batch``: the program with half of the batch left out: the second
  half of each output's images zeroed, and each filter gradient taken
  over the first half and doubled, the mean taken over the rest;
- ``answer_altered``: the program with one element of every output moved
  by a hundredth of the output's largest magnitude.

``--device cpu`` runs on the CPU (tests use it with small
configurations).
"""
import argparse
import contextlib
import json
import sys
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Mapping

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def _wrapped(change: Callable) -> Iterator[None]:
    """``ConvPlan.execute`` replaced by ``change(orig, plan, a, b)``."""
    from repro_torch.plan.build import ConvPlan
    orig = ConvPlan.execute

    def execute(self, a, b):
        return change(orig, self, a, b)

    ConvPlan.execute = execute
    try:
        yield
    finally:
        ConvPlan.execute = orig


def half_batch():
    """Half of the batch (the last axis of every operand) left out."""
    def change(orig, plan, a, b):
        half = a.shape[-1] // 2
        if plan.op.value == "wgrad":
            a = a.clone()
            a[..., half:] = 0
            return 2 * orig(plan, a, b)
        out = orig(plan, a, b).clone()
        out[..., half:] = 0
        return out
    return _wrapped(change)


def answer_altered():
    """One element of every output moved by 1 % of its largest value."""
    def change(orig, plan, a, b):
        out = orig(plan, a, b).clone()
        out.view(-1)[0] += 0.01 * out.abs().max()
        return out
    return _wrapped(change)


FAULTS = {"half_batch": half_batch, "answer_altered": answer_altered}


def readings(config: Mapping, mix: Mapping, seed: int, device,
             what: List[str], driver, plans) -> Dict[str, Dict[str, float]]:
    from bench import reference
    flt = driver.weights(config, seed, device)
    entries = driver.pool(config, mix, seed, device)
    out = {}
    for name in what:
        if name == "control":
            checked = []
            for entry in entries:
                outs = {}
                for i, layer in enumerate(config["layers"]):
                    ops = entry[layer["name"]]
                    outs[layer["name"]] = reference.layer(
                        ops["x"].detach(), flt[layer["name"]].detach(),
                        ops["dy"], layer, "tf32", dgrad=i > 0)
                checked.append((entry, outs))
        else:
            fault = FAULTS[name]() if name in FAULTS else \
                contextlib.nullcontext()
            with fault:
                checked = [(entry, driver.one_pass(plans, flt, entry))
                           for entry in entries]
        out[name] = driver.held(config, flt, checked)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["program", "control"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench.run import _environment
    _environment(ROOT)
    import torch
    from bench import harness
    spec = harness.load_spec(ROOT)
    w = harness.cell(spec, args.workload)
    paths = harness.files(w)
    config = harness.load_json(paths["config"])
    mix = harness.load_json(paths["mix"])
    limits = harness.load_json(paths["limits"])["limits"]
    device = torch.device(args.device)
    driver = harness.import_file(paths["driver"],
                                 f"bench_driver_{mix['driver']}")
    plans = driver.build_plans(config, mix, device)
    for seed in args.seeds:
        for name, numbers in readings(config, mix, seed, device, args.what,
                                      driver, plans).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": name, "numbers": numbers,
                              "limits": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
