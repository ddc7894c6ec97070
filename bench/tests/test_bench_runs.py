"""Runs of the harness on the CPU at small sizes: a cell, a mix and a
metric found from new files alone, the result line, and ``correct``
coming out false when the program underneath is broken."""
import json
import subprocess
import sys
import time

import pytest
import torch

from bench import control, harness
from bench.tests.conftest import LIKE, ROOT

CPU = torch.device("cpu")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(root, trace=False, seconds=0.3, seed=2 ** 31 + 11):
    return harness.run("tiny.layers", seed, seconds, trace, CPU,
                       time.perf_counter(), root)


def test_added_files_make_a_cell(tiny):
    """A configuration, a mix, limits and a metric reader added as files,
    and entries in BENCHMARK.json, run without an edit to any file."""
    result = run(tiny)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"conv_pass_ms", "setup_s"}
    traced = run(tiny, trace=True)
    assert traced["correct"]
    assert "setup_s" not in traced["metrics"]
    assert traced["metrics"]["passes.tiny"]["value"] >= 1
    assert traced["metrics"]["passes.tiny"]["unit"] == "passes"
    assert traced["metrics"]["pass_mfu"]["value"] > 0


def test_result_line_has_the_contract_keys(tiny, capsys):
    harness.emit(run(tiny, trace=True))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes", "busy_s", "window_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["checks"]) == {"fprop_gap", "dgrad_gap", "wgrad_gap"}
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(x.startswith("check ") and " limit " in x for x in last)


def test_run_needs_a_card():
    """On a machine without CUDA the command prints no result and fails."""
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", LIKE, "--seed", "1",
         "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no result" in proc.stderr


def _never_written():
    return control._wrapped(lambda orig, plan, a, b: torch.zeros_like(
        orig(plan, a, b)))


@pytest.mark.parametrize("fault", [control.half_batch,
                                   control.answer_altered, _never_written])
def test_a_broken_program_is_not_correct(tiny, fault):
    with fault():
        result = run(tiny)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_limits(tiny, seed):
    """The reference in TF32, in the program's place, fails a number of the
    cell's limits, and the program passes them, at a small size."""
    spec = harness.load_spec(tiny)
    paths = harness.files(harness.cell(spec, "tiny.layers"), tiny / "bench")
    cfg, mix = (harness.load_json(paths[k]) for k in ("config", "mix"))
    limits = harness.load_json(ROOT / "bench" / "limits" /
                               f"{LIKE}.json")["limits"]
    driver = harness.import_file(paths["driver"], "bench_driver_layers")
    plans = driver.build_plans(cfg, mix, CPU)
    got = control.readings(cfg, mix, seed, CPU, ["program", "control"],
                           driver, plans)
    assert any(got["control"][k] > limits[k] for k in limits), got
    assert all(got["program"][k] <= limits[k] for k in limits), got


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in harness.load_spec()[
    "workloads"]])
def test_cell_on_the_card(card, workload):
    """Each cell, briefly, traced, on the card: correct, and every
    per-layer metric read."""
    result = harness.run(workload, 7, 2.0, True, card, time.perf_counter())
    assert result["correct"], result["checks"]
    spec = harness.load_spec()
    want = {m["name"] for m in spec["per_layer"]
            if harness.applies(m, workload, spec)}
    assert set(result["metrics"]) == want
