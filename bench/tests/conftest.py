"""A checkout-shaped copy of the benchmark with a small cell added as files
of its own, for runs of the harness on the CPU."""
import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
LIKE = "resnet50-fig13.layers-b128"

TINY = {
    "name": "tiny", "source": "small layers for tests", "dtype": "float32",
    "reduced": [],
    "layers": [
        {"name": "L0", "IC": 3, "OC": 8, "inH": 16, "inW": 16, "fltH": 5,
         "fltW": 5, "padH": 2, "padW": 2, "stdH": 2, "stdW": 2},
        {"name": "L1", "IC": 16, "OC": 32, "inH": 8, "inW": 8, "fltH": 1,
         "fltW": 1, "padH": 0, "padW": 0, "stdH": 2, "stdW": 2},
        {"name": "L2", "IC": 32, "OC": 16, "inH": 6, "inW": 6, "fltH": 3,
         "fltW": 3, "padH": 1, "padW": 1, "stdH": 1, "stdW": 1},
    ],
}
PASSES_READER = '''"""Passes in the traced window."""


def read(record):
    return float(record["passes"]) if record.get("passes") else None
'''


def _json(path: Path, doc) -> None:
    path.write_text(json.dumps(doc, indent=1))


def tiny_root(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and bench/ under ``tmp`` with a small
    configuration, a small mix, their cell and its limits, and one more
    per-layer metric, all added as new files and entries."""
    shutil.copytree(ROOT / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp / "bench"
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    _json(bench / "configs" / "tiny.json", TINY)
    mix = json.loads((bench / "mixes" / "layers-b128.json").read_text())
    mix.update(name="layers-tiny", batch=4)
    _json(bench / "mixes" / "layers-tiny.json", mix)
    (bench / "metrics" / "passes.tiny.py").write_text(PASSES_READER)
    spec["workloads"].append({"name": "tiny.layers", "config": "tiny",
                              "traffic": "layers-tiny", "chips": 1,
                              "why": "test"})
    _json(bench / "limits" / "tiny.layers.json",
          json.loads((bench / "limits" / f"{LIKE}.json").read_text()))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if LIKE in m.get("workloads", ()):
            m["workloads"].append("tiny.layers")
    spec["per_layer"].append({
        "name": "passes.tiny", "unit": "passes", "better": "higher",
        "source": "host_clock", "layer": "whole pass", "moves":
        "conv_pass_ms", "workloads": ["tiny.layers"]})
    _json(tmp / "BENCHMARK.json", spec)
    return tmp


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def tiny(tmp_path) -> Path:
    return tiny_root(tmp_path)
