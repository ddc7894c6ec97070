"""The benchmark's files: BENCHMARK.json against the contract's shape, the
configurations, the count, and what the benchmark imports."""
import ast
import json
import re
from pathlib import Path

import pytest

from bench import count, harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def _config(name: str):
    return harness.load_json(ROOT / "bench" / "configs" / f"{name}.json")


def test_spec_keys_names_and_limits():
    assert set(SPEC) == KEYS["top"]
    assert SPEC["command"][1:] == ["bench/run.py"]
    assert SPEC["paths"] == ["bench"] and 1 <= SPEC["run_seconds"] <= 51
    for kind in ("config", "workload", "end_to_end", "per_layer"):
        entries = SPEC[kind + "s" if kind in ("config", "workload") else kind]
        assert entries and len({e["name"] for e in entries}) == len(entries)
        for e in entries:
            extra = set(e) - KEYS[kind] - {"workloads"}
            assert set(e) >= KEYS[kind] and not extra, (e["name"], extra)
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
    for c in SPEC["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("bench/configs/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in SPEC["workloads"]:
        name = w["name"]
        mine = [m["name"] for m in SPEC["end_to_end"]
                if harness.applies(m, name, SPEC)]
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in SPEC["per_layer"]
                  if harness.applies(m, name, SPEC)]
        assert layers
        for m in layers:
            assert m["moves"] in mine and _line(m["layer"])
            assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        for kind in ("configs", "mixes"):
            key = "config" if kind == "configs" else "traffic"
            assert (ROOT / "bench" / kind / f"{w[key]}.json").is_file()
        assert (ROOT / "bench" / "limits" / f"{name}.json").is_file()


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_configuration_is_whole(name):
    cfg = _config(name)
    assert cfg["name"] == name and cfg["dtype"] in count.PEAK_FLOPS
    assert cfg["reduced"] == next(c["reduced"] for c in SPEC["configs"]
                                  if c["name"] == name)
    assert [x["name"] for x in cfg["layers"]] == [
        f"L{i}" for i in range(len(cfg["layers"]))]
    for layer in cfg["layers"]:
        assert set(count.GEOMETRY) <= set(layer)
        assert min(count.out_hw(layer)) >= 1


@pytest.mark.parametrize("name,forward_gflop,pass_tflop", [
    ("resnet50-fig13", 1.443463168, 0.5240782848),
    ("alexnet-fig13", 1.311133056, 0.485484232704)])
def test_count_reproduces_the_paper_layers(name, forward_gflop, pass_tflop):
    cfg = _config(name)
    forward = sum(count.conv_flops(layer, 1) for layer in cfg["layers"])
    assert forward == round(forward_gflop * 1e9)
    assert count.pass_flops(cfg, 128) == round(pass_tflop * 1e12)
    # a pass: every fprop and wgrad, every dgrad but the first layer's
    calls = list(count.pass_calls(cfg))
    assert len(calls) == 3 * len(cfg["layers"]) - 1
    assert (0, "dgrad") not in calls and (1, "dgrad") in calls


def test_bound_is_the_larger_of_operations_and_bytes():
    layer = _config("resnet50-fig13")["layers"][1]        # 1x1, 64 -> 64
    f = count.conv_flops(layer, 64)
    b = count.conv_bytes(layer, "fprop", 64, "float32")
    assert b == 4 * (2 * 56 * 56 * 64 * 64 + 64 * 64)
    assert count.conv_bound_s(layer, "fprop", 64, "float32") == max(
        f / 165e12, b / 3.35e12)
    with pytest.raises(ValueError):
        count.conv_bytes(layer, "xgrad", 64, "float32")


def test_match_layer_by_geometry():
    cfg = _config("alexnet-fig13")
    assert count.match_layer(cfg, cfg["layers"][3]) == 3
    assert count.match_layer(cfg, dict(cfg["layers"][3], IC=7)) == -1


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix() for p in (ROOT / "bench").rglob("*.py")))
def test_imports_nothing_of_jax_or_the_jax_package(path):
    found = set(_imports(ROOT / path))
    assert not found & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    if path.startswith("bench/reference/"):
        assert "repro_torch" not in found


def test_forbidden_modules_compares_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.plan": 1, "reprox": 1}
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules({"repro.core": 1, "jax.numpy": 1}) == [
        "jax", "repro"]
