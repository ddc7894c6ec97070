"""The port stands alone: ``src/repro_torch`` and the chip scripts never
import JAX or the reference package, and importing them never imports
``triton`` or loads the CUDA library (the package must import on a machine
with no GPU toolchain)."""
import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "chip_trunk_ab.py",
                             "chip_tile_sweep.py", "chip_phase_ab.py",
                             "chip_flash_ab.py", "chip_mma_rate.py",
                             "chip_bwd_sweep.py")]
_BANNED_ROOTS = {"jax", "jaxlib", "repro"}
_LOADERS = {("ctypes", "CDLL"), ("ctypes", "cdll"), ("cuda_build", "load"),
            ("cpp_extension", "load")}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node, (node.module or "").split(".")[0]


def _module_level(tree):
    """Statements that run at import: the module body, descending into
    if/try/with blocks but not into function or class bodies."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node, root in _imported_roots(tree):
        assert root not in _BANNED_ROOTS, (
            f"{path.relative_to(ROOT)}:{node.lineno} imports {root!r}")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_toolchain_work_at_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in _module_level(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not any(n.split(".")[0] == "triton" for n in names), (
                f"{path.relative_to(ROOT)}:{node.lineno} imports triton at "
                f"module level")
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                assert (f.value.id, f.attr) not in _LOADERS, (
                    f"{path.relative_to(ROOT)}:{node.lineno} loads a native "
                    f"library at import")


def test_every_module_imports_without_jax_or_a_gpu():
    """Import the whole package in a fresh interpreter and check that
    neither JAX, the reference package nor triton came along."""
    mods = [m.name for m in pkgutil.walk_packages([str(PORT)], "repro_torch.")]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'triton'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert len(mods) >= 15


def test_package_imports_here():
    assert importlib.import_module("repro_torch.serve.sched")


# the training slice's modules, each a port of the reference file of the
# same path under src/repro
TRAINING_MODULES = ("core.autodiff", "core.conv", "kernels.ops",
                    "models.cnn", "train.optimizer", "train.cnn",
                    "train.checkpoint", "data.pipeline", "launch.train_cnn")


@pytest.mark.parametrize("name", TRAINING_MODULES)
def test_training_modules_are_covered(name):
    """Each module is one of the files the guards above walk, mirrors a
    reference file, and imports here without a GPU toolchain."""
    rel = Path(*name.split(".")).with_suffix(".py")
    assert PORT / rel in FILES
    assert (ROOT / "src" / "repro" / rel).is_file()
    assert importlib.import_module(f"repro_torch.{name}")


# the tune slice's modules: each a port of the reference file of the same
# path under src/repro, and its two launchers ports of scripts/
TUNE_MODULES = {"tune.measure": "src/repro/tune/measure.py",
                "tune.space": "src/repro/tune/space.py",
                "tune.cache": "src/repro/tune/cache.py",
                "tune.autotune": "src/repro/tune/autotune.py",
                "tune.calibrate": "src/repro/tune/calibrate.py",
                "launch.tune": "scripts/tune.py",
                "launch.calibrate": "scripts/calibrate.py"}


@pytest.mark.parametrize("name", sorted(TUNE_MODULES))
def test_tune_modules_are_covered(name):
    """Each module is one of the files the guards above walk, mirrors its
    reference file, and imports here without a GPU toolchain."""
    rel = Path(*name.split(".")).with_suffix(".py")
    assert PORT / rel in FILES
    assert (ROOT / TUNE_MODULES[name]).is_file()
    assert importlib.import_module(f"repro_torch.{name}")


# the LM slices' modules, each a port of the reference file of the same
# path under src/repro (models/moe.py since the attention-block families)
LM_MODULES = ("models.layers", "models.mamba2", "models.moe",
              "models.rwkv6", "models.transformer", "serve.engine")


@pytest.mark.parametrize("name", LM_MODULES)
def test_lm_modules_are_covered(name):
    """Each module is one of the files the guards above walk, mirrors a
    reference file, and imports here without a GPU toolchain."""
    rel = Path(*name.split(".")).with_suffix(".py")
    assert PORT / rel in FILES
    assert (ROOT / "src" / "repro" / rel).is_file()
    assert importlib.import_module(f"repro_torch.{name}")


# the LM training slice's modules (rwkv6 and the substrate), each a port of
# the reference file of the same path under src/repro
LM_TRAIN_MODULES = ("models.rwkv6", "data.pipeline", "parallel.ctx",
                    "parallel.sharding", "launch.mesh", "launch.train",
                    "train.step", "train.ft")


@pytest.mark.parametrize("name", LM_TRAIN_MODULES)
def test_lm_train_modules_are_covered(name):
    """Each module is one of the files the guards above walk (no jax, no
    repro, no triton), mirrors a reference file, and imports here without
    a GPU toolchain."""
    rel = Path(*name.split(".")).with_suffix(".py")
    assert PORT / rel in FILES
    assert (ROOT / "src" / "repro" / rel).is_file()
    assert importlib.import_module(f"repro_torch.{name}")


# the static-analysis and cost layers and the LM examples: each a port of
# the reference file named beside it
ANALYSIS_MODULES = {"analysis.verify": "src/repro/analysis/verify.py",
                    "analysis.lint": "src/repro/analysis/lint.py",
                    "launch.dryrun": "src/repro/launch/dryrun.py",
                    "launch.roofline": "src/repro/launch/roofline.py",
                    "launch.analyze": "scripts/analyze.py",
                    "examples.serve_lm": "examples/serve_lm.py",
                    "examples.train_lm": "examples/train_lm.py"}


@pytest.mark.parametrize("name", sorted(ANALYSIS_MODULES))
def test_analysis_modules_are_covered(name):
    """Each module is one of the files the guards above walk (no jax, no
    repro, no triton), mirrors its reference file, and imports here
    without a GPU toolchain."""
    rel = Path(*name.split(".")).with_suffix(".py")
    assert PORT / rel in FILES
    assert (ROOT / ANALYSIS_MODULES[name]).is_file()
    assert importlib.import_module(f"repro_torch.{name}")


def test_meta_hooks_never_load_the_cuda_library(monkeypatch):
    """On the meta device the LM kernels' wrappers (and their autograd
    Functions, forward and backward) report closed forms and never build
    or load a kernel library."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.kernels import causal_conv1d as CC
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mg3m_conv as MG
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import step as S

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel library was loaded on meta")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "load_all", refuse)
    for lib in (FA.library, CC.library, MG.library):
        lib.cache_clear()
    cfg = dataclasses.replace(reduced(get_config("zamba2-7b")),
                              remat_policy="nothing_saveable")
    tr = S.trace_train_step(cfg, "train_4k", make_host_mesh("meta"),
                            S.StepPlan(), batch_override=1, seq_override=32)
    assert tr.by_op["kernel:flash_attention_fwd"][0] > 0
    assert tr.by_op["kernel:causal_conv1d"][0] > 0
    x = torch.empty(1, 8, 4, device="meta", requires_grad=True)
    CC.CausalConv1d.apply(x, torch.empty(3, 4, device="meta")).sum() \
        .backward()
    for lib in (FA.library, CC.library, MG.library):
        assert lib.cache_info().currsize == 0


# the conv sharding slice: each a port of the reference file named beside it
SHARD_MODULES = {"shard": "src/repro/shard/__init__.py",
                 "shard.spec": "src/repro/shard/spec.py",
                 "shard.plan": "src/repro/shard/plan.py",
                 "shard.autodiff": "src/repro/shard/autodiff.py",
                 "examples.shard_conv": "examples/shard_conv.py"}


@pytest.mark.parametrize("name", sorted(SHARD_MODULES))
def test_shard_modules_are_covered(name):
    """Each module is one of the files the guards above walk (no jax, no
    repro, no triton), mirrors its reference file, and imports here
    without a GPU toolchain."""
    rel = Path(*name.split("."))
    rel = rel / "__init__.py" if (PORT / rel).is_dir() else rel.with_suffix(
        ".py")
    assert PORT / rel in FILES
    assert (ROOT / SHARD_MODULES[name]).is_file()
    assert importlib.import_module(f"repro_torch.{name}")


# the last examples and scripts: each a port of the file named beside it
LAST_MODULES = {"examples.quickstart": "examples/quickstart.py",
                "examples.serve_conv": "examples/serve_conv.py",
                "examples.mg3m_cnn": "examples/mg3m_cnn.py",
                "examples.serve_cnn": "examples/serve_cnn.py",
                "launch.obsreport": "scripts/obsreport.py",
                "launch.make_experiments": "scripts/make_experiments.py"}


@pytest.mark.parametrize("name", sorted(LAST_MODULES))
def test_last_modules_are_covered(name):
    """Each module is one of the files the guards above walk (no jax, no
    repro, no triton), mirrors its reference file, and imports here
    without a GPU toolchain."""
    rel = Path(*name.split(".")).with_suffix(".py")
    assert PORT / rel in FILES
    assert (ROOT / LAST_MODULES[name]).is_file()
    assert importlib.import_module(f"repro_torch.{name}")


@pytest.mark.parametrize("name", sorted(LAST_MODULES))
def test_last_modules_run_with_python_m(name):
    """``python -m repro_torch.<name> --help`` runs in a fresh interpreter
    that has neither JAX nor the reference package on its path."""
    out = subprocess.run([sys.executable, "-m", f"repro_torch.{name}",
                          "--help"], capture_output=True, text=True,
                         timeout=120, cwd=str(ROOT),
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert f"python -m repro_torch.{name}" in out.stdout
