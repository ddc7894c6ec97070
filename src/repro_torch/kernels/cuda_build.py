"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Route (b) of the kernel build: ``nvcc`` compiles each source into a
shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, never at import (this module imports on a
machine with no CUDA toolkit), into ``BUILD_DIR`` — ``src/repro_torch/
_build/`` unless ``REPRO_TORCH_BUILD_DIR`` says otherwise, ignored by git.
A library is named by a hash of its source and flags, so an edited source
never loads a stale build.  ``load_all`` builds several sources at once,
one ``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = Path(os.environ.get("REPRO_TORCH_BUILD_DIR", _PKG / "_build"))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}   # source name -> nvcc/ptxas output


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def build(source: str) -> Tuple[Path, str]:
    """Compile ``csrc/<source>`` (if not already built); returns the
    library path and the compiler's output."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists():
        return lib, ""
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, building it first if
    needed (once per process)."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path, log = build(source)
            build_logs[source] = log
            lib = ctypes.CDLL(str(path))
            _libs[source] = lib
        return lib


def load_all(sources: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build every source that is not built yet, one ``nvcc`` each, all
    started together; then load them.  Raises on the first failed build."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        futures = {src: pool.submit(build, src) for src in sources}
        built = {src: fut.result() for src, fut in futures.items()}
    with _lock:
        for src, (path, log) in built.items():
            if src not in _libs:
                build_logs[src] = log
                _libs[src] = ctypes.CDLL(str(path))
        return {src: _libs[src] for src in sources}
