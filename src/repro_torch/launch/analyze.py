"""Static analysis gate of the port: launch-geometry verifier sweep + lint.

    python -m repro_torch.launch.analyze            # CI configuration
    python -m repro_torch.launch.analyze --full     # uncapped scenes
    python -m repro_torch.launch.analyze --json     # machine-readable
    python -m repro_torch.launch.analyze --device cpu

Port of ``scripts/analyze.py``.  Two gates; the run exits 1 on any error
finding of either (warnings are printed and do not fail it):

  verify   every feasible (schedule, blocking, tile) point of every
           fprop/dgrad/wgrad scene of the six paper CNNs is evaluated
           statically (``repro_torch.analysis.verify``): the blocks' walks
           cover the output once, the masked-tap predicate, the
           shared-memory budget, dtypes, agreement with the cost model —
           without executing a kernel.  On a card it also holds the
           card's own ``in_coord`` to the expected table of every swept
           exec scene, bit for bit, and reads each compiled tile's
           registers and occupancy (``occupancy-overestimate`` warnings).
  lint     ``repro_torch.analysis.lint`` over ``src/repro_torch``.

The device: the card when one is present (its SM count sizes the
persistent grids, its shared memory the budget), the H100 datasheet's
limits otherwise or with ``--device cpu``: the analysis computes nothing
on the device, so it has no plain version to stand in for it.

Clean per-(device, scene, op) verdicts are cached under a digest of the
sources the verdicts depend on (``csrc/mg3m_conv.cu`` included), so an
unchanged tree re-checks nothing and an edit of any of them invalidates
everything.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.lint import lint_paths
from repro_torch.analysis.verify import (Finding, device_index_map,
                                         exec_scenes, sweep_scene)
from repro_torch.models.cnn import cnn_layer_scenes
from repro_torch.plan.build import ConvOp

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_REPO = os.path.abspath(os.path.join(_SRC, "..", ".."))

#: Sources whose semantics the verifier's verdicts depend on.  Editing any
#: of these invalidates the whole sweep cache.
_DIGEST_FILES = (
    "analysis/verify.py", "analysis/footprint.py", "kernels/mg3m_conv.py",
    "csrc/mg3m_conv.cu", "plan/build.py", "tune/space.py", "core/scene.py",
    "core/mapping.py", "models/cnn.py",
)

_OPS = (ConvOp.FPROP, ConvOp.DGRAD, ConvOp.WGRAD)


def _source_digest() -> str:
    h = hashlib.sha256()
    for rel in _DIGEST_FILES:
        with open(os.path.join(_SRC, rel), "rb") as f:
            h.update(rel.encode())
            h.update(f.read())
    return h.hexdigest()


def _load_cache(path: str, digest: str) -> set:
    try:
        with open(path) as f:
            data = json.load(f)
        if data.get("digest") == digest:
            return set(data.get("clean", []))
    except (OSError, ValueError):
        pass
    return set()


def _save_cache(path: str, digest: str, clean: set) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"digest": digest, "clean": sorted(clean)}, f)
    os.replace(tmp, path)


def analysis_device(spec: Optional[str]) -> Optional[torch.device]:
    """The device the sweep is checked for: ``spec``, else the card when
    one is present; None stands for the H100 datasheet's limits."""
    if spec is None:
        return torch.device("cuda") if torch.cuda.is_available() else None
    dev = torch.device(spec)
    return dev if dev.type == "cuda" else None


def _device_tag(device: Optional[torch.device]) -> str:
    return (torch.cuda.get_device_name(device) if device is not None
            else "h100-datasheet")


def run_verify(args, device: Optional[torch.device] = None
               ) -> Tuple[List[Finding], int, int]:
    """Returns (findings, points checked, op-sweeps cached)."""
    if args.full:
        scenes = cnn_layer_scenes(batch=args.batch)
    else:
        scenes = cnn_layer_scenes(batch=args.batch, max_hw=args.max_hw,
                                  max_ch=args.max_ch)
    digest = _source_digest()
    clean = set() if args.no_cache else _load_cache(args.cache, digest)
    tag = _device_tag(device)
    findings, checked, cached = [], 0, 0
    for name, scene in sorted(scenes.items()):
        for op in _OPS:
            key = f"{tag}|{scene.describe()}|{op.value}"
            if key in clean:
                cached += 1
                continue
            fnd, n = sweep_scene(scene, ops=(op,), device=device)
            if device is not None:
                for ex in exec_scenes(scene, (op,)).values():
                    fnd.extend(device_index_map(ex, device))
            checked += n
            findings.extend(fnd)
            if not any(f.is_error for f in fnd):
                clean.add(key)
    if not args.no_cache:
        _save_cache(args.cache, digest, clean)
    return findings, checked, cached


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.analyze",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--full", action="store_true",
                    help="uncapped paper scenes (default caps preserve "
                         "stride/pad/remainder structure)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-hw", type=int, default=56,
                    help="cap spatial extent of swept scenes")
    ap.add_argument("--max-ch", type=int, default=128,
                    help="cap channel counts of swept scenes")
    ap.add_argument("--cache", default=os.path.join(
        _REPO, ".cache", "analyze_torch_cache.json"))
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--skip-verify", action="store_true")
    ap.add_argument("--skip-lint", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card if present, else the H100 "
                         "datasheet's limits ('cpu')")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    device = analysis_device(args.device)
    t0 = time.time()
    verify_findings, checked, cached = ([], 0, 0)
    if not args.skip_verify:
        verify_findings, checked, cached = run_verify(args, device)
    lint_findings = [] if args.skip_lint else lint_paths(_SRC)
    n_err = sum(f.is_error for f in verify_findings)

    if args.json:
        print(json.dumps({
            "device": _device_tag(device),
            "verify": [f.__dict__ for f in verify_findings],
            "lint": [f.__dict__ for f in lint_findings],
            "points_checked": checked, "points_cached": cached,
            "elapsed_s": round(time.time() - t0, 2),
        }, indent=2))
    else:
        for f in verify_findings:
            print(f"verify: [{f.code}] ({f.severity}) {f.message}")
        for f in lint_findings:
            print(f"lint: {f}")
        print(f"analyze ({_device_tag(device)}): {checked} points checked, "
              f"{cached} op-sweeps cached, {n_err} verify errors, "
              f"{len(verify_findings) - n_err} warnings, "
              f"{len(lint_findings)} lint findings in "
              f"{time.time() - t0:.1f}s")
    return 1 if (n_err or lint_findings) else 0


if __name__ == "__main__":
    sys.exit(main())
