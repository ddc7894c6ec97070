"""Checkpoints in the reference's format (port of
``repro.train.checkpoint``).

* Atomic: written to a temporary directory beside the target, then
  renamed; a crash mid-save never corrupts the latest checkpoint.
* Self-describing: ``manifest.json`` lists every leaf by its path, file,
  dtype and shape; each leaf is a ``.npy`` file.  Paths are spelled as the
  reference's ``jax.tree_util.keystr`` spells them (``.params['c1']``,
  ``.opt.step``), so a checkpoint written by either package restores into
  the other's ``TrainState``.
* Trees are NamedTuples and dicts (flattened in sorted key order, as JAX
  does) over tensor or numpy leaves; a bf16 tensor is stored
  as f32 (exact) and cast back on restore.  ``restore`` places each
  leaf on the device and in the dtype of the matching leaf of ``like``; the
  reference's elastic re-shard (``mesh=``, ``specs=``) waits for
  ``shard/``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_LEAF_FILE = "leaf_{:05d}.npy"


def _flatten_with_paths(tree: Any, prefix: str = ""
                        ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in JAX's flattening order and ``keystr`` syntax."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for name in tree._fields for pair in
                _flatten_with_paths(getattr(tree, name), f"{prefix}.{name}")]
    if isinstance(tree, dict):
        return [pair for key in sorted(tree) for pair in
                _flatten_with_paths(tree[key], f"{prefix}[{key!r}]")]
    return [(prefix, tree)]


def _rebuild(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, name), leaves,
                                     f"{prefix}.{name}")
                            for name in tree._fields))
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaves, f"{prefix}[{key!r}]")
                for key in tree}
    return leaves[prefix]


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:   # no numpy dtype: f32 is exact
            leaf = leaf.float()
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict] = None) -> str:
    """Atomically save ``tree`` as checkpoint ``step``; returns its path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp_ckpt_", dir=ckpt_dir)
    try:
        manifest = {"step": step, "extra": extra or {}, "leaves": []}
        for i, (path, leaf) in enumerate(_flatten_with_paths(tree)):
            arr = _to_numpy(leaf)
            fname = _LEAF_FILE.format(i)
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"path": path, "file": fname, "dtype": str(arr.dtype),
                 "shape": list(arr.shape)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like: Any) -> Tuple[Any, Dict]:
    """Restore checkpoint ``step`` into the structure of ``like``: each leaf
    takes the dtype and device of ``like``'s leaf at its path (a tensor
    leaf; other leaves become numpy arrays).  Returns ``(tree, extra)``;
    raises ``KeyError`` for a path the checkpoint lacks and ``ValueError``
    for a shape that differs."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    out = {}
    for p, leaf in _flatten_with_paths(like):
        entry = by_path.get(p)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {p}")
        arr = np.load(os.path.join(path, entry["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {p}: {arr.shape} vs "
                             f"{tuple(leaf.shape)}")
        if isinstance(leaf, torch.Tensor):
            out[p] = torch.from_numpy(np.array(arr)).to(
                device=leaf.device, dtype=leaf.dtype)
        else:
            out[p] = arr.astype(np.asarray(leaf).dtype)
    return _rebuild(like, out), manifest["extra"]


def retain(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
