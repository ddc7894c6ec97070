"""Persistent schedule cache — the autotuner's memory (port of
``repro.tune.cache``).

A JSON artifact maps a *canonical scene signature* (problem dims + dtype +
backend + tuner code version) to the tuned record produced by
``tune/autotune.py``.  Layered:

  disk   JSON file, merge-on-save (concurrent tuning runs union their
         results; on key collision an exact-scene timing beats a
         proxy-capped one, then the faster measured choice wins), atomic
         tmp+rename write;
  memory an LRU-bounded dict fronting the file, with hit/miss counters
         (``repro.tune.cache.hits`` / ``misses``) so tests and the
         ``policy="tuned"`` path can observe resolution.

Decisions of the port:

  * Backend tag (``default_backend``): timings are keyed by device,
    ``cuda:<device name>`` on the card and ``cpu+plain`` on the CPU (the
    kernels' plain versions), so plain-version timings never alias kernel
    timings and one card model's never stand for another's.
  * Code version (``CODE_VERSION``): ``mg3m-tune-v1-<hash>``, the hash
    a short digest of ``csrc/mg3m_conv.cu``.  Any kernel edit changes
    every key, so a stale cache cannot pin a grain measured on an older
    kernel; ``v1`` names the measurement harness (``tune/measure.py``).
  * Paths are the port's own, so the two packages never share a file:
    explicit argument > ``$REPRO_TORCH_TUNE_CACHE`` >
    ``~/.cache/repro_torch/tune_cache.json``.
  * ``scene_signature`` keeps the reference's key layout exactly; dtype
    spellings canonicalize through ``core/scene.dtype_name`` (``"<f4"``,
    ``torch.float32`` and ``"float32"`` give one key).
  * A record's choice carries its compiled ``tile``; ``valid_record``
    also rejects a tile that is not compiled for the choice's grain and
    m-tile, which would otherwise fail at launch on the hot path.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.analysis.footprint import tiles
from repro_torch.core.mapping import SCHEDULES, ScheduleChoice
from repro_torch.core.scene import ConvScene, WgradScene, dtype_name
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.obs.metrics import default_metrics
from repro_torch.obs.trace import default_tracer

_KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" \
    / "mg3m_conv.cu"
# Any kernel edit changes every key (see the module docstring).
CODE_VERSION = "mg3m-tune-v1-" + hashlib.sha256(
    _KERNEL_SOURCE.read_bytes()).hexdigest()[:10]
ENV_VAR = "REPRO_TORCH_TUNE_CACHE"
DEFAULT_PATH = os.path.join("~", ".cache", "repro_torch", "tune_cache.json")
_SCHEMA = 1


def resolve_cache_path(path: Optional[str] = None) -> str:
    """Explicit path > $REPRO_TORCH_TUNE_CACHE > ~/.cache default."""
    p = path or os.environ.get(ENV_VAR) or DEFAULT_PATH
    return os.path.abspath(os.path.expanduser(p))


def default_backend(device: DeviceSpec = None) -> str:
    """Backend tag for cache keys on ``device`` (default the card):
    ``cuda:<device name>`` or ``cpu+plain``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu+plain"
    name = torch.cuda.get_device_name(dev)
    return "cuda:" + name.replace("|", "/").replace("=", "-")


def scene_signature(scene: ConvScene, *, backend: str,
                    version: Optional[str] = None) -> str:
    """Canonical cache key for a scene, field for field the reference's:
    every geometric dim, dtype, backend, code version (default
    ``CODE_VERSION``); the dilation axes (the backward scenes of strided
    forwards) are appended only when active, and ``|split=wgrad`` where
    the scene's plans split its reduction (a ``WgradScene``): its launches
    differ from the same dims' in fprop form."""
    dt = dtype_name(scene.dtype)
    split = "|split=wgrad" if scene.seg_taps else ""
    return (f"v={version or CODE_VERSION}|be={backend}|dt={dt}"
            f"|B={scene.B}|IC={scene.IC}|OC={scene.OC}"
            f"|in={scene.inH}x{scene.inW}|flt={scene.fltH}x{scene.fltW}"
            f"|pad={scene.padH},{scene.padW}|std={scene.stdH},{scene.stdW}"
            f"{scene.dilation_suffix()}{split}")


def parse_signature(key: str) -> Dict[str, str]:
    """Split a ``scene_signature`` key into its ``field=value`` parts."""
    parts = {}
    for tok in key.split("|"):
        field, _, value = tok.partition("=")
        parts[field] = value
    return parts


def scene_from_signature(key: str) -> ConvScene:
    """Inverse of ``scene_signature`` (sans backend/version): the scene a
    cache entry was tuned for.  The dilation fields are optional; a
    ``|split=wgrad`` key gives a ``WgradScene``."""
    p = parse_signature(key)
    inH, inW = p["in"].split("x")
    fltH, fltW = p["flt"].split("x")
    padH, padW = p["pad"].split(",")
    stdH, stdW = p["std"].split(",")
    extra = {}
    for name, (a, b) in (("dil", ("dilH", "dilW")),
                         ("fdil", ("fdilH", "fdilW")),
                         ("apad", ("apadH", "apadW"))):
        if name in p:
            x, y = p[name].split(",")
            extra.update({a: int(x), b: int(y)})
    cls = WgradScene if p.get("split") == "wgrad" else ConvScene
    return cls(B=int(p["B"]), IC=int(p["IC"]), OC=int(p["OC"]),
               inH=int(inH), inW=int(inW), fltH=int(fltH), fltW=int(fltW),
               padH=int(padH), padW=int(padW), stdH=int(stdH),
               stdW=int(stdW), dtype=p["dt"], **extra)


def choice_to_dict(choice: ScheduleChoice) -> Dict:
    return {
        "schedule": choice.schedule, "bm": choice.bm, "bn": choice.bn,
        "bk": choice.bk, "predicted_s": choice.predicted_s,
        "compute_s": choice.compute_s, "hbm_s": choice.hbm_s,
        "vmem_bytes": choice.vmem_bytes, "notes": choice.notes,
        "tile": list(choice.tile),
    }


def choice_from_dict(d: Dict) -> ScheduleChoice:
    return ScheduleChoice(
        schedule=d["schedule"], bm=int(d["bm"]), bn=int(d["bn"]),
        bk=int(d["bk"]), predicted_s=float(d["predicted_s"]),
        compute_s=float(d["compute_s"]), hbm_s=float(d["hbm_s"]),
        vmem_bytes=int(d["vmem_bytes"]), notes=d.get("notes", ""),
        tile=tuple(int(t) for t in d.get("tile", ())),
    )


_REQUIRED_CHOICE_KEYS = ("schedule", "bm", "bn", "bk", "predicted_s",
                         "compute_s", "hbm_s", "vmem_bytes", "tile")


def valid_record(rec) -> bool:
    """Schema check for one tuned record as stored in the JSON artifact:
    a hand-edited, truncated or old-schema entry (or one whose tile is not
    compiled for its grain) is skipped on load and merge instead of
    failing on the ``policy="tuned"`` hot path."""
    if not isinstance(rec, dict):
        return False
    ch = rec.get("choice")
    if not isinstance(ch, dict) or any(k not in ch
                                       for k in _REQUIRED_CHOICE_KEYS):
        return False
    if ch["schedule"] not in SCHEDULES:
        return False
    if not isinstance(rec.get("measured_us", 0.0), (int, float)):
        return False
    try:
        choice = choice_from_dict(ch)
        return choice.tile in tiles(choice.schedule, choice.bm)
    except (KeyError, TypeError, ValueError):
        return False


def _beats(rec: Dict, mine: Dict) -> bool:
    """Collision rule: an exact-scene timing beats any proxy-capped one
    (their µs are not comparable); at equal fidelity the faster wins."""
    rank = lambda r: (r.get("proxy") is not None,   # noqa: E731
                      r.get("measured_us", float("inf")))
    return rank(rec) < rank(mine)


class ScheduleCache:
    """LRU-fronted persistent map: scene signature -> tuned record dict."""

    def __init__(self, path: Optional[str] = None, *,
                 max_entries: int = 4096):
        self.path = resolve_cache_path(path)
        self.max_entries = max_entries
        self._mem: "collections.OrderedDict[str, Dict]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0
        if os.path.exists(self.path):
            # tolerant on construction: a half-written artifact must not
            # brick the tuned hot path (explicit load() is strict)
            try:
                self.load()
            except (json.JSONDecodeError, OSError) as e:
                print(f"repro_torch.tune: ignoring unreadable cache "
                      f"{self.path}: {e}", file=sys.stderr)

    def __len__(self) -> int:
        return len(self._mem)

    def records(self) -> Dict[str, Dict]:
        """Snapshot of signature -> record (calibration's training data)."""
        return dict(self._mem)

    def key(self, scene: ConvScene, backend: Optional[str] = None) -> str:
        return scene_signature(scene, backend=backend or default_backend())

    def get(self, scene: ConvScene, backend: Optional[str] = None
            ) -> Optional[Dict]:
        """Tuned record for a scene, or None on a miss (LRU-touching)."""
        k = self.key(scene, backend)
        rec = self._mem.get(k)
        if rec is None:
            self.misses += 1
            default_metrics().counter("repro.tune.cache.misses").inc()
            return None
        self._mem.move_to_end(k)
        self.hits += 1
        default_metrics().counter("repro.tune.cache.hits").inc()
        return rec

    def get_choice(self, scene: ConvScene, backend: Optional[str] = None
                   ) -> Optional[ScheduleChoice]:
        rec = self.get(scene, backend)
        return choice_from_dict(rec["choice"]) if rec else None

    def put(self, scene: ConvScene, record: Dict,
            backend: Optional[str] = None) -> str:
        k = self.key(scene, backend)
        self._mem[k] = record
        self._mem.move_to_end(k)
        self._evict()
        return k

    def _evict(self) -> None:
        while len(self._mem) > self.max_entries:
            self._mem.popitem(last=False)  # least recently used

    def load(self, path: Optional[str] = None) -> int:
        """Merge entries from a JSON artifact into memory; returns how many
        were usable."""
        p = resolve_cache_path(path) if path else self.path
        m = default_metrics()
        m.counter("repro.tune.cache.loads").inc()
        t0 = time.perf_counter()
        with default_tracer().span("repro.tune.cache.load", path=p), \
                open(p) as f:
            doc = json.load(f)
        m.histogram("repro.tune.cache.load_s").observe(
            time.perf_counter() - t0)
        entries = doc.get("entries", {}) if isinstance(doc, dict) else {}
        bad = {k for k, rec in entries.items() if not valid_record(rec)}
        if bad:
            print(f"repro_torch.tune: skipping {len(bad)} malformed cache "
                  f"entr{'y' if len(bad) == 1 else 'ies'} in {p} "
                  f"(first: {sorted(bad)[0]!r})", file=sys.stderr)
        for k, rec in entries.items():
            if k not in bad:
                self._merge_entry(k, rec)
        self._evict()
        return len(entries) - len(bad)

    def _merge_entry(self, k: str, rec: Dict) -> None:
        mine = self._mem.get(k)
        if mine is None or _beats(rec, mine):
            self._mem[k] = rec

    def save(self, path: Optional[str] = None) -> str:
        """Merge-on-save: union with whatever is on disk, written
        atomically; disk entries beyond the LRU bound stay on disk."""
        p = resolve_cache_path(path) if path else self.path
        m = default_metrics()
        m.counter("repro.tune.cache.saves").inc()
        t0 = time.perf_counter()
        with default_tracer().span("repro.tune.cache.save", path=p):
            entries = dict(self._mem)
            if os.path.exists(p):
                try:
                    with open(p) as f:
                        doc = json.load(f)
                    disk = (doc.get("entries", {})
                            if isinstance(doc, dict) else {})
                    for k, rec in (disk
                                   if isinstance(disk, dict) else {}).items():
                        if not valid_record(rec):
                            continue   # drop malformed disk entries
                        if k not in entries or _beats(rec, entries[k]):
                            entries[k] = rec
                except (json.JSONDecodeError, OSError):
                    pass  # corrupt artifact: overwrite with our state
            os.makedirs(os.path.dirname(p), exist_ok=True)
            doc = {"schema": _SCHEMA, "version": CODE_VERSION,
                   "entries": entries}
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p), suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(doc, f, indent=1, sort_keys=True)
                os.replace(tmp, p)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        m.histogram("repro.tune.cache.save_s").observe(
            time.perf_counter() - t0)
        return p


# -- process-wide default cache (consulted by the policy="tuned" path) ------
_default: Optional[ScheduleCache] = None


def default_cache() -> ScheduleCache:
    global _default
    if _default is None:
        _default = ScheduleCache()
    return _default


def set_default_cache(cache: Optional[ScheduleCache]) -> None:
    """Install (or with None, reset) the process-wide cache — used by the
    tuning CLI after a batch run and by tests."""
    global _default
    _default = cache
