"""Process-level plan repository — plan-once, execute-many, serve-forever.

Port of ``repro.plan.registry``.  ``PlanRegistry`` memoizes frozen
``ConvPlan``s under a canonical signature (scene dims + dtype + op + policy
+ backend + use_kernels), with hit/miss counters, bounded LRU eviction,
and a versioned JSON artifact (atomic tmp+rename merge-on-``save`` so
concurrent writers union rather than clobber, merge-on-``load``).  Loading
never re-runs schedule resolution: stored choices are pinned exactly
(``build.assemble_plan``).

The reference's ``int=`` (interpret) key fragment becomes ``be=`` — the
backend, ``cuda`` or ``cpu`` — so a plan built for one backend is never
pinned on the other.  A registry serves one backend (its ``device``);
artifact entries of the other backend ride along on ``save`` and are
skipped on ``load``.  Sharded entries are a later slice.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Union

import torch

from repro_torch.core.scene import ConvScene, dtype_name
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.obs.metrics import (MetricRegistry, snapshot_delta,
                                     snapshot_value)
from repro_torch.obs.trace import default_tracer
from repro_torch.plan.build import (ConvOp, ConvPlan, PolicySpec,
                                    assemble_plan, make_plan, policy_tag)
from repro_torch.tune.cache import choice_from_dict, choice_to_dict

# Bump when plan semantics / the artifact layout change meaning.
PLAN_VERSION = "mg3m-torch-plan-v1"
_SCHEMA = 1
_BACKENDS = ("cuda", "cpu")

_SCENE_FIELDS = ("B", "IC", "OC", "inH", "inW", "fltH", "fltW",
                 "padH", "padW", "stdH", "stdW", "dtype",
                 "dilH", "dilW", "fdilH", "fdilW", "apadH", "apadW")


def plan_signature(scene: ConvScene, op: Union[ConvOp, str],
                   policy: PolicySpec, backend: str,
                   use_kernels: bool) -> str:
    """Canonical registry key: explicit about everything that changes the
    executable.  Dilation axes are appended only when active."""
    return (f"v={PLAN_VERSION}|op={ConvOp(op).value}|pol={policy_tag(policy)}"
            f"|be={backend}|kern={int(use_kernels)}"
            f"|dt={dtype_name(scene.dtype)}"
            f"|B={scene.B}|IC={scene.IC}|OC={scene.OC}"
            f"|in={scene.inH}x{scene.inW}|flt={scene.fltH}x{scene.fltW}"
            f"|pad={scene.padH},{scene.padW}|std={scene.stdH},{scene.stdW}"
            f"{scene.dilation_suffix()}")


def plan_to_dict(plan: ConvPlan) -> Dict:
    return {
        "scene": {f: getattr(plan.scene, f) for f in _SCENE_FIELDS},
        "op": plan.op.value,
        "policy": plan.policy,
        "backend": plan.backend,
        "use_kernels": plan.use_kernels,
        "uses_reference": plan.uses_reference,
        "notes": list(plan.notes),
        "choice": choice_to_dict(plan.choice) if plan.choice else None,
    }


def plan_from_dict(d: Dict) -> ConvPlan:
    """Rebuild a plan from its artifact entry — no schedule resolution.
    Raises ``ValueError`` on an entry that cannot be rebuilt (and
    ``RuntimeError`` for a ``cuda`` entry on a machine with no card)."""
    scene = ConvScene(**d["scene"])
    backend = d["backend"]
    if backend not in _BACKENDS:
        raise ValueError(f"unknown plan backend {backend!r}")
    choice = choice_from_dict(d["choice"]) if d.get("choice") else None
    return assemble_plan(scene, d["op"], d["policy"], choice,
                         device=backend,
                         use_kernels=bool(d.get("use_kernels", True)))


def valid_plan_dict(d) -> bool:
    """Validity check for one stored entry: valid iff it can be rebuilt.
    An entry for a backend this process cannot build (``cuda`` with no
    card) is checked structurally only — the backend is an environment
    property, and merge-on-``save`` must keep it for the process that can
    serve it."""
    if not isinstance(d, dict):
        return False
    try:
        if d.get("backend") == "cuda" and not torch.cuda.is_available():
            ConvScene(**d["scene"])
            ConvOp(d["op"])
            if d.get("choice"):
                choice_from_dict(d["choice"])
            return True
        plan_from_dict(d)
        return True
    except (KeyError, TypeError, ValueError):
        return False


class PlanRegistry:
    """LRU-bounded map: plan signature -> frozen ``ConvPlan`` for one
    backend (``device``; default the card, raising without one unless
    ``device="cpu"``).

    Thread-safe: every public operation holds one reentrant lock;
    ``get_or_build`` holds it across the build, so two threads racing the
    same miss produce one plan, one miss, and one identical object."""

    def __init__(self, *, max_plans: int = 1024,
                 metrics: Optional[MetricRegistry] = None,
                 device: DeviceSpec = None):
        self.device = resolve_device(device)
        self.backend = self.device.type
        self.max_plans = max_plans
        self._mem: "collections.OrderedDict[str, ConvPlan]" = \
            collections.OrderedDict()
        self._lock = threading.RLock()
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self._c_hits = self.metrics.counter("repro.plan.registry.hits")
        self._c_misses = self.metrics.counter("repro.plan.registry.misses")
        self._c_evictions = self.metrics.counter(
            "repro.plan.registry.evictions")
        self._c_builds = self.metrics.counter("repro.plan.registry.builds")

    @property
    def hits(self) -> int:
        return int(self._c_hits.value)

    @property
    def misses(self) -> int:
        return int(self._c_misses.value)

    @property
    def evictions(self) -> int:
        return int(self._c_evictions.value)

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._mem

    def key(self, scene: ConvScene, op: Union[ConvOp, str] = ConvOp.FPROP,
            policy: PolicySpec = "analytic", use_kernels: bool = True) -> str:
        return plan_signature(scene, op, policy, self.backend, use_kernels)

    # -- lookup ------------------------------------------------------------
    def get(self, scene: ConvScene, op: Union[ConvOp, str] = ConvOp.FPROP, *,
            policy: PolicySpec = "analytic",
            use_kernels: bool = True) -> Optional[ConvPlan]:
        """Registered plan, or None on miss (LRU-touching)."""
        k = self.key(scene, op, policy, use_kernels)
        with self._lock:
            plan = self._mem.get(k)
            if plan is None:
                self._c_misses.inc()
                return None
            self._mem.move_to_end(k)
            self._c_hits.inc()
            return plan

    def put(self, plan: ConvPlan) -> str:
        if plan.backend != self.backend:
            raise ValueError(f"a {plan.backend!r} plan cannot be registered "
                             f"in a {self.backend!r} registry")
        k = plan_signature(plan.scene, plan.op, plan.policy, plan.backend,
                           plan.use_kernels)
        with self._lock:
            self._mem[k] = plan
            self._mem.move_to_end(k)
            self._evict()
        return k

    def _build(self, scene: ConvScene, op, policy: PolicySpec,
               use_kernels: bool) -> ConvPlan:
        return make_plan(scene, op, policy=policy, device=self.device,
                         use_kernels=use_kernels)

    def get_or_build(self, scene: ConvScene,
                     op: Union[ConvOp, str] = ConvOp.FPROP, *,
                     policy: PolicySpec = "analytic",
                     use_kernels: bool = True) -> ConvPlan:
        """The plan-once entry: registry hit, or ``make_plan`` + register,
        atomic under the registry lock."""
        with self._lock:
            plan = self.get(scene, op, policy=policy, use_kernels=use_kernels)
            if plan is None:
                plan = self._build(scene, op, policy, use_kernels)
                self._c_builds.inc()
                self.put(plan)
            return plan

    def warm(self, scenes: Iterable[ConvScene],
             ops: Sequence[Union[ConvOp, str]] = (ConvOp.FPROP,),
             buckets: Optional[Sequence[int]] = None, *,
             policy: PolicySpec = "analytic",
             use_kernels: bool = True) -> int:
        """Pre-build every (scene x op x bucket) plan not already
        registered; returns how many were built.  ``buckets`` rebatches each
        scene (``ConvScene.with_batch``); the whole warmed set ends up
        resident and most recently used, a set larger than ``max_plans``
        raises ``ValueError`` up front, and warming bumps neither ``hits``
        nor ``misses``."""
        built = 0
        with self._lock:
            work = []
            for scene in scenes:
                for b in (buckets if buckets else (scene.B,)):
                    rebatched = scene.with_batch(b)
                    for op in ops:
                        work.append((rebatched, op,
                                     self.key(rebatched, op, policy,
                                              use_kernels)))
            n_keys = len({k for _, _, k in work})
            if n_keys > self.max_plans:
                raise ValueError(
                    f"cannot warm {n_keys} plans into a registry bounded at "
                    f"max_plans={self.max_plans}: the LRU would evict part "
                    f"of the warmed set before it is ever served; raise "
                    f"max_plans or shrink the (scenes x ops x buckets) "
                    f"ladder")
            for rebatched, op, k in work:
                if k not in self._mem:
                    self._mem[k] = self._build(rebatched, op, policy,
                                               use_kernels)
                    self._c_builds.inc()
                    built += 1
                self._mem.move_to_end(k)
            self._evict()
        return built

    def _evict(self) -> None:
        # callers hold self._lock
        while len(self._mem) > self.max_plans:
            self._mem.popitem(last=False)  # least-recently used
            self._c_evictions.inc()

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()

    def snapshot(self) -> Dict[str, Dict]:
        """Point-in-time metrics snapshot (pass back as ``stats(since=)``)."""
        return self.metrics.snapshot()

    def reset_stats(self) -> None:
        """Zero hit/miss/eviction/build counters (plans stay resident)."""
        self.metrics.reset()

    def stats(self, since: Optional[Dict] = None) -> Dict[str, float]:
        """Counter view; with ``since`` (a prior ``snapshot()``) every
        counter and the hit rate describe only the window since then."""
        snap = self.metrics.snapshot()
        if since is not None:
            snap = snapshot_delta(since, snap)
        v = lambda name: int(snapshot_value(snap,
                                            f"repro.plan.registry.{name}"))
        hits, misses = v("hits"), v("misses")
        lookups = hits + misses
        return {"size": len(self), "hits": hits, "misses": misses,
                "evictions": v("evictions"), "builds": v("builds"),
                "hit_rate": hits / lookups if lookups else 0.0}

    def plans(self) -> Dict[str, ConvPlan]:
        """Snapshot of signature -> plan."""
        with self._lock:
            return dict(self._mem)

    def warmed_buckets(self, scene: ConvScene,
                       op: Union[ConvOp, str] = ConvOp.FPROP, *,
                       policy: PolicySpec = "analytic",
                       use_kernels: bool = True) -> tuple:
        """Every batch size of ``scene``'s family resident for ``op``,
        ascending — the scheduler's sub-rung execution probe.  A peek, not
        traffic: bumps neither hits nor misses and touches no LRU order."""
        op = ConvOp(op)
        pol = policy_tag(policy)
        base = scene.with_batch(1)
        with self._lock:
            out = {plan.scene.B for plan in self._mem.values()
                   if plan.op is op and plan.policy == pol
                   and plan.use_kernels == use_kernels
                   and plan.scene.with_batch(1) == base}
        return tuple(sorted(out))

    # -- persistence -------------------------------------------------------
    def save(self, path: str) -> str:
        """Merge-on-save: union our plans with whatever is on disk, then
        write atomically (tmp+rename).  Our in-memory plan wins a key
        collision; valid disk-only keys ride along.  Lock-free across
        processes: overlapping saves can still lose keys (last rename
        wins)."""
        p = os.path.abspath(os.path.expanduser(path))
        t0 = time.perf_counter()
        with default_tracer().span("repro.plan.registry.save", path=p):
            with self._lock:
                out = self._save_locked(p)
        self.metrics.histogram("repro.plan.registry.save_s").observe(
            time.perf_counter() - t0)
        return out

    def _save_locked(self, p: str) -> str:
        plans = {k: plan_to_dict(pl) for k, pl in self._mem.items()}
        if os.path.exists(p):
            try:
                with open(p) as f:
                    doc = json.load(f)
                on_disk = doc.get("plans", {}) if isinstance(doc, dict) else {}
                if not isinstance(on_disk, dict):
                    on_disk = {}
            except (json.JSONDecodeError, OSError):
                on_disk = {}   # corrupt artifact: overwrite with our state
            for k, d in on_disk.items():
                if k not in plans and valid_plan_dict(d):
                    plans[k] = d
        doc = {"schema": _SCHEMA, "version": PLAN_VERSION, "plans": plans}
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p) or ".",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            os.replace(tmp, p)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return p

    def load(self, path: str) -> int:
        """Merge this backend's plans from an artifact; returns how many
        were loaded.  Malformed or stale entries are skipped with a
        warning; entries of the other backend are skipped silently."""
        p = os.path.abspath(os.path.expanduser(path))
        t0 = time.perf_counter()
        loaded = 0
        skipped = []
        with default_tracer().span("repro.plan.registry.load", path=p):
            with open(p) as f:
                doc = json.load(f)
            with self._lock:
                for k, d in doc.get("plans", {}).items():
                    if isinstance(d, dict) and d.get("backend") != self.backend:
                        continue
                    try:
                        plan = plan_from_dict(d)
                    except (KeyError, TypeError, ValueError) as e:
                        skipped.append((k, e))
                        continue
                    self._mem[k] = plan
                    self._mem.move_to_end(k)
                    loaded += 1
                self._evict()
        self.metrics.histogram("repro.plan.registry.load_s").observe(
            time.perf_counter() - t0)
        if skipped:
            print(f"repro_torch.plan: skipped {len(skipped)} malformed plan "
                  f"entr{'y' if len(skipped) == 1 else 'ies'} in {p} "
                  f"(first: {skipped[0][0]!r}: {skipped[0][1]})",
                  file=sys.stderr)
        return loaded


# -- process-wide default registry ------------------------------------------
_default: Optional[PlanRegistry] = None


def default_registry() -> PlanRegistry:
    """The process-wide registry (built for the card on first use)."""
    global _default
    if _default is None:
        _default = PlanRegistry()
    return _default


def set_default_registry(registry: Optional[PlanRegistry]) -> None:
    """Install (or with None, reset) the process-wide registry."""
    global _default
    _default = registry


def get_plan(scene: ConvScene, op: Union[ConvOp, str] = ConvOp.FPROP, *,
             policy: PolicySpec = "analytic", use_kernels: bool = True,
             registry: Optional[PlanRegistry] = None) -> ConvPlan:
    """Plan-once convenience on the default (or given) registry."""
    reg = registry if registry is not None else default_registry()
    return reg.get_or_build(scene, op, policy=policy,
                            use_kernels=use_kernels)
