"""Calibrate the cost model from measured tune records (port of
``repro.tune.calibrate``).

Every cache entry written by ``tune/autotune.py`` pairs an analytic
prediction with a measured time; this module fits per-scene-class
corrections over those pairs — an effective compute rate, an effective
HBM rate, a per-step overhead — bucketed by scene class ``schedule x
bound-type x arithmetic-intensity band`` (``mapping.class_key``).  Within
a bucket the dominant term is known, so ``measured - fixed ≈ g *
dominant + o * steps`` is an ordinary least-squares problem in two
features; thin buckets (fewer than ``MIN_LSTSQ_SAMPLES``) and the
aggregate tiers fall back to a median-ratio fit.  The result is a
``mapping.CostModel`` the selector consumes unchanged.

The features are the port's own (``mapping.cost_terms``, the terms
``_score`` composes): the raw compute and HBM terms, ``steps`` — the
chunk steps ``_score`` charges the per-step overhead on (the busiest SM's
steps over its resident blocks), not the whole grid's ``grid_steps``,
which ``_score`` never multiplies by the overhead — and ``fixed_s``, the
resident filter loads, which no class correction scales and which the fit
therefore subtracts from the measured time.  On features with
``fixed_s = 0`` the fit is the reference's, number for number.
``_rel_errors`` prices a sample from its features under a model exactly
as ``_score`` would price its execution.

The fit persists as a versioned JSON artifact (atomic tmp+rename write,
path: explicit > ``$REPRO_TORCH_CALIBRATION`` >
``~/.cache/repro_torch/calibration.json``).  ``active_cost_model()`` is
the hot-path hook: the explicitly installed model, else the artifact at
the resolved path (reloaded when its mtime changes) when it was fitted on
the asking device's backend (``cache.default_backend``) from timings of
the current kernel source (``cache.CODE_VERSION``), else the analytic
default; ``plan/build.resolve_policy`` and ``serve/conv.bucket_ladder``
select under it.  An artifact of another backend or kernel version is
ignored with a warning: the plain versions' CPU times never steer the
card's picks, and a kernel edit orphans its fit as it orphans its tuned
records.

Caveats, recorded rather than hidden: the card's times are a plan's
``execute`` (padding and slice-back included) where the model prices the
kernel; proxy-capped measurements calibrate the model at the proxy's
geometry; CPU times calibrate a model of the plain versions — fit per
backend (``backend=``).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import tempfile
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core import mapping
from repro_torch.core.mapping import (ClassCorrection, CostModel, ai_band,
                                      class_key)
from repro_torch.core.scene import ConvScene
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.tune import cache as cache_mod
from repro_torch.tune.autotune import clip_choice

# Bump when the fit procedure or artifact layout changes meaning.
CALIB_VERSION = "mg3m-calib-v1"
ENV_VAR = "REPRO_TORCH_CALIBRATION"
DEFAULT_PATH = os.path.join("~", ".cache", "repro_torch", "calibration.json")
_SCHEMA = 1
# Below this many samples a bucket gets a median-ratio fit, not least
# squares (2 free parameters need more than 2 points to mean anything).
MIN_LSTSQ_SAMPLES = 3


def resolve_calibration_path(path: Optional[str] = None) -> str:
    """Explicit path > $REPRO_TORCH_CALIBRATION > ~/.cache default."""
    p = path or os.environ.get(ENV_VAR) or DEFAULT_PATH
    return os.path.abspath(os.path.expanduser(p))


@dataclasses.dataclass(frozen=True)
class CalibSample:
    """One (cost terms, measured) training pair from the tune cache."""

    key: str               # cache signature the record came from
    cls: str               # scene class (on the measurement scene)
    schedule: str
    compute_s: float       # raw compute term, measurement scene
    hbm_s: float           # raw HBM term, measurement scene
    n_steps: float         # chunk steps charged the per-step overhead
    predicted_s: float     # uncalibrated total prediction
    measured_s: float      # measured time from the tuned record
    scene: ConvScene       # measurement scene (proxy caps applied)
    bm: int
    bn: int
    bk: int
    tile: Tuple[int, ...] = ()
    fixed_s: float = 0.0   # resident filter loads (never corrected)


@dataclasses.dataclass(frozen=True)
class ClassFit:
    """Fitted correction + fit quality for one scene class."""

    cls: str
    n_samples: int
    compute_scale: float
    bw_scale: float
    overhead_s: float
    method: str            # "lstsq" | "ratio"
    median_err_before: float
    median_err_after: float


@dataclasses.dataclass
class CalibrationReport:
    """Everything a fit produced: the model plus its per-class audit."""

    classes: List[ClassFit]
    n_records: int
    n_skipped: int
    median_err_before: float
    median_err_after: float
    backend: Optional[str]
    source: str = "fit"

    def cost_model(self) -> CostModel:
        corrections = {
            f.cls: ClassCorrection(compute_scale=f.compute_scale,
                                   bw_scale=f.bw_scale,
                                   overhead_s=f.overhead_s)
            for f in self.classes}
        return CostModel(corrections=corrections, source=self.source)


def _make_sample(key: str, msc: ConvScene, choice: mapping.ScheduleChoice,
                 measured_us: float) -> Optional[CalibSample]:
    """One training pair for ``choice``'s clipped execution on the
    measurement scene, its cost terms re-derived."""
    schedule, bm, bn, bk, tile = clip_choice(msc, choice)
    t = mapping.cost_terms(msc, schedule, bm, bn, bk, tile=tile)
    if t is None:
        return None
    predicted = (max(t.compute_s, t.hbm_s)
                 + (t.steps * mapping.DEFAULT_COST_MODEL.step_overhead_s
                    + t.fixed_s))
    return CalibSample(
        key=key, cls=class_key(schedule, t.bound,
                               ai_band(msc.arithmetic_intensity)),
        schedule=schedule, compute_s=t.compute_s, hbm_s=t.hbm_s,
        n_steps=t.steps, predicted_s=predicted,
        measured_s=measured_us * 1e-6, scene=msc, bm=bm, bn=bn, bk=bk,
        tile=tile, fixed_s=t.fixed_s)


def samples_from_cache(cache: cache_mod.ScheduleCache, *,
                       backend: Optional[str] = None
                       ) -> Tuple[List[CalibSample], int]:
    """Training pairs from tuned records; returns (samples, skipped).

    Each record yields its measured winner and, where its execution
    differs from the winner's, its measured analytic favorite (the
    favorite's blocks are reconstructed by ``select_schedule``).  Records
    of other code versions or backends, non-finite or non-positive
    timings, and anything the schema check rejects are skipped."""
    samples, skipped = [], 0
    for key, rec in cache.records().items():
        parts = cache_mod.parse_signature(key)
        if parts.get("v") != cache_mod.CODE_VERSION:
            skipped += 1
            continue
        if backend is not None and parts.get("be") != backend:
            skipped += 1
            continue
        if not cache_mod.valid_record(rec):
            skipped += 1
            continue
        measured_us = rec.get("measured_us")
        if not isinstance(measured_us, (int, float)) or \
                not math.isfinite(measured_us) or measured_us <= 0:
            skipped += 1
            continue
        try:
            scene = cache_mod.scene_from_signature(key)
            proxy = rec.get("proxy")
            msc = dataclasses.replace(scene, **proxy) if proxy else scene
            choice = cache_mod.choice_from_dict(rec["choice"])
        except (KeyError, TypeError, ValueError):
            skipped += 1
            continue
        winner = _make_sample(key, msc, choice, measured_us)
        if winner is None:
            skipped += 1
            continue
        samples.append(winner)

        a_us = rec.get("analytic_measured_us")
        a_sched = rec.get("analytic_schedule")
        if (isinstance(a_us, (int, float)) and math.isfinite(a_us)
                and a_us > 0 and a_sched in mapping.SCHEDULES):
            try:
                analytic = mapping.select_schedule(scene)
            except ValueError:
                analytic = None
            if analytic is not None and analytic.schedule == a_sched:
                fav = _make_sample(key, msc, analytic, a_us)
                if fav is not None and (fav.schedule, fav.bm, fav.bn,
                                        fav.bk, fav.tile) != (
                        winner.schedule, winner.bm, winner.bn, winner.bk,
                        winner.tile):
                    samples.append(fav)
    return samples, skipped


def _ratio_fit(samples: List[CalibSample],
               base_overhead: float) -> Tuple[float, float, float, str]:
    """Median ratio of measured to predicted (both less the uncorrected
    fixed term) applied to every corrected term."""
    r = _median([(s.measured_s - s.fixed_s)
                 / max(s.predicted_s - s.fixed_s, 1e-30) for s in samples])
    if not math.isfinite(r) or r <= 0:
        return 1.0, 1.0, base_overhead, "ratio"
    return 1.0 / r, 1.0 / r, base_overhead * r, "ratio"


def _fit_bucket(cls: str, samples: List[CalibSample],
                base_overhead: float) -> Tuple[float, float, float, str]:
    """(compute_scale, bw_scale, overhead_s) for one scene class: least
    squares of ``measured - fixed`` on (dominant term, steps), the rate
    inverted into a scale; too few points, a negative rate or a
    degenerate fit fall back to the ratio fit."""
    if len(samples) < MIN_LSTSQ_SAMPLES:
        return _ratio_fit(samples, base_overhead)
    bound = cls.split("|")[1]
    dom = np.array([s.compute_s if bound == "compute" else s.hbm_s
                    for s in samples])
    n = np.array([float(s.n_steps) for s in samples])
    y = np.array([s.measured_s - s.fixed_s for s in samples])
    X = np.stack([dom, n], axis=1)
    (g, o), *_ = np.linalg.lstsq(X, y, rcond=None)
    if o < 0:
        # clamp the overhead at zero and refit the rate alone
        o = 0.0
        denom = float(dom @ dom)
        g = float(dom @ y) / denom if denom > 0 else -1.0
    if not math.isfinite(g) or g <= 0:
        return _ratio_fit(samples, base_overhead)
    scale = 1.0 / float(g)
    return scale, scale, float(o), "lstsq"


def _predict(s: CalibSample, model: CostModel) -> float:
    """``_score``'s price of the sample's execution under ``model``,
    from its features."""
    _, bound, band = s.cls.split("|")
    corr = model.correction_for(s.schedule, bound, band)
    per_step = (corr.overhead_s if corr.overhead_s is not None
                else model.step_overhead_s)
    return (max(s.compute_s / max(corr.compute_scale, 1e-30),
                s.hbm_s / max(corr.bw_scale, 1e-30))
            + (s.n_steps * per_step + s.fixed_s))


def _rel_errors(samples: List[CalibSample],
                model: Optional[CostModel]) -> List[float]:
    """|predicted - measured| / measured per sample; ``model=None`` is the
    uncalibrated prediction the sample was recorded with."""
    return [abs((s.predicted_s if model is None else _predict(s, model))
                - s.measured_s) / s.measured_s for s in samples]


def _median(xs: List[float]) -> float:
    if not xs:
        return float("nan")
    xs = sorted(xs)
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else (xs[mid - 1] + xs[mid]) / 2


def fit_calibration(cache: Union[cache_mod.ScheduleCache, List[CalibSample]],
                    *, backend: Optional[str] = None,
                    n_skipped: int = 0) -> CalibrationReport:
    """Fit per-class corrections over a tune cache (or pre-built samples).

    The report's ``backend`` is ``backend``, else the one backend every
    sample was measured on; samples of several backends leave it None,
    and an artifact of such a fit applies to no device."""
    if isinstance(cache, cache_mod.ScheduleCache):
        samples, n_skipped = samples_from_cache(cache, backend=backend)
    else:
        samples = list(cache)
    if backend is None:
        tags = {cache_mod.parse_signature(s.key).get("be") for s in samples}
        backend = tags.pop() if len(tags) == 1 else None
    buckets: Dict[str, List[CalibSample]] = {}
    for s in samples:
        buckets.setdefault(s.cls, []).append(s)
    # aggregate tiers back unseen classes at selection time, one per level
    # of CostModel.correction_for's fallback chain; without the global
    # tier an unmeasured schedule would be priced at raw datasheet rates
    # and beat every calibrated (slowed-down) class
    for s in samples:
        bound = s.cls.split("|")[1]
        buckets.setdefault(class_key(s.schedule, bound, "*"), []).append(s)
        buckets.setdefault(class_key(s.schedule, "*", "*"), []).append(s)
    if samples:
        buckets[class_key("*", "*", "*")] = list(samples)

    base_overhead = mapping.DEFAULT_COST_MODEL.step_overhead_s
    fits: Dict[str, Tuple[float, float, float, str]] = {}
    for cls, bucket in buckets.items():
        if "*" in cls:
            fits[cls] = _ratio_fit(bucket, base_overhead)
        else:
            fits[cls] = _fit_bucket(cls, bucket, base_overhead)

    model = CostModel(corrections={
        cls: ClassCorrection(compute_scale=cs, bw_scale=bs, overhead_s=ov)
        for cls, (cs, bs, ov, _) in fits.items()})

    classes = []
    for cls, bucket in sorted(buckets.items()):
        cs, bs, ov, method = fits[cls]
        # audit each row against a model holding only this class's
        # correction, so the aggregate rows exercise their own correction
        row_model = CostModel(corrections={
            cls: ClassCorrection(compute_scale=cs, bw_scale=bs,
                                 overhead_s=ov)})
        classes.append(ClassFit(
            cls=cls, n_samples=len(bucket), compute_scale=cs, bw_scale=bs,
            overhead_s=ov, method=method,
            median_err_before=_median(_rel_errors(bucket, None)),
            median_err_after=_median(_rel_errors(bucket, row_model))))
    return CalibrationReport(
        classes=classes, n_records=len(samples), n_skipped=n_skipped,
        median_err_before=_median(_rel_errors(samples, None)),
        median_err_after=_median(_rel_errors(samples, model)),
        backend=backend)


# -- artifact persistence (tune/cache.py conventions) ------------------------
def save_calibration(report: CalibrationReport,
                     path: Optional[str] = None) -> str:
    """Write the fit as a versioned JSON artifact (atomic tmp+rename)."""
    p = resolve_calibration_path(path)
    base = mapping.DEFAULT_COST_MODEL
    doc = {
        "schema": _SCHEMA,
        "version": CALIB_VERSION,
        "tune_version": cache_mod.CODE_VERSION,
        "backend": report.backend,
        "n_records": report.n_records,
        "n_skipped": report.n_skipped,
        "median_err_before": report.median_err_before,
        "median_err_after": report.median_err_after,
        "base": {"mxu_flops_bf16": base.mxu_flops_bf16,
                 "mxu_flops_fp32": base.mxu_flops_fp32,
                 "hbm_bw": base.hbm_bw,
                 "step_overhead_s": base.step_overhead_s},
        "corrections": {
            f.cls: {"compute_scale": f.compute_scale,
                    "bw_scale": f.bw_scale, "overhead_s": f.overhead_s,
                    "n_samples": f.n_samples, "method": f.method,
                    "median_err_before": f.median_err_before,
                    "median_err_after": f.median_err_after}
            for f in report.classes},
    }
    os.makedirs(os.path.dirname(p), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(p), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, p)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return p


def load_calibration(path: Optional[str] = None, *,
                     backend: Optional[str] = None) -> CostModel:
    """Load a calibration artifact into a usable ``CostModel`` (strict).
    With ``backend``, also require that the artifact was fitted on that
    backend from timings of the current kernel source."""
    p = resolve_calibration_path(path)
    with open(p) as f:
        doc = json.load(f)
    if doc.get("version") != CALIB_VERSION:
        raise ValueError(
            f"calibration artifact {p} has version "
            f"{doc.get('version')!r}, expected {CALIB_VERSION!r}; re-fit "
            f"with python -m repro_torch.launch.calibrate")
    if backend is not None and doc.get("backend") != backend:
        raise ValueError(
            f"calibration artifact {p} was fitted on backend "
            f"{doc.get('backend')!r}, not {backend!r}")
    if backend is not None and doc.get("tune_version") != \
            cache_mod.CODE_VERSION:
        raise ValueError(
            f"calibration artifact {p} was fitted on kernel version "
            f"{doc.get('tune_version')!r}, not {cache_mod.CODE_VERSION!r}; "
            f"re-tune and re-fit")
    base = doc.get("base", {})
    corrections = {}
    for cls, c in doc.get("corrections", {}).items():
        corrections[cls] = ClassCorrection(
            compute_scale=float(c["compute_scale"]),
            bw_scale=float(c["bw_scale"]),
            overhead_s=(None if c.get("overhead_s") is None
                        else float(c["overhead_s"])))
    dflt = mapping.DEFAULT_COST_MODEL
    return CostModel(
        mxu_flops_bf16=float(base.get("mxu_flops_bf16", dflt.mxu_flops_bf16)),
        mxu_flops_fp32=float(base.get("mxu_flops_fp32", dflt.mxu_flops_fp32)),
        hbm_bw=float(base.get("hbm_bw", dflt.hbm_bw)),
        step_overhead_s=float(base.get("step_overhead_s",
                                       dflt.step_overhead_s)),
        corrections=corrections, source=p)


# -- process-wide active model (consulted by analytic and tuned misses) -----
_active: Optional[CostModel] = None
# (path, backend) -> (mtime, model-or-None); None caches a failed or
# refused load until the file changes, so an unusable artifact warns once
# instead of once per plan.
_autoload: Dict[Tuple[str, str], Tuple[float, Optional[CostModel]]] = {}


def set_active_cost_model(model: Optional[CostModel]) -> None:
    """Install (or with None, reset to artifact auto-loading) the cost
    model schedule resolution uses — for the CLI and tests."""
    global _active
    _active = model


def active_cost_model(device: DeviceSpec = None) -> CostModel:
    """The cost model selection on ``device`` (default the card) uses now:
    the installed model, else the calibration artifact at the resolved
    path (reloaded when its mtime changes) if it was fitted on the
    device's backend from the current kernel source, else the analytic
    default."""
    if _active is not None:
        return _active
    p = resolve_calibration_path()
    try:
        mtime = os.path.getmtime(p)
    except OSError:
        return mapping.DEFAULT_COST_MODEL
    backend = cache_mod.default_backend(resolve_device(device))
    cached = _autoload.get((p, backend))
    if cached is None or cached[0] != mtime:
        model: Optional[CostModel] = None
        try:
            model = load_calibration(p, backend=backend)
        except Exception as e:  # noqa: BLE001 — any malformed or foreign
            # artifact falls back to the analytic model, never breaks
            # resolution
            print(f"repro_torch.tune: ignoring unusable calibration {p}: "
                  f"{e}", file=sys.stderr)
        _autoload[(p, backend)] = (mtime, model)
        cached = _autoload[(p, backend)]
    return cached[1] if cached[1] is not None else mapping.DEFAULT_COST_MODEL
