"""repro_torch.tune.calibrate: fit quality, artifact round trip, the hot
path's use of the active model — the contracts of tests/test_calibrate.py
on the port's cost terms — and parity with ``repro.tune.calibrate``: the
same sample features fitted by both packages give the same ``ClassFit``
numbers within 1e-9 relative."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

from repro import tune as jtune
from repro.core import mapping as jmapping
from repro.core.scene import ConvScene as JScene

from repro_torch import tune
from repro_torch.core import mapping
from repro_torch.core.mapping import (ClassCorrection, CostModel, ai_band,
                                      class_key, select_schedule)
from repro_torch.core.scene import ConvScene
from repro_torch.kernels.ops import resolve_choice
from repro_torch.tune import autotune as autotune_mod
from repro_torch.tune.calibrate import CalibSample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu+plain"

# A machine that is a uniformly mis-modeled version of the model: 3x slower
# compute and HBM and a larger per-step overhead.  The fit must recover it.
_TRUE_SCALE = 3.0
_TRUE_OVERHEAD_S = 40e-9


def synthetic_measure(scene, choice):
    """Deterministic 'device time' consistent across candidates (µs)."""
    sched, bm, bn, bk, tile = autotune_mod.clip_choice(scene, choice)
    t = mapping.cost_terms(scene, sched, bm, bn, bk, tile=tile)
    if t is None:
        return math.inf
    return (max(t.compute_s, t.hbm_s) * _TRUE_SCALE
            + t.steps * _TRUE_OVERHEAD_S + t.fixed_s) * 1e6


def _dims():
    return [dict(B=b, IC=ic, OC=oc, inH=h, inW=h, fltH=3, fltW=3, padH=1,
                 padW=1)
            for b in (2, 8, 32) for ic in (8, 64) for oc in (16, 128)
            for h in (8, 14)]


def scene_grid():
    return [ConvScene(**d) for d in _dims()]


@pytest.fixture(autouse=True)
def no_artifacts(tmp_path, monkeypatch):
    monkeypatch.setenv(tune.cache.ENV_VAR, str(tmp_path / "env_cache.json"))
    monkeypatch.setenv(tune.calibrate.ENV_VAR,
                       str(tmp_path / "env_calib.json"))
    tune.set_active_cost_model(None)
    yield
    tune.set_active_cost_model(None)
    tune.set_default_cache(None)


@pytest.fixture
def tuned_cache(tmp_path):
    cache = tune.ScheduleCache(str(tmp_path / "tune_cache.json"))
    for sc in scene_grid():
        tune.autotune_scene(sc, cache=cache, top_k=4, device="cpu",
                            measure_fn=synthetic_measure)
    cache.save()
    return cache


# -- cost model basics ------------------------------------------------------
def test_default_model_is_uncalibrated_datasheet():
    m = mapping.DEFAULT_COST_MODEL
    assert m.mxu_rate("float32") == mapping.H100_FP32_FLOPS
    assert m.hbm_bw == mapping.H100_HBM_BW
    assert not m.is_calibrated


def test_score_composes_cost_terms():
    sc = scene_grid()[0]
    for pt in tune.enumerate_space(sc):
        a = mapping._score(sc, pt.schedule, pt.bm, pt.bn, pt.bk,
                           tile=pt.tile)
        t = mapping.cost_terms(sc, pt.schedule, pt.bm, pt.bn, pt.bk,
                               tile=pt.tile)
        assert a == mapping._score(sc, pt.schedule, pt.bm, pt.bn, pt.bk,
                                   mapping.DEFAULT_COST_MODEL, tile=pt.tile)
        assert a.predicted_s == max(t.compute_s, t.hbm_s) + (
            t.steps * mapping.STEP_OVERHEAD_S + t.fixed_s)
        assert (a.compute_s, a.hbm_s, a.bound) == (t.compute_s, t.hbm_s,
                                                   t.bound)


def test_correction_fallback_chain():
    exact = ClassCorrection(compute_scale=0.5)
    sched = ClassCorrection(compute_scale=0.25)
    m = CostModel(corrections={class_key("TB88", "compute", "ai1"): exact,
                               class_key("TB88", "*", "*"): sched})
    assert m.correction_for("TB88", "compute", "ai1") is exact
    assert m.correction_for("TB88", "memory", "ai0") is sched
    assert m.correction_for("TB11", "compute", "ai1").compute_scale == 1.0


def test_corrected_model_changes_prediction():
    sc = scene_grid()[0]
    base = select_schedule(sc)
    slow = CostModel(corrections={
        class_key(base.schedule, base.bound, "*"):
            ClassCorrection(compute_scale=1 / 3, bw_scale=1 / 3)})
    corrected = mapping._score(sc, base.schedule, base.bm, base.bn, base.bk,
                               slow, tile=base.tile)
    assert corrected.predicted_s > base.predicted_s


# -- sample extraction ------------------------------------------------------
def test_samples_reconstruct_measurement_scene(tuned_cache):
    samples, skipped = tune.samples_from_cache(tuned_cache)
    assert skipped == 0
    assert len({s.key for s in samples}) == len(scene_grid())
    executions = [(s.key, s.schedule, s.bm, s.bn, s.bk, s.tile)
                  for s in samples]
    assert len(executions) == len(set(executions))
    for s in samples:
        assert s.measured_s > 0 and math.isfinite(s.measured_s)
        assert s.scene == tune.scene_from_signature(s.key)
        assert s.cls.split("|")[0] == s.schedule
        scored = mapping._score(s.scene, s.schedule, s.bm, s.bn, s.bk,
                                tile=s.tile)
        assert s.predicted_s == scored.predicted_s


def test_samples_respect_backend_filter(tuned_cache):
    assert tune.samples_from_cache(tuned_cache, backend=CPU)[0]
    none, skipped = tune.samples_from_cache(tuned_cache,
                                            backend="cuda:other")
    assert none == [] and skipped == len(tuned_cache)


def test_samples_skip_other_code_versions(tuned_cache):
    rec = next(iter(tuned_cache.records().values()))
    key = tune.scene_signature(scene_grid()[0], backend=CPU,
                               version="mg3m-tune-v1-0000000000")
    tuned_cache._mem[key] = rec
    _, skipped = tune.samples_from_cache(tuned_cache)
    assert skipped == 1


# -- fit quality ------------------------------------------------------------
def test_calibration_strictly_reduces_median_error(tuned_cache):
    report = tune.fit_calibration(tuned_cache)
    assert report.n_records >= len(scene_grid())
    assert report.median_err_before > 0.1
    assert report.median_err_after < report.median_err_before
    assert report.median_err_after < 0.05
    for f in report.classes:
        assert f.n_samples > 0
        assert f.median_err_after <= f.median_err_before + 1e-9
    lstsq = [f for f in report.classes if f.method == "lstsq"]
    assert lstsq
    for f in lstsq:
        assert f.compute_scale == pytest.approx(1 / _TRUE_SCALE, rel=1e-6)
        assert f.overhead_s == pytest.approx(_TRUE_OVERHEAD_S, rel=1e-4)


def _sample(sc, choice, us, key="k"):
    t = mapping.cost_terms(sc, choice.schedule, choice.bm, choice.bn,
                           choice.bk, tile=choice.tile)
    return CalibSample(
        key=key, cls=class_key(choice.schedule, t.bound,
                               ai_band(sc.arithmetic_intensity)),
        schedule=choice.schedule, compute_s=t.compute_s, hbm_s=t.hbm_s,
        n_steps=t.steps, predicted_s=choice.predicted_s,
        measured_s=us * 1e-6, scene=sc, bm=choice.bm, bn=choice.bn,
        bk=choice.bk, tile=choice.tile, fixed_s=t.fixed_s)


def test_fit_handles_thin_buckets_via_ratio():
    samples = [_sample(sc, c, synthetic_measure(sc, c)) for sc in
               scene_grid()[:2] for c in tune.ranked_space(sc, top_k=1)]
    report = tune.fit_calibration(samples)
    assert all(f.method == "ratio" for f in report.classes)
    assert report.median_err_after <= report.median_err_before


def test_fit_skips_unusable_records(tmp_path):
    cache = tune.ScheduleCache(str(tmp_path / "c.json"))
    sc = scene_grid()[0]
    tune.autotune_scene(sc, cache=cache, top_k=2, device="cpu",
                        measure_fn=synthetic_measure)
    rec = dict(cache.get(sc, CPU))
    rec["measured_us"] = float("inf")
    cache.put(dataclasses.replace(sc, B=sc.B + 1), rec, CPU)
    samples, skipped = tune.samples_from_cache(cache)
    assert skipped == 1
    assert samples and all(s.key == cache.key(sc, CPU) for s in samples)


def test_fit_populates_every_fallback_tier(tuned_cache):
    model = tune.fit_calibration(tuned_cache).cost_model()
    assert class_key("*", "*", "*") in model.corrections
    for s in tune.samples_from_cache(tuned_cache)[0]:
        bound = s.cls.split("|")[1]
        assert class_key(s.schedule, bound, "*") in model.corrections
        assert class_key(s.schedule, "*", "*") in model.corrections


# -- parity with the reference's fit ----------------------------------------
def _rel_equal(a, b, rel=1e-9):
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-300)


def test_fit_parity_with_reference(tmp_path, monkeypatch):
    """The reference tunes its scene grid under its own synthetic clock;
    its samples' features, fed as lists to both packages' fits (no fixed
    term on the port's side), give the same per-class fits and audits."""
    def jmeasure(scene, choice):
        bm, bn, bk = (min(choice.bm, scene.M), min(choice.bn, scene.N),
                      min(choice.bk, scene.K))
        scored = jmapping._score(scene, choice.schedule, bm, bn, bk)
        return (max(scored.compute_s, scored.hbm_s) * _TRUE_SCALE
                + jmapping.grid_steps(scene, bm, bn, bk)
                * _TRUE_OVERHEAD_S * (1 + (bm % 7) / 10)) * 1e6

    jcache = jtune.ScheduleCache(str(tmp_path / "ref_cache.json"))
    for d in _dims():
        jtune.autotune_scene(JScene(**d), cache=jcache, top_k=4,
                             measure_fn=jmeasure)
    jsamples, _ = jtune.samples_from_cache(jcache)
    tsamples = [CalibSample(
        key=s.key, cls=s.cls, schedule=s.schedule, compute_s=s.compute_s,
        hbm_s=s.hbm_s, n_steps=float(s.n_steps), predicted_s=s.predicted_s,
        measured_s=s.measured_s, scene=ConvScene(**s.scene.__dict__),
        bm=s.bm, bn=s.bn, bk=s.bk) for s in jsamples]
    want = jtune.fit_calibration(jsamples)
    # the ratio fits scale the base model's per-step overhead: the
    # reference's, for this comparison
    monkeypatch.setattr(mapping, "DEFAULT_COST_MODEL", dataclasses.replace(
        mapping.DEFAULT_COST_MODEL,
        step_overhead_s=jmapping.DEFAULT_COST_MODEL.step_overhead_s))
    got = tune.fit_calibration(tsamples)
    assert {f.method for f in want.classes} == {"lstsq", "ratio"}
    assert [f.cls for f in got.classes] == [f.cls for f in want.classes]
    for g, w in zip(got.classes, want.classes):
        for field in dataclasses.fields(w):
            assert _rel_equal(getattr(g, field.name),
                              getattr(w, field.name)), (w.cls, field.name)
    for field in ("n_records", "median_err_before", "median_err_after"):
        assert _rel_equal(getattr(got, field), getattr(want, field)), field


# -- artifact persistence ---------------------------------------------------
def test_artifact_roundtrip_identical_selections(tuned_cache, tmp_path):
    report = tune.fit_calibration(tuned_cache)
    path = tune.save_calibration(report, str(tmp_path / "calib.json"))
    loaded = tune.load_calibration(path)
    fitted = report.cost_model()
    assert loaded.corrections == fitted.corrections
    assert loaded.is_calibrated and loaded.source == path
    with open(path) as f:
        doc = json.load(f)
    assert doc["tune_version"] == tune.CODE_VERSION
    assert doc["version"] == tune.CALIB_VERSION
    for sc in scene_grid():
        a = select_schedule(sc, model=fitted)
        b = select_schedule(sc, model=loaded)
        assert (a.schedule, a.bm, a.bn, a.bk, a.tile) == \
            (b.schedule, b.bm, b.bn, b.bk, b.tile)
        assert a.predicted_s == pytest.approx(b.predicted_s)


def test_load_rejects_wrong_version(tmp_path):
    path = str(tmp_path / "calib.json")
    with open(path, "w") as f:
        json.dump({"schema": 1, "version": "mg3m-calib-v0",
                   "corrections": {}}, f)
    with pytest.raises(ValueError, match="version"):
        tune.load_calibration(path)


def test_resolve_calibration_path_env(tmp_path, monkeypatch):
    monkeypatch.setenv(tune.calibrate.ENV_VAR, str(tmp_path / "env.json"))
    assert tune.resolve_calibration_path() == str(tmp_path / "env.json")
    assert tune.resolve_calibration_path("/x/y.json") == "/x/y.json"
    monkeypatch.delenv(tune.calibrate.ENV_VAR)
    assert tune.resolve_calibration_path().endswith(
        os.path.join(".cache", "repro_torch", "calibration.json"))


# -- hot-path wiring --------------------------------------------------------
def test_active_model_used_on_selection(tuned_cache):
    sc = scene_grid()[0]
    assert tune.active_cost_model("cpu") is mapping.DEFAULT_COST_MODEL
    assert resolve_choice(sc, None, device="cpu") == select_schedule(sc)
    model = tune.fit_calibration(tuned_cache).cost_model()
    tune.set_active_cost_model(model)
    assert tune.active_cost_model("cpu") is model
    assert resolve_choice(sc, None, device="cpu") == \
        select_schedule(sc, model=model)


def test_artifact_autoload_and_mtime_refresh(tuned_cache):
    path = tune.resolve_calibration_path()
    assert tune.active_cost_model("cpu") is mapping.DEFAULT_COST_MODEL
    tune.save_calibration(tune.fit_calibration(tuned_cache), path)
    os.utime(path, (1, 1))
    model = tune.active_cost_model("cpu")
    assert model.is_calibrated and model.source == path
    assert tune.active_cost_model("cpu") is model     # mtime-cached
    with open(path, "w") as f:
        f.write("{broken")
    os.utime(path, (2, 2))
    assert tune.active_cost_model("cpu") is mapping.DEFAULT_COST_MODEL


def test_malformed_artifact_never_crashes_tuned_path(tmp_path):
    path = tune.resolve_calibration_path()
    with open(path, "w") as f:
        json.dump({"schema": 1, "version": tune.CALIB_VERSION,
                   "tune_version": tune.CODE_VERSION, "backend": CPU,
                   "corrections": {"TB88|compute|ai1": None}}, f)
    tune.set_default_cache(tune.ScheduleCache(str(tmp_path / "empty.json")))
    assert tune.active_cost_model("cpu") is mapping.DEFAULT_COST_MODEL
    sc = scene_grid()[0]
    assert resolve_choice(sc, "auto", device="cpu") == select_schedule(sc)
    assert resolve_choice(sc, None, device="cpu") == select_schedule(sc)


CARD = "cuda:NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("fitted_on, version, device_backend, applies", [
    (CPU, None, CPU, True),
    (CARD, None, CPU, False),       # a card's fit never steers the CPU
    (CPU, None, CARD, False),       # the plain versions' never the card
    (CPU, "mg3m-tune-v1-0000000000", CPU, False),   # an older kernel's
    (None, None, CPU, False),       # a fit over several backends
])
def test_artifact_applies_only_to_its_backend_and_kernel(
        tmp_path, monkeypatch, capsys, fitted_on, version, device_backend,
        applies):
    """An auto-loaded calibration steers a device's picks only when it was
    fitted on that device's backend from the current kernel source; any
    other artifact is ignored with a warning and the picks stay the
    uncalibrated model's."""
    tune.set_default_cache(tune.ScheduleCache(str(tmp_path / "empty.json")))
    sc = ConvScene(B=16, IC=64, OC=64, inH=14, inW=14, fltH=3, fltW=3,
                   padH=1, padW=1)
    base = select_schedule(sc)
    corr = class_key(base.schedule, "*", "*")
    flipped = select_schedule(sc, model=CostModel(corrections={
        corr: ClassCorrection(compute_scale=1e-3, bw_scale=1e-3)}))
    assert flipped.schedule != base.schedule     # premise of the test
    with open(tune.resolve_calibration_path(), "w") as f:
        json.dump({"schema": 1, "version": tune.CALIB_VERSION,
                   "tune_version": version or tune.CODE_VERSION,
                   "backend": fitted_on,
                   "corrections": {corr: {"compute_scale": 1e-3,
                                          "bw_scale": 1e-3,
                                          "overhead_s": None}}}, f)
    monkeypatch.setattr(tune.cache, "default_backend",
                        lambda device=None: device_backend)
    assert tune.active_cost_model("cpu").is_calibrated == applies
    want = flipped if applies else base
    for policy in (None, "auto"):
        assert resolve_choice(sc, policy, device="cpu").schedule == \
            want.schedule
    assert ("ignoring unusable calibration" in capsys.readouterr().err) \
        == (not applies)


def test_tuned_cache_miss_uses_calibrated_model(tmp_path):
    tune.set_default_cache(tune.ScheduleCache(str(tmp_path / "empty.json")))
    sc = ConvScene(B=16, IC=64, OC=64, inH=14, inW=14, fltH=3, fltW=3,
                   padH=1, padW=1)
    base = select_schedule(sc)
    model = CostModel(corrections={
        class_key(base.schedule, "*", "*"):
            ClassCorrection(compute_scale=1e-3, bw_scale=1e-3)})
    flipped = select_schedule(sc, model=model)
    assert flipped.schedule != base.schedule     # premise of the test
    tune.set_active_cost_model(model)
    assert resolve_choice(sc, "auto", device="cpu").schedule == \
        flipped.schedule
    assert resolve_choice(sc, None, device="cpu").schedule == \
        flipped.schedule


def test_bucket_ladder_prices_under_the_active_model():
    from repro_torch.serve.conv import bucket_ladder
    sc = ConvScene(B=1, IC=64, OC=64, inH=14, inW=14, fltH=3, fltW=3,
                   padH=1, padW=1)
    flat = CostModel(corrections={class_key("*", "*", "*"): ClassCorrection(
        compute_scale=1.0, bw_scale=1.0, overhead_s=1.0)})
    assert bucket_ladder(sc, 8, model=flat) == (8,)    # overhead-bound
    tune.set_active_cost_model(flat)
    assert bucket_ladder(sc, 8) == (8,)


# -- CLI --------------------------------------------------------------------
def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")
                + os.pathsep + os.environ.get("PYTHONPATH", ""))


def test_calibrate_cli_roundtrip(tuned_cache, tmp_path):
    out = str(tmp_path / "calib.json")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.calibrate", "--cache",
         tuned_cache.path, "--out", out], capture_output=True, text=True,
        env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "median |pred-meas|/meas" in proc.stdout
    loaded = tune.load_calibration(out)
    fitted = tune.fit_calibration(tuned_cache).cost_model()
    assert set(loaded.corrections) == set(fitted.corrections)
    for cls, corr in fitted.corrections.items():
        got = loaded.corrections[cls]
        assert got.compute_scale == pytest.approx(corr.compute_scale)
        assert got.overhead_s == pytest.approx(corr.overhead_s)
    for sc in scene_grid()[:6]:
        a = select_schedule(sc, model=fitted)
        b = select_schedule(sc, model=loaded)
        assert (a.schedule, a.bm, a.tile) == (b.schedule, b.bm, b.tile)


def test_calibrate_cli_dry_run_writes_nothing(tuned_cache, tmp_path):
    from repro_torch.launch import calibrate as calibrate_cli
    out = tmp_path / "calib.json"
    assert calibrate_cli.main(["--cache", tuned_cache.path, "--out",
                               str(out), "--dry-run"]) == 0
    assert not out.exists()


def test_calibrate_cli_refuses_mixed_backends(tuned_cache, tmp_path,
                                             capsys):
    """A fit over several backends would apply to no device: the launcher
    refuses it unless --backend picks one, and the artifact names the
    backend it was fitted on."""
    from repro_torch.launch import calibrate as calibrate_cli
    assert tune.fit_calibration(tuned_cache).backend == CPU
    sc = scene_grid()[0]
    tuned_cache.put(sc, tuned_cache.get(sc, CPU), CARD)
    tuned_cache.save()
    out = tmp_path / "calib.json"
    args = ["--cache", tuned_cache.path, "--out", str(out)]
    assert calibrate_cli.main(args) == 2
    assert "several backends" in capsys.readouterr().err
    assert not out.exists()
    assert calibrate_cli.main(args + ["--backend", CPU]) == 0
    with open(out) as f:
        assert json.load(f)["backend"] == CPU
    assert tune.load_calibration(str(out), backend=CPU).is_calibrated
    with pytest.raises(ValueError, match="backend"):
        tune.load_calibration(str(out), backend=CARD)


def test_calibrate_cli_empty_cache_errors(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.calibrate", "--cache",
         str(tmp_path / "missing.json"), "--out",
         str(tmp_path / "calib.json")], capture_output=True, text=True,
        env=_env(), timeout=300)
    assert proc.returncode == 2
    assert "no tuned records" in proc.stderr
