"""repro_torch.tune: search space, cache, autotune, tuned dispatch, CLI —
the contracts of tests/test_tune.py on the port's CPU path (the kernels'
plain versions, backend tag ``cpu+plain``), and parity with ``repro.tune``
on the same scenes: identical scene signatures, signatures that parse
across the packages, and ``proxy_scene`` field for field.

Tolerance of the numeric checks: f32 within rtol=atol=1e-4
(tests/test_kernels.py:41)."""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro import tune as jtune
from repro.core.scene import ConvScene as JScene
from repro.plan import build as jbuild

from repro_torch import tune
from repro_torch.analysis.footprint import vmem_bytes
from repro_torch.core import autodiff
from repro_torch.core.mapping import (SCHEDULES, SMEM_BUDGET,
                                      candidate_blocks, select_schedule)
from repro_torch.core.scene import ConvScene
from repro_torch.kernels import ref
from repro_torch.kernels.ops import resolve_choice
from repro_torch.plan import PlanRegistry, make_plan
from repro_torch.plan import build as tbuild
from repro_torch.tune import autotune as autotune_mod
from repro_torch.tune import measure as measure_mod
from repro_torch.tune.cache import choice_to_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu+plain"
SC = ConvScene(B=8, IC=16, OC=24, inH=10, inW=10, fltH=3, fltW=3,
               padH=1, padW=1)
# filter 3x3x512x512 f32 (9.4 MB): TB11's resident filter never fits
BIG = ConvScene(B=16, IC=512, OC=512, inH=8, inW=8, fltH=3, fltW=3,
                padH=1, padW=1)
# tests/test_dilated.py's strided scenes: their dgrad (lhs-dilated,
# apad) and wgrad (rhs-dilated) exec scenes
STRIDED = [dict(B=2, IC=8, OC=4, inH=10, inW=10, fltH=3, fltW=3, padH=1,
                padW=1, stdH=2, stdW=2),
           dict(B=3, IC=5, OC=7, inH=11, inW=9, fltH=3, fltW=3, padH=0,
                padW=0, stdH=3, stdW=2)]


def _cache(tmp_path, name="c.json", **kw):
    return tune.ScheduleCache(str(tmp_path / name), **kw)


def _rec(choice, us, **extra):
    return {"choice": choice_to_dict(choice), "measured_us": us, **extra}


@pytest.fixture
def fresh_default_cache(tmp_path):
    cache = _cache(tmp_path, "default.json")
    tune.set_default_cache(cache)
    yield cache
    tune.set_default_cache(None)


@pytest.fixture(autouse=True)
def no_artifacts(tmp_path, monkeypatch):
    """No test reads or writes a tuning artifact outside its tmp dir."""
    monkeypatch.setenv(tune.cache.ENV_VAR, str(tmp_path / "env_cache.json"))
    monkeypatch.setenv(tune.calibrate.ENV_VAR,
                       str(tmp_path / "env_calib.json"))
    tune.set_active_cost_model(None)
    yield
    tune.set_active_cost_model(None)


# -- space ------------------------------------------------------------------
def test_space_feasible_and_covers_schedules():
    pts = tune.enumerate_space(SC)
    assert {p.schedule for p in pts} == set(SCHEDULES)
    for p in pts:
        assert vmem_bytes(SC, p.schedule, p.bm, p.bn, p.bk,
                          p.tile) <= SMEM_BUDGET


def test_ranked_space_sorted_and_contains_analytic_winner():
    ranked = tune.ranked_space(SC)
    preds = [c.predicted_s for c in ranked]
    assert preds == sorted(preds)
    assert ranked[0] == select_schedule(SC)
    assert tune.ranked_space(SC, top_k=2) == ranked[:2]
    assert len(ranked) == len(tune.enumerate_space(SC))


def test_mapping_candidate_blocks_delegates_to_space():
    for sched in SCHEDULES:
        assert candidate_blocks(SC, sched) == tuple(
            (p.bm, p.bn, p.bk, p.tile) for p in
            tune.enumerate_space(SC, (sched,), vmem_budget=1 << 62))


def test_ranked_space_restricted_schedules_never_substitute():
    with pytest.raises(ValueError, match="TB11"):
        tune.ranked_space(BIG, schedules=("TB11",))
    assert tune.ranked_space(BIG)[0].schedule in ("TB18", "TB88")


# -- signatures -------------------------------------------------------------
@pytest.mark.parametrize("alias", ["float32", "<f4", "f4", torch.float32])
def test_signature_stable_across_dtype_aliases(alias):
    a = dataclasses.replace(SC, dtype="float32")
    b = dataclasses.replace(SC, dtype=alias)
    assert tune.scene_signature(a, backend=CPU) == \
        tune.scene_signature(b, backend=CPU)
    bf = {tune.scene_signature(dataclasses.replace(SC, dtype=d),
                               backend=CPU)
          for d in ("bfloat16", torch.bfloat16, "torch.bfloat16")}
    assert len(bf) == 1 and tune.scene_signature(a, backend=CPU) not in bf


def test_signature_discriminates_dims_backend_and_version():
    key = tune.scene_signature(SC, backend=CPU)
    assert key != tune.scene_signature(dataclasses.replace(SC, B=9),
                                       backend=CPU)
    assert key != tune.scene_signature(SC, backend="cuda:NVIDIA H100")
    assert key != tune.scene_signature(SC, backend=CPU, version="other")
    assert f"v={tune.CODE_VERSION}|" in key


def test_code_version_hashes_the_kernel_source():
    import hashlib
    src = os.path.join(REPO, "src", "repro_torch", "csrc", "mg3m_conv.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:10]
    assert tune.CODE_VERSION.endswith(digest)


def test_default_backend_names_the_device(tmp_path):
    assert tune.default_backend("cpu") == CPU
    assert _cache(tmp_path).key(SC, CPU) == \
        tune.scene_signature(SC, backend=CPU)


@pytest.mark.parametrize("kind", ["fprop", "dgrad", "wgrad"])
@pytest.mark.parametrize("dims", STRIDED + [dict(B=8, IC=16, OC=24, inH=10,
                                                 inW=10, fltH=3, fltW=3,
                                                 padH=1, padW=1)])
def test_signature_parity_with_reference(dims, kind):
    """Same scene, backend and version: the same key in both packages,
    for the forward scenes and the backward exec scenes each package's
    plan/build derives; and each package parses the other's key back to
    the scene."""
    js, ts = JScene(**dims), ConvScene(**dims)
    if kind == "dgrad":
        js, ts = jbuild.grad_input_scene(js), tbuild.grad_input_scene(ts)
    elif kind == "wgrad":
        js, ts = jbuild.grad_filter_scene(js), tbuild.grad_filter_scene(ts)
    for be, v in ((CPU, tune.CODE_VERSION), ("tpu", "mg3m-tune-v1")):
        jkey = jtune.scene_signature(js, backend=be, version=v)
        tkey = tune.scene_signature(ts, backend=be, version=v)
        assert jkey == tkey
    assert tune.scene_from_signature(jkey) == ts
    assert jtune.scene_from_signature(tkey) == js


def test_scene_signature_roundtrip_bf16():
    sc = ConvScene(B=3, IC=5, OC=7, inH=11, inW=13, fltH=3, fltW=5, padH=1,
                   padW=2, stdH=2, stdW=1, dtype="bfloat16")
    assert tune.scene_from_signature(
        tune.scene_signature(sc, backend=CPU)) == sc


# -- cache ------------------------------------------------------------------
def test_cache_roundtrip(tmp_path):
    cache = _cache(tmp_path)
    choice = tune.ranked_space(SC)[0]
    cache.put(SC, _rec(choice, 42.0), CPU)
    cache.save()
    reloaded = _cache(tmp_path)
    assert reloaded.get_choice(SC, CPU) == choice
    assert reloaded.hits == 1
    assert reloaded.get(dataclasses.replace(SC, B=99), CPU) is None
    assert reloaded.misses == 1


def test_cache_lru_eviction_and_merge(tmp_path):
    cache = _cache(tmp_path, max_entries=2)
    choice = tune.ranked_space(SC)[0]
    scenes = [dataclasses.replace(SC, B=b) for b in (1, 2, 3)]
    for s in scenes:
        cache.put(s, _rec(choice, 1.0), CPU)
    assert len(cache) == 2
    assert cache.get(scenes[0], CPU) is None      # evicted
    cache.save()
    slower = _cache(tmp_path, max_entries=8)
    slower.put(scenes[2], _rec(choice, 100.0), CPU)
    slower.save()
    assert _cache(tmp_path).get(scenes[2], CPU)["measured_us"] == 1.0


def test_cache_merge_prefers_exact_over_proxy(tmp_path):
    choice = tune.ranked_space(SC)[0]
    proxy_run = _cache(tmp_path)
    proxy_run.put(SC, _rec(choice, 80.0, proxy={"B": 2}), CPU)
    proxy_run.save()
    exact_run = _cache(tmp_path)
    exact_run.put(SC, _rec(choice, 5000.0, proxy=None), CPU)
    exact_run.save()
    merged = _cache(tmp_path).get(SC, CPU)
    assert merged["measured_us"] == 5000.0 and merged["proxy"] is None
    proxy_again = _cache(tmp_path)
    proxy_again.put(SC, _rec(choice, 1.0, proxy={"B": 2}), CPU)
    proxy_again.save()
    assert _cache(tmp_path).get(SC, CPU)["measured_us"] == 5000.0


def test_cache_lru_bound_applies_on_load(tmp_path):
    choice = tune.ranked_space(SC)[0]
    big = _cache(tmp_path, max_entries=16)
    for b in range(1, 6):
        big.put(dataclasses.replace(SC, B=b), _rec(choice, 1.0), CPU)
    big.save()
    bounded = _cache(tmp_path, max_entries=2)
    assert len(bounded) == 2
    bounded.save()
    assert len(_cache(tmp_path, max_entries=16)) == 5


def test_cache_tolerates_corrupt_artifact_on_init(tmp_path, capsys):
    path = tmp_path / "corrupt.json"
    path.write_text("{truncated")
    cache = tune.ScheduleCache(str(path))
    assert len(cache) == 0
    assert "unreadable cache" in capsys.readouterr().err
    with pytest.raises(json.JSONDecodeError):
        cache.load()


def test_cache_skips_malformed_entries_on_load(tmp_path, capsys):
    choice = tune.ranked_space(SC)[0]
    good = _cache(tmp_path)
    good.put(SC, _rec(choice, 7.0), CPU)
    path = good.save()
    with open(path) as f:
        doc = json.load(f)
    keys = [good.key(dataclasses.replace(SC, B=SC.B + i), CPU)
            for i in (1, 2, 3)]
    doc["entries"][keys[0]] = {"choice": {"schedule": "TB11"},
                               "measured_us": 1.0}     # missing blocks
    doc["entries"][keys[1]] = "not-a-record"
    bad_tile = choice_to_dict(choice)
    bad_tile["tile"] = [7, 7, 7, 7]                    # not a compiled tile
    doc["entries"][keys[2]] = {"choice": bad_tile, "measured_us": 1.0}
    with open(path, "w") as f:
        json.dump(doc, f)
    cache = _cache(tmp_path)
    assert "malformed" in capsys.readouterr().err
    assert len(cache) == 1
    assert cache.get_choice(SC, CPU) == choice
    cache.save()
    with open(path) as f:
        assert set(json.load(f)["entries"]) == {good.key(SC, CPU)}


def test_resolve_cache_path_env(tmp_path, monkeypatch):
    monkeypatch.setenv(tune.cache.ENV_VAR, str(tmp_path / "env.json"))
    assert tune.resolve_cache_path() == str(tmp_path / "env.json")
    assert tune.resolve_cache_path("/x/y.json") == "/x/y.json"
    monkeypatch.delenv(tune.cache.ENV_VAR)
    assert tune.resolve_cache_path().endswith(
        os.path.join(".cache", "repro_torch", "tune_cache.json"))


# -- autotune ---------------------------------------------------------------
def test_autotune_picks_measured_winner_over_analytic(tmp_path):
    cache = _cache(tmp_path)
    analytic = select_schedule(SC)
    fake = lambda s, c: 1.0 if c.schedule != analytic.schedule else 1000.0
    t = tune.autotune_scene(SC, cache=cache, top_k=8, device="cpu",
                            measure_fn=fake)
    assert t.choice.schedule != analytic.schedule
    assert not t.agrees_with_analytic
    assert (t.measured_us, t.analytic_measured_us) == (1.0, 1000.0)
    assert t.analytic_schedule == analytic.schedule
    assert t.prediction_error >= 0 and t.backend == CPU
    hits0 = cache.hits
    t2 = tune.autotune_scene(SC, cache=cache, device="cpu",
                             measure_fn=lambda s, c: 1 / 0)  # must not run
    assert cache.hits == hits0 + 1 and t2.choice == t.choice


def test_autotune_all_candidates_failing_does_not_poison_cache(tmp_path):
    cache = _cache(tmp_path)
    t = tune.autotune_scene(SC, cache=cache, top_k=4, device="cpu",
                            measure_fn=lambda s, c: math.inf)
    assert t.choice == select_schedule(SC)
    assert not math.isfinite(t.measured_us)
    assert len(cache) == 0 and cache.get(SC, CPU) is None


def test_autotune_dedups_candidates_aliased_by_proxy_clipping(tmp_path):
    cache = _cache(tmp_path)
    big = ConvScene(B=64, IC=128, OC=256, inH=14, inW=14, fltH=3, fltW=3,
                    padH=1, padW=1)
    calls = []
    t = tune.autotune_scene(big, cache=cache, top_k=16, device="cpu",
                            measure_batch=2, measure_max_ch=16,
                            measure_max_hw=6,
                            measure_fn=lambda s, c: calls.append(c) or 1.0)
    msc = tune.proxy_scene(big, measure_batch=2, measure_max_ch=16,
                           measure_max_hw=6)
    executed = [autotune_mod.clip_choice(msc, c) for c in calls]
    assert len(executed) == len(set(executed)), "aliases measured twice"
    assert t.n_candidates == len(calls) <= 16
    for c in calls:      # each measured point is a launchable plan there
        make_plan(msc, policy=c, device="cpu")


def test_autotune_reuses_analytic_timing_on_clipped_key(tmp_path,
                                                        monkeypatch):
    big = ConvScene(B=64, IC=128, OC=256, inH=14, inW=14, fltH=3, fltW=3,
                    padH=1, padW=1)
    caps = dict(measure_batch=2, measure_max_ch=16, measure_max_hw=6)
    msc = tune.proxy_scene(big, **caps)
    ranked = tune.ranked_space(big, top_k=16)
    # an "analytic" favorite whose full blocks differ from every measured
    # candidate but that clips to the execution of one of them
    real = ranked[0]
    fake = dataclasses.replace(real, bm=real.bm + 8, bk=real.bk + 8)
    assert autotune_mod.clip_choice(msc, fake) == \
        autotune_mod.clip_choice(msc, real)
    monkeypatch.setattr(autotune_mod, "select_schedule",
                        lambda scene, *a, **k: fake)
    measured = []
    t = tune.autotune_scene(big, cache=_cache(tmp_path), top_k=16,
                            device="cpu", **caps,
                            measure_fn=lambda s, c: measured.append(c)
                            or 1.0)
    executed = [autotune_mod.clip_choice(msc, c) for c in measured]
    assert len(executed) == len(set(executed))
    assert t.analytic_measured_us == 1.0


def test_autotune_real_measurement_smoke(tmp_path):
    cache = _cache(tmp_path)
    sc = ConvScene(B=4, IC=8, OC=8, inH=7, inW=7, fltH=1, fltW=1)
    t = tune.autotune_scene(sc, cache=cache, top_k=2, iters=1,
                            device="cpu")
    assert math.isfinite(t.measured_us) and t.measured_us > 0
    assert t.n_candidates == 2
    assert tune.TunedChoice.from_record(cache.get(sc, CPU)) == t


def test_autotune_proxy_scene_caps_recorded(tmp_path):
    t = tune.autotune_scene(SC, cache=_cache(tmp_path), top_k=1, iters=1,
                            device="cpu", measure_batch=2,
                            measure_max_ch=8, measure_max_hw=6)
    assert t.proxy == {"B": 2, "IC": 8, "OC": 8, "inH": 6, "inW": 6}
    assert math.isfinite(t.measured_us)


def test_measure_counts_failures_and_scores_inf(monkeypatch):
    from repro_torch.obs.metrics import default_metrics
    c = default_metrics().counter("repro.tune.measure_failures")
    before = c.value
    bad = dataclasses.replace(tune.ranked_space(SC)[0], tile=(7, 7, 7, 7))
    assert tune.measure_choice(SC, bad, device="cpu") == math.inf
    assert c.value == before + 1


def test_measure_timeout_enforced_during_warmup(monkeypatch):
    calls = []

    class SlowPlan:
        def execute(self, inp, flt):
            calls.append(1)
            time.sleep(0.05)

    monkeypatch.setattr(measure_mod, "make_operands",
                        lambda scene, seed=0, device=None: (None, None))
    monkeypatch.setattr(tbuild, "make_plan", lambda *a, **k: SlowPlan())
    choice = tune.ranked_space(SC, top_k=1)[0]
    t0 = time.perf_counter()
    us = tune.measure_choice(SC, choice, device="cpu", warmup=100, iters=3,
                             timeout_s=0.01)
    assert us == math.inf
    assert len(calls) <= 2
    assert time.perf_counter() - t0 < 2.0


# -- proxy scenes -------------------------------------------------------------
def test_proxy_scene_keeps_filter_window_valid():
    sc = ConvScene(B=128, IC=3, OC=64, inH=224, inW=224, fltH=11, fltW=11,
                   padH=2, padW=2, stdH=4, stdW=4)   # alexnet L0
    p = tune.proxy_scene(sc, measure_batch=2, measure_max_ch=16,
                         measure_max_hw=8)
    assert p.outH > 0 and p.outW > 0
    assert (p.B, p.IC, p.OC) == (2, 3, 16)
    assert tune.proxy_scene(sc, measure_max_hw=4).inH == 7


def test_proxy_scene_never_exceeds_original_dims():
    sc = ConvScene(B=2, IC=4, OC=4, inH=5, inW=5, fltH=3, fltW=3)
    p = tune.proxy_scene(sc, measure_max_hw=64)
    assert (p.inH, p.inW) == (5, 5)


def test_cnn_layer_scenes_caps_through_the_tune_proxy():
    from repro_torch.models.cnn import cnn_layer_scenes, cnn_scenes
    capped = cnn_layer_scenes(("vgg",), 2, max_hw=6, max_ch=16)
    for i, sc in enumerate(cnn_scenes(2)["vgg"]):
        assert capped[f"vgg/L{i}"] == tune.proxy_scene(
            sc, measure_max_ch=16, measure_max_hw=6)


def test_proxy_scene_parity_property():
    """The port's proxy equals the reference's field for field."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=200, deadline=None)
    @hyp.given(inH=st.integers(3, 64), inW=st.integers(3, 64),
               padH=st.integers(0, 3), padW=st.integers(0, 3),
               fltH=st.integers(1, 11), fltW=st.integers(1, 11),
               stdH=st.integers(1, 4), stdW=st.integers(1, 4),
               dilH=st.integers(1, 3), fdilW=st.integers(1, 2),
               apadH=st.integers(0, 1), b=st.integers(1, 16),
               ch=st.integers(1, 40),
               caps=st.tuples(st.none() | st.integers(1, 8),
                              st.none() | st.integers(1, 32),
                              st.none() | st.integers(1, 16)))
    def prop(inH, inW, padH, padW, fltH, fltW, stdH, stdW, dilH, fdilW,
             apadH, b, ch, caps):
        dims = dict(B=b, IC=ch, OC=ch + 3, inH=inH, inW=inW, fltH=fltH,
                    fltW=fltW, padH=padH, padW=padW, stdH=stdH, stdW=stdW,
                    dilH=dilH, fdilW=fdilW, apadH=apadH)
        try:
            js = JScene(**dims)
        except ValueError:
            with pytest.raises(ValueError):
                ConvScene(**dims)
            return
        kw = dict(zip(("measure_batch", "measure_max_ch", "measure_max_hw"),
                      caps))
        jp = jtune.proxy_scene(js, **kw)
        tp = tune.proxy_scene(ConvScene(**dims), **kw)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        assert tp.outH > 0 and tp.outW > 0

    prop()


# -- the tuned policy ---------------------------------------------------------
def test_tuned_policy_hit_and_miss(fresh_default_cache):
    cache = fresh_default_cache
    assert resolve_choice(SC, "auto", device="cpu") == select_schedule(SC)
    assert (cache.misses, cache.hits) == (1, 0)
    other = next(c for c in tune.ranked_space(SC)
                 if c.schedule != select_schedule(SC).schedule)
    cache.put(SC, _rec(other, 1.0), CPU)
    assert resolve_choice(SC, "auto", device="cpu") == other
    assert tune.resolve_schedule(SC, device="cpu") == other
    assert cache.hits == 2


def test_tuned_plan_resolves_from_cache_and_matches_oracle(
        fresh_default_cache):
    cache = fresh_default_cache
    tune.autotune_scene(SC, cache=cache, top_k=2, iters=1, device="cpu")
    hits0 = cache.hits
    plan = make_plan(SC, policy="tuned", device="cpu")
    assert cache.hits == hits0 + 1 and plan.policy == "tuned"
    assert plan.choice == cache.get_choice(SC, CPU)
    rng = np.random.default_rng(0)
    inp = torch.from_numpy(rng.standard_normal(SC.in_shape(),
                                               dtype=np.float32))
    flt = torch.from_numpy(rng.standard_normal(SC.flt_shape(),
                                               dtype=np.float32))
    got = plan.execute(inp, flt)
    analytic = make_plan(SC, policy="analytic", device="cpu").execute(inp,
                                                                      flt)
    torch.testing.assert_close(got, analytic, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, ref.conv_ref(inp, flt, SC), rtol=1e-4,
                               atol=1e-4)


def test_mg3m_conv_accepts_explicit_choice():
    from repro_torch.core.conv import mg3m_conv
    choice = tune.ranked_space(SC)[-1]   # worst-predicted, still feasible
    inp, flt = tune.make_operands(SC, device="cpu")
    torch.testing.assert_close(
        mg3m_conv(inp, flt, SC, schedule=choice, device="cpu"),
        ref.conv_ref(inp, flt, SC), rtol=1e-4, atol=1e-4)


def test_make_operands_seeded_on_the_device():
    a = tune.make_operands(SC, seed=3, device="cpu")
    b = tune.make_operands(SC, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == SC.in_shape() and a[1].shape == SC.flt_shape()
    bf = tune.make_operands(dataclasses.replace(SC, dtype="bfloat16"),
                            device="cpu")
    assert bf[0].dtype == torch.bfloat16


def test_tuned_training_plans_resolve_backward_scenes_from_cache(
        fresh_default_cache):
    """dgrad and wgrad follow fprop into the cache: their exec scenes are
    what gets tuned and resolved."""
    cache = fresh_default_cache
    sc = ConvScene(B=2, IC=8, OC=4, inH=10, inW=10, fltH=3, fltW=3,
                   padH=1, padW=1, stdH=2, stdW=2)
    exec_scenes = [sc, tbuild.grad_input_scene(sc),
                   tbuild.grad_filter_scene(sc)]
    fake = lambda s, c: 1.0 if c.schedule == "TB88" else 5.0
    for es in exec_scenes:
        tune.autotune_scene(es, cache=cache, top_k=8, device="cpu",
                            measure_fn=fake)
    hits0 = cache.hits
    plans = autodiff.make_training_plans(sc, policy="tuned", device="cpu")
    assert cache.hits == hits0 + 3
    for plan, es in zip((plans.fprop, plans.dgrad, plans.wgrad),
                        exec_scenes):
        assert plan.exec_scene == es
        assert plan.choice == cache.get_choice(es, CPU)
        assert plan.policy == "tuned"


def test_tuned_model_plans_on_a_registry(fresh_default_cache):
    cache = fresh_default_cache
    scenes = {"a/L0": SC, "a/L1": dataclasses.replace(
        SC, IC=24, OC=16)}
    for sc in scenes.values():
        for es in (sc, tbuild.grad_input_scene(sc),
                   tbuild.grad_filter_scene(sc)):
            tune.autotune_scene(es, cache=cache, top_k=2, device="cpu",
                                measure_fn=lambda s, c: 1.0)
    reg = PlanRegistry(device="cpu")
    hits0 = cache.hits
    plans = autodiff.make_model_plans(scenes, policy="tuned", registry=reg)
    assert cache.hits - hits0 == 6 == len(reg)
    for _, op, plan in plans.plans():
        assert plan.choice == cache.get_choice(plan.exec_scene, CPU), op


# -- CLI --------------------------------------------------------------------
def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")
                + os.pathsep + os.environ.get("PYTHONPATH", ""))


def test_tune_cli_writes_resolvable_artifact(tmp_path):
    """``launch.tune`` tunes two capped VGG scenes on the CPU, then
    ``launch.calibrate`` fits them; a "tuned" plan built in a fresh
    process resolves from the artifact."""
    cache_path = str(tmp_path / "cli_cache.json")
    calib_path = str(tmp_path / "cli_calib.json")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", "--device", "cpu",
         "--nets", "vgg", "--batch", "2", "--limit", "2", "--cache",
         cache_path, "--top-k", "2", "--iters", "1", "--measure-max-hw",
         "6"], capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "vgg_L0" in proc.stdout and "vgg_L1" in proc.stdout
    with open(cache_path) as f:
        assert len(json.load(f)["entries"]) == 2
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.calibrate", "--cache",
         cache_path, "--out", calib_path, "--backend", CPU],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "median |pred-meas|/meas" in proc.stdout

    code = (
        "from repro_torch import tune\n"
        "from repro_torch.models.cnn import cnn_scenes\n"
        "from repro_torch.plan import make_plan\n"
        "sc = cnn_scenes(2)['vgg'][0]\n"
        "plan = make_plan(sc, policy='tuned', device='cpu')\n"
        "c = tune.default_cache()\n"
        "print(c.hits, c.misses, plan.choice == c.get_choice(sc, "
        "'cpu+plain'), tune.active_cost_model('cpu').is_calibrated)\n")
    env = dict(_env(), **{tune.cache.ENV_VAR: cache_path,
                          tune.calibrate.ENV_VAR: calib_path})
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["1", "0", "True", "True"]


def test_tune_cli_rejects_unknown_net(tmp_path):
    from repro_torch.launch import tune as tune_cli
    assert tune_cli.main(["--device", "cpu", "--nets", "nope", "--cache",
                          str(tmp_path / "c.json")]) == 2
