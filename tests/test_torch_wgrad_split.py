"""The weight gradient's split reduction (``core.scene.WgradScene``,
``core.mapping.wgrad_segments``, ``ConvPlan.seg_taps``,
``kernels.mg3m_conv.segment_sum``) on the CPU.

A wgrad exec scene contracts the forward's output pixels x batch; where
that reduction is long, ``grad_filter_scene`` returns a ``WgradScene``,
whose plans cut it into segments of whole taps, sum each from zero in the
kernels' order and add the segments' f32 partials in segment order.
Here, on scenes small enough for the plain versions but long
enough for three segments or more: the split plans within
rtol=atol=1e-4 of the JAX package's wgrad plans (their plain route), the
segments covering every reduction value once on whole taps and equal for
a scene and its batch/oc/h sub-scenes (bitwise sharded results), fprop
and dgrad never split, tuned and analytic plans bitwise equal, the
verifier's and the cost model's view of the split launch, and the split
of the full-width ResNet trunk's ten wgrad scenes; the scene's type
carries the split through partitions, tuning keys and fprop-form plans,
and an exact TB18 choice on a split is refused on every path."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scene import ConvScene as JScene
from repro.plan import ConvOp as JOp
from repro.plan import make_plan as j_make_plan

from repro_torch import tune
from repro_torch.analysis import verify as V
from repro_torch.analysis.footprint import tiles, vmem_bytes
from repro_torch.core import mapping
from repro_torch.core.scene import WGRAD_SEGMENT_R, ConvScene, WgradScene
from repro_torch.kernels import mg3m_conv as K
from repro_torch.models.cnn import cnn_chain_scenes
from repro_torch.plan import (ConvOp, assemble_plan, grad_filter_scene,
                              make_plan, plan_from_dict, plan_to_dict)
from repro_torch.plan.build import (derive_exec_spec, launched_shapes,
                                    wgrad_finish, wgrad_operands)
from repro_torch.plan.registry import valid_plan_dict
from repro_torch.shard import (make_sharded_plan, pinned_shard_spec,
                               shard_blocker, shard_sub_scene)
from repro_torch.shard.spec import select_shard_spec
from repro_torch.tune.cache import choice_to_dict

TOL = dict(rtol=1e-4, atol=1e-4)
RING = ("cpu",) * 8

# Forward scenes whose wgrad exec scene splits into three segments or more
# (seg_taps = WGRAD_SEGMENT_R // B taps of the forward's outH x outW):
# padded, strided (the exec scene rhs-dilated by the stride) with a
# stride remainder, and a 1 x 1 layer.
SCENES = {
    "padded": dict(B=16, IC=4, OC=6, inH=18, inW=18, fltH=3, fltW=3,
                   padH=1, padW=1, stdH=1, stdW=1),
    "strided": dict(B=8, IC=3, OC=5, inH=38, inW=35, fltH=3, fltW=3,
                    padH=1, padW=1, stdH=2, stdW=2),
    "one_by_one": dict(B=16, IC=5, OC=7, inH=16, inW=17, fltH=1, fltW=1,
                       padH=0, padW=0, stdH=1, stdW=1),
}
# a layer wide enough (OC 64) for the tuner to have several candidates
TUNED = dict(B=16, IC=4, OC=64, inH=18, inW=18, fltH=3, fltW=3, padH=1,
             padW=1, stdH=1, stdW=1)
# the full-width trunk at the training microbatch (8): S of L0 ... L9
TRUNK_SEGMENTS = (98, 98, 98, 98, 25, 25, 7, 7, 2, 2)


@pytest.fixture(autouse=True)
def _isolated_tuning(tmp_path, monkeypatch):
    """No tuned entry or calibration from outside the test."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE",
                       str(tmp_path / "tune_cache.json"))
    monkeypatch.setenv("REPRO_TORCH_CALIBRATION",
                       str(tmp_path / "calibration.json"))
    tune.set_default_cache(None)
    yield
    tune.set_default_cache(None)


def _operands(scene: ConvScene, op: str, seed: int = 5):
    shapes = {"fprop": (scene.in_shape(), scene.flt_shape()),
              "dgrad": (scene.out_shape(), scene.flt_shape()),
              "wgrad": (scene.in_shape(), scene.out_shape())}[op]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_split_wgrad_matches_reference(name):
    """The split wgrad plan within 1e-4 of the JAX package's wgrad plan
    (plain route) on the same seeded operands."""
    kw = SCENES[name]
    sc = ConvScene(**kw)
    plan = make_plan(sc, "wgrad", device="cpu")
    assert plan.segments >= 3 and plan.seg_taps > 0
    a, b = _operands(sc, "wgrad")
    want = np.asarray(j_make_plan(JScene(**kw), JOp("wgrad"),
                                  use_pallas=False).execute(jnp.asarray(a),
                                                            jnp.asarray(b)))
    got = plan.execute(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_segments_cover_the_reduction_on_whole_taps(name):
    """Every reduction value r = tap * K + k in exactly one segment, each
    segment whole taps in order, every segment but the last
    ``seg_taps`` taps long."""
    es = grad_filter_scene(ConvScene(**SCENES[name]))
    seg = es.seg_taps
    bounds = mapping.wgrad_segments(es)
    r_total = es.fltH * es.fltW * es.K
    assert bounds[0][0] == 0 and bounds[-1][1] == r_total
    for (r0, r1), (n0, _) in zip(bounds, bounds[1:]):
        assert r1 == n0
    assert all(r0 % es.K == 0 and r1 % es.K == 0 for r0, r1 in bounds)
    assert all(r1 - r0 == seg * es.K for r0, r1 in bounds[:-1])
    assert 0 < bounds[-1][1] - bounds[-1][0] <= seg * es.K
    assert seg * es.K <= WGRAD_SEGMENT_R


@pytest.mark.parametrize("name", sorted(SCENES))
def test_split_kernel_call_is_its_segmented_plain_version(name):
    """The wrapper a split plan launches, on its own operands, is bitwise
    ``conv_plain`` with the plan's segments, whose last step is
    ``segment_sum_plain`` over the per-segment partials."""
    sc = ConvScene(**SCENES[name])
    plan = make_plan(sc, "wgrad", device="cpu")
    a, b = (torch.from_numpy(x) for x in _operands(sc, "wgrad"))
    fn, inp, flt, blocks = plan.kernel_call(a, b)
    assert blocks["seg_taps"] == plan.seg_taps
    got = fn(inp, flt, plan.exec_scene, **blocks)
    assert torch.equal(got, K.conv_plain(inp, flt, plan.exec_scene,
                                         plan.seg_taps))
    # the partials by hand: segment s over its taps alone, then in order
    es = plan.exec_scene
    fh, fw = es.fltH, es.fltW
    parts = []
    for r0, r1 in mapping.wgrad_segments(es):
        t0, t1 = r0 // es.K, r1 // es.K
        mask = torch.zeros(fh * fw, dtype=torch.bool)
        mask[t0:t1] = True
        sub = flt * mask.view(fh, fw, 1, 1)
        parts.append(K.conv_plain(inp, sub, es).float())
    whole = K.segment_sum_plain(parts, inp.dtype)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)


def test_segment_sum_adds_in_segment_order():
    """(1e8 + 1) - 1e8 is 0 in f32, so the order of the adds shows; the
    CPU wrapper is the plain version and counts no launch."""
    parts = torch.tensor([[1e8, 1.0], [1.0, 1e8], [-1e8, -1e8]])
    K.reset_launch_counts()
    out = K.segment_sum(parts, torch.float32)
    assert out.tolist() == [0.0, 0.0]
    assert torch.equal(out, K.segment_sum_plain(parts, torch.float32))
    assert K.segment_sum.launches == 0
    bf = K.segment_sum(torch.ones(4, 3, 2), torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and torch.equal(bf.float(),
                                                      torch.full((3, 2), 4.))
    with pytest.raises(ValueError, match="f32"):
        K.segment_sum(torch.ones(4, 3, dtype=torch.float64), torch.float32)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_segments_equal_for_batch_oc_h_sub_scenes(name):
    """A batch, oc or h partition keeps the wgrad exec scene's reduction
    and so its segments; an ic partition changes K."""
    es = grad_filter_scene(ConvScene(**SCENES[name]))
    for axis in ("batch", "oc", "h"):
        for n in (2, 3):
            if shard_blocker(es, axis, n):
                continue
            sub = shard_sub_scene(es, axis, n)
            assert isinstance(sub, WgradScene)
            assert mapping.wgrad_segments(sub) == mapping.wgrad_segments(es)
    if not shard_blocker(es, "ic", 2):
        sub = shard_sub_scene(es, "ic", 2)
        assert sub.K != es.K


def _sharded_cases():
    for name, kw in SCENES.items():
        es = grad_filter_scene(ConvScene(**kw))
        for axis in ("batch", "oc", "h", "ic"):
            n = 3 if not shard_blocker(es, axis, 3) else 2
            if not shard_blocker(es, axis, n):
                yield name, axis, n


@pytest.mark.parametrize("name, axis, n", list(_sharded_cases()))
def test_sharded_split_wgrad(name, axis, n):
    """Pinned partitions of a split wgrad: batch/oc/h bitwise the
    one-device plan (the same segments), ic within 1e-4; every inner plan
    split as the rule splits its sub-scene."""
    sc = ConvScene(**SCENES[name])
    es = grad_filter_scene(sc)
    sub = shard_sub_scene(es, axis, n)
    choice = mapping.select_schedule(sub)
    plan = make_sharded_plan(sc, "wgrad", devices=RING,
                             spec=pinned_shard_spec(sc, "wgrad", axis, n,
                                                    choice))
    assert all(p.seg_taps == sub.seg_taps for p in plan.inners)
    assert not V.verify_sharded_plan(plan)
    a, b = (torch.from_numpy(x) for x in _operands(sc, "wgrad"))
    got = plan.execute(a, b)
    one = make_plan(sc, "wgrad", device="cpu").execute(a, b)
    if axis == "ic":
        np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)
    else:
        assert torch.equal(got, one)


def test_selected_sharded_wgrad_never_picks_tb18_on_a_split():
    """The joint selector prices every (sub-)scene's split: no TB18 where
    the sub-scene's reduction splits."""
    for kw in SCENES.values():
        es = grad_filter_scene(ConvScene(**kw))
        spec = select_shard_spec(es, max_shards=4)
        if spec.sub_scene.seg_taps:
            assert spec.choice.schedule != "TB18"


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("op", ("fprop", "dgrad"))
def test_fprop_and_dgrad_never_split(name, op):
    """S is 1 for every fprop and dgrad plan, forced grains included, and
    their launches are bitwise ``conv_plain`` without segments."""
    sc = ConvScene(**SCENES[name])
    a, b = (torch.from_numpy(x) for x in _operands(sc, op))
    for policy in ("analytic", "TB11", "TB18", "TB88"):
        try:
            plan = make_plan(sc, op, device="cpu", policy=policy)
        except ValueError:
            continue   # the grain does not fit this scene
        assert plan.seg_taps == 0 and plan.segments == 1
        fn, inp, flt, blocks = plan.kernel_call(a, b)
        assert "seg_taps" not in blocks
        assert torch.equal(fn(inp, flt, plan.exec_scene, **blocks),
                           K.conv_plain(inp, flt, plan.exec_scene))


def test_split_excludes_tb18_and_forced_tb18_raises():
    sc = ConvScene(**SCENES["padded"])
    es = grad_filter_scene(sc)
    with pytest.raises(ValueError, match="TB18"):
        make_plan(sc, "wgrad", device="cpu", policy="TB18")
    with pytest.raises(ValueError, match="TB18"):
        mapping.select_schedule(es, allowed=("TB18",))
    from repro_torch.tune.space import enumerate_space
    assert all(p.schedule != "TB18" for p in enumerate_space(es))
    assert mapping.cost_terms(es, "TB18", 8, es.N, es.K,
                              tile=(8, 64, 4, 2)) is None
    with pytest.raises(ValueError, match="TB18"):
        K.launch_spec(es, "TB18", in_shape=K.launched_in_hw(es)
                      + (es.K, es.N), flt_shape=es.flt_shape(), bm=es.M,
                      tile=(8, 64, 4, 2), seg_taps=es.seg_taps)


def _tb18_choice(scene):
    return mapping.ScheduleChoice("TB18", 8, scene.N, scene.K, 1e-3, 1e-3,
                                  1e-3, 0, tile=(8, 64, 4, 2))


def test_exact_tb18_choice_on_a_split_raises():
    """An exact TB18 ``ScheduleChoice`` on a split reduction raises on
    every path that pins one (``make_plan``, the registry's
    ``assemble_plan`` and ``plan_from_dict``, a pinned shard spec), with
    ``select_schedule``'s message; on the same dims unsplit it builds."""
    sc = ConvScene(**SCENES["padded"])
    es = grad_filter_scene(sc)
    tb18 = _tb18_choice(es)
    msg = mapping.split_tb18_error(es)
    with pytest.raises(ValueError) as e:
        mapping.select_schedule(es, allowed=("TB18",))
    assert str(e.value) == msg
    for build in (
            lambda: make_plan(sc, "wgrad", device="cpu", policy=tb18),
            lambda: make_plan(es, "fprop", device="cpu", policy=tb18),
            lambda: assemble_plan(sc, "wgrad", "analytic", tb18,
                                  device="cpu"),
            lambda: make_sharded_plan(sc, "wgrad", devices=RING,
                                      spec=pinned_shard_spec(
                                          sc, "wgrad", "oc", 2, tb18))):
        with pytest.raises(ValueError) as e:
            build()
        assert msg.split(" of ")[0] in str(e.value)
    d = plan_to_dict(make_plan(sc, "wgrad", device="cpu"))
    d["choice"] = choice_to_dict(tb18)
    with pytest.raises(ValueError, match="TB18"):
        plan_from_dict(d)
    assert not valid_plan_dict(d)
    whole = ConvScene(**es.__dict__)
    assert make_plan(whole, "fprop", device="cpu",
                     policy=tb18).seg_taps == 0


def test_wgrad_scene_carries_the_split():
    """``grad_filter_scene`` returns a ``WgradScene`` only where the rule
    splits (an unsplit exec scene stays a plain ``ConvScene``); the same
    dims as a ``ConvScene`` never split; an fprop-form plan over the
    ``WgradScene`` is the WGRAD plan's launch, bitwise; the tune key's
    ``|split=wgrad`` parses back to a ``WgradScene``."""
    sc = ConvScene(**SCENES["strided"])
    es = grad_filter_scene(sc)
    assert type(es) is WgradScene and es.seg_taps > 0
    whole = ConvScene(**es.__dict__)
    assert whole.seg_taps == 0 and whole != es
    assert mapping.wgrad_segments(whole) == ((0, es.fltH * es.fltW * es.K),)
    short = grad_filter_scene(ConvScene(B=2, IC=3, OC=4, inH=8, inW=8,
                                        fltH=3, fltW=3, padH=1, padW=1))
    assert type(short) is ConvScene and short.seg_taps == 0
    assert type(es.with_batch(es.B + 1)) is WgradScene
    wg = make_plan(sc, "wgrad", device="cpu")
    fp = make_plan(es, "fprop", device="cpu")
    assert fp.seg_taps == wg.seg_taps and fp.choice == wg.choice
    a, b = (torch.from_numpy(x) for x in _operands(sc, "wgrad"))
    out = fp.execute(*wgrad_operands(a, b))[:sc.fltH, :sc.fltW]
    assert torch.equal(wgrad_finish(out), wg.execute(a, b))
    key = tune.scene_signature(es, backend="cpu")
    assert key.endswith("|split=wgrad")
    assert tune.scene_from_signature(key) == es
    assert tune.scene_signature(whole, backend="cpu") + "|split=wgrad" == key


def test_tuned_and_analytic_wgrad_plans_are_bitwise_equal():
    """A tuned wgrad exec scene, its measured winner made to differ from
    the analytic pick, resolves under ``policy="tuned"`` from its own
    split key; the tuned and analytic plans sum in one order."""
    sc = ConvScene(**TUNED)
    analytic = make_plan(sc, "wgrad", device="cpu")
    es = analytic.exec_scene
    cache = tune.ScheduleCache()
    tune.set_default_cache(cache)

    def fake(msc, choice):   # the analytic pick measured slowest
        same = (choice.schedule, choice.tile, choice.bm) == (
            analytic.choice.schedule, analytic.choice.tile,
            analytic.choice.bm)
        return 1e6 if same else 10.0 + choice.bm

    rec = tune.autotune_scene(es, cache=cache, top_k=4, device="cpu",
                              measure_fn=fake)
    assert rec.choice.schedule != "TB18"
    assert (rec.choice.schedule, rec.choice.tile, rec.choice.bm) != (
        analytic.choice.schedule, analytic.choice.tile, analytic.choice.bm)
    key = cache.key(es, tune.default_backend("cpu"))
    assert key.endswith("|split=wgrad") and key in cache.records()
    assert cache.get(ConvScene(**es.__dict__),
                     tune.default_backend("cpu")) is None
    tuned = make_plan(sc, "wgrad", device="cpu", policy="tuned")
    assert tuned.choice == rec.choice and tuned.seg_taps == analytic.seg_taps
    a, b = (torch.from_numpy(x) for x in _operands(sc, "wgrad"))
    assert torch.equal(tuned.execute(a, b), analytic.execute(a, b))


def test_split_launch_verifies_and_mutations_are_found():
    """``check_launch`` on split launches of both grains: clean, its step
    and MAC counts the cost model's; a segment visited twice and a Geom
    whose segments miss reduction values are found.  TB11's resident
    filter does not fit a split of WGRAD_SEGMENT_R values a segment, so
    its split launch is checked at a short ``seg_taps`` the wrappers
    take, on a small scene, on every TB11 tile that runs it."""
    small = grad_filter_scene(ConvScene(B=2, IC=3, OC=4, inH=8, inW=8,
                                        fltH=3, fltW=3, padH=1, padW=1,
                                        stdH=1, stdW=1))
    for tile in tiles("TB11", small.M):
        choice = mapping.ScheduleChoice("TB11", small.M, small.N, small.K,
                                        0.0, 0.0, 0.0, 0, tile=tile)
        spec = derive_exec_spec(small, choice)
        in_shape, flt_shape = launched_shapes(small, spec)
        for seg_taps in (5, 16, 63):
            launch = V.kernel_launch(small, "TB11", in_shape=in_shape,
                                     flt_shape=flt_shape, bm=spec.bm,
                                     bn=spec.bn, bk=spec.bk, tile=tile,
                                     seg_taps=seg_taps)
            assert launch.segments == -(-64 // seg_taps)
            findings = V.check_launch(launch)
            assert not V.errors(findings), findings
    sc = ConvScene(**SCENES["strided"])
    es = grad_filter_scene(sc)
    seg = es.seg_taps
    plan = make_plan(sc, "wgrad", device="cpu", policy="TB88")
    assert plan.seg_taps == seg and not V.verify_plan(plan)
    assert not V.errors(V.verify_point(es, "TB88", bm=min(es.M, 64)))
    a, b = (torch.from_numpy(x) for x in _operands(sc, "wgrad"))
    _, inp, flt, blocks = plan.kernel_call(a, b)
    launch = V.kernel_launch(es, "TB88", in_shape=inp.shape,
                             flt_shape=flt.shape, **blocks)
    assert launch.segments == len(mapping.wgrad_segments(es)) >= 3
    assert not V.errors(V.check_launch(launch))

    def twice(L):
        s = V.kernel_walk_segments(L)
        return np.where(s == 1, 0, s)
    codes = {f.code for f in V.check_launch(
        dataclasses.replace(launch, seg_walk=twice))}
    assert {"out-overlap", "out-coverage"} <= codes
    short = dataclasses.replace(launch, geom={
        **launch.geom, "nseg": launch.segments - 1})
    assert "reduction-coverage" in {f.code for f in V.check_launch(short)}
    other = dataclasses.replace(launch, geom={**launch.geom,
                                              "seg_taps": seg - 1})
    assert "grid-structure" in {f.code for f in V.check_launch(other)}


def test_cost_model_prices_the_split():
    """Split launches: S times the work items, chunk steps per segment,
    TB11's resident filter a chunk boundary per segment, and the second
    pass's bytes; the modeled time of the trunk's L0 wgrad falls."""
    es = grad_filter_scene(cnn_chain_scenes("resnet")["resnet/L0"]
                           .with_batch(8))
    n_seg = len(mapping.wgrad_segments(es))
    tile = (64, 32, 4, 4)
    steps = mapping.grid_steps(es, "TB88", 64, 8, tile)
    n_ct = -(-es.outH * es.outW * es.N // 32)
    assert steps == n_ct * sum(-(-(r1 - r0) // 32)
                               for r0, r1 in mapping.wgrad_segments(es))
    whole_scene = ConvScene(**es.__dict__)
    assert (mapping.grid_steps(whole_scene, "TB88", 64, 8, tile)
            == mapping.grid_steps(es, "TB88", 64, 8, tile, seg_taps=0))
    assert mapping.segsum_bytes(es) == (
        n_seg * es.bytes_out() + es.bytes_out())
    assert mapping.segsum_bytes(whole_scene) == 0
    split = mapping.select_schedule(es)
    whole = mapping.select_schedule(whole_scene)
    assert split.predicted_s < whole.predicted_s / 10
    small = grad_filter_scene(ConvScene(**SCENES["one_by_one"]))
    assert vmem_bytes(small, "TB11", small.M, small.N, small.K,
                      (64, 32, 4, 4)) >= vmem_bytes(
        small, "TB11", small.M, small.N, small.K, (64, 32, 4, 4),
        seg_taps=0)


def test_trunk_wgrad_segments():
    """Scene arithmetic only: the full-width ResNet trunk's ten wgrad exec
    scenes at the training microbatch, each split every 128 taps (K = 8),
    and the selector's pick on each is TB11 or TB88."""
    chain = cnn_chain_scenes("resnet")
    got = []
    for sc in chain.values():
        es = grad_filter_scene(sc.with_batch(8))
        assert isinstance(es, WgradScene)
        assert es.K == 8 and es.seg_taps == 128
        got.append(len(mapping.wgrad_segments(es)))
        pick = mapping.select_schedule(es)
        assert pick.schedule in ("TB11", "TB88")
    assert tuple(got) == TRUNK_SEGMENTS
