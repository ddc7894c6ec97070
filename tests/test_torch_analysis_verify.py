"""The port's static launch-geometry verifier (``repro_torch.analysis.
verify``), held to ``tests/test_analysis_verify.py``: clean sweeps, every
seeded bug class flagged (``dataclasses.replace`` on a good
``KernelLaunch``), and caught by the ``launch.analyze`` gate; a flagged
launch really computes a wrong answer (a plain emulation of the blocks'
walk against ``conv_plain``); the verifier's expected live-tap map agrees
with the reference's ``_expected_spatial`` on the paper scenes; the
persistent grids at the datasheet's 132 SMs and at a smaller card's.
The card's own hooks (``mg3m_in_coord_table``, ``mg3m_tile_attributes``)
run in ``chip_smoke.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis.verify import _expected_spatial
from repro.core.scene import ConvScene as JScene

import repro_torch.kernels.mg3m_conv as mg
from repro_torch.analysis import footprint
from repro_torch.analysis import verify as V
from repro_torch.core import mapping
from repro_torch.core.scene import ConvScene
from repro_torch.launch import analyze
from repro_torch.models.cnn import cnn_layer_scenes
from repro_torch.plan import ConvOp, make_plan
from repro_torch.plan.build import derive_exec_spec, launched_shapes
from repro_torch.tune import space as tune_space

DENSE = ConvScene(B=4, IC=8, OC=16, inH=8, inW=8, fltH=3, fltW=3,
                  padH=1, padW=1)
STRIDED = ConvScene(B=4, IC=8, OC=16, inH=10, inW=10, fltH=3, fltW=3,
                    padH=1, padW=1, stdH=2, stdW=2)
# the dgrad-shaped scene class: lhs-dilated + asymmetric pad
DILATED = ConvScene(B=2, IC=8, OC=16, inH=5, inW=5, fltH=3, fltW=3,
                    padH=1, padW=1, dilH=2, dilW=2, apadH=1, apadW=1)
# persistent grids with several items a block: a card of 2 SMs
SMALL_CARD = (232448, 233472, 2)


def _launch(scene, schedule="TB11", bm=0, bn=0, bk=0, tile=None):
    bm, bn, bk = bm or scene.M, bn or scene.N, bk or scene.K
    tile = tile or footprint.tiles(schedule, scene.M if schedule == "TB11"
                                   else min(bm, scene.M))[0]
    choice = mapping.ScheduleChoice(schedule, bm, bn, bk, 0.0, 0.0, 0.0, 0,
                                    tile=tile)
    spec = derive_exec_spec(scene, choice)
    in_shape, flt_shape = launched_shapes(scene, spec)
    return V.kernel_launch(scene, schedule, in_shape=in_shape,
                           flt_shape=flt_shape, bm=spec.bm, bn=spec.bn,
                           bk=spec.bk, tile=tile)


def _codes(findings):
    return {f.code for f in findings}


@pytest.fixture
def small_card(monkeypatch):
    """launch_grid and the verifier see a card of 2 SMs."""
    monkeypatch.setattr(mg, "device_limits", lambda device=None: SMALL_CARD)
    monkeypatch.setattr(V, "device_limits", lambda device=None: SMALL_CARD)


# --------------------------------------------------------------------------
# clean tree: zero findings, no kernel executed
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scene", [DENSE, STRIDED, DILATED],
                         ids=["dense", "strided", "dilated"])
@pytest.mark.parametrize("schedule", ["TB11", "TB18", "TB88"])
def test_verify_point_clean(scene, schedule):
    blocks = {} if schedule == "TB11" else dict(bm=8, bn=128, bk=8)
    assert V.verify_point(scene, schedule, **blocks) == []


@pytest.mark.parametrize("op", list(ConvOp))
def test_verify_plan_clean_all_ops(op):
    assert V.verify_plan(make_plan(STRIDED, op, device="cpu")) == []


def test_sweep_scene_covers_all_ops_and_points():
    findings, checked = V.sweep_scene(STRIDED)
    assert findings == []
    assert checked >= 3 * len(footprint.TB88_SHAPES)


@pytest.mark.parametrize("card", ["datasheet", "small"])
def test_sweep_paper_scenes_clean(card, request):
    if card == "small":
        request.getfixturevalue("small_card")
    scenes = cnn_layer_scenes(batch=1, max_hw=14, max_ch=32)
    findings, checked = V.sweep_scenes(scenes)
    assert findings == {}
    assert checked > 100


def test_reference_plan_has_nothing_to_verify():
    # over-padded 1x1 dgrad is blocked -> reference path: no launch
    sc = ConvScene(B=1, IC=2, OC=2, inH=6, inW=6, fltH=1, fltW=1,
                   padH=1, padW=1)
    plan = make_plan(sc, ConvOp.DGRAD, device="cpu")
    assert plan.uses_reference and V.verify_plan(plan) == []


@pytest.mark.parametrize("full", [False, True], ids=["ci", "full"])
def test_analyze_gate_passes(full, tmp_path, capsys):
    argv = ["--device", "cpu", "--cache", str(tmp_path / "c.json")]
    assert analyze.main(argv + (["--full"] if full else [])) == 0
    out = capsys.readouterr().out
    assert "0 verify errors" in out and "0 lint findings" in out


def test_analyze_cache_hits_on_an_unchanged_tree(tmp_path, capsys):
    argv = ["--device", "cpu", "--skip-lint", "--batch", "1", "--max-hw",
            "14", "--max-ch", "32", "--cache", str(tmp_path / "c.json")]
    assert analyze.main(argv) == 0
    first = capsys.readouterr().out
    assert analyze.main(argv) == 0
    assert " 0 points checked" in capsys.readouterr().out
    assert " 0 points checked" not in first


# --------------------------------------------------------------------------
# mutation coverage: each seeded bug class is flagged, actionably
# --------------------------------------------------------------------------
def _skip_first(launch):
    """A persistent walk starting at x + 1: item 0 is never visited."""
    ct, mt = V.kernel_walk(launch)
    keep = ~((ct == 0) & (mt == 0))
    return ct[keep], mt[keep]


def _visit_twice(launch):
    ct, mt = V.kernel_walk(launch)
    return np.append(ct, ct[-1]), np.append(mt, mt[-1])


def _geom(launch, **kw):
    return dataclasses.replace(launch, geom={**launch.geom, **kw})


def _no_hole_mask(o, t, stride, fdil, pad, dil, extent):
    q = o * stride + t * fdil - pad
    return np.where((q >= 0) & (q // dil < extent), q // dil, -1)


def _mask_tap0(o, t, *args):
    return np.where(t == 0, -1, V.in_coord_np(o, t, *args))


def _shift_row(o, t, *args):
    got = V.in_coord_np(o, t, *args)
    return np.where(got >= 0, got + 1, got)


# name -> (scene, schedule, blocks, mutate, expected code)
MUTATIONS = {
    "shifted-column-tile": (
        DENSE, "TB88", dict(bm=8, bn=4, bk=8),
        lambda L: dataclasses.replace(
            L, col0=lambda ct: ct * L.geom["bc"] + 1), "out-coverage"),
    "overlapping-column-tile": (
        DENSE, "TB18", dict(bm=8),
        lambda L: dataclasses.replace(
            L, col0=lambda ct: ct * (L.geom["bc"] - 1)), "out-overlap"),
    "shifted-m-tile": (
        DENSE, "TB88", dict(bm=8, bn=4, bk=8),
        lambda L: dataclasses.replace(
            L, row0=lambda mt: mt * L.m_tile + 1), "out-coverage"),
    "walk-skips-an-item-tb11": (
        STRIDED, "TB11", {},
        lambda L: dataclasses.replace(L, walk=_skip_first), "out-coverage"),
    "walk-skips-an-item-tb18": (
        STRIDED, "TB18", dict(bm=8),
        lambda L: dataclasses.replace(L, walk=_skip_first), "out-coverage"),
    "walk-visits-an-item-twice": (
        DENSE, "TB11", {},
        lambda L: dataclasses.replace(L, walk=_visit_twice), "out-overlap"),
    "walk-stride-past-the-grid": (
        DENSE, "TB18", dict(bm=8),
        lambda L: dataclasses.replace(L, stride=L.grid[0] + 1, grid=(
            max(1, L.grid[0] - 1), L.grid[1]), geom={
                **L.geom, "grid": max(1, L.grid[0] - 1)}), "out-coverage"),
    "dropped-tap": (
        DENSE, "TB11", {}, lambda L: _geom(L, fh=L.geom["fh"] - 1),
        "dropped-tap"),
    "hole-tap-unmasked": (
        DILATED, "TB88", dict(bm=8, bn=2, bk=8),
        lambda L: dataclasses.replace(L, in_coord=_no_hole_mask),
        "sentinel-miss"),
    "live-tap-masked": (
        DILATED, "TB18", dict(bm=8),
        lambda L: dataclasses.replace(L, in_coord=_mask_tap0),
        "dropped-tap"),
    "smem-overshoot": (
        DENSE, "TB11", {},
        lambda L: dataclasses.replace(L, spec=dataclasses.replace(
            L.spec, smem=mapping.SMEM_BUDGET + 16)), "smem-overshoot"),
    "bf16-accumulator": (
        DENSE, "TB11", {},
        lambda L: dataclasses.replace(L, acc_dtype="bfloat16"),
        "dtype-promotion"),
    "out-of-bounds-input-index": (
        DENSE, "TB88", dict(bm=8, bn=4, bk=8),
        lambda L: dataclasses.replace(L, in_coord=_shift_row), "in-bounds"),
    "out-of-bounds-input-extent": (
        STRIDED, "TB11", {}, lambda L: _geom(L, Hl=L.geom["Hl"] + 2),
        "in-bounds"),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_flagged(name, small_card):
    scene, schedule, blocks, mutate, code = MUTATIONS[name]
    good = _launch(scene, schedule, **blocks)
    assert V.check_launch(good) == []
    findings = V.check_launch(mutate(good))
    assert code in _codes(findings), findings
    bad = next(f for f in findings if f.code == code)
    assert bad.is_error
    assert schedule in bad.message and "scene(" in bad.message


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_fails_the_analyze_gate(name, small_card, monkeypatch,
                                         tmp_path, capsys):
    """The gate (``launch.analyze``) exits 1 with an error finding when
    every launch it builds carries the mutation."""
    _, schedule, _, mutate, code = MUTATIONS[name]
    orig = V.kernel_launch

    def mutated(*args, **kw):
        launch = orig(*args, **kw)
        return mutate(launch) if launch.spec.schedule == schedule \
            else launch
    monkeypatch.setattr(V, "kernel_launch", mutated)
    argv = ["--device", "cpu", "--skip-lint", "--no-cache", "--batch", "2",
            "--max-hw", "14", "--max-ch", "32"]
    assert analyze.main(argv + ["--cache", str(tmp_path / "c.json")]) == 1
    assert f"[{code}] (error)" in capsys.readouterr().out


def test_tight_budget_is_an_overshoot():
    findings = V.check_launch(_launch(DENSE, "TB11"), smem_budget_bytes=1024)
    assert _codes(findings) == {"smem-overshoot"}


def test_occupancy_overestimate_is_a_warning():
    """A persistent grid sized for more resident blocks than the card
    reports is a warning (the walk still covers the output); a tile the
    card cannot launch at all is an error."""
    launch = _launch(cnn_layer_scenes(["resnet"], 8)["resnet/L1"], "TB11")
    assert launch.grid[0] > 132
    attrs = {"registers": 255, "max_threads": 1024,
             "max_dynamic_smem": 232448, "blocks_per_sm": 1,
             "local_bytes": 0}
    findings = V.check_launch(launch, attributes=attrs)
    assert _codes(findings) == {"occupancy-overestimate"}
    assert not V.errors(findings)
    dead = V.check_launch(launch, attributes=dict(attrs, blocks_per_sm=0))
    assert "launch-resources" in _codes(V.errors(dead))


def test_findings_name_scene_schedule_and_tile():
    launch = _launch(STRIDED, "TB18", bm=8)
    bad = dataclasses.replace(launch, row0=lambda mt: mt * 0)
    findings = V.check_launch(bad)
    assert findings
    for f in findings:
        assert f.schedule == "TB18"
        assert f.scene == STRIDED.describe()
        assert f.tile == launch.spec.tile
        assert f.message


def test_sharded_plan_verifies_with_no_errors():
    """A ring-sharded plan's partition and inner launches verify clean
    (the reference's finding codes on tampered plans:
    tests/test_torch_shard.py)."""
    from repro_torch.shard import make_sharded_plan, pinned_shard_spec
    from repro_torch.shard.spec import shard_sub_scene
    from repro_torch.core.mapping import select_schedule
    choice = select_schedule(shard_sub_scene(DENSE, "h", 2))
    plan = make_sharded_plan(DENSE, devices=("cpu",) * 2,
                             spec=pinned_shard_spec(DENSE, "fprop", "h", 2,
                                                    choice))
    assert plan.shard_tag == "h:2"
    assert not V.errors(V.verify_sharded_plan(plan))


# --------------------------------------------------------------------------
# what the checks evaluate is what the kernel receives
# --------------------------------------------------------------------------
def test_launch_geom_is_the_launch_spec():
    spec = mg.launch_spec(STRIDED, "TB18", in_shape=(12, 12, 8, 4),
                          flt_shape=(3, 3, 8, 16), bm=8,
                          tile=footprint.tiles("TB18", 8)[0])
    g = mg.geom_fields(mg.launch_geom(spec))
    assert (g["Hl"], g["Wl"], g["K"], g["N"], g["M"]) == (12, 12, 8, 4, 16)
    assert (g["padH"], g["dilH"]) == (0, 1)       # dense route: pre-padded
    assert g["grid"] == mg.launch_grid(spec)[0]
    assert (g["tbm"], g["bc"], g["tm"], g["tc"]) == spec.tile


@pytest.mark.parametrize("op", list(ConvOp))
@pytest.mark.parametrize("scene", [DENSE, STRIDED],
                         ids=["dense", "strided"])
def test_launched_shapes_are_the_launched_operands(scene, op):
    """The shapes the verifier rebuilds a plan's launch from are those of
    the operands the plan hands its kernel (the strided dgrad's on the
    compact lhs-dilated route)."""
    plan = make_plan(scene, op, device="cpu")
    a_shape, b_shape, _ = plan.io_shapes()
    _, inp, flt, _ = plan.kernel_call(torch.zeros(a_shape),
                                      torch.zeros(b_shape))
    assert launched_shapes(plan.exec_scene, plan.spec) == \
        (tuple(inp.shape), tuple(flt.shape))


def test_single_footprint_source():
    assert mapping._vmem_bytes is footprint.vmem_bytes
    assert tune_space.vmem_bytes is footprint.vmem_bytes
    assert mg.vmem_bytes is footprint.vmem_bytes


def test_footprint_pinned_bytes():
    # K=8, N=4, M=16, 3x3 filter, f32: hand-counted shared memory
    # TB18 (8, 64, 4, 2): slice 9*8*8*4 + IN 2*64*(32*4+16) + table 4*9*64
    assert footprint.vmem_bytes(DENSE, "TB18", 8, 4, 8,
                                (8, 64, 4, 2)) == 2304 + 18432 + 2304
    # TB11 (64, 128, 8, 8): filter 3 chunks of 32 rows x 64 cols x 4 B,
    # IN 2*128*144, rtab 2*32*16, row/col tables 4*(3+3)*128
    assert footprint.vmem_bytes(DENSE, "TB11", 16, 4, 8,
                                (64, 128, 8, 8)) == 24576 + 36864 + 1024 + 3072
    # TB88 (32, 128, 8, 4): filter ring 2*32*32*4
    assert footprint.vmem_bytes(DENSE, "TB88", 16, 4, 8,
                                (32, 128, 8, 4)) == 8192 + 36864 + 1024 + 3072
    with pytest.raises(ValueError):
        footprint.vmem_bytes(DENSE, "TB99", 8, 4, 8)


def test_verifier_smem_agrees_with_selection_filter():
    for pt in tune_space.enumerate_space(STRIDED):
        fnd = V.verify_point(STRIDED, pt.schedule, pt.bm, pt.bn, pt.bk,
                             pt.tile)
        assert not any(f.code == "smem-overshoot" for f in fnd)


# --------------------------------------------------------------------------
# a flagged launch really computes a wrong answer
# --------------------------------------------------------------------------
def _emulate(launch, inp, flt):
    """The blocks' walk in plain PyTorch: each visited (column tile,
    m-tile) item writes its tile's outputs, each the sum over the taps the
    index map makes live; unwritten outputs stay nan."""
    g, sc = launch.geom, launch.spec.scene
    out = torch.full((sc.outH * sc.outW * g["N"], g["M"]), float("nan"),
                     dtype=torch.float64)
    ih = launch.in_coord(np.arange(sc.outH)[:, None],
                         np.arange(g["fh"])[None, :], g["stdH"], g["fdilH"],
                         g["padH"], g["dilH"], g["Hl"])
    iw = launch.in_coord(np.arange(sc.outW)[:, None],
                         np.arange(g["fw"])[None, :], g["stdW"], g["fdilW"],
                         g["padW"], g["dilW"], g["Wl"])
    x, f = inp.double(), flt.double()
    ct, mt = launch.walk(launch)
    for c_t, m_t in zip(ct.tolist(), mt.tolist()):
        c0 = int(launch.col_starts(np.array(c_t)))
        m0 = int(launch.row_starts(np.array(m_t)))
        for c in range(max(c0, 0), min(c0 + g["bc"], out.shape[0])):
            p, n = divmod(c, g["N"])
            oh, ow = divmod(p, sc.outW)
            rows = slice(max(m0, 0), min(m0 + launch.m_tile, g["M"]))
            acc = torch.zeros(rows.stop - rows.start, dtype=torch.float64)
            for i in range(g["fh"]):
                for j in range(g["fw"]):
                    if ih[oh, i] >= 0 and iw[ow, j] >= 0:
                        acc += x[ih[oh, i], iw[ow, j], :, n] @ f[i, j, :, rows]
            out[c, rows] = acc
    return out.reshape(sc.outH, sc.outW, g["N"], g["M"]).permute(0, 1, 3, 2)


@pytest.mark.parametrize("name", ["overlapping-column-tile",
                                  "walk-skips-an-item-tb18",
                                  "live-tap-masked", "hole-tap-unmasked",
                                  "dropped-tap"])
def test_flagged_launch_really_diverges(name, small_card):
    scene, schedule, blocks, mutate, code = MUTATIONS[name]
    good = _launch(scene, schedule, **blocks)
    bad = mutate(good)
    assert code in _codes(V.check_launch(bad))
    rng = np.random.default_rng(0)
    inp = torch.tensor(rng.standard_normal(good.spec.in_shape),
                       dtype=torch.float32)
    flt = torch.tensor(rng.standard_normal(good.spec.flt_shape),
                       dtype=torch.float32)
    want = mg.conv_plain(inp, flt, scene).double()
    np.testing.assert_allclose(_emulate(good, inp, flt), want, rtol=1e-5,
                               atol=1e-5)
    got = _emulate(bad, inp, flt)
    assert not np.allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# the expected map is the reference's specification
# --------------------------------------------------------------------------
def test_expected_map_agrees_with_the_reference():
    scenes = cnn_layer_scenes(batch=2, max_hw=28, max_ch=16)
    checked = 0
    for scene in scenes.values():
        for ex in V.exec_scenes(scene).values():
            jsc = JScene(**ex.__dict__)
            for axis in ("h", "w"):
                want, live = V.expected_in_coord(ex, axis)
                ref, ref_live = _expected_spatial(jsc, axis)
                np.testing.assert_array_equal(live, ref_live)
                np.testing.assert_array_equal(want[live], ref[ref_live])
                # the reference reads its sentinel where the port masks
                assert (want[~live] == -1).all()
                checked += 1
    assert checked > 50
