"""The port's conv kernels on the CPU (their plain PyTorch versions) held
against the JAX reference's Pallas kernels in interpret mode, plus the
port's oracles and selector.

Same numpy operands go to both packages.  Tolerance: f32 within
rtol=atol=1e-4, the reference's own (tests/test_kernels.py:41) — the two
sum the taps in different orders.  The CUDA kernels themselves cannot run
here; ``chip_smoke.py`` holds each against its plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ref as jref
import repro.plan as jplan
from repro.core.scene import ConvScene as JScene

import repro_torch.kernels.ref as tref
from repro_torch.core import mapping as tmapping
from repro_torch.core.scene import ConvScene
from repro_torch.kernels import mg3m_conv as K
from repro_torch.models.cnn import cnn_chain_scenes, cnn_scenes
from repro_torch.plan import ConvOp, make_plan
from repro_torch.tune.space import block_candidates, enumerate_space

GRAINS = ("TB11", "TB18", "TB88")
# tests/test_kernels.py's sweep: (B, IC, OC, inHW, flt, pad, std)
KERNEL_SCENES = [(8, 16, 24, 10, 3, 1, 1), (4, 8, 8, 7, 1, 0, 1),
                 (16, 32, 48, 12, 5, 2, 2), (3, 5, 7, 9, 3, 0, 2),
                 (1, 1, 1, 4, 3, 1, 1), (2, 64, 16, 8, 3, 1, 1),
                 (128, 16, 8, 6, 2, 0, 2)]
# tests/test_dilated.py's "stride2" and "asym_stride"
STRIDED = {"stride2": (2, 8, 4, 10, 10, 3, 1, 2, 2),
           "asym_stride": (3, 5, 7, 11, 9, 3, 0, 3, 2)}
# oracle-only scenes: every dilation axis and the high-side pad
ORACLE_SCENES = {
    "atrous": dict(B=2, IC=3, OC=5, inH=9, inW=8, fltH=3, fltW=3, padH=2,
                   padW=2, fdilH=2, fdilW=2),
    "lhs_dil_apad": dict(B=2, IC=4, OC=3, inH=5, inW=6, fltH=3, fltW=2,
                         padH=2, padW=1, dilH=2, dilW=3, apadH=1, apadW=2,
                         stdH=1, stdW=2),
    "plain": dict(B=3, IC=2, OC=4, inH=7, inW=7, fltH=3, fltW=3, padH=1,
                  padW=1),
}
TOL = dict(rtol=1e-4, atol=1e-4)


def _kw(b, ic, oc, hw, f, pad, std):
    return dict(B=b, IC=ic, OC=oc, inH=hw, inW=hw, fltH=f, fltW=f,
                padH=pad, padW=pad, stdH=std, stdW=std)


def _strided_kw(b, ic, oc, h, w, f, pad, sh, sw):
    return dict(B=b, IC=ic, OC=oc, inH=h, inW=w, fltH=f, fltW=f, padH=pad,
                padW=pad, stdH=sh, stdW=sw)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(op, kw, a, b, grain):
    """(JAX interpret-mode result, port CPU result) of one forced plan."""
    want = jplan.make_plan(JScene(**kw), op.value, policy=grain,
                           interpret=True).execute(jnp.asarray(a),
                                                   jnp.asarray(b))
    got = make_plan(ConvScene(**kw), op, policy=grain,
                    device="cpu").execute(torch.from_numpy(a),
                                          torch.from_numpy(b))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("spec", KERNEL_SCENES)
@pytest.mark.parametrize("grain", GRAINS)
def test_fprop_grains_match_reference(spec, grain):
    kw = _kw(*spec)
    sc = ConvScene(**kw)
    a, b = _np(sc.in_shape(), 1), _np(sc.flt_shape(), 2)
    want, got = _both(ConvOp.FPROP, kw, a, b, grain)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(STRIDED))
@pytest.mark.parametrize("op", [ConvOp.DGRAD, ConvOp.WGRAD])
@pytest.mark.parametrize("grain", GRAINS)
def test_dilated_backward_grains_match_reference(name, op, grain):
    """DGRAD plans run the lhs-dilated route (compact input, masked hole
    taps; the reference reads a sentinel), WGRAD plans the rhs-dilated
    one."""
    kw = _strided_kw(*STRIDED[name])
    sc = ConvScene(**kw)
    plan = make_plan(sc, op, policy=grain, device="cpu")
    assert not plan.uses_reference
    assert plan.exec_scene.is_dilated
    x, flt, cot = (_np(sc.in_shape(), 3), _np(sc.flt_shape(), 4),
                   _np(sc.out_shape(), 5))
    a, b = (cot, flt) if op is ConvOp.DGRAD else (x, cot)
    want, got = _both(op, kw, a, b, grain)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(ORACLE_SCENES))
def test_conv_ref_matches_reference_oracle(name):
    kw = ORACLE_SCENES[name]
    sc = ConvScene(**kw)
    x, f = _np(sc.in_shape(), 6), _np(sc.flt_shape(), 7)
    want = np.asarray(jref.conv_ref(jnp.asarray(x), jnp.asarray(f),
                                    JScene(**kw)))
    got = tref.conv_ref(torch.from_numpy(x), torch.from_numpy(f), sc)
    assert got.dtype == torch.float32 and tuple(got.shape) == sc.out_shape()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tref.conv_direct_ref(x, f, sc),
                               jref.conv_direct_ref(x, f, JScene(**kw)),
                               **TOL)


@pytest.mark.parametrize("name", sorted(ORACLE_SCENES))
def test_conv_plain_matches_oracle_on_launched_operands(name):
    """``conv_plain`` on the operands a plan launches (pre-padded dense
    input, or the compact lhs-dilated one) is the convolution."""
    sc = ConvScene(**ORACLE_SCENES[name])
    x = torch.from_numpy(_np(sc.in_shape(), 8))
    f = torch.from_numpy(_np(sc.flt_shape(), 9))
    plan = make_plan(sc, policy="TB88", device="cpu")
    fn, inp, flt, blocks = plan.kernel_call(x, f)
    assert fn is K.conv_tb88 and set(blocks) == {"bm", "bn", "bk", "tile"}
    got = K.conv_plain(inp, flt, sc)[:, :, :sc.OC, :sc.B]
    np.testing.assert_allclose(got.numpy(), tref.conv_ref(x, f, sc).numpy(),
                               **TOL)


def test_mm_unit_ref_matches_reference():
    f, x = _np((6, 5), 10), _np((6, 3), 11)
    want = np.asarray(jref.mm_unit_ref(jnp.asarray(f), jnp.asarray(x)))
    got = tref.mm_unit_ref(torch.from_numpy(f), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bf16_plain_version_close_to_f32():
    kw = dict(_kw(8, 16, 16, 8, 3, 1, 1), dtype="bfloat16")
    sc = ConvScene(**kw)
    x = torch.from_numpy(_np(sc.in_shape(), 12))
    f = torch.from_numpy(_np(sc.flt_shape(), 13))
    got = make_plan(sc, policy="TB88", device="cpu").execute(
        x.bfloat16(), f.bfloat16())
    assert got.dtype == torch.bfloat16
    want = tref.conv_ref(x, f, ConvScene(**_kw(8, 16, 16, 8, 3, 1, 1)))
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=2e-2, atol=2e-1)


# -- the Hopper selector ------------------------------------------------------
@pytest.mark.parametrize("batch", [1, 8, 128])
def test_every_cnn_layer_selects_a_feasible_choice(batch):
    for net, layers in cnn_scenes(batch).items():
        for sc in layers:
            for dtype in ("float32", "bfloat16"):
                s = ConvScene(**{**sc.__dict__, "dtype": dtype})
                ch = tmapping.select_schedule(s)
                assert ch.schedule in GRAINS
                assert ch.vmem_bytes <= tmapping.SMEM_BUDGET, (net, s)
                assert ch.predicted_s > 0


@pytest.mark.parametrize("name", list(cnn_chain_scenes("resnet")))
def test_resnet_trunk_plans_fit_the_kernels(name):
    """Every plan the serving ladder builds for the full-width trunk
    passes the kernels' own launch checks at the operands it launches."""
    sc = cnn_chain_scenes("resnet")[name]
    for b in (1, 2, 4, 8):
        plan = make_plan(sc.with_batch(b), device="cpu")
        fn, inp, flt, blocks = plan.kernel_call(
            torch.zeros(plan.scene.in_shape()),
            torch.zeros(plan.scene.flt_shape()))
        assert fn is K.WRAPPERS[plan.schedule]
        spec = K.launch_spec(plan.exec_scene, plan.schedule,
                             in_shape=inp.shape, flt_shape=flt.shape,
                             smem_budget=tmapping.SMEM_BUDGET, **blocks)
        assert spec.smem == plan.choice.vmem_bytes


def test_forced_infeasible_grain_raises():
    """TB11 on the trunk's last layer (a 9.4 MB f32 filter) cannot hold
    the filter in 227 KB: forcing it raises instead of running another
    grain."""
    last = cnn_chain_scenes("resnet")["resnet/L9"]
    with pytest.raises(ValueError, match="shared-memory budget"):
        tmapping.select_schedule(last, allowed=("TB11",))
    with pytest.raises(ValueError, match="shared-memory budget"):
        make_plan(last, policy="TB11", device="cpu")
    assert make_plan(last, policy="TB18", device="cpu").schedule == "TB18"


def test_tuned_policy_names_the_missing_slice(tmp_path, monkeypatch):
    """"tuned" resolves through the tune cache (a miss here: the analytic
    choice).  Before ``repro_torch.tune`` existed this test held the raise
    that named the missing slice; it keeps its name."""
    from repro_torch import tune
    sc = ConvScene(**_kw(1, 4, 4, 6, 3, 1, 1))
    monkeypatch.setenv(tune.cache.ENV_VAR, str(tmp_path / "cache.json"))
    monkeypatch.setenv(tune.calibrate.ENV_VAR, str(tmp_path / "cal.json"))
    tune.set_default_cache(None)
    try:
        plan = make_plan(sc, policy="tuned", device="cpu")
        assert plan.policy == "tuned"
        assert plan.choice == make_plan(sc, device="cpu").choice
        assert tune.default_cache().misses == 1
    finally:
        tune.set_default_cache(None)


def test_search_space_is_kernel_tiles():
    sc = ConvScene(**_kw(2, 300, 200, 8, 3, 1, 1))
    assert block_candidates(sc, "TB11") == ((200, 2, 300),)
    assert {bm for bm, _, _ in block_candidates(sc, "TB18")} == {
        8, 16, 32, 64, 128}
    for bm, bn, bk in block_candidates(sc, "TB88"):
        assert bm in (16, 32, 64, 128) and bn == 2 and bk in (8, 16, 32)
    pts = enumerate_space(sc)
    assert pts and all(p.schedule != "TB11" for p in pts)   # 2.2 MB filter
    with pytest.raises(ValueError):
        block_candidates(sc, "TB99")


# -- launch checks and wrappers ----------------------------------------------
def test_launch_spec_rejects_bad_geometry():
    sc = ConvScene(**_kw(2, 8, 16, 6, 3, 1, 1))
    good_in, good_flt = (8, 8, 8, 2), (3, 3, 8, 16)
    K.launch_spec(sc, "TB88", in_shape=good_in, flt_shape=good_flt, bm=16,
                  bn=2, bk=8, tile=(32, 128, 8, 4))
    with pytest.raises(ValueError, match="K dim"):
        K.launch_spec(sc, "TB11", in_shape=(8, 8, 4, 2), flt_shape=good_flt)
    with pytest.raises(ValueError, match="spatial extent"):
        K.launch_spec(sc, "TB11", in_shape=(6, 6, 8, 2), flt_shape=good_flt)
    with pytest.raises(ValueError, match="must divide"):
        K.launch_spec(sc, "TB18", in_shape=good_in, flt_shape=good_flt,
                      bm=5)
    with pytest.raises(ValueError, match="must divide"):
        K.launch_spec(sc, "TB88", in_shape=good_in, flt_shape=good_flt,
                      bm=16, bn=2, bk=64)
    with pytest.raises(ValueError, match="shared memory"):
        K.launch_spec(sc, "TB11", in_shape=good_in, flt_shape=good_flt,
                      tile=(64, 64, 4, 4), smem_budget=1024)
    with pytest.raises(ValueError, match="unknown schedule"):
        K.launch_spec(sc, "TB99", in_shape=good_in, flt_shape=good_flt)


def test_wrappers_on_cpu_run_the_plain_version_without_counting():
    sc = ConvScene(**_kw(2, 8, 16, 6, 3, 1, 1))
    x = torch.from_numpy(_np((8, 8, 8, 2), 14))
    f = torch.from_numpy(_np((3, 3, 8, 16), 15))
    K.reset_launch_counts()
    want = K.conv_plain(x, f, sc)
    for out in (K.conv_tb11(x, f, sc, tile=(64, 64, 4, 4)),
                K.conv_tb18(x, f, sc, bm=8, tile=(8, 64, 4, 2)),
                K.conv_tb88(x, f, sc, bm=16, bn=2, bk=8,
                            tile=(32, 128, 8, 4))):
        assert torch.equal(out, want)
    assert K.launch_counts() == {"TB11": 0, "TB18": 0, "TB88": 0}


def test_plan_rejects_operands_of_the_other_backend():
    sc = ConvScene(**_kw(1, 2, 2, 5, 3, 1, 1))
    plan = make_plan(sc, device="cpu")
    with pytest.raises(ValueError, match="expects operands"):
        plan.execute(torch.zeros(4, 4, 2, 1), torch.zeros(3, 3, 2, 2))
    with pytest.raises(ValueError, match="backend"):
        plan.execute(torch.zeros(sc.in_shape(), device="meta"),
                     torch.zeros(sc.flt_shape()))


def test_reference_plans_are_exact_adjoints():
    """The recorded fallback (dgrad with padding past the filter extent)
    and ``use_kernels=False`` run the torch oracle's autograd adjoint."""
    kw = dict(B=1, IC=2, OC=3, inH=6, inW=6, fltH=3, fltW=3, padH=3, padW=3)
    sc = ConvScene(**kw)
    dplan = make_plan(sc, ConvOp.DGRAD, device="cpu")
    assert dplan.uses_reference and dplan.notes
    with pytest.raises(ValueError, match="forced policy"):
        make_plan(sc, ConvOp.DGRAD, policy="TB88", device="cpu")
    cot = _np(sc.out_shape(), 16)
    f = _np(sc.flt_shape(), 17)
    want = jplan.make_plan(JScene(**kw), "dgrad").execute(jnp.asarray(cot),
                                                          jnp.asarray(f))
    got = dplan.execute(torch.from_numpy(cot), torch.from_numpy(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    x = _np(sc.in_shape(), 18)
    wplan = make_plan(sc, ConvOp.WGRAD, device="cpu", use_kernels=False)
    assert wplan.uses_reference
    want_w = jplan.make_plan(JScene(**kw), "wgrad").execute(
        jnp.asarray(x), jnp.asarray(cot))
    np.testing.assert_allclose(
        wplan.execute(torch.from_numpy(x), torch.from_numpy(cot)).numpy(),
        np.asarray(want_w), **TOL)
