"""Property link between the port's static verifier and what its plans
compute, held to ``tests/test_analysis_properties.py``: a point the
verifier passes executes (the kernels' plain versions, on the CPU) to the
reference's ``conv_ref`` on the same numpy inputs, and so does whatever
geometry ``make_plan`` settles on."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st   # noqa: E402

from repro.core.scene import ConvScene as JScene           # noqa: E402
from repro.kernels import ref                              # noqa: E402

from repro_torch.analysis.verify import (verify_plan,       # noqa: E402
                                         verify_point)
from repro_torch.core.mapping import ScheduleChoice        # noqa: E402
from repro_torch.core.scene import ConvScene               # noqa: E402
from repro_torch.plan import make_plan                     # noqa: E402
from repro_torch.tune.space import enumerate_space         # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


@st.composite
def small_scenes(draw):
    f = draw(st.integers(1, 3))
    hw = draw(st.integers(4, 8))
    return ConvScene(
        B=draw(st.integers(1, 4)), IC=draw(st.integers(1, 8)),
        OC=draw(st.integers(1, 8)), inH=hw, inW=hw, fltH=f, fltW=f,
        padH=draw(st.integers(0, f - 1)), padW=draw(st.integers(0, f - 1)),
        stdH=draw(st.integers(1, 2)), stdW=draw(st.integers(1, 2)))


def _operands(sc):
    rng = np.random.default_rng(sc.macs % 2 ** 31)
    return (rng.standard_normal(sc.in_shape()).astype(np.float32),
            rng.standard_normal(sc.flt_shape()).astype(np.float32))


def _reference(sc, inp, flt):
    return np.asarray(ref.conv_ref(jnp.asarray(inp), jnp.asarray(flt),
                                   JScene(**sc.__dict__)))


@given(small_scenes(), st.data())
@settings(max_examples=10, deadline=None)
def test_verified_point_matches_reference(sc, data):
    pts = enumerate_space(sc)
    assert pts, sc.describe()
    pt = data.draw(st.sampled_from(list(pts)), label="point")
    # statically clean ...
    assert verify_point(sc, pt.schedule, pt.bm, pt.bn, pt.bk, pt.tile) == []
    # ... and numerically right when executed
    inp, flt = _operands(sc)
    choice = ScheduleChoice(pt.schedule, pt.bm, pt.bn, pt.bk, 0.0, 0.0, 0.0,
                            0, tile=pt.tile)
    plan = make_plan(sc, policy=choice, device="cpu")
    got = plan.execute(torch.from_numpy(inp), torch.from_numpy(flt))
    np.testing.assert_allclose(got.numpy(), _reference(sc, inp, flt), **TOL)


@given(small_scenes())
@settings(max_examples=10, deadline=None)
def test_plan_for_scene_verifies_and_matches_reference(sc):
    # the production path end to end: whatever launch make_plan settles on
    # is statically clean and numerically right
    plan = make_plan(sc, device="cpu")
    assert verify_plan(plan) == []
    inp, flt = _operands(sc)
    got = plan.execute(torch.from_numpy(inp), torch.from_numpy(flt))
    np.testing.assert_allclose(got.numpy(), _reference(sc, inp, flt), **TOL)
