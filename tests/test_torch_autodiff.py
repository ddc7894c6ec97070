"""The port's differentiable MG3MConv (``repro_torch.core.autodiff``) on the
CPU, held against the JAX reference's custom_vjp (Pallas in interpret
mode): the same numpy operands and cotangent go to both, and the input
and filter gradients agree within rtol=atol=2e-4, the reference's own
tolerance (tests/test_autodiff.py).  On a CPU tensor every kernel wrapper
runs its plain version; ``chip_smoke.py`` drives the CUDA kernels."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autodiff as jad
from repro.core.scene import ConvScene as JScene

from repro_torch import obs
from repro_torch.core import autodiff as ad
from repro_torch.core.conv import mg3m_conv, mg3m_conv_nhwc
from repro_torch.core.scene import ConvScene
from repro_torch.kernels import ops
from repro_torch.plan import PlanRegistry
from repro_torch.plan import registry as registry_mod

TOL = dict(rtol=2e-4, atol=2e-4)
# tests/test_autodiff.py:22-27, then the ResNet stem's 7x7 stride-2 pad-3
# and a strided 1x1 (its dgrad is lhs-dilated, its wgrad rhs-dilated)
SPECS = {"3x3": (4, 8, 12, 9, 3, 1, 1), "1x1": (2, 6, 6, 7, 1, 0, 1),
         "3x3_valid": (3, 5, 7, 8, 3, 0, 1), "stride2": (2, 8, 4, 10, 3, 1, 2),
         "stem7x7": (2, 3, 8, 16, 7, 3, 2), "1x1_stride2": (2, 8, 6, 9, 1, 0, 2)}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    def reset():
        obs.set_default_metrics(None)
        obs.set_default_tracer(None)
        obs.set_default_monitor(None)
        registry_mod.set_default_registry(None)
    reset()
    yield
    reset()


def _kw(b, ic, oc, hw, f, pad, std):
    return dict(B=b, IC=ic, OC=oc, inH=hw, inW=hw, fltH=f, fltW=f,
                padH=pad, padW=pad, stdH=std, stdW=std)


def _operands(kw, seed=0):
    sc = ConvScene(**kw)
    rng = np.random.default_rng(seed)
    return (sc, *(rng.standard_normal(s).astype(np.float32) for s in
                  (sc.in_shape(), sc.flt_shape(), sc.out_shape())))


def _jax_grads(kw, inp, flt, cot):
    jsc = JScene(**kw)

    def loss(i, f):
        return jnp.sum(jad.mg3m_conv_trainable(i, f, jsc) * cot)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(inp), jnp.asarray(flt))]


def _torch_grads(conv, inp, flt, cot):
    i = torch.from_numpy(inp).requires_grad_(True)
    f = torch.from_numpy(flt).requires_grad_(True)
    (conv(i, f) * torch.from_numpy(cot)).sum().backward()
    return [i.grad.numpy(), f.grad.numpy()]


@pytest.mark.parametrize("api", ["conv_with_plans", "mg3m_conv_trainable"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_grads_match_the_reference(name, api):
    kw = _kw(*SPECS[name])
    sc, inp, flt, cot = _operands(kw)
    if api == "conv_with_plans":
        plans = ad.make_training_plans(sc, device="cpu")
        assert plans.reference_ops == ()

        def conv(i, f):
            return ad.conv_with_plans(i, f, plans)
    else:
        def conv(i, f):
            return ad.mg3m_conv_trainable(i, f, sc, device="cpu")
    got = _torch_grads(conv, inp, flt, cot)
    want = _jax_grads(kw, inp, flt, cot)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_dgrad_blocked_layer_trains_through_the_reference_adjoint():
    """A 1x1 conv with padding 1 has no MG3M dgrad scene (padding exceeds
    the dilated filter extent minus one): that direction alone runs the
    torch adjoint, fprop and wgrad the kernels, and the gradients still
    match the reference's."""
    kw = dict(B=4, IC=3, OC=6, inH=6, inW=6, fltH=1, fltW=1, padH=1, padW=1,
              stdH=1, stdW=1)
    sc, inp, flt, cot = _operands(kw, seed=3)
    plans = ad.make_model_plans({"odd": sc}, device="cpu")
    assert plans.reference_ops == {"odd": ("dgrad",)}
    assert plans["odd"].uses_reference
    got = _torch_grads(lambda i, f: ad.apply_conv(i, f, plans["odd"]),
                       inp, flt, cot)
    for g, w in zip(got, _jax_grads(kw, inp, flt, cot)):
        np.testing.assert_allclose(g, w, **TOL)


class _Counting:
    """A plan stand-in that counts its executions."""

    def __init__(self, plan):
        self.plan, self.calls = plan, 0

    def execute(self, a, b):
        self.calls += 1
        return self.plan.execute(a, b)


@pytest.mark.parametrize("needs", [(False, True), (True, False),
                                   (True, True)])
def test_only_the_needed_directions_launch(needs):
    """``ctx.needs_input_grad`` decides which backward plans run: an input
    that needs no gradient (images into the first layer) runs no dgrad,
    the eager counterpart of XLA dropping the unused cotangent."""
    sc, inp, flt, cot = _operands(_kw(*SPECS["stride2"]), seed=1)
    base = ad.make_training_plans(sc, device="cpu")
    dgrad, wgrad = _Counting(base.dgrad), _Counting(base.wgrad)
    plans = dataclasses.replace(base, dgrad=dgrad, wgrad=wgrad)
    i = torch.from_numpy(inp).requires_grad_(needs[0])
    f = torch.from_numpy(flt).requires_grad_(needs[1])
    (ad.conv_with_plans(i, f, plans) * torch.from_numpy(cot)).sum().backward()
    assert (dgrad.calls, wgrad.calls) == (int(needs[0]), int(needs[1]))
    assert (i.grad is not None, f.grad is not None) == needs


def test_backward_takes_a_non_contiguous_cotangent():
    """Mean pooling hands the last conv a broadcast (stride-0) cotangent;
    the backward makes it contiguous before the plans dispatch."""
    sc, inp, flt, _ = _operands(_kw(*SPECS["3x3"]), seed=2)
    plans = ad.make_training_plans(sc, device="cpu")
    i = torch.from_numpy(inp).requires_grad_(True)
    f = torch.from_numpy(flt).requires_grad_(True)
    ad.conv_with_plans(i, f, plans).mean(dim=(0, 1)).sum().backward()
    cot = np.broadcast_to(np.float32(1.0 / (sc.outH * sc.outW)),
                          sc.out_shape())
    for g, w in zip((i.grad.numpy(), f.grad.numpy()),
                    _jax_grads(_kw(*SPECS["3x3"]), inp, flt, cot)):
        np.testing.assert_allclose(g, w, **TOL)


def test_grad_shims_match_the_reference():
    kw = _kw(*SPECS["stride2"])
    sc, inp, flt, cot = _operands(kw, seed=4)
    jsc = JScene(**kw)
    din = ad.grad_input(torch.from_numpy(cot), torch.from_numpy(flt), sc,
                        device="cpu")
    dflt = ad.grad_filter(torch.from_numpy(inp), torch.from_numpy(cot), sc,
                          device="cpu")
    np.testing.assert_allclose(
        din.numpy(), np.asarray(jad.grad_input(jnp.asarray(cot),
                                               jnp.asarray(flt), jsc)), **TOL)
    np.testing.assert_allclose(
        dflt.numpy(), np.asarray(jad.grad_filter(jnp.asarray(inp),
                                                 jnp.asarray(cot), jsc)),
        **TOL)


def test_model_plans_protocol_and_prewarm():
    scenes = {"a": ConvScene(**_kw(2, 3, 4, 8, 3, 1, 1)),
              "b": ConvScene(**_kw(2, 4, 6, 8, 3, 1, 2))}
    reg = PlanRegistry(device="cpu")
    plans = ad.make_model_plans(scenes, registry=reg)
    assert plans.names() == ("a", "b") and list(plans) == ["a", "b"]
    assert len(plans) == 2 and "b" in plans and "z" not in plans
    with pytest.raises(KeyError):
        plans["z"]
    assert [op for _, op, _ in plans.plans()] == ["fprop", "dgrad",
                                                  "wgrad"] * 2
    assert plans.scenes() == scenes and plans.reference_ops == {}
    assert hash(plans) == hash(plans) and "a:" in plans.describe()
    st = reg.stats()                   # prewarm is not traffic: all hits
    assert st["misses"] == 0 and st["hits"] == 6 and len(reg) == 6
    # the default registry of the device serves the same build
    again = ad.make_model_plans(scenes, device="cpu")
    assert again.names() == plans.names()
    assert registry_mod.default_registry("cpu").stats()["hit_rate"] == 1.0


def test_unported_options_raise():
    sc = ConvScene(**_kw(2, 3, 4, 8, 3, 1, 1))
    with pytest.raises(NotImplementedError, match="shard/"):
        ad.make_model_plans({"a": sc}, device="cpu", devices=("d0", "d1"))
    with pytest.raises(ValueError, match="TrainingPlans"):
        ad.apply_conv(torch.zeros(4, 4, 3, 2), torch.zeros(3, 3, 3, 4),
                      {"not": "plans"})
    with pytest.raises(ValueError, match="registry serves"):
        ad.make_model_plans({"a": sc}, registry=PlanRegistry(device="cpu"),
                            device="cuda")
    assert ad.backward_policy("TB11") == "analytic"
    assert ad.backward_policy("auto") == "tuned"


def test_tuned_training_plans_resolve_on_a_cache_miss(tmp_path, monkeypatch):
    """On an empty tune cache every direction of a "tuned" triple resolves
    under the (uncalibrated) active model: the analytic choices."""
    from repro_torch import tune
    sc = ConvScene(**_kw(2, 3, 4, 8, 3, 1, 1))
    monkeypatch.setenv(tune.cache.ENV_VAR, str(tmp_path / "cache.json"))
    monkeypatch.setenv(tune.calibrate.ENV_VAR, str(tmp_path / "cal.json"))
    tune.set_default_cache(None)
    try:
        tuned = ad.make_training_plans(sc, policy="tuned", device="cpu")
        analytic = ad.make_training_plans(sc, device="cpu")
        for t, a in zip((tuned.fprop, tuned.dgrad, tuned.wgrad),
                        (analytic.fprop, analytic.dgrad, analytic.wgrad)):
            assert t.policy == "tuned" and t.choice == a.choice
        assert tune.default_cache().misses == 3
    finally:
        tune.set_default_cache(None)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    sc = ConvScene(**_kw(2, 3, 4, 8, 3, 1, 1))
    x, w = torch.zeros(sc.in_shape()), torch.zeros(sc.flt_shape())
    for call in (lambda: ad.make_model_plans({"a": sc}),
                 lambda: ad.make_training_plans(sc),
                 lambda: ad.mg3m_conv_trainable(x, w, sc),
                 lambda: mg3m_conv(x, w, sc)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("schedule", [None, "TB11", "TB18", "TB88"])
def test_conv_shims_match_the_reference(schedule):
    """``mg3m_conv`` / ``mg3m_conv_nhwc`` / ``ops.mg3m_conv_op`` against
    the reference's shims (forced grains included)."""
    from repro.core import conv as jconv
    kw = _kw(*SPECS["3x3"])
    sc, inp, flt, _ = _operands(kw, seed=6)
    want = np.asarray(jconv.mg3m_conv(jnp.asarray(inp), jnp.asarray(flt),
                                      JScene(**kw), schedule=schedule))
    got = mg3m_conv(torch.from_numpy(inp), torch.from_numpy(flt), sc,
                    schedule=schedule, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    x = np.ascontiguousarray(inp.transpose(3, 0, 1, 2))
    want_nhwc = np.asarray(jconv.mg3m_conv_nhwc(
        jnp.asarray(x), jnp.asarray(flt), stride=(1, 1), padding=(1, 1),
        schedule=schedule))
    got_nhwc = mg3m_conv_nhwc(torch.from_numpy(x), torch.from_numpy(flt),
                              stride=(1, 1), padding=(1, 1),
                              schedule=schedule, device="cpu")
    np.testing.assert_allclose(got_nhwc.numpy(), want_nhwc, rtol=1e-4,
                               atol=1e-4)
    choice = ops.resolve_choice(sc, schedule, device="cpu")
    assert choice.schedule == (schedule or choice.schedule)


def test_conv_op_checks_operand_shapes():
    sc = ConvScene(**_kw(2, 3, 4, 8, 3, 1, 1))
    with pytest.raises(ValueError, match="IN layout"):
        ops.mg3m_conv_op(torch.zeros(8, 8, 3, 3), torch.zeros(sc.flt_shape()),
                         sc, device="cpu")
    with pytest.raises(ValueError, match="FLT layout"):
        ops.mg3m_conv_op(torch.zeros(sc.in_shape()), torch.zeros(3, 3, 3, 5),
                         sc, device="cpu")
    with pytest.raises(ValueError, match="input channels"):
        mg3m_conv_nhwc(torch.zeros(2, 8, 8, 3), torch.zeros(3, 3, 4, 4),
                       device="cpu")


def test_training_through_the_kernels_decreases_loss():
    """tests/test_autodiff.py's descent, through the port's plans."""
    sc, inp, flt, _ = _operands(_kw(4, 3, 4, 8, 3, 1, 1), seed=5)
    x = torch.from_numpy(inp)
    target = mg3m_conv(x, torch.full(sc.flt_shape(), 0.1), sc, device="cpu")
    f = torch.from_numpy(flt).requires_grad_(True)

    def loss():
        return ((ad.mg3m_conv_trainable(x, f, sc, device="cpu")
                 - target) ** 2).mean()

    l0 = loss().item()
    for _ in range(80):
        g, = torch.autograd.grad(loss(), f)
        with torch.no_grad():
            f -= 0.02 * g
    assert loss().item() < 0.3 * l0
