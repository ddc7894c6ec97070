"""Plan-driven CNN training in the port (``repro_torch.train``) on the CPU,
mirroring tests/test_train_cnn.py and held against the JAX reference
(Pallas in interpret mode): the same parameters (carried by
``convert.cnn_params_from_numpy``) and the same numpy batches go to both
trainers.  Tolerances are the reference's own: step losses within 1e-3 and
parameters within 5e-3 after six steps (tests/test_train_cnn.py); the
optimizer alone within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.autodiff import make_model_plans as j_make_model_plans
from repro.data.pipeline import SyntheticImages as JSyntheticImages
from repro.models import cnn as JM
from repro.train import checkpoint as jckpt
from repro.train import cnn as jtc
from repro.train import optimizer as jopt

from repro_torch import obs
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.core.autodiff import (ModelPlans, TrainingPlans,
                                       make_model_plans)
from repro_torch.core.scene import ConvScene
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.launch import train_cnn as launcher
from repro_torch.models import cnn as M
from repro_torch.obs.metrics import default_metrics
from repro_torch.plan import make_plan
from repro_torch.plan import registry as registry_mod
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import cnn as tc
from repro_torch.train import optimizer as topt

B, RES, WIDTH = 8, 8, 4
CPU = "cpu"


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


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _jax_params(width=WIDTH, seed=0):
    return JM.init_small_cnn(jax.random.PRNGKey(seed), width=width)


def _model(width=WIDTH, batch=B):
    params = cnn_params_from_numpy(_np_tree(_jax_params(width)), CPU)
    return params, M.small_cnn_plans(params, batch, RES, device=CPU)


def _np_batches(n, batch=B, seed=3, noise=0.3, res=RES, classes=10):
    data = SyntheticImages(batch, res, seed=seed, noise=noise,
                           n_classes=classes)
    return [data.batch_at(i) for i in range(n)]


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _clone(params):
    return {k: v.clone() for k, v in params.items()}


def _run(step, state, batches, with_norms=False):
    losses, norms = [], []
    for b in batches:
        state, ms = step(state, _t(b))
        losses.append(float(ms["loss"]))
        norms.append(float(ms["grad_norm"]))
    return (state, losses, norms) if with_norms else (state, losses)


# ---------------------------------------------------------------------------
# parity with the reference's trainer
# ---------------------------------------------------------------------------
def test_six_steps_match_the_reference():
    """The small CNN from the reference's parameters, six steps on the same
    batches: losses within 1e-3 at every step, parameters within 5e-3."""
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=20)
    batches = _np_batches(6)
    jparams = _jax_params()
    jplans = JM.small_cnn_plans(jparams, B, RES)
    jstep = jtc.jit_train_step(jtc.build_cnn_train_step(
        jplans, jopt.AdamWConfig(**cfg)))
    jstate = jtc.init_train_state(jparams)
    want, want_norms = [], []
    for b in batches:
        jstate, ms = jstep(jstate, jax.tree.map(jnp.asarray, b))
        want.append(float(ms["loss"]))
        want_norms.append(float(ms["grad_norm"]))

    params, plans = _model()
    step = tc.build_cnn_train_step(plans, topt.AdamWConfig(**cfg))
    state, got, norms = _run(step, tc.init_train_state(params), batches,
                             with_norms=True)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    # the gradients' own scale: AdamW and clipping would hide a scaling
    np.testing.assert_allclose(norms, want_norms, rtol=1e-3)
    assert got[-1] < got[0]
    for k in params:
        np.testing.assert_allclose(state.params[k].numpy(),
                                   np.asarray(jstate.params[k]),
                                   rtol=5e-3, atol=5e-3)
    assert int(state.opt.step) == int(jstate.opt.step) == 6


def test_resnet_trunk_two_steps_match_the_reference():
    """The capped ResNet trunk (``cnn_chain_scenes("resnet", 2, max_hw=16,
    max_ch=16)``: stride-2 stem, 1x1 and 3x3 layers, strided 1x1s) trains
    two steps like the reference's from the same parameters."""
    caps = dict(max_hw=16, max_ch=16)
    jscenes = JM.cnn_chain_scenes("resnet", 2, **caps)
    scenes = M.cnn_chain_scenes("resnet", 2, **caps)
    assert [s.describe() for s in scenes.values()] == \
        [s.describe() for s in jscenes.values()]
    jparams = JM.init_cnn_from_scenes(jax.random.PRNGKey(1), jscenes)
    params = cnn_params_from_numpy(_np_tree(jparams), CPU)  # before donation
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    batches = _np_batches(2, batch=2, res=16, seed=0)
    jplans = j_make_model_plans(jscenes)
    jstep = jtc.jit_train_step(jtc.build_cnn_train_step(
        jplans, jopt.AdamWConfig(**cfg)))
    jstate = jtc.init_train_state(jparams)
    want, want_norms = [], []
    for b in batches:
        jstate, ms = jstep(jstate, jax.tree.map(jnp.asarray, b))
        want.append(float(ms["loss"]))
        want_norms.append(float(ms["grad_norm"]))

    plans = make_model_plans(scenes, device=CPU)
    assert plans.reference_ops == {}
    step = tc.build_cnn_train_step(plans, topt.AdamWConfig(**cfg))
    state, got, norms = _run(step, tc.init_train_state(params), batches,
                             with_norms=True)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(norms, want_norms, rtol=1e-3)
    for k in params:
        np.testing.assert_allclose(state.params[k].numpy(),
                                   np.asarray(jstate.params[k]),
                                   rtol=5e-3, atol=5e-3)


def test_small_cnn_forward_plan_path_matches_both_references():
    params, plans = _model()
    x = _np_batches(1)[0]["images"]
    want = np.asarray(JM.small_cnn_forward(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()},
        jnp.asarray(x), use_pallas=False))
    xt = torch.from_numpy(x)
    ref = M.small_cnn_forward(params, xt, use_kernels=False)
    got = M.small_cnn_forward(params, xt, use_kernels=True, plans=plans)
    np.testing.assert_allclose(ref.numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # without plans, the default registry of x's device builds them
    again = M.small_cnn_forward(params, xt, use_kernels=True)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_multi_step_loss_descent_parity_vs_the_torch_reference():
    """tests/test_train_cnn.py's descent: the plan step and a
    ``use_kernels=False`` step give the same losses, and both descend."""
    params, plans = _model()
    cfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=20)
    batches = _np_batches(6)
    step = tc.build_cnn_train_step(plans, cfg)
    state, plan_losses = _run(step, tc.init_train_state(_clone(params)),
                              batches)

    def ref_loss(p, b):
        logits = M.small_cnn_forward(p, b["images"], use_kernels=False)
        return tc.softmax_cross_entropy(logits, b["labels"]), {
            "accuracy": (logits.argmax(-1) == b["labels"]).float().mean()}

    rstep = tc.build_cnn_train_step(plans, cfg, loss_fn=ref_loss)
    rstate, ref_losses = _run(rstep, tc.init_train_state(_clone(params)),
                              batches)
    np.testing.assert_allclose(plan_losses, ref_losses, rtol=1e-3,
                               atol=1e-3)
    assert plan_losses[-1] < plan_losses[0]
    for k in params:
        np.testing.assert_allclose(state.params[k].numpy(),
                                   rstate.params[k].numpy(),
                                   rtol=5e-3, atol=5e-3)


# ---------------------------------------------------------------------------
# optimizer, loss, data: the reference's functions on the same inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("clip_norm", [1e9, 0.05])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(clip_norm, moments):
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 3, 2, 4), "b": (5,), "head": (4, 3)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    cfg_kw = dict(lr=1e-2, warmup_steps=2, total_steps=10,
                  clip_norm=clip_norm, weight_decay=0.1,
                  moments_dtype=moments)
    jcfg, cfg = jopt.AdamWConfig(**cfg_kw), topt.AdamWConfig(**cfg_kw)
    jstate = jopt.init_opt_state({k: jnp.asarray(v) for k, v in p.items()},
                                 moments)
    tstate = topt.init_opt_state({k: torch.from_numpy(v)
                                  for k, v in p.items()}, moments)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for i in range(4):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jp, jstate, jm = jopt.adamw_update(
            jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tp, tstate, tm = topt.adamw_update(
            cfg, tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(
                tstate.m[k].float().numpy(),
                np.asarray(jstate.m[k].astype(jnp.float32)), rtol=1e-6,
                atol=1e-6)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
    assert int(tstate.step) == 4 and tstate.step.dtype == torch.int32


def test_lr_schedule_matches_the_reference():
    cfg_kw = dict(lr=3e-3, warmup_steps=5, total_steps=30, min_lr_frac=0.2)
    for s in (0, 1, 4, 5, 6, 17, 30, 45):
        got = topt.lr_schedule(topt.AdamWConfig(**cfg_kw), torch.tensor(s))
        want = jopt.lr_schedule(jopt.AdamWConfig(**cfg_kw), jnp.asarray(s))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_softmax_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, 6).astype(np.int32)
    got = tc.softmax_cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels))
    want = jtc.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(batch=8, res=8, seed=7),
                                dict(batch=4, res=6, channels=1, n_classes=3,
                                     seed=2, noise=0.3, host_id=1,
                                     n_hosts=2)])
def test_synthetic_images_bitwise_equal_to_the_reference(kw):
    mine, ref = SyntheticImages(**kw), JSyntheticImages(**kw)
    for step in (0, 3):
        a, b = mine.batch_at(step), ref.batch_at(step)
        for k in ("images", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    first = next(iter(mine))
    np.testing.assert_array_equal(first["images"], ref.batch_at(0)["images"])
    with pytest.raises(ValueError, match="divisible"):
        SyntheticImages(7, 8, n_hosts=2)


# ---------------------------------------------------------------------------
# the step: microbatches, buckets, geometry, the plan-once contract
# ---------------------------------------------------------------------------
def test_microbatch_accumulation_matches_full_batch():
    params, _ = _model()
    cfg = topt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                           clip_norm=1e9)
    batch = _t(_np_batches(1)[0])
    full = tc.build_cnn_train_step(M.small_cnn_plans(params, B, RES,
                                                     device=CPU), cfg)
    fstate, fms = full(tc.init_train_state(_clone(params)), batch)
    mb = tc.build_cnn_train_step(
        M.small_cnn_plans(params, B // 2, RES, device=CPU), cfg,
        n_microbatches=2, buckets=tc.make_grad_buckets(params))
    mstate, mms = mb(tc.init_train_state(_clone(params)), batch)
    np.testing.assert_allclose(float(fms["loss"]), float(mms["loss"]),
                               rtol=1e-5, atol=1e-5)
    # the mean gradient, not the sum: its norm is the full batch's
    np.testing.assert_allclose(float(mms["grad_norm"]),
                               float(fms["grad_norm"]), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(fstate.params[k].numpy(),
                                   mstate.params[k].numpy(),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bucket_mb", [None, 0.001])
def test_microbatch_accumulation_matches_the_reference(bucket_mb):
    """Two microbatches, into one bucket (packed by the step) or several:
    the accumulated gradient's norm, the loss and the parameters match
    the reference's accumulating step from the same parameters."""
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _np_batches(1)[0]
    jparams = _jax_params()
    params = cnn_params_from_numpy(_np_tree(jparams), CPU)
    jstep = jtc.jit_train_step(jtc.build_cnn_train_step(
        JM.small_cnn_plans(jparams, B // 2, RES), jopt.AdamWConfig(**cfg),
        n_microbatches=2, buckets=jtc.make_grad_buckets(jparams)))
    jstate, jms = jstep(jtc.init_train_state(jparams),
                        jax.tree.map(jnp.asarray, batch))
    buckets = (None if bucket_mb is None
               else tc.make_grad_buckets(params, bucket_mb=bucket_mb))
    assert buckets is None or buckets.n_buckets > 1
    step = tc.build_cnn_train_step(
        M.small_cnn_plans(params, B // 2, RES, device=CPU),
        topt.AdamWConfig(**cfg), n_microbatches=2, buckets=buckets)
    state, ms = step(tc.init_train_state(params), _t(batch))
    np.testing.assert_allclose(float(ms["grad_norm"]),
                               float(jms["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(ms["loss"]), float(jms["loss"]),
                               rtol=1e-5, atol=1e-5)
    for k in params:
        np.testing.assert_allclose(state.params[k].numpy(),
                                   np.asarray(jstate.params[k]),
                                   rtol=1e-4, atol=1e-5)


def test_train_step_names_microbatch_geometry_mismatch():
    params, plans = _model()                  # plans built for B
    step = tc.build_cnn_train_step(plans, topt.AdamWConfig(),
                                   n_microbatches=2)
    with pytest.raises(ValueError, match="microbatch"):
        step(tc.init_train_state(params), _t(_np_batches(1)[0]))
    with pytest.raises(ValueError, match="n_microbatches"):
        tc.build_cnn_train_step(plans, topt.AdamWConfig(), n_microbatches=0)


def test_zero_steady_state_resolutions_after_warmup():
    params, plans = _model()
    step = tc.build_cnn_train_step(plans, topt.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10))
    batches = _np_batches(3)
    state, _ = step(tc.init_train_state(params), _t(batches[0]))
    with tc.resolution_guard():
        _run(step, state, batches[1:])


def test_resolution_guard_raises_on_resolution():
    sc = ConvScene(B=2, IC=3, OC=4, inH=6, inW=6, fltH=3, fltW=3,
                   padH=1, padW=1, stdH=1, stdW=1)
    with pytest.raises(ValueError, match="plan-once contract"):
        with tc.resolution_guard():
            make_plan(sc, device=CPU)          # resolves a schedule


def test_reference_fallback_inside_training_step():
    """A 1x1 conv with padding 1 trains through the per-op dgrad fallback
    (no dgrad runs here: the images need none) while fprop/wgrad run the
    kernels' path."""
    sc = ConvScene(B=4, IC=3, OC=6, inH=6, inW=6, fltH=1, fltW=1,
                   padH=1, padW=1, stdH=1, stdW=1)
    plans = make_model_plans({"odd": sc}, device=CPU)
    assert plans.reference_ops == {"odd": ("dgrad",)}
    params = M.init_cnn_from_scenes(torch.Generator().manual_seed(0),
                                    {"odd": sc}, n_classes=4, device=CPU)
    step = tc.build_cnn_train_step(plans, topt.AdamWConfig(
        lr=1e-2, warmup_steps=1, total_steps=10))
    _, losses = _run(step, tc.init_train_state(params),
                     _np_batches(4, batch=4, res=6, seed=5, classes=4))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_grad_buckets_roundtrip_and_packing():
    params, _ = _model()
    buckets = tc.make_grad_buckets(params, bucket_mb=0.001)
    assert buckets.n_buckets > 1               # tiny cap forces splits
    g = {k: torch.full_like(p, 0.5) + i for i, (k, p) in
         enumerate(params.items())}
    rt = buckets.unflatten(buckets.flatten(g))
    assert set(rt) == set(g)
    for k in g:
        assert torch.equal(rt[k], g[k]) and rt[k].shape == g[k].shape
    z = buckets.zeros()
    assert len(z) == buckets.n_buckets
    assert sum(b.numel() for b in z) == sum(p.numel()
                                            for p in params.values())
    assert buckets.names == tuple(sorted(params))
    assert tc.make_grad_buckets(params).n_buckets == 1
    with pytest.raises(ValueError, match="bucket_mb"):
        tc.make_grad_buckets(params, bucket_mb=0)


def test_jit_train_step_updates_the_state_in_place():
    params, plans = _model()
    step = tc.build_cnn_train_step(plans, topt.AdamWConfig(
        lr=1e-2, warmup_steps=1, total_steps=10))
    batches = _np_batches(2)
    want, want_ms = step(tc.init_train_state(_clone(params)),
                         _t(batches[0]))
    state = tc.init_train_state(_clone(params))
    held = state.params["c1"]
    out, ms = tc.jit_train_step(step)(state, _t(batches[0]))
    assert out is state and state.params["c1"] is held
    assert int(state.opt.step) == 1
    for k in params:
        assert torch.equal(state.params[k], want.params[k])
        assert torch.equal(state.opt.v[k], want.opt.v[k])
    assert float(ms["loss"]) == float(want_ms["loss"])


def test_fused_loop_matches_stepwise():
    params, plans = _model()
    step = tc.build_cnn_train_step(plans, topt.AdamWConfig(
        lr=1e-3, warmup_steps=1, total_steps=10))
    batches = _np_batches(4)
    s1, step_losses = _run(step, tc.init_train_state(_clone(params)),
                           batches)
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches]))
               for k in ("images", "labels")}
    s2, lms = tc.build_cnn_train_loop(step)(
        tc.init_train_state(_clone(params)), stacked)
    np.testing.assert_allclose(lms["loss"].numpy(), step_losses, rtol=1e-6)
    for k in params:
        assert torch.equal(s1.params[k], s2.params[k])


# ---------------------------------------------------------------------------
# model plans, metrics, drift, checkpoints, the launcher
# ---------------------------------------------------------------------------
def test_model_plans_of_the_small_cnn():
    params, plans = _model()
    assert isinstance(plans, ModelPlans)
    assert plans.names() == ("c1", "c2", "c3")
    assert isinstance(plans["c1"], TrainingPlans)
    st = registry_mod.default_registry(CPU).stats()
    assert st["misses"] == 0 and st["hits"] >= 9 and st["hit_rate"] == 1.0
    M.validate_scene_chain(plans.scenes())
    assert plans.scenes()["c1"].B == B and plans.scenes()["c1"].inH == RES
    # the same scenes as the reference's
    jsc = JM.small_cnn_scenes(_jax_params(), B, RES)
    assert [s.describe() for s in plans.scenes().values()] == \
        [s.describe() for s in jsc.values()]


def test_vgg_style_scenes_chain_and_init():
    scenes = M.vgg_style_scenes(4, res=16, stages=((8, 1), (16, 2), (32, 2)))
    jscenes = JM.vgg_style_scenes(4, res=16,
                                  stages=((8, 1), (16, 2), (32, 2)))
    assert [s.describe() for s in scenes.values()] == \
        [s.describe() for s in jscenes.values()]
    params = M.init_cnn_from_scenes(torch.Generator().manual_seed(1), scenes,
                                    n_classes=5, device=CPU)
    assert params["v0"].shape == (3, 3, 3, 8)
    assert params["head"].shape == (32, 5)
    assert float(params["v0"].abs().max()) <= 0.2 + 1e-6      # 2 sigma
    plans = make_model_plans(scenes, device=CPU)
    logits = M.cnn_forward_planned(params, torch.randn(4, 16, 16, 3), plans)
    assert logits.shape == (4, 5)
    again = M.init_cnn_from_scenes(torch.Generator().manual_seed(1), scenes,
                                   n_classes=5, device=CPU)
    assert all(torch.equal(params[k], again[k]) for k in params)
    small = M.init_small_cnn(torch.Generator().manual_seed(0), width=4,
                             device=CPU)
    assert {k: tuple(v.shape) for k, v in small.items()} == \
        {k: tuple(v.shape) for k, v in _jax_params().items()}


def test_train_metrics_recorded():
    m = default_metrics()
    tc.observe_step(0.01, 2.3, 8, m)
    tc.observe_step(0.02, 2.2, 8, m)
    assert m.value("repro.train.steps") == 2
    assert m.value("repro.train.examples") == 16
    assert m.value("repro.train.step_s") == 2      # histogram count
    assert m.value("repro.train.loss") == pytest.approx(2.2)
    _model()
    assert tc.observe_plan_hit_rate(device=CPU) == 1.0
    assert m.value("repro.train.plan_hit_rate") == 1.0


def test_profile_step_breakdown_and_drift_feed():
    from repro_torch.obs.drift import default_monitor
    params, plans = _model()
    state = tc.init_train_state(params)
    m = default_metrics()
    out = tc.profile_step_breakdown(state, _t(_np_batches(1)[0]), plans,
                                    topt.AdamWConfig(), metrics=m)
    assert out["grads_s"] > 0 and out["update_s"] > 0
    assert m.value("repro.train.grads_s") == 1
    assert m.value("repro.train.update_s") == 1
    assert tc.feed_drift_from_plans(plans) == 9
    assert default_monitor().stats()


def test_checkpoint_roundtrip_and_bitwise_resume(tmp_path):
    params, plans = _model()
    step = tc.jit_train_step(tc.build_cnn_train_step(plans, topt.AdamWConfig(
        lr=1e-2, warmup_steps=1, total_steps=10)))
    batches = _np_batches(2)
    state, _ = step(tc.init_train_state(params), _t(batches[0]))
    ckpt.save(str(tmp_path), 1, state, extra={"next_step": 1})
    like = tc.init_train_state(M.init_small_cnn(
        torch.Generator().manual_seed(9), width=WIDTH, device=CPU))
    restored, extra = ckpt.restore(str(tmp_path), 1, like)
    assert extra == {"next_step": 1}
    assert restored.opt.step.dtype == torch.int32
    for k in params:
        assert torch.equal(restored.params[k], state.params[k])
        assert torch.equal(restored.opt.m[k], state.opt.m[k])
    _, m1 = step(state, _t(batches[1]))
    _, m2 = step(restored, _t(batches[1]))
    assert float(m1["loss"]) == float(m2["loss"])
    for s in (2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, state)
    ckpt.retain(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000004",
                                                          "step_00000005"]
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path), 5, {"other": torch.zeros(2)})


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A ``TrainState`` saved by ``repro.train.checkpoint`` restores into
    the port's ``TrainState`` (same manifest paths, same .npy leaves), and
    the port's save restores into the reference's."""
    jparams = _jax_params()
    jstate = jtc.init_train_state(jparams)
    jstate = jstate._replace(opt=jstate.opt._replace(
        m=jax.tree.map(lambda p: p * 0.5, jparams),
        step=jnp.asarray(7, jnp.int32)))
    jckpt.save(str(tmp_path / "ref"), 7, jstate, extra={"next_step": 7})
    like = tc.init_train_state(M.init_small_cnn(
        torch.Generator().manual_seed(3), width=WIDTH, device=CPU))
    got, extra = ckpt.restore(str(tmp_path / "ref"), 7, like)
    assert extra == {"next_step": 7} and int(got.opt.step) == 7
    for k in jparams:
        np.testing.assert_array_equal(got.params[k].numpy(),
                                      np.asarray(jparams[k]))
        np.testing.assert_array_equal(got.opt.m[k].numpy(),
                                      np.asarray(jstate.opt.m[k]))
    ckpt.save(str(tmp_path / "port"), 7, got, extra={"next_step": 7})
    back, _ = jckpt.restore(str(tmp_path / "port"), 7, jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    losses = launcher.main(["--device", "cpu", "--check-loss",
                            "--ckpt-dir", str(tmp_path / "ck"),
                            "--metrics-out", str(tmp_path / "m.json")])
    assert len(losses) == 20 and losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert "loss decreased" in out and "plan_hit_rate=1.000" in out
    assert (tmp_path / "m.json").exists()
    assert ckpt.latest_step(str(tmp_path / "ck")) == 20
    # a second run resumes at the last checkpoint: nothing left to do
    assert launcher.main(["--device", "cpu", "--ckpt-dir",
                          str(tmp_path / "ck")]) == []


@pytest.mark.parametrize("argv, exc", [(["--sharded", "--device", "cpu"],
                                        None),
                                       (["--batch", "15", "--device", "cpu"],
                                        ValueError)])
def test_launcher_rejects_unported_or_bad_flags(argv, exc, capsys):
    """A bad flag raises; ``--sharded`` trains on ring-sharded triples
    over eight CPU devices and gives the unsharded run's losses."""
    if exc is not None:
        with pytest.raises(exc):
            launcher.main(argv)
        return
    steps = ["--steps", "4"]
    sharded = launcher.main(argv + steps)
    assert "plan_hit_rate=nan" in capsys.readouterr().out
    np.testing.assert_allclose(sharded, launcher.main(argv[1:] + steps),
                               rtol=1e-4, atol=1e-4)


def test_launcher_vgg_model():
    losses = launcher.main(["--device", "cpu", "--model", "vgg", "--steps",
                            "4", "--no-strict"])
    assert len(losses) == 4 and np.isfinite(losses).all()
