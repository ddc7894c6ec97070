"""Whole-model serving in the port (``repro_torch.serve``) on the CPU,
held against the JAX reference's scheduler in interpret mode: same capped
ResNet trunk, same weights (carried by ``repro_torch.convert``), same
ModelSession burst.  Inside the port: session output bitwise equal to
per-layer serving, strict mode with zero post-warm resolutions, the
background loop, the plan artifact, and entry points that default to the
card."""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.cnn import cnn_chain_scenes as j_chain
from repro.serve import ConvScheduler as JScheduler
from repro.serve import SchedConfig as JSchedConfig

from repro_torch import obs
from repro_torch.convert import flt_from_numpy, net_weights_from_numpy
from repro_torch.kernels import mg3m_conv as K
from repro_torch.models.cnn import cnn_chain_scenes, cnn_layer_scenes
from repro_torch.obs.metrics import default_metrics
from repro_torch.plan import ConvOp, PlanRegistry, make_plan
from repro_torch.plan import registry as registry_mod
from repro_torch.serve.conv import ConvRequest, ConvServer, server_from_scenes
from repro_torch.serve.sched import (ConvScheduler, ModelRequest, Overloaded,
                                     SchedConfig, scheduler_from_scenes)

CAPS = dict(max_hw=8, max_ch=8, layers_per_net=3)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Process-global obs state and the default registry, fresh per test."""
    def reset():
        obs.set_default_metrics(None)
        obs.set_default_tracer(None)
        obs.set_default_monitor(None)
        registry_mod.set_default_registry(None)
    reset()
    yield
    reset()


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _weights(chain, seed=0):
    return {name: _np(sc.flt_shape(), seed + i)
            for i, (name, sc) in enumerate(chain.items())}


def _sched(**kw):
    kw.setdefault("config", SchedConfig(occupancy_target=8,
                                        max_gather_s=0.02))
    return ConvScheduler(max_batch=8, ladder_slack=0.0, strict=True,
                         device="cpu", **kw)


@pytest.mark.parametrize("net", ["resnet", "alexnet"])
@pytest.mark.parametrize("relu", [False, True])
def test_session_matches_jax_scheduler(net, relu):
    """The reference's ``ConvScheduler`` (interpret mode) and the port's
    (CPU) serve one ModelSession burst over the same capped trunk with the
    same weights: outputs agree within 1e-4."""
    chain = cnn_chain_scenes(net, **CAPS)
    arrays = _weights(chain, seed=20)
    sc0 = next(iter(chain.values()))
    xs = [_np(sc0.in_shape()[:3] + (b,), 30 + i)
          for i, b in enumerate((1, 2, 1))]

    jsched = JScheduler(max_batch=8, ladder_slack=0.0, strict=True,
                        interpret=True,
                        config=JSchedConfig(occupancy_target=8,
                                            max_gather_s=0.02))
    jsched.register_net(net, j_chain(net, **CAPS),
                        {k: jnp.asarray(v) for k, v in arrays.items()},
                        activation=jax.nn.relu if relu else None)
    jsched.prewarm()
    want = jsched.session(net).serve([jnp.asarray(x) for x in xs])

    tsched = _sched()
    tsched.register_net(net, chain,
                        net_weights_from_numpy(chain, arrays, "cpu"),
                        activation=torch.relu if relu else None)
    tsched.prewarm()
    got = tsched.session(net).serve([torch.from_numpy(x) for x in xs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert tsched.stats()["plan_misses"] == 0


@pytest.mark.parametrize("net", ["resnet", "googlenet"])
def test_session_bitwise_equals_layer_by_layer(net):
    """Inside the port: a ModelSession burst is bitwise what a plain
    ``ConvServer`` produces serving the same images layer by layer."""
    chain = cnn_chain_scenes(net, max_hw=8, max_ch=8, layers_per_net=2)
    sched = _sched()
    sched.register_net(net, chain, seed=9)
    sched.prewarm()
    flts = {ln: sched._layers[ln].flt for ln in chain}
    sc0 = next(iter(chain.values()))
    xs = [torch.from_numpy(_np(sc0.in_shape()[:3] + (1,), 40 + i))
          for i in range(5)]
    outs = sched.session(net).serve(xs)
    assert sched.stats()["dispatches"] >= 1

    server = server_from_scenes(chain, flts, max_batch=8, ladder_slack=0.0,
                                strict=True, device="cpu")
    server.prewarm()
    for x, out in zip(xs, outs):
        cur = x
        for i, lname in enumerate(chain):
            r = ConvRequest(rid=i, layer=lname, x=cur)
            server.serve([r])
            cur = r.out
        assert torch.equal(out, cur)


def test_strict_steady_state_has_zero_resolutions():
    chain = cnn_chain_scenes("resnet", **CAPS)
    sched = _sched(config=SchedConfig(occupancy_target=4,
                                      max_gather_s=0.01))
    sched.register_net("resnet", chain, seed=1)
    sched.prewarm(compile=True)
    res = default_metrics().counter("repro.plan.resolutions")
    before = res.value
    snap = sched.snapshot()
    sc0 = next(iter(chain.values()))
    sess = sched.session("resnet")
    reqs = [sess.submit(torch.from_numpy(_np(sc0.in_shape()[:3] + (b,), i)),
                        deadline_s=5.0) for i, b in enumerate((1, 2, 1, 3))]
    sched.drain()
    sched.wait(reqs)
    s = sched.stats(since=snap)
    assert res.value == before
    assert s["plan_misses"] == 0 and s["plan_builds"] == 0
    assert s["registry"]["misses"] == 0 and s["requests"] == 4
    assert not any(p.uses_reference for p in sched.registry.plans().values())
    assert K.launch_counts() == {"TB11": 0, "TB18": 0, "TB88": 0}


def test_strict_server_raises_on_unwarmed_bucket():
    layers = cnn_layer_scenes(("alexnet",), max_hw=8, max_ch=8,
                              layers_per_net=1)
    server = server_from_scenes(layers, max_batch=4, ladder_slack=0.0,
                                strict=True, device="cpu")
    server.prewarm()
    fam = next(iter(server._layers.values()))
    with pytest.raises(RuntimeError, match="post-warm plan miss"):
        server._plan(fam, ConvOp.FPROP, 3)


def test_background_loop_serves_concurrent_submitters():
    chain = cnn_chain_scenes("resnet", **CAPS)
    sched = _sched(config=SchedConfig(occupancy_target=4,
                                      max_gather_s=0.005))
    sched.register_net("resnet", chain, seed=2)
    sched.prewarm()
    sc0 = next(iter(chain.values()))
    sess = sched.session("resnet")
    results, errors = {}, []

    def client(cid):
        try:
            x = torch.from_numpy(_np(sc0.in_shape()[:3] + (1,), 50 + cid))
            r = sess.submit(x, deadline_s=2.0)
            results[cid] = (x, sched.wait([r])[0])
        except Exception as e:  # noqa: BLE001 — surfaced by the assert
            errors.append(e)

    sched.start()
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sched.stop()
    assert not errors and len(results) == 6
    solo = _sched()
    solo.register_net("resnet", chain, seed=2)
    for x, out in results.values():
        assert torch.equal(solo.session("resnet").serve([x])[0], out)


def test_bounded_queue_and_validation():
    chain = cnn_chain_scenes("resnet", **CAPS)
    sched = _sched(config=SchedConfig(max_queue=2, occupancy_target=8))
    sched.register_net("resnet", chain, seed=3)
    sched.prewarm()
    sc0 = next(iter(chain.values()))
    sess = sched.session("resnet")
    x = torch.zeros(sc0.in_shape()[:3] + (1,))
    sess.submit(x)
    sess.submit(x)
    with pytest.raises(Overloaded):
        sess.submit(x)
    with pytest.raises(ValueError, match="expects"):
        sess.submit(torch.zeros(3, 3, 3, 1))
    with pytest.raises(ValueError, match="already registered"):
        sched.register_net("resnet", chain)
    with pytest.raises(KeyError):
        sched.session("vgg")
    with pytest.raises(ValueError, match="wgrad"):
        sched.register_layer("w", sc0, torch.zeros(sc0.flt_shape()),
                             ops=(ConvOp.WGRAD,))
    assert sched.stats()["shed"] == 1
    sched.drain()


def test_plan_artifact_roundtrip_pins_choices(tmp_path):
    scenes = cnn_layer_scenes(("resnet",), max_hw=8, max_ch=8,
                              layers_per_net=3)
    reg = PlanRegistry(device="cpu")
    reg.warm(scenes.values(), ops=(ConvOp.FPROP, ConvOp.DGRAD),
             buckets=(1, 2))
    path = reg.save(str(tmp_path / "plans.json"))
    fresh = PlanRegistry(device="cpu")
    assert fresh.load(path) == len(reg)
    for k, plan in reg.plans().items():
        assert "|be=cpu|" in k
        again = fresh.plans()[k]
        assert again.choice == plan.choice and again.spec == plan.spec
    # merge-on-save keeps the other registry's keys
    other = PlanRegistry(device="cpu")
    sc = next(iter(scenes.values())).with_batch(4)
    other.get_or_build(sc)
    other.save(path)
    assert PlanRegistry(device="cpu").load(path) == len(reg) + 1


def test_registry_lru_and_warmed_buckets():
    sc = next(iter(cnn_layer_scenes(("vgg",), max_hw=8, max_ch=8,
                                    layers_per_net=1).values()))
    reg = PlanRegistry(max_plans=3, device="cpu")
    assert reg.warm([sc], buckets=(1, 2, 4)) == 3
    assert reg.warmed_buckets(sc) == (1, 2, 4)
    assert (reg.hits, reg.misses) == (0, 0)
    reg.get_or_build(sc.with_batch(8))
    assert reg.evictions == 1 and reg.warmed_buckets(sc) == (2, 4, 8)
    with pytest.raises(ValueError, match="max_plans"):
        reg.warm([sc], buckets=(1, 2, 4, 16))
    cuda_plan = dataclasses.replace(make_plan(sc, device="cpu"),
                                    backend="cuda")
    with pytest.raises(ValueError, match="registry"):
        reg.put(cuda_plan)


def test_convert_checks_shapes():
    sc = cnn_chain_scenes("resnet", **CAPS)["resnet/L0"]
    arr = _np(sc.flt_shape(), 60)
    t = flt_from_numpy(arr, sc, "cpu")
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), arr)
    with pytest.raises(ValueError, match="FLT layout"):
        flt_from_numpy(arr[:, :, :1], sc, "cpu")
    with pytest.raises(KeyError, match="no weight"):
        net_weights_from_numpy({"a": sc}, {}, "cpu")
    bf = flt_from_numpy(np.asarray(jnp.asarray(arr, jnp.bfloat16)),
                        sc.__class__(**{**sc.__dict__, "dtype": "bfloat16"}),
                        "cpu")
    assert bf.dtype == torch.bfloat16


def test_entry_points_default_to_the_card():
    """Without ``device=`` every entry point asks for CUDA; with no card
    that raises instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is satisfiable")
    sc = cnn_chain_scenes("resnet", **CAPS)["resnet/L0"]
    chain = cnn_chain_scenes("resnet", **CAPS)
    for call in (lambda: make_plan(sc), lambda: PlanRegistry(),
                 lambda: ConvServer(), lambda: ConvScheduler(),
                 lambda: scheduler_from_scenes(chain),
                 lambda: flt_from_numpy(_np(sc.flt_shape(), 0), sc),
                 lambda: registry_mod.get_plan(sc)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_model_request_squeezes_3d_input():
    chain = cnn_chain_scenes("resnet", **CAPS)
    sched = _sched()
    sched.register_net("resnet", chain, seed=4)
    sc0 = next(iter(chain.values()))
    x = torch.from_numpy(_np(sc0.in_shape()[:3], 70))
    out = sched.session("resnet").serve([x])[0]
    last = list(chain.values())[-1]
    assert tuple(out.shape) == last.out_shape()[:3]
    r = ModelRequest(rid=0, layer="", x=x, net="resnet")
    assert sched.submit(r) is r
    sched.drain()
    assert torch.equal(r.out, out)
