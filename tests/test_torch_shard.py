"""The port's ring-sharded plans (``repro_torch.shard``) on the CPU, held to
the JAX reference (``repro.shard``, tests/test_shard.py).

Every test runs in this process on a ring of eight CPU devices
(``("cpu",) * 8``, the counterpart of the reference's forced 8-device
host), where the kernel wrappers run their plain versions.  Partition
math (sub-scenes, halo geometry, blockers, collective bytes, pinned
specs) must equal the reference's exactly.  Sharded fprop/dgrad/wgrad
and their gradients are held to the reference's unsharded plans (its
plain route) within rtol=atol=1e-4, the reference's own tolerance, and
inside the port the batch/oc/h partitions are bitwise equal to the
unsharded plan; one test runs the reference's own ``ShardedConvPlan``
under ``shard_map`` on eight forced host devices in a subprocess and
holds the port to its output, ``psum`` included."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import verify_sharded_plan as j_verify_sharded
from repro.core import autodiff as jad
from repro.core.mapping import ScheduleChoice as JChoice
from repro.core.mapping import select_schedule as j_select
from repro.core.scene import ConvScene as JScene
from repro.models.cnn import cnn_layer_scenes as j_layer_scenes
from repro.plan import ConvOp as JOp
from repro.plan import make_plan as j_make_plan
from repro.shard import plan as jsp
from repro.shard import spec as jss

from repro_torch import obs
from repro_torch.analysis import verify_sharded_plan
from repro_torch.core import autodiff as ad
from repro_torch.core.mapping import (ICI_BW, ICI_LATENCY_S,
                                      SHARD_LAUNCH_OVERHEAD_S, ScheduleChoice,
                                      select_schedule)
from repro_torch.core.scene import ConvScene
from repro_torch.launch.mesh import data_devices, make_mesh_for
from repro_torch.models import cnn as M
from repro_torch.obs.metrics import default_metrics
from repro_torch.plan import ConvOp, PlanRegistry, make_plan
from repro_torch.plan import registry as registry_mod
from repro_torch.plan.registry import (plan_from_dict, plan_signature,
                                       plan_to_dict, valid_plan_dict)
from repro_torch.serve.conv import ConvRequest, server_from_scenes
from repro_torch.serve.sched import ConvScheduler
from repro_torch.shard import (PARTITION_AXES, ShardedTrainingPlans,
                               assemble_sharded_plan, collective_bytes,
                               collective_seconds, halo_geometry,
                               make_sharded_plan, make_sharded_training_plans,
                               pinned_shard_spec, select_shard_spec,
                               shard_blocker, shard_sub_scene,
                               sharded_conv_with_plans)
from repro_torch.shard.plan import _exec_scene_for, device_pool
from repro_torch.shard.spec import _shard_counts
from repro_torch.train import cnn as tc
from repro_torch.train.optimizer import AdamWConfig

ROOT = Path(__file__).resolve().parent.parent
RING = ("cpu",) * 8
TOL = dict(rtol=1e-4, atol=1e-4)
OPS = ("fprop", "dgrad", "wgrad")

# the reference's acceptance set: all six paper CNNs, capped small
J_SCENES = j_layer_scenes(batch=8, max_hw=12, max_ch=16, layers_per_net=2)

# tests/test_shard.py's SC, and scenes with remainder shards: uneven B, OC,
# IC and outH over 3 shards, a strided forward (lhs-dilated dgrad,
# rhs-dilated wgrad), the reference's multi-hop halo scene
SC = dict(B=16, IC=16, OC=32, inH=14, inW=14, fltH=3, fltW=3, padH=1,
          padW=1, stdH=1, stdW=1)
PARITY_SCENES = {
    "dense": dict(B=5, IC=7, OC=10, inH=9, inW=7, fltH=3, fltW=3, padH=1,
                  padW=1, stdH=1, stdW=1),
    "strided": dict(B=6, IC=5, OC=7, inH=9, inW=8, fltH=3, fltW=3, padH=1,
                    padW=1, stdH=2, stdW=1),
    "halo": dict(B=4, IC=8, OC=8, inH=11, inW=11, fltH=3, fltW=3, padH=1,
                 padW=1, stdH=2, stdW=2),
}


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


def _fields(scene) -> dict:
    d = {f.name: getattr(scene, f.name) for f in dataclasses.fields(scene)}
    d["dtype"] = jnp.dtype(d["dtype"]).name
    return d


def _port_scene(jscene) -> ConvScene:
    return ConvScene(**_fields(jscene))


def _exec(scene, op, pkg):
    """(exec scene, error) of ``op`` in one package."""
    try:
        if pkg == "jax":
            return jsp._exec_scene_for(scene, JOp(op))[0], None
        return _exec_scene_for(scene, ConvOp(op))[0], None
    except ValueError as e:
        return None, e


def _operands(scene: ConvScene, op: str, seed: int = 7):
    shapes = {"fprop": (scene.in_shape(), scene.flt_shape()),
              "dgrad": (scene.out_shape(), scene.flt_shape()),
              "wgrad": (scene.in_shape(), scene.out_shape())}[op]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in shapes)


def _pinned(scene: ConvScene, op: str, axis: str, n: int):
    exec_scene, _ = _exec_scene_for(scene, ConvOp(op))
    choice = select_schedule(shard_sub_scene(exec_scene, axis, n))
    return make_sharded_plan(scene, op, devices=RING,
                             spec=pinned_shard_spec(scene, op, axis, n,
                                                    choice))


# --------------------------------------------------------------------------
# partition math: exactly the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", sorted(J_SCENES))
def test_partition_math_matches_reference(name, op):
    """Blockers, sub-scenes, halo geometry, collective bytes and pinned
    specs of every axis at n = 2..8 equal the reference's, on every exec
    scene of the reference's scene set."""
    jexec, jerr = _exec(J_SCENES[name], op, "jax")
    pexec, perr = _exec(_port_scene(J_SCENES[name]), op, "torch")
    assert (jerr is None) == (perr is None)
    if jerr is not None:
        return
    assert _fields(pexec) == _fields(jexec)
    jchoice = JChoice("TB88", 8, 8, 8, 1e-6, 1e-6, 1e-7, 0)
    pchoice = ScheduleChoice("TB88", 8, 8, 8, 1e-6, 1e-6, 1e-7, 0)
    for axis in PARTITION_AXES:
        for n in range(1, 9):
            why = shard_blocker(pexec, axis, n)
            assert why == jss.shard_blocker(jexec, axis, n)
            if why:
                continue
            assert (_fields(shard_sub_scene(pexec, axis, n))
                    == _fields(jss.shard_sub_scene(jexec, axis, n)))
            assert (collective_bytes(pexec, axis, n)
                    == jss.collective_bytes(jexec, axis, n))
            if axis == "h":
                assert (dataclasses.asdict(halo_geometry(pexec, n))
                        == dataclasses.asdict(jss.halo_geometry(jexec, n)))
            ps = pinned_shard_spec(_port_scene(J_SCENES[name]), op, axis, n,
                                   pchoice)
            js = jsp.pinned_shard_spec(J_SCENES[name], JOp(op), axis, n,
                                       jchoice)
            assert (ps.axis, ps.n_shards, ps.tag, ps.collective_bytes) == (
                js.axis, js.n_shards, js.tag, js.collective_bytes)
            assert _fields(ps.sub_scene) == _fields(js.sub_scene)
            # the cost terms are the port's own constants over the same
            # closed forms
            rounds = (halo_geometry(pexec, n).hops if axis == "h"
                      else (n - 1) if axis == "ic" else 0)
            want_s = (ps.collective_bytes / ICI_BW + rounds * ICI_LATENCY_S
                      if rounds or ps.collective_bytes else 0.0)
            assert ps.collective_s == pytest.approx(want_s, rel=1e-12)
            assert ps.predicted_s == pytest.approx(
                1e-6 + want_s + SHARD_LAUNCH_OVERHEAD_S, rel=1e-12)


@pytest.mark.parametrize("max_shards", range(1, 10))
def test_shard_counts_match_reference(max_shards):
    assert _shard_counts(max_shards) == jss._shard_counts(max_shards)


def test_sub_scenes_blockers_and_bytes():
    sc = ConvScene(**SC)
    assert shard_sub_scene(sc, "batch", 4).B == 4
    assert shard_sub_scene(sc, "oc", 8).OC == 4
    assert shard_sub_scene(sc, "ic", 4).IC == 4
    sub = shard_sub_scene(sc, "h", 4)
    assert (sub.padH, sub.apadH, sub.outH) == (0, 0, 4)
    assert shard_sub_scene(sc.with_batch(10), "batch", 4).B == 3
    assert shard_blocker(sc, "batch", 1) and shard_blocker(sc, "h", 15)
    assert shard_blocker(dataclasses.replace(sc, dilH=2), "h", 2)
    assert shard_blocker(sc, "diagonal", 2) == \
        "unknown partition axis 'diagonal'"
    with pytest.raises(ValueError, match="cannot shard"):
        shard_sub_scene(sc, "ic", 17)
    # itemsize from the torch dtype: bf16 moves half the bytes
    bf = dataclasses.replace(sc, dtype="bfloat16")
    assert collective_bytes(bf, "ic", 4) * 2 == collective_bytes(sc, "ic", 4)
    assert collective_bytes(sc, "batch", 4) == 0
    assert collective_seconds(sc, "oc", 4) == 0.0


# --------------------------------------------------------------------------
# the joint selector and the registry keys
# --------------------------------------------------------------------------
def test_selector_falls_back_when_collective_loses():
    tiny = ConvScene(B=2, IC=8, OC=8, inH=4, inW=4, fltH=3, fltW=3,
                     padH=1, padW=1)
    spec = select_shard_spec(tiny, max_shards=8)
    assert not spec.is_sharded and spec.tag == "none:1"


def test_selector_total_beats_baseline_or_n1():
    sc = ConvScene(**SC)
    for scene in (sc, sc.with_batch(256)):
        spec = select_shard_spec(scene, max_shards=8)
        base = select_schedule(scene).predicted_s
        if spec.is_sharded:
            assert spec.predicted_s < base
            assert spec.predicted_s >= (spec.choice.predicted_s
                                        + SHARD_LAUNCH_OVERHEAD_S)
        else:
            assert spec.predicted_s == base
    with pytest.raises(ValueError, match="max_shards"):
        select_shard_spec(sc, max_shards=0)


@pytest.mark.parametrize("axes", [("batch",), ("oc",), ("h",), ("ic",)])
def test_selector_respects_axis_restriction(axes):
    spec = select_shard_spec(ConvScene(**SC).with_batch(256), max_shards=8,
                             axes=axes)
    assert spec.axis in axes + ("none",)


def test_plan_signature_shard_fragment():
    sc = ConvScene(**SC)
    base = plan_signature(sc, ConvOp.FPROP, "analytic", "cpu", True)
    assert plan_signature(sc, ConvOp.FPROP, "analytic", "cpu", True,
                          None) == base
    assert "shard" not in base
    assert plan_signature(sc, ConvOp.FPROP, "analytic", "cpu", True,
                          shard="h:8") == base + "|shard=h:8"


def test_registry_sharded_and_unsharded_keys_disjoint():
    sc = ConvScene(**SC)
    reg = PlanRegistry(device="cpu")
    plan = make_sharded_plan(sc, ConvOp.FPROP, devices=RING, max_shards=1)
    reg.put(plan)
    assert reg.get(sc, ConvOp.FPROP) is None          # unsharded key: miss
    assert reg.get(sc, ConvOp.FPROP, shard=plan.shard_tag) is plan
    one = reg.get_or_build(sc, ConvOp.FPROP)
    assert one is not plan and one.shard_tag is None and len(reg) == 2
    assert reg.warmed_buckets(sc) == (16,)    # the one-device plan only


def test_make_sharded_plan_validation():
    sc = ConvScene(**SC)
    with pytest.raises(ValueError, match="ScheduleChoice"):
        make_sharded_plan(sc, devices=RING, policy=select_schedule(sc))
    with pytest.raises(ValueError, match="exact blocks"):
        make_sharded_plan(sc, devices=RING, policy="forced:TB88@8/8/8")
    forced = make_sharded_plan(sc, devices=RING, policy="TB88")
    assert forced.schedule == "TB88" and forced.policy == "forced:TB88"
    choice = select_schedule(shard_sub_scene(sc, "batch", 8))
    spec = pinned_shard_spec(sc, ConvOp.FPROP, "batch", 8, choice)
    with pytest.raises(ValueError, match="device"):
        make_sharded_plan(sc, devices=RING[:4], spec=spec)
    bad = dataclasses.replace(spec, sub_scene=sc)
    with pytest.raises(ValueError, match="re-derive"):
        make_sharded_plan(sc, devices=RING, spec=bad)


def test_device_pool(monkeypatch):
    assert device_pool(("cpu", torch.device("cpu"))) == (
        torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="empty"):
        device_pool(())
    with pytest.raises(ValueError, match="CUDA devices or CPU devices"):
        device_pool(("meta",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_pool(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sharded_plan(ConvScene(**SC))


def test_mesh_over_a_device_pool():
    mesh = make_mesh_for(4, 1, devices=RING[:4])
    assert mesh.shape == {"data": 4, "model": 1} and mesh.size == 4
    assert data_devices(mesh) == (torch.device("cpu"),) * 4
    assert make_mesh_for(16, 16, devices=RING).shape == {"data": 1,
                                                         "model": 8}
    assert make_mesh_for(8, 4, "cpu").shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="not both"):
        make_mesh_for(2, 1, "cpu", devices=RING)


# --------------------------------------------------------------------------
# execution: every feasible axis against the reference and the port
# --------------------------------------------------------------------------
def _parity_cases():
    for name, kw in PARITY_SCENES.items():
        sc = ConvScene(**kw)
        for op in OPS:
            exec_scene, _ = _exec_scene_for(sc, ConvOp(op))
            for axis in PARTITION_AXES:
                n = 3 if not shard_blocker(exec_scene, axis, 3) else 2
                if not shard_blocker(exec_scene, axis, n):
                    yield name, op, axis, n


@pytest.mark.parametrize("name, op, axis, n", list(_parity_cases()))
def test_sharded_directions_match_reference(name, op, axis, n):
    """fprop/dgrad/wgrad of each feasible partition (remainder shards
    included) within 1e-4 of the reference's unsharded plan on the same
    operands; batch/oc/h bitwise equal to the port's unsharded plan."""
    kw = PARITY_SCENES[name]
    sc = ConvScene(**kw)
    a, b = _operands(sc, op)
    want = np.asarray(j_make_plan(JScene(**kw), JOp(op),
                                  use_pallas=False).execute(jnp.asarray(a),
                                                            jnp.asarray(b)))
    plan = _pinned(sc, op, axis, n)
    assert plan.shard_tag == f"{axis}:{n}"
    assert not verify_sharded_plan(plan)
    got = plan.execute(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    one = make_plan(sc, op, device="cpu").execute(torch.from_numpy(a),
                                                  torch.from_numpy(b))
    if axis == "ic":
        np.testing.assert_allclose(got.numpy(), one.numpy(), **TOL)
    else:
        assert torch.equal(got, one)


def test_n1_fallback_and_metrics():
    sc = ConvScene(**SC)
    m = default_metrics()
    plan = make_sharded_plan(sc, ConvOp.FPROP, devices=RING, max_shards=1)
    assert not plan.spec.is_sharded and plan.inners == (plan.inner,)
    assert not verify_sharded_plan(plan)
    a, b = (torch.from_numpy(t) for t in _operands(sc, "fprop"))
    assert torch.equal(plan.execute(a, b),
                       make_plan(sc, device="cpu").execute(a, b))
    h = _pinned(sc, "fprop", "h", 4)
    h.execute(a, b)
    assert m.value("repro.shard.plans") == 2
    assert m.value("repro.shard.fallbacks") == 1
    assert m.value("repro.shard.executes") == 2
    assert m.value("repro.shard.collective_bytes") == h.spec.collective_bytes
    assert len(h.kernel_calls(a, b)) == 4
    with pytest.raises(ValueError, match="expects operands"):
        h.execute(b, a)


def test_sharded_gradients_match_reference():
    """The autograd Function's gradients within 1e-4 of the reference's
    ``conv_with_plans``; a forward input that needs no gradient launches
    no dgrad."""
    kw = PARITY_SCENES["strided"]
    sc = ConvScene(**kw)
    inp, flt = _operands(sc, "fprop")
    cot = np.random.default_rng(3).standard_normal(
        sc.out_shape()).astype(np.float32)
    jplans = jad.make_training_plans(JScene(**kw), use_pallas=False)
    jgi, jgf = jad.jax.grad(
        lambda i, f: jnp.sum(jad.conv_with_plans(i, f, jplans) * cot),
        argnums=(0, 1))(jnp.asarray(inp), jnp.asarray(flt))
    triples = [make_sharded_training_plans(sc, devices=RING),
               ShardedTrainingPlans(fprop=_pinned(sc, "fprop", "batch", 3),
                                    dgrad=_pinned(sc, "dgrad", "ic", 3),
                                    wgrad=_pinned(sc, "wgrad", "oc", 3))]
    for plans in triples:
        x = torch.from_numpy(inp).requires_grad_(True)
        w = torch.from_numpy(flt).requires_grad_(True)
        (sharded_conv_with_plans(x, w, plans)
         * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgi), **TOL)
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(jgf), **TOL)
    assert triples[1].shard_tags == ("batch:3", "ic:3", "oc:3")
    m = default_metrics()
    before = m.value("repro.shard.executes")
    w = torch.from_numpy(flt).requires_grad_(True)
    ad.apply_conv(torch.from_numpy(inp), w, triples[1]).sum().backward()
    assert m.value("repro.shard.executes") - before == 2   # fprop, wgrad


def test_sharded_training_plans_fall_back_where_no_exec_scene():
    sc = ConvScene(B=2, IC=3, OC=4, inH=6, inW=6, fltH=3, fltW=3, padH=1,
                   padW=1, apadH=1)
    plans = make_sharded_training_plans(sc, devices=RING)
    assert plans.reference_ops == ("dgrad", "wgrad")
    assert plans.shard_tags[1:] == ("-", "-")
    assert "|" in plans.describe() and plans.scene == sc


def test_sharded_small_cnn_train_step_matches_unsharded():
    """tests/test_train_cnn.py:378: three steps of the small CNN on
    sharded triples — the selector's, and pinned ones that shard every
    direction (a remainder shard in dgrad) — give the one-device
    trainer's losses within 1e-4."""
    gen = torch.Generator().manual_seed(0)
    params = M.init_small_cnn(gen, width=4, device="cpu")
    plans = M.small_cnn_plans(params, 8, 8, device="cpu", devices=RING)
    assert isinstance(plans["c1"], ShardedTrainingPlans)
    pinned = ad.ModelPlans(layers=tuple(
        (name, ShardedTrainingPlans(fprop=_pinned(sc, "fprop", "batch", 4),
                                    dgrad=_pinned(sc, "dgrad", "oc", 2),
                                    wgrad=_pinned(sc, "wgrad", "ic", 4)))
        for name, sc in plans.scenes().items()))
    ref = M.small_cnn_plans(params, 8, 8, device="cpu")
    cfg = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    from repro_torch.data.pipeline import SyntheticImages
    data = SyntheticImages(8, 8, seed=3, noise=0.3)
    losses = {}
    for key, p in (("sharded", plans), ("pinned", pinned), ("one", ref)):
        step = tc.jit_train_step(tc.build_cnn_train_step(p, cfg))
        state = tc.init_train_state({k: v.clone() for k, v in
                                     params.items()})
        out = []
        with tc.resolution_guard():
            for i in range(3):
                batch = {k: torch.from_numpy(v) for k, v in
                         data.batch_at(i).items()}
                state, ms = step(state, batch)
                out.append(float(ms["loss"]))
        losses[key] = out
    np.testing.assert_allclose(losses["sharded"], losses["one"], **TOL)
    np.testing.assert_allclose(losses["pinned"], losses["one"], **TOL)
    assert tc.feed_drift_from_plans(pinned) == 9


# --------------------------------------------------------------------------
# registry artifacts, serving, the verifier
# --------------------------------------------------------------------------
def test_registry_roundtrip_sharded_plan(tmp_path, capsys):
    sc = ConvScene(**SC)
    plan = _pinned(sc, "fprop", "h", 8)
    d = plan_to_dict(plan)
    assert d["shard"] == {"axis": "h", "n": 8} and valid_plan_dict(d)
    assert not valid_plan_dict(dict(d, shard={"axis": "h", "n": 99}))
    reg = PlanRegistry(device="cpu")
    reg.put(plan)
    path = str(tmp_path / "plans.json")
    reg.save(path)
    reg2 = PlanRegistry(device="cpu")
    assert reg2.load(path, devices=RING) == 1
    again = reg2.get(sc, ConvOp.FPROP, shard="h:8")
    assert again is not None and again.spec == plan.spec
    a, b = (torch.from_numpy(t) for t in _operands(sc, "fprop"))
    assert torch.equal(again.execute(a, b), plan.execute(a, b))
    # the default pool of a cpu registry is one device: the 8-shard entry
    # is stale there, skipped on load and kept on merge-on-save
    reg3 = PlanRegistry(device="cpu")
    assert reg3.load(path) == 0
    assert "skipped 1" in capsys.readouterr().err
    with pytest.raises(ValueError, match="device"):
        plan_from_dict(d)
    reg3.put(make_plan(sc, device="cpu"))
    reg3.save(path)
    with open(path) as f:
        keys = json.load(f)["plans"]
    assert len(keys) == 2 and any(k.endswith("|shard=h:8") for k in keys)


def _servers(**kwargs):
    scenes = {"a": _port_scene(J_SCENES["vgg/L1"]).with_batch(1),
              "b": _port_scene(J_SCENES["resnet/L1"]).with_batch(1)}
    mesh = make_mesh_for(8, 1, devices=RING)
    kw = dict(max_batch=16, strict=True, ladder_slack=0.0)
    return (scenes, server_from_scenes(scenes, mesh=mesh, **kw, **kwargs),
            server_from_scenes(scenes, device="cpu", **kw))


def _serve_both(scenes, mesh_srv, ref_srv):
    mesh_srv.prewarm()
    ref_srv.prewarm()
    snap = mesh_srv.snapshot()
    rng = np.random.default_rng(0)
    reqs = [(layer, rng.standard_normal(
        scenes[layer].with_batch(b).in_shape()).astype(np.float32))
        for layer, b in (("a", 3), ("b", 5), ("a", 16), ("b", 2))]
    outs = [srv.serve([ConvRequest(rid=i, layer=lay, x=torch.from_numpy(x))
                       for i, (lay, x) in enumerate(reqs)])
            for srv in (mesh_srv, ref_srv)]
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    st = mesh_srv.stats(since=snap)
    assert st["plan_misses"] == 0 and st["plan_builds"] == 0
    assert st["dispatches"] >= 1
    return st


def test_conv_server_mesh_mode_parity_and_zero_resolution():
    """tests/test_shard.py:318: ``ConvServer(mesh=...)`` serves bitwise
    what the one-device server serves, with zero steady-state plan misses
    or builds (strict mode)."""
    scenes, mesh_srv, ref_srv = _servers()
    m = default_metrics()
    _serve_both(scenes, mesh_srv, ref_srv)
    assert mesh_srv.device == torch.device("cpu")
    assert set(mesh_srv._shard_tags) == {
        (lay, ConvOp.FPROP, b) for lay in "ab" for b in (1, 2, 4, 8, 16)}
    assert all(t.split(":")[0] in ("batch", "none")
               for t in mesh_srv._shard_tags.values())
    before = m.value("repro.plan.resolutions")
    mesh_srv.prewarm()                  # a second warm re-selects nothing
    assert m.value("repro.plan.resolutions") == before


def test_conv_server_mesh_from_an_artifact_of_pinned_plans(tmp_path):
    """A registry artifact of pinned ``batch:4`` plans prewarms a mesh
    server that serves under them (the artifact satisfies the warm), and
    bitwise what the one-device server serves."""
    scenes, _, _ = _servers()
    reg = PlanRegistry(device="cpu")
    for layer, sc in scenes.items():
        for b in (4, 8, 16):
            scene = sc.with_batch(b)
            choice = select_schedule(shard_sub_scene(scene, "batch", 4))
            reg.put(assemble_sharded_plan(scene, "fprop", "analytic",
                                          "batch", 4, choice, devices=RING))
    path = str(tmp_path / "pinned.json")
    reg.save(path)
    scenes, mesh_srv, ref_srv = _servers()
    assert mesh_srv.prewarm(artifact=path) == 4       # buckets 1, 2 built
    tags = mesh_srv._shard_tags
    assert all(tags[(lay, ConvOp.FPROP, b)] == "batch:4"
               for lay in "ab" for b in (4, 8, 16))
    _serve_both(scenes, mesh_srv, ref_srv)


def test_mesh_server_refusals():
    with pytest.raises(ValueError, match="use_kernels"):
        server_from_scenes({}, mesh=make_mesh_for(8, 1, devices=RING),
                           use_kernels=False)
    with pytest.raises(ValueError, match="not both"):
        server_from_scenes({}, mesh=make_mesh_for(8, 1, devices=RING),
                           device="cpu")
    with pytest.raises(ValueError, match="mesh serving"):
        ConvScheduler(mesh=make_mesh_for(8, 1, devices=RING))


def _reference_sharded(jscene, op, axis, n):
    """The reference's ``ShardedConvPlan`` of a pinned partition, built
    field by field (this process's JAX has one device, which its
    ``make_sharded_plan`` would refuse; the verifier reads no device)."""
    jexec, out_hw = jsp._exec_scene_for(jscene, JOp(op))
    sub = jexec if n == 1 else jss.shard_sub_scene(jexec, axis, n)
    spec = jsp.pinned_shard_spec(jscene, JOp(op), axis, n, j_select(sub))
    inner = j_make_plan(spec.sub_scene, JOp.FPROP, policy=spec.choice)
    return jsp.ShardedConvPlan(scene=jscene, op=JOp(op), policy="analytic",
                               interpret=True, spec=spec, inner=inner,
                               exec_scene=jexec, devices=(None,) * n,
                               out_hw=out_hw)


def _codes(findings):
    return sorted(f.code for f in findings if f.severity == "error")


@pytest.mark.parametrize("case", ["batch:4", "oc:2", "h:3", "ic:2",
                                  "none:1", "tampered-sub", "tampered-h",
                                  "blocked", "fallback-sub"])
def test_verify_sharded_plan_matches_reference_codes(case):
    jscene = J_SCENES["vgg/L1"]
    sc = _port_scene(jscene)
    axis, n = ({"tampered-sub": ("batch", 4), "tampered-h": ("h", 3),
                "blocked": ("batch", 4), "fallback-sub": ("none", 1)}
               .get(case) or (case.split(":")[0], int(case.split(":")[1])))
    jplan = _reference_sharded(jscene, "fprop", axis, n)
    plan = (make_sharded_plan(sc, devices=RING, max_shards=1) if n == 1
            else _pinned(sc, "fprop", axis, n))

    def tamper(p):
        if case == "tampered-sub":
            sub = dataclasses.replace(p.spec.sub_scene,
                                      B=p.spec.sub_scene.B + 1)
        elif case == "tampered-h":
            sub = dataclasses.replace(p.spec.sub_scene,
                                      inH=p.spec.sub_scene.inH + 2)
        elif case == "blocked":
            return dataclasses.replace(p, spec=dataclasses.replace(
                p.spec, n_shards=16))
        elif case == "fallback-sub":
            sub = dataclasses.replace(p.spec.sub_scene, OC=3)
        else:
            return p
        return dataclasses.replace(p, spec=dataclasses.replace(
            p.spec, sub_scene=sub))

    got = _codes(verify_sharded_plan(tamper(plan)))
    want = _codes(j_verify_sharded(tamper(jplan)))
    assert got == want
    assert bool(got) == case.startswith(("tampered", "blocked", "fallback"))


# --------------------------------------------------------------------------
# the reference's own sharded plan, on eight forced host devices
# --------------------------------------------------------------------------
_REFERENCE_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core.mapping import select_schedule
from repro.core.scene import ConvScene
from repro.plan import ConvOp
from repro.shard import make_sharded_plan, pinned_shard_spec, shard_sub_scene
assert jax.device_count() == 8, jax.device_count()
kw, axes, path = json.loads(sys.argv[1]), sys.argv[2].split(","), sys.argv[3]
sc = ConvScene(**kw)
d = np.load(path)
out = {}
for axis in axes:
    ch = select_schedule(shard_sub_scene(sc, axis, 4))
    plan = make_sharded_plan(sc, ConvOp.FPROP, spec=pinned_shard_spec(
        sc, ConvOp.FPROP, axis, 4, ch))
    out[axis] = np.asarray(plan.execute(jnp.asarray(d["a"]),
                                        jnp.asarray(d["b"])))
np.savez(path.replace("in.npz", "out.npz"), **out)
"""


def test_reference_sharded_plan_on_eight_host_devices(tmp_path):
    """The reference's ``ShardedConvPlan`` (``shard_map``, ``ppermute``,
    ``psum``; Pallas in interpret mode) in a subprocess with eight forced
    host devices, one scene x four axes x fprop, against the port's
    plan of the same partition on the same operands."""
    kw = dict(B=8, IC=8, OC=8, inH=8, inW=8, fltH=3, fltW=3, padH=1,
              padW=1, stdH=1, stdW=1)
    sc = ConvScene(**kw)
    a, b = _operands(sc, "fprop")
    np.savez(tmp_path / "in.npz", a=a, b=b)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SCRIPT, json.dumps(kw),
         ",".join(PARTITION_AXES), str(tmp_path / "in.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    ref = np.load(tmp_path / "out.npz")
    for axis in PARTITION_AXES:
        got = _pinned(sc, "fprop", axis, 4).execute(torch.from_numpy(a),
                                                    torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), ref[axis], **TOL)
