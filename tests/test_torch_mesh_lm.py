"""The LM path on a ring of CPU devices (``parallel/ring.py``) held to the
one-device port and to the JAX reference.

* ``sharding.shard_tree``/``gather_tree`` round-trip every leaf of every
  family bitwise, each local slice of the spec's division.
* DP grain: a (2, 1) and a (2, 2) ring's steps of reduced qwen2.5-3b
  (dense), zamba2-7b (hybrid, causal_conv1d's plain version) and
  rwkv6-3b (ssm) are bitwise equal to the one-device step with 2x / 4x
  the microbatches: losses, every parameter and both moments, with
  gradient clipping engaged.  grok-1-314b (moe) routes each microbatch
  as one set, as the reference does, so its ring is held within 1e-4 to
  the one-device step with the same microbatches
  (``tests/test_torch_mesh_moe.py`` holds it to the reference).  With
  checkpointing on, each layer's leaves are gathered as the layer runs
  and again in its recomputation, and no other checkpointed unit's are
  alive then.  A batch that does not divide over the positions is
  replicated, as the reference's ``batch_pspecs`` replicates it.
* TP + SP grain (reduced qwen3-14b, f32) on (1, 2) and (2, 2): the
  gradients within 1e-5 of max |g| of the one-device port's, their norm
  from per-shard sums and a scalar all-reduce within 1e-6, and one
  step within 1e-4 of the reference's ``build_train_step`` (run under
  ``ctx.activation_sharding({})`` on its host mesh) on the same numpy
  batch and the reference's weights (``convert.lm_params_from_numpy``).
* Elastic restore (2, 2) -> (4, 1) -> (1, 1): the gathered leaves equal
  the saved ones, and each next step the uninterrupted run's, bitwise.
* The dry run's model of a ring (one representative position, times the
  chips) against a trace of every position of the same ``meta`` ring:
  FLOPs within 1 %, collective bytes exact; a DP ring's transients grow
  by less than a gathered layer per layer.
"""
import collections
import dataclasses
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import transformer as JT
from repro.parallel import ctx as jctx
from repro.train import optimizer as JO
from repro.train import step as JS

from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_mesh_for
from repro_torch.models import transformer as T
from repro_torch.parallel import ctx, ring
from repro_torch.parallel import sharding as SH
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import ft
from repro_torch.train import optimizer as O
from repro_torch.train import step as S

TOL = 1e-4
GRAD_TOL = 1e-5
FAMILY_ARCHS = {"dense": "qwen2.5-3b", "moe": "grok-1-314b",
                "vlm": "llava-next-mistral-7b", "audio": "musicgen-large",
                "hybrid": "zamba2-7b", "ssm": "rwkv6-3b"}
DP_ARCHS = ("qwen2.5-3b", "zamba2-7b", "rwkv6-3b", "grok-1-314b")
# clip_norm below every first gradient norm: the clipped path runs
OPT = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50, clip_norm=0.5)


def _ring(d, m):
    return make_mesh_for(d, m, devices=("cpu",) * (d * m))


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    else:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)) \
            .astype(np.float32)
    return out


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
@pytest.mark.parametrize("tp", (True, False))
def test_shard_gather_round_trip(family, tp):
    cfg = treg.reduced(treg.get_config(FAMILY_ARCHS[family]))
    model = T.init_params(cfg, device="cpu")
    mesh = _ring(2, 2)
    named = {n: p.detach() for n, p in model.named_parameters()}
    specs = SH.param_pspecs(cfg, named, mesh, tp)
    shards = SH.shard_tree(named, specs, mesh)
    assert len(shards) == 4
    for pos, tree in enumerate(shards):
        for n, t in tree.items():
            assert t.shape == SH.local_shape(specs[n], named[n].shape, mesh)
            want = named[n][SH.local_slices(specs[n], named[n].shape, mesh,
                                            pos)]
            assert torch.equal(t, want), n
            assert t.untyped_storage().data_ptr() != \
                named[n].untyped_storage().data_ptr()
    back = SH.gather_tree(shards, specs, mesh, "cpu")
    for n, t in named.items():
        assert torch.equal(back[n], t), n
    # replicated leaves are copies of their own on every position
    rep = [n for n in named if not any(SH.spec_axes(e) for e in specs[n])]
    for n in rep:
        ptrs = {tr[n].untyped_storage().data_ptr() for tr in shards}
        assert len(ptrs) == 4, n


def test_indivisible_spec_raises_naming_leaf_and_axis():
    mesh = _ring(2, 2)
    with pytest.raises(ValueError, match=r"w: dim 0 .* \('data', 'model'\)"):
        SH.shard_leaf(torch.zeros(6, 4), (("data", "model"), None), mesh,
                      name="w")
    # fewer q heads than model shards: nothing runs
    cfg = dataclasses.replace(treg.reduced(treg.get_config("qwen3-14b")),
                              n_heads=2, n_kv_heads=2)
    model = T.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="wq: 2 heads .* 'model' \\(4\\)"):
        ring.shard_params(model, _ring(1, 4), tp=True)
    # the hybrid's 8 Mamba2 heads leave 8 of 16 model shards without one
    hybrid = T.init_params(treg.reduced(treg.get_config("zamba2-7b")),
                           device="cpu")
    with pytest.raises(ValueError, match="8 Mamba2 heads .* 'model' "
                                         "\\(16\\) without one"):
        ring.shard_params(hybrid, _ring(1, 16), tp=True)


def _steps(step, state, cfg, b, s, seeds):
    return [step(state, _batch(cfg, b, s, i))[1] for i in seeds]


@pytest.mark.parametrize("arch", DP_ARCHS)
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_dp_grain_bitwise_equals_one_device(arch, shape):
    cfg = treg.reduced(treg.get_config(arch))
    model = T.init_params(cfg, device="cpu", trainable=True)
    mesh = _ring(*shape)
    state = ring.init_state(model, mesh, tp=False)
    step, hooks = S.build_train_step(cfg, mesh, OPT,
                                     S.StepPlan(n_microbatches=1, tp=False))
    assert isinstance(hooks, ctx.RingHooks)
    with ctx.activation_sharding(hooks):
        got = _steps(step, state, cfg, 4, 16, range(2))
    one = S.init_train_state(model)
    # a routed microbatch is the reference's: the oracle takes the plan's
    # one microbatch, and agrees within rounding (the ring sums per
    # position); without MoE each position's rows are the one-device
    # step's microbatches, bit for bit
    routed = cfg.moe is not None
    step1, _ = S.build_train_step(
        cfg, make_host_mesh("cpu"), OPT,
        S.StepPlan(n_microbatches=1 if routed else mesh.size), model)
    want = _steps(step1, one, cfg, 4, 16, range(2))

    def same(a, b, what):
        if routed:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                       atol=TOL, err_msg=what)
        else:
            assert torch.equal(a, b), what

    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "lr", "ce_loss", "moe_aux"):
            same(g[k], w[k], k)
    assert float(want[0]["grad_norm"]) > OPT.clip_norm
    glob = state.global_state()
    for n, p in model.named_parameters():
        same(glob.params[n](), p.detach(), n)
        same(glob.opt.m[n](), one.opt.m[n], n)
        same(glob.opt.v[n](), one.opt.v[n], n)
    assert all(int(o.step) == 2 for o in state.opt)
    assert ring.replica_mismatches(state) == []


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "grok-1-314b"])
def test_dp_grain_replicates_a_batch_that_does_not_divide(arch):
    """2 rows on a (2, 2) ring: every position runs both, as the
    reference's ``batch_pspecs`` replicate them (a 512-chip mesh's 256
    rows), and the step is the one-device step's within rounding."""
    cfg = treg.reduced(treg.get_config(arch))
    model = T.init_params(cfg, device="cpu", trainable=True)
    mesh = _ring(2, 2)
    assert SH.batch_pspecs(cfg, "train_4k", mesh, tp=False)["tokens"] == \
        (("data", "model"), None)
    state = ring.init_state(model, mesh, tp=False)
    step, _ = S.build_train_step(cfg, mesh, OPT,
                                 S.StepPlan(n_microbatches=1, tp=False))
    got = _steps(step, state, cfg, 2, 16, range(2))
    one = S.init_train_state(model)
    step1, _ = S.build_train_step(cfg, make_host_mesh("cpu"), OPT,
                                  S.StepPlan(n_microbatches=1), model)
    want = _steps(step1, one, cfg, 2, 16, range(2))
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "ce_loss", "moe_aux"):
            np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=TOL,
                                       err_msg=k)
    glob = state.global_state()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(glob.params[n]().numpy(),
                                   p.detach().numpy(), atol=TOL, err_msg=n)


@pytest.mark.parametrize("arch", DP_ARCHS)
def test_dp_grain_gathers_each_layer_as_it_runs(arch, monkeypatch):
    cfg = dataclasses.replace(treg.reduced(treg.get_config(arch)),
                              remat_policy="nothing_saveable")
    model = T.init_params(cfg, device="cpu", trainable=True)
    mesh = _ring(2, 1)
    state = ring.init_state(model, mesh, tp=False)
    layer_of = {f"{prefix}.{n}": prefix
                for prefix, mod in ring._layer_modules(model)
                for n, _ in mod.named_parameters()}
    assert layer_of and len(layer_of) < len(state.params.names)
    live, seen, gathers = [], [], collections.Counter()
    real = ring.MeshParams.gather

    def spy(self, name, *args, **kwargs):
        out = real(self, name, *args, **kwargs)
        if name in layer_of:
            alive = {lay for lay, ref in live if ref() is not None}
            seen.append(alive | {layer_of[name]})
            live.append((layer_of[name],
                         weakref.ref(out.untyped_storage())))
            gathers[name] += 1
        return out

    monkeypatch.setattr(ring.MeshParams, "gather", spy)
    step, _ = S.build_train_step(cfg, mesh, OPT,
                                 S.StepPlan(n_microbatches=2, tp=False))
    got = _steps(step, state, cfg, 4, 16, range(1))
    monkeypatch.undo()
    # the checkpointed unit is the layer, or the hybrid's group of
    # attn_every Mamba2 layers, whose backward holds them all
    unit = cfg.attn_every if cfg.family == "hybrid" else 1
    assert max(len(s) for s in seen) <= unit
    # 2 data positions x 2 microbatches x (forward + recomputation), and
    # for a routed microbatch its pass without gradients
    routed = cfg.moe is not None
    assert set(gathers.values()) == {12 if routed else 8}
    one = S.init_train_state(model)
    step1, _ = S.build_train_step(
        cfg, make_host_mesh("cpu"), OPT,
        S.StepPlan(n_microbatches=2 if routed else 4), model)
    want = _steps(step1, one, cfg, 4, 16, range(1))

    def same(a, b, what):
        if routed:      # the reference's microbatches, within rounding
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL,
                                       atol=TOL, err_msg=what)
        else:
            assert torch.equal(a, b), what

    for k in ("loss", "grad_norm"):
        same(got[0][k], want[0][k], k)
    glob = state.global_state()
    for n, p in model.named_parameters():
        same(glob.params[n](), p.detach(), n)


def _ref_pair(arch):
    jcfg = jreg.reduced(jreg.get_config(arch))
    cfg = treg.reduced(treg.get_config(arch))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    return jcfg, cfg, params, np_params


def _ref_leaf(tree, name):
    """The reference leaf of port parameter ``name`` (dense family)."""
    parts = name.split(".")
    idx = ()
    if parts[0] == "layers":
        idx, parts = (int(parts[1]),), ["layers"] + parts[2:]
    node = tree
    for p in parts:
        node = node[p]
    return np.asarray(node)[idx]


@pytest.mark.parametrize("shape,sp", [((1, 2), True), ((2, 2), True),
                                      ((2, 2), False)])
def test_tp_grain_matches_one_device_and_reference(shape, sp):
    jcfg, cfg, params, np_params = _ref_pair("qwen3-14b")
    mesh = _ring(*shape)
    batch = _batch(cfg, 4, 32, 3)
    plan = S.StepPlan(n_microbatches=1, tp=True, seq_shard_activations=sp)
    # gradients: the ring against the one-device port
    model = lm_params_from_numpy(cfg, np_params, device="cpu",
                                 trainable=True)
    state = ring.init_state(model, mesh, tp=True)
    gstep, hooks = S.build_train_step(
        cfg, mesh, OPT, dataclasses.replace(plan, skip_update=True))
    with ctx.activation_sharding(hooks):
        _, gm = gstep(state, batch)
    got = ring.gather_grads(state.params, gm["grads"])
    # the TP grain's norm: per-shard sums of squares (a replicated slice
    # once) and an all-reduce of one f32 scalar per position, no gather
    acc = ring._Accumulator(state.params, None)
    acc.acc = gm["grads"]
    before = SH.collective_bytes()
    norms = acc.sharded_norm()
    moved = {k: v - before[k] for k, v in SH.collective_bytes().items()}
    assert moved == {"all_gather": 0, "reduce_scatter": 0,
                     "all_reduce": 4 * mesh.size}
    whole = float(O.global_norm(got))
    assert all(float(x) == float(norms[0]) for x in norms)
    np.testing.assert_allclose(float(norms[0]), whole, rtol=1e-6)
    one_step, _ = S.build_train_step(
        cfg, make_host_mesh("cpu"), OPT,
        S.StepPlan(n_microbatches=shape[0], skip_update=True), model)
    _, om = one_step(S.init_train_state(model), batch)
    np.testing.assert_allclose(float(gm["loss"]), float(om["loss"]),
                               rtol=GRAD_TOL)
    for n, g in om["grads"].items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((got[n] - g).abs().max()) <= GRAD_TOL * scale, n
    # one step against the reference's
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    jstep, _ = JS.build_train_step(jcfg, j_host_mesh(),
                                   JO.AdamWConfig(**opt_kw),
                                   JS.StepPlan(n_microbatches=shape[0]))
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    with jctx.activation_sharding({}):
        jnew, jm = jax.jit(jstep)(
            JS.TrainState(params, JO.init_opt_state(params)), jb)
    ref = jax.tree.map(np.asarray, jnew.params)
    step, hooks = S.build_train_step(cfg, mesh, O.AdamWConfig(**opt_kw),
                                     plan)
    _, m = step(state, batch)
    # the norms' and replicated biases' copies on every shard stay equal
    assert ring.replica_mismatches(state) == []
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=TOL,
                                   atol=TOL, err_msg=key)
    glob = state.global_state()
    lr = float(jm["lr"])
    for n in state.params.names:
        new, want = glob.params[n]().numpy(), _ref_leaf(ref, n)
        g = om["grads"][n].numpy()
        # Adam's first step moves each element by about lr * sign(g): an
        # element whose gradient is within rounding of 0 may take either
        firm = np.abs(g) > TOL * max(float(np.abs(g).max()), 1e-30)
        err = np.abs(new - want)
        assert float(err[firm].max(initial=0.0)) <= TOL, n
        assert float(err.max()) <= 2 * lr + TOL, n


def test_elastic_restore_across_meshes(tmp_path):
    cfg = treg.reduced(treg.get_config("qwen2.5-3b"))
    model = T.init_params(cfg, device="cpu", trainable=True)
    d = str(tmp_path)
    plan = S.StepPlan(n_microbatches=1, tp=False)

    def run(mesh, state, seeds, n_mb=1):
        step, _ = S.build_train_step(
            cfg, mesh, OPT, dataclasses.replace(plan, n_microbatches=n_mb))
        return [m["loss"] for m in _steps(step, state, cfg, 4, 16, seeds)]

    m22, m41, m11 = _ring(2, 2), _ring(4, 1), make_host_mesh("cpu")
    straight = ring.init_state(model, m22, tp=False)
    want = run(m22, straight, range(3))
    a = ring.init_state(model, m22, tp=False)
    run(m22, a, [0])
    ckpt.save(d, 1, a, extra={"next_step": 1})
    b = ft.elastic_restore(d, 1, a, m41)
    ga, gb = a.global_state(), b.global_state()
    for n in a.params.names:
        for tree in ("params", "m", "v"):
            src = ga.params if tree == "params" else getattr(ga.opt, tree)
            dst = gb.params if tree == "params" else getattr(gb.opt, tree)
            assert torch.equal(src[n](), dst[n]()), (tree, n)
    assert run(m41, b, [1]) == [want[1]]
    ckpt.save(d, 2, b, extra={"next_step": 2})
    c = ft.elastic_restore(d, 2, b, m11)
    assert run(m11, c, [2], n_mb=4) == [want[2]]
    gs, gc = straight.global_state(), c.global_state()
    for n in a.params.names:
        assert torch.equal(gs.params[n](), gc.params[n]()), n
    # the files are the same whatever mesh wrote them: a one-device state
    # restores from the ring's checkpoint and steps to the same loss
    one = S.init_train_state(model)
    ft.elastic_restore(d, 2, one, m11)
    step1, _ = S.build_train_step(cfg, m11, OPT,
                                  S.StepPlan(n_microbatches=4), model)
    assert torch.equal(step1(one, _batch(cfg, 4, 16, 2))[1]["loss"], want[2])


def test_dp_grain_dry_run_holds_one_gathered_layer():
    """The dry run of a DP ring counts FSDP's memory: a layer more adds
    its slices' f32 gradient and a checkpointed input to a chip's
    transients, not the whole gathered layer."""
    mesh = make_mesh_for(2, 2, devices=("meta",) * 4)
    temp = {}
    for n_layers in (2, 4):
        cfg = dataclasses.replace(treg.get_config("qwen2.5-3b"),
                                  n_layers=n_layers)
        r = dryrun.run_config(cfg, "train_4k", mesh=mesh, n_microbatches=1,
                              batch_override=4, seq_override=256)
        assert r["status"] == "ok" and not r["tp"]
        temp[n_layers] = r["memory"]["temp_bytes"]
    model = T.init_params(cfg, device="meta")
    layer = sum(p.numel() * p.element_size()
                for p in model.layers[0].parameters())
    assert 0 < (temp[4] - temp[2]) / 2 < layer


@pytest.mark.parametrize("width", ("reduced", "full"))
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_dryrun_model_matches_full_ring_trace(width, shape):
    cfg = treg.get_config("qwen3-14b")
    if width == "reduced":
        cfg, kw = treg.reduced(cfg), dict(batch_override=8, seq_override=64)
    else:       # full width, depth cut to 2 layers and the cell to fit
        cfg = dataclasses.replace(cfg, n_layers=2)
        kw = dict(batch_override=4, seq_override=256)
    mesh = make_mesh_for(*shape, devices=("meta",) * 4)
    model = dryrun.run_config(cfg, "train_4k", mesh=mesh, n_microbatches=2,
                              **kw)
    full = dryrun.run_config(cfg, "train_4k", mesh=mesh, n_microbatches=2,
                             representative=False, **kw)
    assert model["status"] == full["status"] == "ok"
    assert model["source"] == "model"
    assert model["tp"] == (width == "full")
    ratio = model["flops_traced"] * mesh.size / full["flops_traced"]
    assert abs(ratio - 1) <= 0.01, ratio
    assert model["collectives"]["ring_bytes"] == \
        full["collectives"]["ring_bytes"]
    assert sum(full["collectives"]["ring_bytes"].values()) > 0
