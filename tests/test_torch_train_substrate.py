"""The port's LM training substrate on the CPU held to the JAX reference:
data sources, the one-device mesh and the sharding rules as data, the
fault-tolerant training loop, elastic restore, the launcher.

For the three reference tests that fail under JAX versions whose
``make_mesh`` gives Explicit axes (``tests/test_train_substrate.py``:
``test_grad_accum_matches_single_batch``,
``test_bf16_grad_compression_close_to_fp32``,
``test_run_with_restarts_resumes_bitexact``: such a mesh rejects the
reference's sharding-hook constraints), the property each
states is checked within the port, with the reference test's bounds:
4 microbatches equal 1, bf16 gradient compression lands within its bound,
a run restarted twice is bitwise equal to a clean one.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jreg
from repro.configs.base import SHAPES
from repro.data import pipeline as JD
from repro.launch import mesh as JM
from repro.models import transformer as JT
from repro.parallel import sharding as JSH
from repro.train import ft as JFT
from repro.train import step as JS

from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as TD
from repro_torch.launch import mesh as TM
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as TT
from repro_torch.parallel import ctx as tctx
from repro_torch.parallel import sharding as TSH
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import ft as TFT
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS


# -- data pipeline -----------------------------------------------------------
@pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (0, 2), (1, 2), (3, 4)])
def test_synthetic_lm_is_the_references_batch(host_id, n_hosts):
    kw = dict(seed=3, host_id=host_id, n_hosts=n_hosts)
    ref, port = JD.SyntheticLM(1000, 8, 16, **kw), \
        TD.SyntheticLM(1000, 8, 16, **kw)
    for step in (0, 5, 17):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert set(got) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        assert got["tokens"].shape == (8 // n_hosts, 16)
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])


def test_synthetic_lm_hosts_partition_and_resume():
    parts = [TD.SyntheticLM(1000, 8, 16, seed=3, host_id=h, n_hosts=2)
             for h in range(2)]
    b = [p.batch_at(4)["tokens"] for p in parts]
    assert b[0].shape == (4, 16) and not np.array_equal(b[0], b[1])
    it = iter(TD.SyntheticLM(1000, 8, 16, seed=3))
    first = [next(it)["tokens"] for _ in range(3)]
    for step, toks in enumerate(first):
        np.testing.assert_array_equal(
            toks, TD.SyntheticLM(1000, 8, 16, seed=3).batch_at(step)["tokens"])
    with pytest.raises(ValueError, match="not divisible"):
        TD.SyntheticLM(1000, 6, 16, n_hosts=4)


@pytest.mark.parametrize("suffix", [".npy", ".bin"])
def test_token_file_is_the_references_batch(tmp_path, suffix):
    path = str(tmp_path / f"toks{suffix}")
    toks = np.random.default_rng(0).integers(0, 50000, 20001,
                                             dtype=np.int32)
    np.save(path, toks) if suffix == ".npy" else toks.tofile(path)
    for host_id in (0, 1):
        ref = JD.TokenFileDataset(path, batch=4, seq=32, seed=2,
                                  host_id=host_id, n_hosts=2)
        port = TD.TokenFileDataset(path, batch=4, seq=32, seed=2,
                                   host_id=host_id, n_hosts=2)
        assert port.steps_per_epoch == ref.steps_per_epoch == 156
        for step in (0, 1, 155, 156, 400):          # across epochs
            want, got = ref.batch_at(step), port.batch_at(step)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
            assert got["tokens"].shape == (2, 32)
            np.testing.assert_array_equal(got["tokens"][:, 1:],
                                          got["labels"][:, :-1])


def test_token_file_too_small_raises(tmp_path):
    path = str(tmp_path / "small.npy")
    np.save(path, np.arange(100, dtype=np.int32))
    with pytest.raises(ValueError, match="too small"):
        TD.TokenFileDataset(path, batch=8, seq=32)


def test_prefetcher_orders_batches_and_stops():
    ds = TD.SyntheticLM(100, 2, 8, seed=1)
    pf = TD.Prefetcher(ds, start_step=5, depth=2)
    got = [next(pf) for _ in range(4)]
    pf.stop()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for step, batch in got:
        np.testing.assert_array_equal(batch["tokens"],
                                      ds.batch_at(step)["tokens"])
    assert not pf._thread.is_alive()


# -- fault tolerance ---------------------------------------------------------
def test_straggler_monitor_flags_outliers():
    """The reference's test, on the port's monitor, and the same flags as
    the reference's on one noisy series."""
    mon = TFT.StragglerMonitor(threshold=2.0, warmup=2)
    for i in range(10):
        mon.record(i, 0.1)
    assert mon.record(10, 0.5) is True
    assert mon.flagged == [10]
    assert mon.record(11, 0.1) is False
    times = np.random.default_rng(0).lognormal(-2, 0.6, 200)
    ref, port = JFT.StragglerMonitor(), TFT.StragglerMonitor()
    assert [port.record(i, float(t)) for i, t in enumerate(times)] == \
        [ref.record(i, float(t)) for i, t in enumerate(times)]
    assert port.flagged == ref.flagged and port.flagged


def _tiny(n_mb=1, compress=None, arch="qwen3-14b"):
    """The reference's ``_tiny_setup`` in the port: reduced qwen3-14b,
    lr 1e-3 with 2 warm-up steps, SyntheticLM batch 8 x 32 (seed 7)."""
    cfg = treg.reduced(treg.get_config(arch))
    model = TT.init_params(cfg, seed=0, device="cpu", trainable=True)
    plan = TS.StepPlan(n_microbatches=n_mb, grad_compression=compress)
    opt_cfg = TO.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    step, hooks = TS.build_train_step(cfg, TM.make_host_mesh("cpu"),
                                      opt_cfg, plan, model)
    return cfg, model, step, hooks, TD.SyntheticLM(cfg.vocab, 8, 32, seed=7)


def test_elastic_restore_onto_a_host_mesh(tmp_path):
    cfg, model, _, _, _ = _tiny()
    state = TS.init_train_state(model)
    ckpt.save(str(tmp_path), 1, state.params)
    saved = {k: p.detach().clone() for k, p in state.params.items()}
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    mesh = TM.make_host_mesh("cpu")
    restored = TFT.elastic_restore(str(tmp_path), 1, state.params, mesh)
    for k, p in model.named_parameters():
        assert restored[k] is p             # written into the model's own
        assert torch.equal(p, saved[k]) and p.device == torch.device("cpu")
    big = TM.Mesh(("data", "model"), np.empty((2, 1), object))
    with pytest.raises(NotImplementedError, match="item 6"):
        TFT.elastic_restore(str(tmp_path), 1, state.params, big)


def test_run_with_restarts_resumes_bitexact(tmp_path):
    """Two injected failures, restarts from the latest checkpoint: the
    final parameters equal a clean run's bit for bit (the property of the
    reference test of the same name)."""
    cfg, model, step, hooks, data = _tiny()
    init = {k: p.detach().clone() for k, p in model.named_parameters()}

    def make_state():
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(init[k])
        return TS.init_train_state(model)

    runs = {}
    with tctx.activation_sharding(hooks):
        for name, fail_at in (("clean", None), ("faulty", {0: 6, 1: 9})):
            out = TFT.run_with_restarts(
                make_state=make_state, train_step=step, data_source=data,
                n_steps=12, ckpt_dir=str(tmp_path / name), ckpt_every=4,
                fail_at=fail_at, mesh=TM.make_host_mesh("cpu"))
            runs[name] = (out, {k: p.detach().clone()
                                for k, p in model.named_parameters()})
    assert runs["faulty"][0]["restarts"] == 2
    assert runs["clean"][0]["restarts"] == 0
    assert runs["clean"][0]["losses"] == runs["faulty"][0]["losses"]
    for k, p in runs["clean"][1].items():
        assert torch.equal(p, runs["faulty"][1][k]), k
    assert not torch.equal(runs["clean"][1]["embed"], init["embed"])


# -- gradient accumulation / compression -------------------------------------
def _grads(n_mb, compress=None):
    cfg, model, _, _, data = _tiny()
    step, _ = TS.build_train_step(
        cfg, TM.make_host_mesh("cpu"), TO.AdamWConfig(),
        TS.StepPlan(n_microbatches=n_mb, grad_compression=compress,
                    skip_update=True), model)
    return step(TS.init_train_state(model), data.batch_at(0))[1]


def test_grad_accum_matches_single_batch():
    """4 accumulated microbatches give the 1-microbatch step: gradients
    within 1e-4 of max |g| per leaf (f32), and, after the update, the
    reference test's bounds (loss 1e-3, parameters 5e-3)."""
    one, four = _grads(1), _grads(4)
    assert abs(float(one["loss"]) - float(four["loss"])) < 1e-5
    for k, g in one["grads"].items():
        scale = float(g.abs().max())
        assert float((four["grads"][k] - g).abs().max()) <= 1e-4 * scale, k
    stepped = []
    for n_mb in (1, 4):
        _, model, step, _, data = _tiny(n_mb)
        state, m = step(TS.init_train_state(model), data.batch_at(0))
        stepped.append((m, state))
    (m1, s1), (m4, s4) = stepped
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-3
    assert max(float((s1.params[k] - s4.params[k]).detach().abs().max())
               for k in s1.params) < 5e-3


def test_bf16_grad_compression_close_to_fp32():
    """bf16 accumulation over 4 microbatches: gradients within bf16's
    rounding (2^-8 relative per sum, four sums: 2e-2 of max |g|), and
    after the update the reference test's bounds (loss 1e-3, parameters
    5e-2 relative)."""
    f32, bf = _grads(4), _grads(4, "bf16")
    assert all(g.dtype == torch.bfloat16 for g in bf["grads"].values())
    for k, g in f32["grads"].items():
        scale = float(g.abs().max())
        assert float((bf["grads"][k].float() - g).abs().max()) <= \
            2e-2 * scale, k
    stepped = []
    for compress in (None, "bf16"):
        _, model, step, _, data = _tiny(4, compress)
        state, m = step(TS.init_train_state(model), data.batch_at(0))
        stepped.append((m, state))
    (mf, sf), (mc, sc) = stepped
    assert abs(float(mc["loss"]) - float(mf["loss"])) < 1e-3
    rel = max(float((sc.params[k] - sf.params[k]).detach().abs().max()
                    / (sf.params[k].detach().abs().max() + 1e-9))
              for k in sf.params)
    assert rel < 5e-2


# -- mesh and sharding rules -------------------------------------------------
def test_host_mesh_and_clamping():
    mesh = TM.make_host_mesh("cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert TM.data_axes(mesh) == ("data",)
    assert TM.data_devices(mesh) == (torch.device("cpu"),)
    assert TM.make_mesh_for(8, 4, "cpu").shape == {"data": 1, "model": 1}
    assert tuple(JM.make_mesh_for(8, 1).shape.values()) == (1, 1)
    with pytest.raises(ValueError):
        TM.make_mesh_for(0, 1, "cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        TM.make_production_mesh()
    with pytest.raises(NotImplementedError, match="item 6"):
        tctx.residual_hooks(TM.Mesh(("data", "model"),
                                    np.empty((2, 2), object)))


def test_constrain_is_identity_and_hooks_install():
    x = torch.ones(2, 3, 4)
    assert tctx.constrain(x, "residual") is x
    hooks = tctx.residual_hooks(TM.make_host_mesh("cpu"))
    assert set(hooks) == {"residual", "logits", "hidden", "heads",
                          "moe_dispatch"}
    seen = []
    with tctx.activation_sharding({"residual": lambda t: seen.append(t)
                                   or t}):
        assert tctx.constrain(x, "residual") is x
        assert tctx.constrain(x, "logits") is x
    assert len(seen) == 1 and tctx.constrain(x, "residual") is x


MESHES = [(16, 16), (4, 8), (1, 1)]


def _meshes(shape):
    devices = np.empty(shape, object)
    return AbstractMesh(shape, ("data", "model")), \
        TM.Mesh(("data", "model"), devices)


def _port_shapes(arch):
    """The port's parameter names with the reference's leaf shapes (its
    stacked layer axes dropped), from ``jax.eval_shape``: full-width
    configs are never built."""
    jcfg = jreg.get_config(arch)
    tree = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    small = TT.init_params(treg.reduced(treg.get_config(arch)),
                           device="cpu")
    out = {}
    for name, _ in small.named_parameters():
        parts = name.split(".")
        top = parts[0]
        n = {"layers": 1, "groups": 2, "tail": 1}.get(top, 0)
        keys = [{"groups": "layers", "tail": "tail_layers",
                 "shared": "shared_attn"}.get(top, top)] + parts[1 + n:]
        node = tree
        for k in keys:
            node = node[k]
        out[name] = (jax.ShapeDtypeStruct(node.shape[n:], node.dtype), n)
    return jcfg, tree, out


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "grok-1-314b", "zamba2-7b",
                                  "rwkv6-3b", "arctic-480b"])
@pytest.mark.parametrize("tp", [True, False])
def test_param_pspecs_match_reference(arch, tp):
    jcfg, tree, shapes = _port_shapes(arch)
    for mshape in MESHES:
        jmesh, tmesh = _meshes(mshape)
        jspec = JSH.param_pspecs(jcfg, tree, jmesh, tp)
        tspec = TSH.param_pspecs(treg.get_config(arch),
                                 {k: v for k, (v, _) in shapes.items()},
                                 tmesh, tp)
        for name, (_, n) in shapes.items():
            parts = name.split(".")
            top = parts[0]
            keys = [{"groups": "layers", "tail": "tail_layers",
                     "shared": "shared_attn"}.get(top, top)] + parts[1 + n:]
            node = jspec
            for k in keys:
                node = node[k]
            want = tuple(node)[n:] if len(tuple(node)) > n else ()
            assert tspec[name] == want, (name, mshape)


@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_batch_cache_specs_and_plans_match_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for mshape in MESHES:
        jmesh, tmesh = _meshes(mshape)
        assert TSH.dp_size(tmesh) == JSH.dp_size(jmesh)
        assert TSH.model_axis_size(tmesh) == JSH.model_axis_size(jmesh)
        for shape in SHAPES:
            for tp in (True, False):
                want = JSH.batch_pspecs(jcfg, shape, jmesh, tp)
                got = TSH.batch_pspecs(tcfg, shape, tmesh, tp)
                assert got == {k: tuple(v) for k, v in want.items()}
            # the port's plan has the reference's fields but
            # seq_shard_activations, which waits for sharding (its default)
            jp = dataclasses.asdict(JS.default_plan(jcfg, shape, jmesh))
            assert jp.pop("seq_shard_activations") is True
            assert dataclasses.asdict(TS.default_plan(tcfg, shape, tmesh)) \
                == jp
            if SHAPES[shape]["kind"] != "decode":
                continue
            want = jax.tree.map(tuple, JSH.cache_pspecs(jcfg, shape, jmesh),
                                is_leaf=lambda x: isinstance(
                                    x, jax.sharding.PartitionSpec))
            assert TSH.cache_pspecs(tcfg, shape, tmesh) == want
            cache_shape = jax.eval_shape(
                lambda: JT.init_cache(jcfg, SHAPES[shape]["global_batch"],
                                      SHAPES[shape]["seq_len"]))
            jfix = JSH.sanitize_pspecs(JSH.cache_pspecs(jcfg, shape, jmesh),
                                       cache_shape, jmesh)
            tfix = TSH.sanitize_pspecs(TSH.cache_pspecs(tcfg, shape, tmesh),
                                       cache_shape, tmesh)
            assert tfix == jax.tree.map(
                tuple, jfix,
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def test_state_pspecs_mirror_parameters():
    cfg, model, _, _, _ = _tiny()
    state = TS.init_train_state(model)
    mesh = TM.make_host_mesh("cpu")
    sspec = TS.state_pspecs(cfg, state, mesh)
    assert sspec.opt.m == sspec.opt.v == sspec.params
    assert sspec.params["embed"] == ("model", "data")
    assert sspec.opt.step == ()


# -- the launcher ------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-3b"])
def test_launch_train_smoke_on_cpu(arch, tmp_path, capsys):
    losses = launch_train.main(["--arch", arch, "--smoke", "--steps", "4",
                                "--device", "cpu", "--ckpt-dir",
                                str(tmp_path), "--ckpt-every", "2"])
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert ckpt.latest_step(str(tmp_path)) == 4
    more = launch_train.main(["--arch", arch, "--smoke", "--steps", "6",
                              "--device", "cpu", "--ckpt-dir",
                              str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "resumed at step 4" in out and "training complete" in out
    assert len(more) == 2


def test_launch_train_rejects_embedding_models():
    with pytest.raises(SystemExit, match="embeddings"):
        launch_train.main(["--arch", "musicgen-large", "--smoke",
                           "--steps", "1", "--device", "cpu"])


# -- serve steps ---------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-3b", "zamba2-7b"])
def test_prefill_and_decode_steps(arch):
    """``build_prefill_step`` gives the last position's logits and the
    cache of ``prefill``; ``build_decode_step`` one token's logits, the
    cache updated in place; neither records a graph, and both run under
    the mesh's hooks."""
    cfg = treg.reduced(treg.get_config(arch))
    model = TT.init_params(cfg, seed=1, device="cpu", trainable=True)
    mesh = TM.make_host_mesh("cpu")
    prefill, decode = TS.build_prefill_step(mesh), TS.build_decode_step(mesh)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)))
    seen = []
    spy = {"residual": lambda t: seen.append(t.shape) or t}
    with tctx.activation_sharding(spy):     # replaced inside the steps
        last, cache = prefill(model, {"tokens": toks[:, :15]})
    with torch.no_grad():
        pre, _ = model.prefill(tokens=toks[:, :15])
        full, _ = model(tokens=toks)
    assert last.grad_fn is None and torch.equal(last, pre[:, -1])
    if "kv" in cache:
        cache["kv"] = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1))
                       for k, v in cache["kv"].items()}
    with tctx.activation_sharding(spy):
        logits, new = decode(model, cache, {"tokens": toks[:, 15:],
                                            "position": torch.full((2,),
                                                                   15)})
    assert not seen
    assert new is cache and logits.shape == (2, cfg.vocab)
    assert logits.grad_fn is None
    torch.testing.assert_close(logits, full[:, -1], rtol=3e-3, atol=3e-3)
