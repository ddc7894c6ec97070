"""The moe, vlm and audio families on a ring of CPU devices
(``parallel/ring.py``) held to the JAX reference and the one-device port.

Every case carries the reference's weights across
(``convert.lm_params_from_numpy``), f32, and holds one step of the ring
against the reference's ``build_train_step`` (run under
``ctx.activation_sharding({})`` on its host mesh) with the same
``n_microbatches``: loss, ``ce_loss``, ``moe_aux``, the gradient norm
and the learning rate within 1e-4, every updated parameter within 1e-4
where its gradient's sign is firm (2 lr elsewhere: Adam's first step
moves each element by about lr * sign(g)).  Before it, the ring's
gradients (a ``skip_update`` step) within 1e-5 of max |g| of the
one-device port's.

* The routing set: reduced grok-1-314b in the DP grain on (2, 2) at
  capacity factor 1.25 and 4.0 (drop-free), and on (2, 1) at 2
  microbatches, where the reference's microbatch is rows [0, 2) and [2, 4)
  of the batch (the port gave each position two of its own rows before).
* The TP + SP grain: expert parallelism on (1, 2) and (2, 2) for reduced
  grok and arctic (dense residual MLP beside the experts), TP inside the
  experts with ``n_experts`` replaced by 2 on (1, 4) in both packages;
  vlm and audio on (2, 2); q heads that do not divide over "model" (10 q
  over 2 k/v heads on (1, 4): 3, 3, 2 and 2 per shard, the second
  shard's straddling the k/v groups) for a dense and a moe config.
* The dry run's model of a moe ring (one representative position, times
  the chips) against a trace of every position of the same ``meta``
  ring: FLOPs within 1 %, collective bytes (the routing exchange among
  them) exact.
"""
import dataclasses

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
from repro_torch.parallel import ctx, ring
from repro_torch.parallel import sharding as SH
from repro_torch.train import optimizer as O
from repro_torch.train import step as S

TOL = 1e-4
GRAD_TOL = 1e-5
OPT_KW = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def _ring(d, m):
    return make_mesh_for(d, m, devices=("cpu",) * (d * m))


def _replace(cfg, over, moe_over):
    if moe_over:
        over = dict(over, moe=dataclasses.replace(cfg.moe, **moe_over))
    return dataclasses.replace(cfg, **over)


def _pair(arch, over=None, moe_over=None, seed=0):
    """The reduced config in both packages (the same replacements) and
    the reference's weights, as JAX arrays and as numpy."""
    over, moe_over = over or {}, moe_over or {}
    jcfg = _replace(jreg.reduced(jreg.get_config(arch)), over, moe_over)
    cfg = _replace(treg.reduced(treg.get_config(arch)), over, moe_over)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, params, jax.tree.map(np.asarray, params)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    else:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)) \
            .astype(np.float32)
    return out


def _ref_leaf(tree, name):
    """The reference leaf of port parameter ``name``."""
    parts = name.split(".")
    idx = ()
    if parts[0] == "layers":
        idx, parts = (int(parts[1]),), ["layers"] + parts[2:]
    node = tree
    for p in parts:
        node = node[p]
    return np.asarray(node)[idx]


def _ref_step(jcfg, params, batch, n_mb):
    jstep, _ = JS.build_train_step(jcfg, j_host_mesh(),
                                   JO.AdamWConfig(**OPT_KW),
                                   JS.StepPlan(n_microbatches=n_mb))
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    with jctx.activation_sharding({}):
        jnew, jm = jax.jit(jstep)(
            JS.TrainState(params, JO.init_opt_state(params)), jb)
    return jax.tree.map(np.asarray, jnew.params), jm


def _hold_step(arch, mesh, plan, batch, over=None, moe_over=None):
    """The ring's gradients against the one-device port's, then one step
    against the reference's (see the module docstring)."""
    jcfg, cfg, params, np_params = _pair(arch, over, moe_over)
    model = lm_params_from_numpy(cfg, np_params, device="cpu",
                                 trainable=True)
    state = ring.init_state(model, mesh, tp=plan.tp)
    gstep, hooks = S.build_train_step(
        cfg, mesh, O.AdamWConfig(**OPT_KW),
        dataclasses.replace(plan, skip_update=True))
    with ctx.activation_sharding(hooks):
        _, gm = gstep(state, batch)
    got = ring.gather_grads(state.params, gm["grads"])
    one_step, _ = S.build_train_step(
        cfg, make_host_mesh("cpu"), O.AdamWConfig(**OPT_KW),
        S.StepPlan(n_microbatches=plan.n_microbatches, skip_update=True),
        model)
    _, om = one_step(S.init_train_state(model), batch)
    np.testing.assert_allclose(float(gm["loss"]), float(om["loss"]),
                               rtol=GRAD_TOL)
    for n, g in om["grads"].items():
        scale = max(float(g.abs().max()), 1e-30)
        assert float((got[n] - g).abs().max()) <= GRAD_TOL * scale, n
    ref, jm = _ref_step(jcfg, params, batch, plan.n_microbatches)
    step, hooks = S.build_train_step(cfg, mesh, O.AdamWConfig(**OPT_KW),
                                     plan)
    with ctx.activation_sharding(hooks):
        _, m = step(state, batch)
    assert ring.replica_mismatches(state) == []
    for key in ("loss", "ce_loss", "moe_aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=TOL,
                                   atol=TOL, err_msg=key)
    glob = state.global_state()
    lr = float(jm["lr"])
    for n in state.params.names:
        new, want = glob.params[n]().numpy(), _ref_leaf(ref, n)
        g = om["grads"][n].numpy()
        firm = np.abs(g) > TOL * max(float(np.abs(g).max()), 1e-30)
        err = np.abs(new - want)
        assert float(err[firm].max(initial=0.0)) <= TOL, n
        assert float(err.max()) <= 2 * lr + TOL, n
    return m, jm


@pytest.mark.parametrize("shape,n_mb,cf", [((2, 2), 1, 1.25),
                                           ((2, 2), 1, 4.0),
                                           ((2, 1), 2, 1.25)])
def test_dp_grain_routes_the_reference_microbatch(shape, n_mb, cf):
    mesh = _ring(*shape)
    batch = _batch(treg.reduced(treg.get_config("grok-1-314b")), 4, 16, 0)
    m, jm = _hold_step("grok-1-314b", mesh,
                       S.StepPlan(n_microbatches=n_mb, tp=False), batch,
                       moe_over={"capacity_factor": cf})
    assert float(m["moe_aux"]) > 0


def test_routing_set_counts_its_exchange(monkeypatch):
    """One all-gather of the members' per-expert counts (4 members x 8
    experts x 8 bytes) per MoE layer and receiving position, in the pass
    without gradients only."""
    cfg = treg.reduced(treg.get_config("grok-1-314b"))
    model = lm_params_from_numpy(cfg, _pair("grok-1-314b")[3], device="cpu",
                                 trainable=True)
    mesh = _ring(2, 2)
    calls, records = {}, []
    route, record = ring._RoutingSet.route, SH.record

    def spy(self, layer, logits):
        calls[self.recording] = calls.get(self.recording, 0) + 1
        return route(self, layer, logits)

    monkeypatch.setattr(ring._RoutingSet, "route", spy)
    monkeypatch.setattr(SH, "record", lambda kind, nbytes: (
        records.append((kind, nbytes)), record(kind, nbytes)))
    state = ring.init_state(model, mesh, tp=False)
    step, _ = S.build_train_step(cfg, mesh, O.AdamWConfig(**OPT_KW),
                                 S.StepPlan(n_microbatches=1, tp=False))
    step(state, _batch(cfg, 4, 16, 1))
    # 4 positions x 2 layers in each pass
    assert calls == {True: 8, False: 8}
    assert records.count(("all_gather", 4 * 8 * 8)) == 8


@pytest.mark.parametrize("arch,shape,moe_over", [
    ("grok-1-314b", (1, 2), {}),
    ("grok-1-314b", (2, 2), {"capacity_factor": 1.25}),
    ("arctic-480b", (1, 2), {}),
    ("arctic-480b", (2, 2), {"capacity_factor": 1.25}),
    ("grok-1-314b", (1, 4), {"n_experts": 2})])
def test_moe_tp_grain(arch, shape, moe_over):
    mesh = _ring(*shape)
    cfg = treg.reduced(treg.get_config(arch))
    ep = moe_over.get("n_experts", cfg.moe.n_experts) >= shape[1]
    assert ep == ("n_experts" not in moe_over)
    m, _ = _hold_step(arch, mesh, S.StepPlan(n_microbatches=1, tp=True),
                      _batch(cfg, 4, 32, 3), moe_over=moe_over)
    assert float(m["moe_aux"]) > 0


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "musicgen-large"])
@pytest.mark.parametrize("sp", (True, False))
def test_embeds_families_tp_grain(arch, sp):
    cfg = treg.reduced(treg.get_config(arch))
    _hold_step(arch, _ring(2, 2),
               S.StepPlan(n_microbatches=1, tp=True,
                          seq_shard_activations=sp),
               _batch(cfg, 4, 32, 4))


@pytest.mark.parametrize("arch", ["qwen3-14b", "arctic-480b"])
def test_q_heads_that_do_not_divide(arch):
    mesh = _ring(1, 4)
    over = {"n_heads": 10, "n_kv_heads": 2}
    cfg = dataclasses.replace(treg.reduced(treg.get_config(arch)), **over)
    state = ring.init_state(lm_params_from_numpy(
        cfg, _pair(arch, over)[3], device="cpu", trainable=True), mesh,
        tp=True)
    sh = ring._Shards(state.params, 0, [0, 1, 2, 3], {})
    assert [sh.q_heads(j) for j in range(4)] == [(0, 3), (3, 6), (6, 8),
                                                 (8, 10)]
    # shard 1's q heads 3, 4 and 5 read k/v heads 0, 0 and 1
    assert [sh.kv_take(j) for j in range(4)] == [None, [0, 0, 1], None,
                                                 None]
    _hold_step(arch, mesh, S.StepPlan(n_microbatches=1, tp=True),
               _batch(cfg, 2, 32, 5), over=over)


@pytest.mark.parametrize("width,shape", [("reduced", (2, 2)),
                                         ("full", (2, 2)),
                                         ("full", (1, 4))])
def test_dryrun_model_matches_full_ring_trace(width, shape):
    cfg = treg.get_config("grok-1-314b")
    if width == "reduced":      # the DP grain, its routing set over 4
        cfg, kw = treg.reduced(cfg), dict(batch_override=8, seq_override=64)
    else:       # full width, depth cut to 2 layers and the cell to fit
        cfg = dataclasses.replace(cfg, n_layers=2)
        kw = dict(batch_override=4, seq_override=128)
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


@pytest.mark.parametrize("arch,shape", [("grok-1-314b", (1, 4)),
                                        ("musicgen-large", (2, 2)),
                                        ("qwen2.5-3b", (1, 4))])
def test_dryrun_serving_model_matches_the_counters(arch, shape):
    """A prefill and a decode step on a CPU ring: their ``repro.mesh.*``
    bytes equal the dry run's model of the same cells (the logits are
    gathered on position 0 alone)."""
    cfg = treg.reduced(treg.get_config(arch))
    n = shape[0] * shape[1]
    mp = ring.shard_params(lm_params_from_numpy(cfg, _pair(arch)[3],
                                                device="cpu"),
                           _ring(*shape), tp=True)
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, 2, 16, 6).items()
             if k != "labels"}
    step = {"decode": _batch(cfg, 2, 1, 7)}
    step = {k: torch.as_tensor(v) for k, v in step["decode"].items()
            if k != "labels"}
    step["position"] = torch.full((2,), 16)
    b0 = SH.collective_bytes()
    _, cache = S.build_prefill_step(mp.mesh)(mp, batch, max_len=32)
    b1 = SH.collective_bytes()
    S.build_decode_step(mp.mesh)(mp, cache, step)
    b2 = SH.collective_bytes()
    meta = make_mesh_for(*shape, devices=("meta",) * n)
    for cell, seq, lo, hi in (("prefill_32k", 16, b0, b1),
                              ("decode_32k", 32, b1, b2)):
        r = dryrun.run_config(cfg, cell, mesh=meta, batch_override=2,
                              seq_override=seq)
        want = {k.replace("-", "_"): v
                for k, v in r["collectives"]["ring_bytes"].items()}
        assert want == {k: hi[k] - lo[k] for k in hi}, cell
