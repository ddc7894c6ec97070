"""The hybrid (Mamba2) and ssm (rwkv6) families on a ring of CPU devices
(``parallel/ring.py``, their TP grain) held to the one-device port and to
the JAX reference.

Every case carries the reference's weights across
(``convert.lm_params_from_numpy``), f32, tolerance 1e-4 of max |logit|
(of max |g| per leaf for gradients).

* Serving (``build_prefill_step``/``build_decode_step``): a prefill and
  four greedy decode steps, each step's logits against the one-device
  port's and the reference's forward over the same tokens (its greedy
  forward chain), the gathered cache (``kv``, ``mamba``, ``mamba_tail``,
  ``rwkv``) against the one-device cache.  Reduced zamba2-7b (8 Mamba2
  heads, 2 k/v heads) on (1, 2) (head-sharded k/v cache), (1, 4)
  (sequence-sharded) and (2, 2) (the batch split over the data rows);
  reduced rwkv6-3b at d_model 256 (4 heads) on (1, 2) and (1, 4), and at
  192 (3 heads over 2 shards: 2 and 1) on (1, 2).
* ``long_500k``'s grain: batch 1, which does not divide over the data
  rows, replicated on every row, the k/v's sequence over "data" (zamba2
  on (2, 2): heads over "model") or over ("data", "model") (on (2, 4): 2
  k/v heads < 4); a 5-token prompt in a cache of 64 leaves shards with no
  valid position (weight 0, not nan); every data row's logits equal.
* Mamba2's gated RMSNorm takes its mean over every head: each shard's
  mean over its own heads alone moves the logits far past the tolerance.
* TP training on (1, 2) and (2, 2), SP on and off: the loss against the
  one-device step's and the reference's ``lm_loss``, every gradient
  against ``jax.value_and_grad`` of it; a full step keeps every
  replicated leaf's copies equal.
* The cache layout: ``shard_cache`` and ``gather_cache`` round-trip a
  one-device cache bitwise; ``sanitize_pspecs`` drops "model" where it
  does not divide (rwkv6-3b's ``u`` and state heads at 16 shards).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as JT

from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.mesh import make_host_mesh, make_mesh_for
from repro_torch.models import transformer as T
from repro_torch.parallel import ctx, ring
from repro_torch.parallel import sharding as SH
from repro_torch.train import optimizer as O
from repro_torch.train import step as S

TOL = 1e-4
STEPS = 4
RWKV_WIDTHS = {4: 256, 3: 192}       # rwkv6 heads -> d_model
PAD_LEN = 128


@pytest.fixture(autouse=True)
def _one_thread():
    """Rings of many small shards: one intra-op thread a test process (the
    suite's workers would otherwise oversubscribe the cores), restored
    after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring(d, m):
    return make_mesh_for(d, m, devices=("cpu",) * (d * m))


@functools.lru_cache(maxsize=None)
def _pair(arch, d_model=None, trainable=False):
    """The reduced config in both packages (rwkv6 at ``d_model``), the
    port's model on the reference's weights, the reference's logits at
    the last position of a sequence, and its loss with its gradients of a
    batch."""
    jcfg = jreg.reduced(jreg.get_config(arch))
    cfg = treg.reduced(treg.get_config(arch))
    if d_model:
        jcfg = dataclasses.replace(jcfg, d_model=d_model)
        cfg = dataclasses.replace(cfg, d_model=d_model)
    params = JT.init_params(jcfg, jax.random.PRNGKey(3))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu", trainable=trainable)
    # the forward is causal: one padded length (one compile), read at the
    # last real position; the hybrid's SSD chunk raised to that length
    # (the same function, which takes lengths over 16 only in multiples)
    ocfg = jcfg if jcfg.ssm is None else dataclasses.replace(
        jcfg, ssm=dataclasses.replace(jcfg.ssm, chunk=PAD_LEN))
    fwd = jax.jit(lambda t: JT.forward(params, ocfg, tokens=t)[0])

    def last(seq):
        padded = np.zeros((seq.shape[0], PAD_LEN), np.int32)
        padded[:, :seq.shape[1]] = seq
        return np.asarray(fwd(padded))[:, seq.shape[1] - 1]
    grads = jax.jit(jax.value_and_grad(lambda p, b: JT.lm_loss(p, jcfg, b)[0]))
    return cfg, model, last, functools.partial(grads, params)


def _ref_leaf(tree, name):
    """The reference leaf of port parameter ``name`` (its layers stacked
    on leading axes: ``layers`` (L, ...) or the hybrid's (G, A, ...),
    ``tail_layers``, ``shared_attn``)."""
    parts = name.split(".")
    idx = ()
    if parts[0] == "layers":
        idx, parts = (int(parts[1]),), ["layers"] + parts[2:]
    elif parts[0] == "groups":
        idx, parts = (int(parts[1]), int(parts[2])), ["layers"] + parts[3:]
    elif parts[0] == "tail":
        idx, parts = (int(parts[1]),), ["tail_layers"] + parts[2:]
    elif parts[0] == "shared":
        parts = ["shared_attn"] + parts[1:]
    node = tree
    for p in parts:
        node = node[p]
    return np.asarray(node)[idx]


def _close(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _serve(cfg, model, fwd, mesh, bsz, prompt, max_len):
    """A prefill and ``STEPS`` greedy decode steps on the ring and on one
    device, each step's logits held to one device's and the reference's;
    returns (the ring's parameters, its cache, one device's cache)."""
    mp = ring.shard_params(model, mesh, tp=True)
    tokens = np.random.default_rng(prompt).integers(0, cfg.vocab,
                                                   (bsz, prompt))
    host = make_host_mesh("cpu")
    pf1, dc1 = S.build_prefill_step(host), S.build_decode_step(host)
    pfr, dcr = S.build_prefill_step(mesh), S.build_decode_step(mesh)
    l1, c1 = pf1(model, {"tokens": torch.as_tensor(tokens)}, max_len=max_len)
    lr, cr = pfr(mp, {"tokens": tokens}, max_len=max_len)
    assert lr.shape == (bsz, cfg.vocab)
    seq = tokens
    for t in range(STEPS + 1):
        _close(lr, l1, f"step {t} vs one device")
        _close(lr, fwd(seq), f"step {t} vs the reference")
        assert torch.isfinite(lr).all()
        if t == STEPS:
            break
        nxt = l1.argmax(-1)[:, None]
        pos = torch.full((bsz,), prompt + t)
        l1, c1 = dc1(model, c1, {"tokens": nxt, "position": pos})
        lr, cr = dcr(mp, cr, {"tokens": nxt.numpy(), "position": pos})
        seq = np.concatenate([seq, nxt.numpy()], 1)
    return mp, cr, c1


def _hold_cache(cr, c1, mesh):
    got = ring.gather_cache(cr, mesh, "cpu")
    want = dict(SH._flat_items(c1))
    flat = dict(SH._flat_items(got))
    assert sorted(flat) == sorted(want)
    for path, leaf in flat.items():
        assert leaf.shape == want[path].shape, path
        _close(leaf, want[path], f"cache {path}")


@pytest.mark.parametrize("shape,grain", [((1, 2), "heads"),
                                         ((1, 4), "sequence"),
                                         ((2, 2), "heads")])
def test_hybrid_serves_in_both_cache_grains(shape, grain):
    cfg, model, fwd, _ = _pair("zamba2-7b")
    assert ring.mamba_heads(cfg) == 8 and cfg.n_kv_heads == 2
    mesh = _ring(*shape)
    assert ring.cache_grain(cfg, mesh) == grain
    _, cr, c1 = _serve(cfg, model, fwd, mesh, 2, 16, 32)
    assert cr.grain == grain and cr.split
    # each shard holds its heads' SSM state, and the conv state of its x
    # channels and of every B/C channel
    ssm = cfg.ssm
    hl = ring.mamba_heads(cfg) // shape[1]
    bc = 2 * ssm.n_groups * ssm.state
    local = cr.shards[0]
    assert local["ssm"].shape[3] == hl
    assert local["conv"].shape[-1] == hl * ssm.head_dim + bc
    assert local["tail_ssm"].shape[2] == hl
    _hold_cache(cr, c1, mesh)


@pytest.mark.parametrize("heads,shape", [(4, (1, 2)), (4, (1, 4)),
                                         (3, (1, 2))])
def test_ssm_serves_on_a_ring(heads, shape):
    cfg, model, fwd, _ = _pair("rwkv6-3b", RWKV_WIDTHS[heads])
    assert ring.rwkv_heads(cfg) == heads
    mesh = _ring(*shape)
    mp, cr, c1 = _serve(cfg, model, fwd, mesh, 2, 64, 64)
    assert cr.grain is None
    sh = ring._Shards(mp, 0, list(range(shape[1])), {})
    # uneven heads (3 over 2) cut at head boundaries: 2 and 1
    want = {(4, 2): [2, 2], (4, 4): [1] * 4, (3, 2): [2, 1]}[heads, shape[1]]
    assert [c["s"].shape[2] for c in cr.shards] == want
    assert sh.whole_over_model("layers.0.mix.wr") == (heads % shape[1] != 0)
    _hold_cache(cr, c1, mesh)


@pytest.mark.parametrize("arch,shape,seq_axes", [
    ("zamba2-7b", (2, 2), ("data",)),
    ("zamba2-7b", (2, 4), ("data", "model")),
    ("rwkv6-3b", (2, 2), ())])
def test_long_500k_grain_replicates_the_batch(arch, shape, seq_axes):
    cfg, model, fwd, _ = _pair(arch, RWKV_WIDTHS[4] if arch == "rwkv6-3b"
                               else None)
    mesh = _ring(*shape)
    mp, cr, c1 = _serve(cfg, model, fwd, mesh, 1, 5, 64)
    assert not cr.split and cr.seq_axes == seq_axes
    if seq_axes:
        spec = SH.cache_pspecs_for_batch(cfg, 1, mesh)["kv"]["k"]
        assert cr.spec == spec and spec[1] is None
        t_local = cr.shards[0]["k"].shape[2]
        assert t_local == 64 // (2 if shape == (2, 2) else 8) > 5
    _hold_cache(cr, c1, mesh)
    # every data row runs the replicated token: their logits agree
    nxt = torch.tensor([[7]])
    rows, _ = ring.decode(mp, cr, {"tokens": nxt,
                                   "position": torch.tensor([5 + STEPS])},
                          per_row=True)
    assert len(rows) == shape[0]
    for r in rows[1:]:
        assert torch.equal(r, rows[0])


def test_gated_norm_spans_every_head(monkeypatch):
    """The ring's logits equal one device's; with each shard normalising
    over its own heads alone they do not."""
    cfg, model, fwd, _ = _pair("zamba2-7b")
    mesh = _ring(1, 2)
    mp = ring.shard_params(model, mesh, tp=True)
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 16)))
    want, _ = S.build_prefill_step(make_host_mesh("cpu"))(
        model, {"tokens": tokens})
    got, _ = S.build_prefill_step(mesh)(mp, {"tokens": tokens})
    _close(got, want, "the ring")
    monkeypatch.setattr(ring, "_mean_square", lambda sh, ys, width: [
        (y * y).mean(-1, keepdim=True) for y in ys])
    own, _ = S.build_prefill_step(mesh)(mp, {"tokens": tokens})
    scale = float(want.abs().max())
    assert float((own - want).abs().max()) > 100 * TOL * scale


@pytest.mark.parametrize("arch,heads", [("zamba2-7b", None),
                                        ("rwkv6-3b", 4), ("rwkv6-3b", 3)])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("sp", (True, False))
def test_tp_grain_trains(arch, heads, shape, sp):
    cfg, model, _, jgrads = _pair(arch, RWKV_WIDTHS.get(heads),
                                  trainable=True)
    mesh = _ring(*shape)
    rng = np.random.default_rng(11)
    # rwkv6 at 64 tokens: its chunked time mix (a scan below that)
    seq = 64 if arch == "rwkv6-3b" else 32
    batch = {k: rng.integers(0, cfg.vocab, (4, seq), dtype=np.int32)
             for k in ("tokens", "labels")}
    opt_cfg = O.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    plan = S.StepPlan(n_microbatches=1, tp=True, seq_shard_activations=sp,
                      skip_update=True)
    state = ring.init_state(model, mesh, tp=True)
    step, hooks = S.build_train_step(cfg, mesh, opt_cfg, plan)
    with ctx.activation_sharding(hooks):
        _, gm = step(state, batch)
    got = ring.gather_grads(state.params, gm["grads"])
    one, _ = S.build_train_step(
        cfg, make_host_mesh("cpu"), opt_cfg,
        S.StepPlan(n_microbatches=1, skip_update=True), model)
    _, om = one(S.init_train_state(model), batch)
    jl, jg = jgrads({k: jax.numpy.asarray(v) for k, v in batch.items()})
    for want in (float(om["loss"]), float(jl)):
        np.testing.assert_allclose(float(gm["loss"]), want, rtol=TOL)
    # the gradients against the reference's: the one-device port's own
    # differ from it by up to 0.95e-4 of max |g| on rwkv6's u (the bonus
    # term's sum over every token), the ring's by less
    for n in om["grads"]:
        want = _ref_leaf(jg, n)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got[n].numpy() - want).max()) <= TOL * scale, n
    # a full step keeps the replicated leaves' copies equal
    step, hooks = S.build_train_step(
        cfg, mesh, opt_cfg, dataclasses.replace(plan, skip_update=False))
    with ctx.activation_sharding(hooks):
        _, m = step(state, batch)
    assert np.isfinite(float(m["grad_norm"]))
    assert ring.replica_mismatches(state) == []


@pytest.mark.parametrize("arch,shape,bsz", [("zamba2-7b", (2, 2), 2),
                                            ("zamba2-7b", (2, 4), 1),
                                            ("rwkv6-3b", (1, 4), 2)])
def test_shard_and_gather_cache_round_trip(arch, shape, bsz):
    cfg = treg.reduced(treg.get_config(arch))
    if arch == "rwkv6-3b":
        cfg = dataclasses.replace(cfg, d_model=256)
    model = T.init_params(cfg, device="cpu")
    gen = torch.Generator().manual_seed(4)
    tree = model.init_cache(bsz, 32)
    for _, leaf in SH._flat_items(tree):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    mesh = _ring(*shape)
    mp = ring.shard_params(model, mesh, tp=True)
    cache = ring.shard_cache(mp, tree)
    back = dict(SH._flat_items(ring.gather_cache(cache, mesh, "cpu")))
    for path, leaf in SH._flat_items(tree):
        assert torch.equal(back[path], leaf), path
    zero = ring.init_cache(mp, bsz, 32)
    for a, b in zip(zero.shards, cache.shards):
        assert {k: v.shape for k, v in a.items()} == \
            {k: v.shape for k, v in b.items()}


def test_sanitize_drops_model_where_it_does_not_divide():
    cfg = treg.get_config("rwkv6-3b")
    mesh = make_mesh_for(1, 16, devices=("meta",) * 16)
    shapes = SH.cache_shapes(cfg, 2, 1)
    leaves = {k: {n: torch.empty(s, device="meta") for n, s in v.items()}
              for k, v in shapes.items()}
    specs = SH.sanitize_pspecs(SH.cache_pspecs_for_batch(cfg, 2, mesh),
                               leaves, mesh)
    # 40 heads over 16: the state is left whole by the spec (the ring
    # holds each shard's uneven heads)
    assert specs["rwkv"]["s"] == (None, "data", None, None, None)
    u = torch.empty(40, 64, device="meta")
    assert SH.param_pspecs(cfg, {"u": u}, mesh)["u"] == (None, None)
    zamba = treg.get_config("zamba2-7b")
    w = {"in_proj": torch.empty(3584, 14576, device="meta"),
         "conv_w": torch.empty(4, 7296, device="meta")}
    mesh32 = make_mesh_for(1, 32, devices=("meta",) * 32)
    # 14576 columns divide over 16 shards, not over 32
    assert SH.param_pspecs(zamba, w, mesh)["in_proj"] == ("data", "model")
    assert SH.param_pspecs(zamba, w, mesh32)["in_proj"] == ("data", None)
