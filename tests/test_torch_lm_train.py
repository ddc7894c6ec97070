"""The port's LM training path on the CPU held against the JAX reference.

* ``transformer.lm_loss`` and the gradient of every parameter against
  ``jax.value_and_grad(repro.models.transformer.lm_loss)`` for one reduced
  config per family (dense, moe, vlm, audio, hybrid, ssm), f32, the
  reference's seeded weights carried across by
  ``convert.lm_params_from_numpy``: loss within 1e-4, each gradient leaf
  within 1e-4 of its max |g| (``tests/test_kernels.py:41``'s f32
  tolerance).
* Per-layer activation checkpointing (``remat_policy="nothing_saveable"``)
  gives the gradients of the uncheckpointed model.
* The two kernels' autograd Functions: ``FlashAttention``'s backward (the
  backward kernels' plain version on the CPU) against autograd of the
  kernel's plain version and against ``jax.vjp`` of the reference's
  ``layers.flash_attention``; ``CausalConv1d``'s against autograd of its
  plain version and ``jax.vjp`` of ``kernels.ref.causal_conv1d_ref``; both
  within 1e-4 (f32), each backward counted.
* One ``train.step.build_train_step`` step against the reference's on its
  1x1 host mesh (1 and 2 microbatches), the reference's parameters taken
  to numpy before it steps.  The reference's step runs without its
  activation-sharding hooks, which are the identity on a 1x1 mesh (JAX
  versions whose ``make_mesh`` gives Explicit axes reject the hooks'
  constraints, which is what fails ``tests/test_train_substrate.py``'s
  step tests).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.kernels import ref as jref
from repro.launch.mesh import make_host_mesh as j_host_mesh
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.parallel import ctx as jctx
from repro.train import optimizer as JO
from repro.train import step as JS

from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.causal_conv1d import (CausalConv1d,
                                               causal_conv1d_plain)
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_bshd,
                                                 flash_attention_chunked)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS

TOL = 1e-4
FAMILY_ARCHS = {"dense": "qwen2.5-3b", "moe": "grok-1-314b",
                "vlm": "llava-next-mistral-7b", "audio": "musicgen-large",
                "hybrid": "zamba2-7b", "ssm": "rwkv6-3b"}


def _setup(arch, seed=0):
    jcfg = jreg.reduced(jreg.get_config(arch))
    tcfg = treg.reduced(treg.get_config(arch))
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, params)
    model = lm_params_from_numpy(tcfg, np_params, device="cpu",
                                 trainable=True)
    return jcfg, tcfg, params, np_params, model


def _batch(cfg, b, s, seed):
    """(reference batch, port batch) from numpy."""
    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)}
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    else:
        out["embeds"] = rng.standard_normal((b, s, cfg.d_model)) \
            .astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            TS.to_device(out, "cpu"))


def _ref_leaf(tree, name):
    """The reference leaf of port parameter ``name`` (its stacked layer
    axes indexed)."""
    parts = name.split(".")
    top, idx = parts[0], ()
    if top in ("layers", "groups", "tail"):
        n = 2 if top == "groups" else 1
        idx = tuple(int(p) for p in parts[1:1 + n])
        parts = [{"groups": "layers", "tail": "tail_layers"}.get(top, top)] \
            + parts[1 + n:]
    elif top == "shared":
        parts = ["shared_attn"] + parts[1:]
    node = tree
    for p in parts:
        node = node[p]
    return np.asarray(node)[idx]


def _grads_close(tag, named, ref_tree, tol=TOL):
    worst = 0.0
    for name, g in named.items():
        want = _ref_leaf(ref_tree, name)
        got = g.detach().float().numpy()
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max()) / scale
        worst = max(worst, err)
        assert err <= tol, f"{tag} {name}: {err:.3e} of max |g| {scale:.3e}"
    print(f"{tag}: {len(named)} leaves, worst {worst:.3e} of max |g|")


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_lm_loss_and_grads_match_reference(family):
    jcfg, tcfg, params, _, model = _setup(FAMILY_ARCHS[family])
    jb, tb = _batch(jcfg, 2, 64, 1)
    (jloss, jstats), jgrads = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jb), has_aux=True)(params)
    loss, stats = TT.lm_loss(model, tb)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    loss = loss.detach()
    print(f"{family} loss {float(loss):.6f} ref {float(jloss):.6f}")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(stats["moe_aux"].detach()),
                               float(jstats["moe_aux"]), rtol=TOL, atol=TOL)
    # every reference parameter has its port counterpart
    assert sum(p.numel() for p in model.parameters()) == \
        sum(leaf.size for leaf in jax.tree.leaves(params))
    _grads_close(family, dict(zip(names, grads)),
                 jax.tree.map(np.asarray, jgrads))


@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_checkpointed_layers_give_the_same_gradients(family):
    """``remat_policy="nothing_saveable"`` (every full-width config's)
    recomputes each layer in the backward: same loss and gradients."""
    _, tcfg, _, np_params, model = _setup(FAMILY_ARCHS[family])
    remat = lm_params_from_numpy(
        dataclasses.replace(tcfg, remat_policy="nothing_saveable"),
        np_params, device="cpu", trainable=True)
    _, tb = _batch(tcfg, 2, 64, 2)
    out = []
    for m in (model, remat):
        loss, _ = TT.lm_loss(m, tb)
        out.append((loss, torch.autograd.grad(loss, list(m.parameters()))))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_remat_policy_without_counterpart_raises():
    cfg = dataclasses.replace(treg.reduced(treg.get_config("qwen2.5-3b")),
                              remat_policy="dots_saveable")
    model = TT.init_params(cfg, device="cpu", trainable=True)
    with pytest.raises(ValueError, match="remat_policy"):
        model(tokens=torch.zeros(1, 8, dtype=torch.long))


# --------------------------------------------------------------------------
# the kernels' autograd Functions
# --------------------------------------------------------------------------
FLASH_CASES = [  # (B, S, Hq, Hkv, D, q_chunk, kv_chunk, causal)
    (2, 64, 4, 2, 32, 16, 32, True), (2, 64, 4, 2, 32, 16, 32, False),
    (1, 48, 2, 2, 16, 16, 16, True), (2, 32, 8, 1, 64, 0, 0, True),
    (1, 64, 4, 4, 16, 64, 16, True)]


def _qkv(b, s, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv)] + \
        [rng.standard_normal((b, s, hq, d)).astype(np.float32)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_matches_plain_and_reference(case):
    b, s, hq, hkv, d, qc, kc, causal = case
    q, k, v, dout = _qkv(b, s, hq, hkv, d, sum(case[:5]))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    before = FlashAttention.backward_calls
    out = FlashAttention.apply(tq, tk, tv, causal, qc, kc)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    assert FlashAttention.backward_calls == before + 1
    # autograd of the kernel's plain version (a full softmax)
    pq, pk, pv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    plain = flash_attention_bshd(pq, pk, pv, causal=causal)
    want = torch.autograd.grad(plain, (pq, pk, pv), torch.from_numpy(dout))
    torch.testing.assert_close(out, plain, rtol=2e-4, atol=2e-4)
    # the reference's chunked attention, differentiated by JAX
    jout, vjp = jax.vjp(lambda a, b_, c: JL.flash_attention(
        a, b_, c, causal=causal, q_chunk=qc, kv_chunk=kc), q, k, v)
    jgrads = vjp(jnp.asarray(dout))
    chunked = flash_attention_chunked(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal,
                                      q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    for name, g, p, j in zip("qkv", grads, want, jgrads):
        err = (g - p).abs().max().item()
        print(f"{case} d{name}: vs plain {err:.3e}")
        torch.testing.assert_close(g, p, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)


def test_flash_chunks_must_divide():
    q = torch.zeros(1, 24, 2, 16, requires_grad=True)
    with pytest.raises(ValueError, match="not divisible"):
        FlashAttention.apply(q, q, q, True, 16, 16)


@pytest.mark.parametrize("shape", [(2, 32, 16, 4), (1, 7, 5, 3),
                                   (3, 20, 8, 2), (2, 3, 6, 4)])
def test_causal_conv1d_backward_matches_plain_and_reference(shape):
    b, l, d, kw = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    w = rng.standard_normal((kw, d)).astype(np.float32)
    dy = rng.standard_normal((b, l, d)).astype(np.float32)
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    before = CausalConv1d.backward_calls
    y = CausalConv1d.apply(tx, tw)
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(dy))
    assert CausalConv1d.backward_calls == before + 1
    px, pw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    want = torch.autograd.grad(causal_conv1d_plain(px, pw), (px, pw),
                               torch.from_numpy(dy))
    _, vjp = jax.vjp(jref.causal_conv1d_ref, x, w)
    jdx, jdw = vjp(jnp.asarray(dy))
    for g, p, j in zip((dx, dw), want, (jdx, jdw)):
        torch.testing.assert_close(g, p, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)


def test_model_paths_go_through_the_functions():
    """The hybrid's training backward runs both Functions' backward."""
    _, tcfg, _, _, model = _setup("zamba2-7b")
    _, tb = _batch(tcfg, 2, 32, 3)
    f0, c0 = FlashAttention.backward_calls, CausalConv1d.backward_calls
    loss, _ = TT.lm_loss(model, tb)
    loss.backward()
    n_groups, tail = TT.layer_counts(tcfg)
    assert FlashAttention.backward_calls - f0 == n_groups
    assert CausalConv1d.backward_calls - c0 == tcfg.n_layers
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


def test_serving_records_no_graph():
    """Serving keeps frozen parameters: no output carries a graph."""
    _, tcfg, _, np_params, _ = _setup("zamba2-7b")
    model = lm_params_from_numpy(tcfg, np_params, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    logits, cache = model.prefill(tokens=torch.zeros(1, 16,
                                                     dtype=torch.long))
    assert logits.grad_fn is None
    assert all(t.grad_fn is None for leaves in cache.values()
               for t in leaves.values())


# --------------------------------------------------------------------------
# one train step against the reference's
# --------------------------------------------------------------------------
def _ref_grads(cfg, params, batch, n_mb):
    """The reference step's gradient (the mean over its microbatches)."""
    def grad(mb):
        return jax.jit(jax.grad(lambda p: JS.loss_fn(p, cfg, mb)[0]))(params)
    split = [{k: v.reshape(n_mb, -1, *v.shape[1:])[i]
              for k, v in batch.items()} for i in range(n_mb)]
    gs = [grad(mb) for mb in split]
    return jax.tree.map(lambda *g: sum(g) / n_mb, *gs)


def assert_updated_close(name, got, want, grad, lr):
    """Parameters after one AdamW step: within 1e-4 wherever the reference
    gradient exceeds 1e-4 of the leaf's max |g| (there the gradient check
    fixes its sign); elsewhere within 2 lr, since Adam's first step moves
    each element by about lr * sign(g) and a gradient within rounding of 0
    may take either sign."""
    firm = np.abs(grad) > TOL * max(float(np.abs(grad).max()), 1e-30)
    err = np.abs(got - want)
    assert float(err[firm].max(initial=0.0)) <= TOL, name
    assert float(err.max()) <= 2 * lr + TOL, name


@pytest.mark.parametrize("arch,n_mb", [("qwen3-14b", 1), ("qwen3-14b", 2),
                                       ("rwkv6-3b", 2), ("zamba2-7b", 1)])
def test_train_step_matches_reference(arch, n_mb):
    jcfg, tcfg, params, _, model = _setup(arch)
    opt_kw = dict(lr=1e-3, warmup_steps=2, total_steps=50)
    jb, tb = _batch(jcfg, 4, 32, 4)
    jstep, _ = JS.build_train_step(jcfg, j_host_mesh(),
                                   JO.AdamWConfig(**opt_kw),
                                   JS.StepPlan(n_microbatches=n_mb))
    jstate = JS.TrainState(params, JO.init_opt_state(params))
    with jctx.activation_sharding({}):
        jnew, jm = jax.jit(jstep)(jstate, jb)
    step, _ = TS.build_train_step(tcfg, make_host_mesh("cpu"),
                                  TO.AdamWConfig(**opt_kw),
                                  TS.StepPlan(n_microbatches=n_mb), model)
    state = TS.init_train_state(model)
    new, m = step(state, tb)
    assert new is state and new.params["embed"] is model.embed
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)
    ref = jax.tree.map(np.asarray, jnew.params)
    ref_g = jax.tree.map(np.asarray, _ref_grads(jcfg, params, jb, n_mb))
    for name, p in new.params.items():
        assert_updated_close(name, p.detach().numpy(), _ref_leaf(ref, name),
                             _ref_leaf(ref_g, name), float(jm["lr"]))
    assert int(new.opt.step) == int(jnew.opt.step) == 1
    # the first moments after one step: (1 - b1) times the clipped gradient
    ref_m = jax.tree.map(np.asarray, jnew.opt.m)
    for name, t in new.opt.m.items():
        want = _ref_leaf(ref_m, name)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(t.numpy() - want).max()) <= TOL * scale, name


def test_skip_update_returns_grads_and_leaves_state():
    _, tcfg, _, _, model = _setup("qwen2.5-3b")
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    step, _ = TS.build_train_step(tcfg, make_host_mesh("cpu"),
                                  TO.AdamWConfig(),
                                  TS.StepPlan(n_microbatches=2,
                                              skip_update=True), model)
    state = TS.init_train_state(model)
    _, tb = _batch(tcfg, 4, 16, 5)
    _, m = step(state, tb)
    assert set(m) == {"loss", "grads"}
    assert set(m["grads"]) == set(before)
    assert all(m["grads"][k].dtype == torch.float32 for k in before)
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k])
    assert int(state.opt.step) == 0


def test_state_must_be_the_models_parameters():
    _, tcfg, _, np_params, model = _setup("qwen2.5-3b")
    other = lm_params_from_numpy(tcfg, np_params, device="cpu",
                                 trainable=True)
    step, _ = TS.build_train_step(tcfg, make_host_mesh("cpu"),
                                  TO.AdamWConfig(), TS.StepPlan(), model)
    _, tb = _batch(tcfg, 2, 16, 6)
    with pytest.raises(ValueError, match="own parameters"):
        step(TS.init_train_state(other), tb)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 5, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 5), dtype=np.int32)
    want = JS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = TS.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


# -- Mamba2's decay at a chunk of 256 ----------------------------------------
def test_segsum_decay_backward_is_finite_past_f32_range():
    """``_segsum_decay`` over a chunk of 256 whose decay sums to ~190:
    the masked entries' exponent (up to +190) overflows f32, and the
    gradient must still be finite and equal the f64 gradient of the
    where-after-exp form (which does not overflow in f64); the values
    equal that form's in f32 bit for bit."""
    from repro_torch.models.mamba2 import _segsum_decay

    a = -torch.as_tensor(np.random.default_rng(3).uniform(0, 1.5, (2, 256)),
                         dtype=torch.float32)
    w = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (2, 256, 256)), dtype=torch.float32)

    def where_form(x):
        cum = torch.cumsum(x, -1)
        seg = cum[..., :, None] - cum[..., None, :]
        mask = torch.ones(256, 256, dtype=torch.bool).tril()
        return torch.where(mask, torch.exp(seg), 0.0)

    leaf = a.clone().requires_grad_(True)
    out = _segsum_decay(leaf)
    (got,) = torch.autograd.grad((out * w).sum(), leaf)
    with torch.no_grad():
        assert torch.equal(out, where_form(a))
    leaf64 = a.double().requires_grad_(True)
    (want,) = torch.autograd.grad((where_form(leaf64) * w.double()).sum(),
                                  leaf64)
    assert float(-a.sum(-1).min()) > 88             # exp(88) overflows f32
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    err = float((got.double() - want).abs().max() / want.abs().max())
    assert err <= TOL, err


def test_hybrid_grads_finite_at_chunk_256():
    """Reduced zamba2-7b with its SSD chunk at the full config's 256 and
    512 tokens: the reference's gradients overflow to nan in the masked
    decay entries (``repro.models.mamba2._segsum_decay`` masks after
    ``exp``); the port's are finite, and equal the reference's within
    1e-4 of max |g| on every leaf the reference gets finite, the loss
    too."""
    jcfg = jreg.reduced(jreg.get_config("zamba2-7b"))
    jcfg = dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm,
                                                             chunk=256))
    tcfg = treg.reduced(treg.get_config("zamba2-7b"))
    tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm,
                                                             chunk=256))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu", trainable=True)
    jb, tb = _batch(jcfg, 1, 512, 5)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JT.lm_loss(p, jcfg, jb), has_aux=True)(params)
    loss, _ = TT.lm_loss(model, tb)
    names = [k for k, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(
        model.parameters()))))
    assert abs(float(loss.detach()) - float(jloss)) <= TOL
    assert all(torch.isfinite(g).all() for g in grads.values())
    ref_finite = {k: g for k, g in grads.items()
                  if np.isfinite(_ref_leaf(jgrads, k)).all()}
    assert len(ref_finite) < len(grads), "the reference did not overflow"
    _grads_close("zamba2-7b chunk 256", ref_finite, jgrads)
