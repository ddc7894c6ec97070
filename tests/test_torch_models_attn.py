"""The port's attention-block LMs (``AttnLM``: dense, moe, vlm, audio) on
the CPU held against the JAX reference.

Configs: ``reduced(get_config(arch))`` for qwen2.5-3b (QKV bias, tied
head), qwen3-14b (qk-norm), llava-next-mistral-7b (embeds in), musicgen-large
(embeds in, LayerNorm, GELU, sinusoidal positions, full MHA), arctic-480b
(8 experts top-2 plus the dense residual MLP) and grok-1-314b (8 experts
top-2): 2 layers, d_model 128, 4 heads over <= 2 kv heads, f32.  The
reference's seeded weights are carried into the port with
``convert.lm_params_from_numpy``; inputs are made with numpy.  The reduced
MoE configs are drop-free (``capacity_factor = E / k``), so one case sets
1.25 to hold the port to the reference's drops.

Tolerances (f32): 1e-3 on whole-model logits, caches and aux loss, as
tests/test_torch_models.py; the port's own cross-form oracle within the
reference's 3e-3 (tests/test_models.py:72).  Each test prints the
observed max error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import transformer as JT

from repro_torch.configs import registry as treg
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import transformer as TT

MODEL_TOL = 1e-3
ORACLE_TOL = 3e-3
ARCHS = ("qwen2.5-3b", "qwen3-14b", "llava-next-mistral-7b",
         "musicgen-large", "arctic-480b", "grok-1-314b")
MOE_ARCHS = ("arctic-480b", "grok-1-314b")
_PAIRS = {}


def _pair(arch, capacity_factor=None):
    """(reference config, params, port config, port model), cached."""
    key = (arch, capacity_factor)
    if key not in _PAIRS:
        jcfg = jreg.reduced(jreg.get_config(arch))
        tcfg = treg.reduced(treg.get_config(arch))
        if capacity_factor is not None:
            jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
                jcfg.moe, capacity_factor=capacity_factor))
            tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
                tcfg.moe, capacity_factor=capacity_factor))
        params = JT.init_params(jcfg, jax.random.PRNGKey(0))
        model = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                     device="cpu")
        _PAIRS[key] = (jcfg, params, tcfg, model)
    return _PAIRS[key]


def _inputs(cfg, b, s, seed):
    """({"tokens"|"embeds": jax array}, {...: torch tensor}) from numpy."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        a = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
        return {"tokens": jnp.asarray(a)}, \
            {"tokens": torch.as_tensor(a, dtype=torch.int64)}
    a = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return {"embeds": jnp.asarray(a)}, {"embeds": torch.from_numpy(a)}


def _cut(inp, lo, hi):
    return {k: v[:, lo:hi] for k, v in inp.items()}


def _close(name, got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    print(f"{name}: max abs err {err:.3e} (tol {tol})")
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=name)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# --------------------------------------------------------------------------
# parity with repro.models.transformer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, params, _, model = _pair(arch)
    jin, tin = _inputs(jcfg, 2, 32, 0)
    jl, jaux = JT.forward(params, jcfg, **jin)
    tl, taux = model(**tin)
    assert isinstance(model, TT.AttnLM)
    assert tl.shape == (2, 32, jcfg.vocab) and tl.dtype == torch.float32
    _close(f"{arch} forward logits", tl, jl, MODEL_TOL)
    _close(f"{arch} aux loss", taux, jaux, MODEL_TOL)
    assert (float(taux) > 0) == (arch in MOE_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(arch):
    jcfg, params, tcfg, model = _pair(arch)
    jin, tin = _inputs(jcfg, 2, 32, 1)
    jl, jc = JT.prefill(params, jcfg, **jin)
    tl, tc = model.prefill(**tin)
    _close(f"{arch} prefill logits", tl, jl, MODEL_TOL)
    jleaves, tleaves = dict(_leaves(jc)), dict(_leaves(tc))
    assert jleaves.keys() == tleaves.keys() == {"/kv/k", "/kv/v"}
    for name, want in jleaves.items():
        assert tuple(tleaves[name].shape) == want.shape == \
            (tcfg.n_layers, 2, 32, tcfg.n_kv_heads, tcfg.d_head), name
        _close(f"{arch} prefill cache {name}", tleaves[name], want, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch):
    """From the same prefilled cache, one decode step: logits and every
    cache leaf (for musicgen the sinusoidal position enters at 16)."""
    jcfg, params, _, model = _pair(arch)
    jin, tin = _inputs(jcfg, 2, 17, 2)
    _, jc = JT.prefill(params, jcfg, **_cut(jin, 0, 16))
    jc = {"kv": jax.tree.map(
        lambda t: jnp.pad(t, ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0))),
        jc["kv"])}
    pos = np.full((2,), 16, np.int32)
    jl, jnew = JT.decode_step(params, jcfg, jc, jnp.asarray(pos),
                              **_cut(jin, 16, 17))
    tcache = {"kv": {k: torch.from_numpy(np.array(v))
                     for k, v in jc["kv"].items()}}
    tl, tnew = model.decode_step(tcache, torch.as_tensor(pos,
                                                         dtype=torch.int64),
                                 **_cut(tin, 16, 17))
    assert tnew is tcache
    assert tl.shape == (2, 1, jcfg.vocab)
    _close(f"{arch} decode logits", tl, jl, MODEL_TOL)
    for name, want in _leaves(jax.tree.map(np.asarray, jnew)):
        _close(f"{arch} decode cache {name}", dict(_leaves(tnew))[name], want,
               MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_decode_matches_forward(arch):
    """prefill(S-1) + decode(1) == forward(S) at the last position, in the
    port alone (the reference's tests/test_models.py:47 oracle)."""
    _, _, tcfg, model = _pair(arch)
    b, s = 2, 16
    _, tin = _inputs(tcfg, b, s, 3)
    full, _ = model(**tin)
    _, cache = model.prefill(**_cut(tin, 0, s - 1))
    cache["kv"] = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1))
                   for k, v in cache["kv"].items()}
    dec, _ = model.decode_step(cache, torch.full((b,), s - 1),
                               **_cut(tin, s - 1, s))
    _close(f"{arch} decode vs forward", dec[:, 0], full[:, s - 1].numpy(),
           ORACLE_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_with_drops_matches_reference(arch):
    """At capacity factor 1.25 the MoE drops tokens: ``forward``'s logits
    and aux loss still match the reference's (the same tokens dropped),
    and differ from the drop-free ones; ``capacity_factor=E/k`` restores
    the drop-free result."""
    jcfg, params, tcfg, model = _pair(arch, capacity_factor=1.25)
    jin, tin = _inputs(jcfg, 2, 32, 4)
    jl, jaux = JT.forward(params, jcfg, **jin)
    tl, taux = model(**tin)
    _close(f"{arch} forward logits at cf 1.25", tl, jl, MODEL_TOL)
    _close(f"{arch} aux loss at cf 1.25", taux, jaux, MODEL_TOL)
    free_cf = tcfg.moe.n_experts / tcfg.moe.top_k
    free, _ = model(**tin, capacity_factor=free_cf)
    assert float((free - tl).abs().max()) > 1e-3       # tokens were dropped
    jfree, _ = JT.forward(params, dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=free_cf)),
        **jin)
    _close(f"{arch} forward logits drop-free", free, jfree, MODEL_TOL)
    pl, _ = model.prefill(**tin, capacity_factor=free_cf)
    _close(f"{arch} drop-free prefill vs forward", pl, free.numpy(), 1e-5)


# --------------------------------------------------------------------------
# init, counts, prefill lengths, families
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_is_seeded_and_shaped(arch):
    jcfg, _, tcfg, _ = _pair(arch)
    m1 = TT.init_params(tcfg, seed=3, device="cpu")
    m2 = TT.init_params(tcfg, seed=3, device="cpu")
    s1, s2 = m1.state_dict(), m2.state_dict()
    assert isinstance(m1, TT.AttnLM) and len(m1.layers) == tcfg.n_layers
    assert s1.keys() == s2.keys()
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert not any(t.requires_grad for t in m1.parameters())
    jshapes = jax.tree.leaves(jax.eval_shape(
        lambda: JT.init_params(jcfg, jax.random.PRNGKey(0))))
    n = sum(t.numel() for t in s1.values())
    assert n == sum(int(np.prod(v.shape)) for v in jshapes)
    # param_count counts the matrices (norms, biases, qk-norm scales
    # aside) and, for the stub-fronted vlm/audio configs, a token
    # embedding they do not build
    matrices = sum(t.numel() for t in s1.values() if t.dim() >= 2)
    stub = 0 if tcfg.embed_inputs else tcfg.vocab * tcfg.d_model
    assert matrices + stub == tcfg.param_count() == jcfg.param_count()
    if tcfg.moe is not None:
        router = s1["layers.0.moe.router"]
        assert router.dtype == torch.float32
        assert router.shape == (tcfg.d_model, tcfg.moe.n_experts)
        assert s1["layers.0.moe.w_down"].shape == \
            (tcfg.moe.n_experts, tcfg.moe.d_ff_expert, tcfg.d_model)
        assert ("layers.0.dense_mlp.w_up" in s1) == \
            bool(tcfg.moe.dense_residual_ff)


def test_converted_leaves_keep_their_dtypes():
    """bf16 weights stay bf16 and the MoE router f32 across convert."""
    jcfg = dataclasses.replace(jreg.reduced(jreg.get_config("arctic-480b")),
                               dtype="bfloat16")
    tcfg = dataclasses.replace(treg.reduced(treg.get_config("arctic-480b")),
                               dtype="bfloat16")
    params = JT.init_params(jcfg, jax.random.PRNGKey(1))
    model = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    sd = model.state_dict()
    assert sd["layers.1.moe.router"].dtype == torch.float32
    assert sd["layers.1.moe.w_gate"].dtype == torch.bfloat16
    assert sd["layers.1.dense_mlp.w_gate"].dtype == torch.bfloat16
    want = np.asarray(params["layers"]["moe"]["w_up"][1], np.float32)
    np.testing.assert_array_equal(sd["layers.1.moe.w_up"].float().numpy(),
                                  want)


def test_prefill_len_is_what_prefill_accepts():
    """Without an SSM only the attention chunks constrain the length."""
    full = treg.get_config("qwen2.5-3b")              # q 512, kv 1024
    assert full.ssm is None
    assert TT.prefill_len(full, 599) == 512
    assert TT.prefill_len(full, 1100) == 1024
    assert TT.prefill_len(full, 2048) == 2048
    assert TT.prefill_len(full, 254) == 254
    small = dataclasses.replace(treg.reduced(treg.get_config("qwen3-14b")),
                                q_chunk=8, kv_chunk=16)
    m = TT.init_params(small, device="cpu")
    accepted = []
    for n in range(1, 41):
        toks = torch.zeros((1, n), dtype=torch.int64)
        try:
            m.prefill(tokens=toks)
            accepted.append(n)
        except ValueError:
            pass
    assert accepted == [n for n in range(1, 41)
                        if TT.prefill_accepts(small, n)]
    assert accepted == list(range(1, 9)) + [16, 32]
    assert TT.prefill_len(small, 31) == 16


def test_families_build_their_model():
    """Every family builds its model (ssm since the rwkv6 slice)."""
    for arch in treg.ARCH_IDS:
        cfg = treg.reduced(treg.get_config(arch))
        model = TT.init_params(cfg, device="cpu")
        want = {"hybrid": TT.HybridLM, "ssm": TT.RwkvLM}.get(cfg.family,
                                                              TT.AttnLM)
        assert type(model) is want, arch
