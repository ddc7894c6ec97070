"""The port's hybrid LM (zamba2) on the CPU held against the JAX reference.

Config: ``reduced(get_config("zamba2-7b"))`` — 5 layers (2 groups of 2
Mamba2 layers, each followed by the shared attention block, then 1 tail
layer), d_model 128, 4 heads over 2 kv heads (GQA 2:1), SSM chunk 16, f32.
The reference's seeded weights are carried into the port with
``convert.lm_params_from_numpy``; inputs are made with numpy.

Tolerances (f32): 1e-4 per block, 1e-3 on whole-model logits and caches
(the two packages sum in different orders; the reference's own cross-form
tolerance is 3e-3, tests/test_models.py:71).  Each test prints the
observed max error.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import layers as JL
from repro.models import mamba2 as JM2
from repro.models import transformer as JT

from repro_torch.configs import registry as treg
from repro_torch.configs.base import SSMConfig
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM2
from repro_torch.models import transformer as TT

BLOCK_TOL = 1e-4
MODEL_TOL = 1e-3
KEY = jax.random.PRNGKey(0)


def _cfgs():
    return jreg.reduced(jreg.get_config("zamba2-7b")), \
        treg.reduced(treg.get_config("zamba2-7b"))


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


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


@pytest.fixture(scope="module")
def model_pair():
    jcfg, tcfg = _cfgs()
    params = JT.init_params(jcfg, KEY)
    tree = jax.tree.map(np.asarray, params)
    model = lm_params_from_numpy(tcfg, tree, device="cpu")
    return jcfg, tcfg, params, model


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jreg.ARCH_IDS)
def test_configs_and_param_counts_match(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert jcfg.param_count() == tcfg.param_count()
    assert jcfg.active_param_count() == tcfg.active_param_count()
    assert dataclasses.asdict(jreg.reduced(jcfg)) == \
        dataclasses.asdict(treg.reduced(tcfg))
    assert jreg.reduced(jcfg).param_count() == \
        treg.reduced(tcfg).param_count()


def test_registry_aliases_and_shapes_match():
    from repro.configs.base import SHAPES as JSHAPES
    from repro_torch.configs.base import SHAPES as TSHAPES
    assert jreg.ALIASES == treg.ALIASES and jreg.ARCH_IDS == treg.ARCH_IDS
    assert JSHAPES == TSHAPES
    assert set(treg.all_configs()) == set(treg.ARCH_IDS)
    with pytest.raises(KeyError):
        treg.get_config("no-such-arch")


def test_other_families_name_their_roadmap_item():
    """Every family is ported since the ssm slice: rwkv6 builds its model,
    and only a family the port does not know raises, naming it."""
    cfg = treg.reduced(treg.get_config("rwkv6-3b"))
    assert type(TT.init_params(cfg, device="cpu")) is TT.RwkvLM
    with pytest.raises(ValueError, match="unknown family"):
        TT.init_params(dataclasses.replace(cfg, family="retnet"),
                       device="cpu")


# --------------------------------------------------------------------------
# Mamba2 blocks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_reference(groups):
    b, l, h, p, s, chunk = 2, 32, 4, 8, 6, 8
    x = _np((b, l, h, p), 1)
    dt = np.abs(_np((b, l, h), 2, 0.5)) + 0.01
    a = -np.linspace(0.5, 2.0, h).astype(np.float32)
    bm, cm = _np((b, l, groups, s), 3), _np((b, l, groups, s), 4)
    jy, js = JM2.ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)),
                             chunk=chunk)
    ty, ts = TM2.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)),
                             chunk=chunk)
    _close("ssd y", ty, jy, BLOCK_TOL)
    _close("ssd state", ts, js, BLOCK_TOL)
    with pytest.raises(ValueError):
        TM2.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)), chunk=5)


def _mamba_pair(d=64, seed=9):
    scfg = SSMConfig(state=16, head_dim=32, chunk=16)
    from repro.configs.base import SSMConfig as JSSM
    jscfg = JSSM(state=16, head_dim=32, chunk=16)
    jp = JM2.init_mamba2(jax.random.PRNGKey(seed), d, jscfg, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    return jscfg, scfg, jp, tp


@pytest.mark.parametrize("length", [2, 16, 48])
def test_mamba2_block_with_state_matches_reference(length):
    """Output and serving state (conv tail incl. the left zero pad when
    L < K-1, final SSM state)."""
    jscfg, scfg, jp, tp = _mamba_pair()
    x = _np((2, length, 64), length, 0.5)
    jy, jst = JM2.mamba2_block(jp, jnp.asarray(x), jscfg, return_state=True)
    ty, tst = TM2.mamba2_block(tp, _t(x), scfg, return_state=True)
    _close(f"mamba2_block L={length}", ty, jy, BLOCK_TOL)
    _close("conv state", tst["conv"], jst["conv"], BLOCK_TOL)
    _close("ssm state", tst["ssm"], jst["ssm"], BLOCK_TOL)
    assert TM2.mamba2_block(tp, _t(x), scfg).shape == (2, length, 64)


def test_mamba2_step_matches_reference():
    jscfg, scfg, jp, tp = _mamba_pair(seed=10)
    st = {"conv": _np((2, 3, 64 * 2 + 32), 11, 0.5),
          "ssm": _np((2, 4, 16, 32), 12, 0.1)}
    x = _np((2, 1, 64), 13, 0.5)
    jy, jst = JM2.mamba2_step(jp, jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in st.items()},
                              jscfg)
    state = {k: _t(v) for k, v in st.items()}
    ty, tst = TM2.mamba2_step(tp, _t(x), state, scfg)
    _close("mamba2_step y", ty, jy, BLOCK_TOL)
    _close("mamba2_step conv", tst["conv"], jst["conv"], BLOCK_TOL)
    _close("mamba2_step ssm", tst["ssm"], jst["ssm"], BLOCK_TOL)
    np.testing.assert_array_equal(state["ssm"].numpy(), st["ssm"])


def test_mamba2_step_chain_matches_block():
    """The port's own cross-form check (tests/test_models.py:112)."""
    _, scfg, _, tp = _mamba_pair()
    x = _t(_np((2, 32, 64), 14, 0.5))
    y_full, st = TM2.mamba2_block(tp, x, scfg, return_state=True)
    cur = TM2.mamba2_init_state(2, 64, scfg, torch.float32)
    ys = []
    for t in range(32):
        y, cur = TM2.mamba2_step(tp, x[:, t:t + 1], cur, scfg)
        ys.append(y)
    _close("step chain vs block", torch.cat(ys, 1), y_full.numpy(), 2e-3)
    _close("step chain ssm", cur["ssm"], st["ssm"].numpy(), 2e-3)


def test_attention_prefill_and_decode_match_reference():
    spec_kw = dict(d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                   rope_theta=10000.0)
    jspec, tspec = JL.AttnSpec(**spec_kw), TL.AttnSpec(**spec_kw)
    jp = JL.init_attention(jax.random.PRNGKey(3), jspec, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    x = _np((2, 16, 64), 15)
    jy, jkv = JL.attention_prefill(jp, jnp.asarray(x), jspec)
    ty, tkv = TL.attention_prefill(tp, _t(x), tspec)
    _close("attention_prefill", ty, jy, BLOCK_TOL)
    _close("prefill k", tkv["k"], jkv["k"], BLOCK_TOL)
    cache = {k: np.pad(np.asarray(v), ((0, 0), (0, 4), (0, 0), (0, 0)))
             for k, v in jkv.items()}
    pos = np.array([16, 16], np.int32)
    xd = _np((2, 1, 64), 16)
    jyd, jc = JL.attention_decode(jp, jnp.asarray(xd), jspec,
                                  {k: jnp.asarray(v) for k, v in cache.items()},
                                  jnp.asarray(pos))
    tcache = {k: _t(v) for k, v in cache.items()}
    tyd, tc = TL.attention_decode(tp, _t(xd), tspec, tcache,
                                  torch.as_tensor(pos, dtype=torch.int64))
    _close("attention_decode", tyd, jyd, BLOCK_TOL)
    _close("decode cache v", tc["v"], jc["v"], BLOCK_TOL)
    assert tc["k"] is tcache["k"]                  # written in place


# --------------------------------------------------------------------------
# whole model
# --------------------------------------------------------------------------
def test_forward_matches_reference(model_pair):
    jcfg, _, params, model = model_pair
    toks = _tokens(jcfg, 2, 32, 0)
    jl, _ = JT.forward(params, jcfg, tokens=jnp.asarray(toks))
    tl, aux = model(tokens=torch.as_tensor(toks, dtype=torch.int64))
    assert tl.shape == (2, 32, jcfg.vocab) and tl.dtype == torch.float32
    assert float(aux) == 0.0
    _close("forward logits", tl, jl, MODEL_TOL)


def test_prefill_logits_and_cache_match_reference(model_pair):
    jcfg, _, params, model = model_pair
    toks = _tokens(jcfg, 2, 32, 1)
    jl, jc = JT.prefill(params, jcfg, tokens=jnp.asarray(toks))
    tl, tc = model.prefill(tokens=torch.as_tensor(toks, dtype=torch.int64))
    _close("prefill logits", tl, jl, MODEL_TOL)
    jleaves, tleaves = dict(_leaves(jc)), dict(_leaves(tc))
    assert jleaves.keys() == tleaves.keys()
    for name, want in jleaves.items():
        assert tuple(tleaves[name].shape) == want.shape, name
        _close(f"prefill cache {name}", tleaves[name], want, MODEL_TOL)


def test_decode_step_matches_reference(model_pair):
    """From the same prefilled cache, one decode step: logits and every
    cache leaf."""
    jcfg, _, params, model = model_pair
    toks = _tokens(jcfg, 2, 17, 2)
    _, jc = JT.prefill(params, jcfg, tokens=jnp.asarray(toks[:, :16]))
    jc = dict(jc)
    jc["kv"] = jax.tree.map(
        lambda t: jnp.pad(t, ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0))),
        jc["kv"])
    pos = np.full((2,), 16, np.int32)
    jl, jnew = JT.decode_step(params, jcfg, jc, jnp.asarray(pos),
                              tokens=jnp.asarray(toks[:, 16:]))
    tcache = {name: {k: _t(v) for k, v in leaves.items()}
              for name, leaves in jax.tree.map(np.asarray, jc).items()}
    tl, tnew = model.decode_step(tcache, torch.as_tensor(pos,
                                                         dtype=torch.int64),
                                 tokens=torch.as_tensor(toks[:, 16:],
                                                        dtype=torch.int64))
    assert tnew is tcache
    _close("decode logits", tl, jl, MODEL_TOL)
    for name, want in _leaves(jax.tree.map(np.asarray, jnew)):
        _close(f"decode cache {name}", dict(_leaves(tnew))[name], want,
               MODEL_TOL)


def test_port_decode_matches_forward(model_pair):
    """prefill(S-1) + decode(1) == forward(S) at the last position, in the
    port alone (the reference's tests/test_models.py:47 oracle)."""
    _, tcfg, _, model = model_pair
    b, s = 2, 16
    toks = torch.as_tensor(_tokens(tcfg, b, s, 3), dtype=torch.int64)
    full, _ = model(tokens=toks)
    _, cache = model.prefill(tokens=toks[:, :s - 1])
    cache["kv"] = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1))
                   for k, v in cache["kv"].items()}
    dec, _ = model.decode_step(cache, torch.full((b,), s - 1),
                               tokens=toks[:, s - 1:])
    _close("decode vs forward", dec[:, 0], full[:, s - 1].numpy(), 3e-3)


def test_init_params_is_seeded_and_shaped():
    _, tcfg = _cfgs()
    m1 = TT.init_params(tcfg, seed=3, device="cpu")
    m2 = TT.init_params(tcfg, seed=3, device="cpu")
    s1, s2 = m1.state_dict(), m2.state_dict()
    assert s1.keys() == s2.keys()
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert len(m1.groups) == 2 and len(m1.groups[0]) == 2
    assert len(m1.tail) == 1
    n = sum(t.numel() for t in s1.values())
    jn = sum(int(np.prod(v.shape)) for v in jax.tree.leaves(
        jax.eval_shape(lambda: JT.init_params(_cfgs()[0], KEY))))
    assert n == jn
    w = s1["groups.0.0.mamba.in_proj"]
    assert float(w.abs().max()) <= 2.0 * tcfg.d_model ** -0.5 + 1e-6
    assert not any(t.requires_grad for t in m1.parameters())


def test_prefill_len_is_what_prefill_accepts():
    _, tcfg = _cfgs()                         # chunk 16, q 512, kv 1024
    assert [TT.prefill_len(tcfg, n) for n in (0, 1, 15, 16, 17, 40, 48)] == \
        [0, 1, 15, 16, 16, 32, 48]
    full = treg.get_config("zamba2-7b")       # chunk 256, q 512, kv 1024
    assert TT.prefill_len(full, 599) == 512
    assert TT.prefill_len(full, 1100) == 1024
    assert TT.prefill_len(full, 2048) == 2048
    assert TT.prefill_len(full, 254) == 254
