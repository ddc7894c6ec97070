"""The port's MoE FFN (``repro_torch.models.moe``) on the CPU held against
the JAX reference (``repro.models.moe``), and the reference's own routing
contracts (tests/test_moe.py) ported.

The same numpy inputs and weights (f32) go to both packages.  Tolerance:
1e-5 on ``y``, ``lb_loss`` and ``drop_frac`` (the packages sum the router
and expert products in different orders); routing indices and the set of
dropped tokens must be equal.  Each parity test prints the observed max
error.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as JMOE

from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as MOE

hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

MOE_TOL = 1e-5


def _cfgs(e=8, k=2, cf=1.25, f=16):
    kw = dict(n_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf)
    return JMoEConfig(**kw), MoEConfig(**kw)


def _weights(d, e, f, seed):
    rng = np.random.default_rng(seed)

    def draw(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)
    return {"router": draw((d, e), d ** -0.5),
            "w_gate": draw((e, d, f), d ** -0.5),
            "w_up": draw((e, d, f), d ** -0.5),
            "w_down": draw((e, f, d), f ** -0.5)}


def _tokens(t, d, seed, zero_rows=0, shift=0.0):
    """Normal rows plus ``shift`` (a shared direction: the router then
    favours the same experts for every token, so capacity binds)."""
    x = np.random.default_rng(seed).standard_normal((t, d)).astype(np.float32)
    x += np.float32(shift)
    x[:zero_rows] = 0.0                 # uniform routing: every expert ties
    return x


def _both(w, x, jcfg, tcfg, cf=None):
    jy, jaux = JMOE.moe_ffn({k: jnp.asarray(v) for k, v in w.items()},
                            jnp.asarray(x), jcfg, capacity_factor=cf)
    ty, taux = MOE.moe_ffn({k: torch.from_numpy(v) for k, v in w.items()},
                           torch.from_numpy(x), tcfg, capacity_factor=cf)
    return (np.asarray(jy), {k: float(v) for k, v in jaux.items()},
            ty.numpy(), {k: float(v) for k, v in taux.items()})


def _dropped_rows(y):
    """Tokens all of whose slots were dropped: their output row is 0."""
    return set(np.flatnonzero(~np.any(y != 0, axis=1)).tolist())


# --------------------------------------------------------------------------
# parity with repro.models.moe
# --------------------------------------------------------------------------
def test_route_topk_matches_reference_with_ties():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    logits[:4] = 0.0                                   # all 8 experts tie
    logits[4:8, :3] = 1.5                              # three-way tie on top
    logits[8:12, 5:] = logits[8:12, :3]                # ties off the top
    for k in (1, 2, 3):
        jg, ji = JMOE.route_topk(jnp.asarray(logits), k)
        tg, ti = MOE.route_topk(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=MOE_TOL,
                                   atol=MOE_TOL)
        np.testing.assert_array_equal(ti[:4].numpy(),
                                      np.tile(np.arange(k), (4, 1)))


@pytest.mark.parametrize("cf", [4.0, 0.1, 1.25],
                         ids=["drop_free", "tiny_capacity", "cf1.25"])
def test_moe_ffn_matches_reference(cf):
    jcfg, tcfg = _cfgs(cf=cf)
    w = _weights(32, 8, 16, 1)
    x = _tokens(64, 32, 2, zero_rows=3, shift=0.5)
    jy, jaux, ty, taux = _both(w, x, jcfg, tcfg)
    err = float(np.abs(ty - jy).max())
    print(f"cf={cf}: y max abs err {err:.3e}, drop_frac {taux['drop_frac']} "
          f"(reference {jaux['drop_frac']}), lb_loss {taux['lb_loss']:.6f} "
          f"(reference {jaux['lb_loss']:.6f})")
    np.testing.assert_allclose(ty, jy, rtol=MOE_TOL, atol=MOE_TOL)
    for key in ("lb_loss", "drop_frac"):
        assert abs(taux[key] - jaux[key]) <= MOE_TOL, key
    assert _dropped_rows(ty) == _dropped_rows(jy)
    assert (taux["drop_frac"] == 0.0) == (cf == 4.0)


def test_drop_free_override_matches_reference():
    """The ``capacity_factor`` argument overrides the config's, as on
    decode (``transformer.py:393-395``)."""
    jcfg, tcfg = _cfgs(cf=0.1)
    w = _weights(32, 8, 16, 3)
    x = _tokens(24, 32, 4)
    jy, jaux, ty, taux = _both(w, x, jcfg, tcfg, cf=8 / 2)
    np.testing.assert_allclose(ty, jy, rtol=MOE_TOL, atol=MOE_TOL)
    assert taux["drop_frac"] == jaux["drop_frac"] == 0.0


@hypothesis.settings(max_examples=25, deadline=None)
@hypothesis.given(t=st.integers(1, 48), e=st.integers(2, 8),
                  k=st.integers(1, 3),
                  cf=st.sampled_from([0.05, 0.3, 0.75, 1.0, 1.25, 2.0]),
                  zero_rows=st.integers(0, 4),
                  shift=st.sampled_from([0.0, 0.5]),
                  seed=st.integers(0, 2 ** 16))
def test_same_tokens_dropped_as_reference(t, e, k, cf, zero_rows, shift,
                                          seed):
    """Over (T, E, k, capacity): the same drop fraction, the same tokens
    with every slot dropped, and the same outputs as the reference."""
    k = min(k, e)
    jcfg, tcfg = _cfgs(e=e, k=k, cf=cf, f=8)
    w = _weights(16, e, 8, seed)
    x = _tokens(t, 16, seed + 1, zero_rows=min(zero_rows, t), shift=shift)
    jy, jaux, ty, taux = _both(w, x, jcfg, tcfg)
    assert taux["drop_frac"] == pytest.approx(jaux["drop_frac"], abs=1e-7)
    assert _dropped_rows(ty) == _dropped_rows(jy)
    np.testing.assert_allclose(ty, jy, rtol=MOE_TOL, atol=MOE_TOL)


# --------------------------------------------------------------------------
# tests/test_moe.py's contracts, on the port
# --------------------------------------------------------------------------
def _setup(t=64, d=32, e=8, k=2, cf=1.25):
    _, cfg = _cfgs(e=e, k=k, cf=cf)
    gen = torch.Generator().manual_seed(0)
    p = MOE.init_moe(gen, d, cfg, torch.float32)
    x = torch.from_numpy(_tokens(t, d, 1))
    return cfg, p, x


def test_init_moe_shapes_dtypes_and_stds():
    _, cfg = _cfgs(e=4, k=2, f=64)
    gen = torch.Generator().manual_seed(0)
    p = MOE.init_moe(gen, 32, cfg, torch.bfloat16, n_layers=2)
    assert p["router"].shape == (32, 4) and p["router"].dtype == torch.float32
    assert p["w_gate"].shape == p["w_up"].shape == (4, 32, 64)
    assert p["w_down"].shape == (4, 64, 32)
    assert all(p[n].dtype == torch.bfloat16 for n in ("w_gate", "w_up",
                                                       "w_down"))
    assert float(p["w_gate"].float().abs().max()) <= 2 * 32 ** -0.5 + 1e-3
    assert float(p["w_down"].float().abs().max()) <= \
        2 * 64 ** -0.5 / 2 + 1e-3                       # / sqrt(2 * 2)


def test_route_topk_gates_normalized():
    logits = torch.from_numpy(_tokens(100, 8, 5))
    gates, idx = MOE.route_topk(logits, 2)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert bool((idx >= 0).all()) and bool((idx < 8).all())
    assert bool((gates[:, 0] >= gates[:, 1] - 1e-6).all())


def test_moe_output_shape_and_finite():
    cfg, p, x = _setup()
    y, aux = MOE.moe_ffn(p, x, cfg)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(aux["lb_loss"]) > 0


def test_no_drop_capacity_processes_every_token():
    """capacity_factor = E/k  =>  capacity == T  =>  nothing dropped."""
    cfg, p, x = _setup(cf=4.0)
    assert MOE.capacity(cfg, x.shape[0], MOE.drop_free_factor(cfg)) == \
        x.shape[0]
    _, aux = MOE.moe_ffn(p, x, cfg,
                         capacity_factor=MOE.drop_free_factor(cfg))
    assert float(aux["drop_frac"]) == 0.0


def test_tiny_capacity_drops_tokens():
    cfg, p, x = _setup(cf=0.1)
    _, aux = MOE.moe_ffn(p, x, cfg)
    assert float(aux["drop_frac"]) > 0.0


def test_moe_permutation_equivariance_no_drop():
    """With drop-free capacity, permuting tokens permutes outputs."""
    cfg, p, x = _setup()
    perm = torch.from_numpy(np.random.default_rng(2).permutation(x.shape[0]))
    cf = MOE.drop_free_factor(cfg)
    y1, _ = MOE.moe_ffn(p, x, cfg, capacity_factor=cf)
    y2, _ = MOE.moe_ffn(p, x[perm], cfg, capacity_factor=cf)
    np.testing.assert_allclose(y2.numpy(), y1[perm].numpy(), rtol=2e-4,
                               atol=2e-4)


def test_moe_matches_dense_reference():
    """Scatter-dispatch output == direct per-token expert evaluation."""
    cfg, p, x = _setup(t=32, e=4)
    y, _ = MOE.moe_ffn(p, x, cfg, capacity_factor=MOE.drop_free_factor(cfg))
    gates, idx = MOE.route_topk(x @ p["router"], cfg.top_k)
    want = torch.zeros_like(x)
    for t in range(x.shape[0]):
        for slot in range(cfg.top_k):
            e = int(idx[t, slot])
            h = torch.nn.functional.silu(x[t] @ p["w_gate"][e]) * \
                (x[t] @ p["w_up"][e])
            want[t] += gates[t, slot] * (h @ p["w_down"][e])
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=2e-3, atol=2e-3)


@hypothesis.settings(max_examples=30, deadline=None)
@hypothesis.given(st.integers(8, 128), st.integers(2, 16), st.integers(1, 2))
def test_capacity_never_exceeded(t, e, k):
    """Per expert, the kept (token, slot) pairs never exceed the capacity,
    and ``moe_ffn``'s drop fraction counts exactly the rest."""
    k = min(k, e)
    _, cfg = _cfgs(e=e, k=k, cf=1.25, f=4)
    logits = torch.from_numpy(_tokens(t, e, t * e + k))
    _, idx = MOE.route_topk(logits, k)
    cap = MOE.capacity(cfg, t)
    assert cap == max(1, int(1.25 * t * k / e))
    flat = idx.reshape(-1).numpy()
    mypos = (np.eye(e, dtype=np.int64)[flat].cumsum(0) - 1)[
        np.arange(len(flat)), flat]
    kept = mypos < cap
    assert np.bincount(flat[kept], minlength=e).max() <= cap
    # moe_ffn routes the same logits when x @ router == logits
    p = {"router": torch.eye(e), "w_gate": torch.zeros(e, e, 4),
         "w_up": torch.zeros(e, e, 4), "w_down": torch.zeros(e, 4, e)}
    _, aux = MOE.moe_ffn(p, logits, cfg)
    assert float(aux["drop_frac"]) == pytest.approx(1.0 - kept.mean(),
                                                    abs=1e-6)
