"""The port's rwkv6 block (``models/rwkv6.py``) on the CPU held to the JAX
reference's (``repro.models.rwkv6``).

The reference's seeded layer parameters and numpy inputs go through both.
Tolerances (f32): 1e-4 against the reference (``tests/test_kernels.py:41``'s
f32 tolerance); the chunked form against the scan form within the
reference's own 5e-4 (``tests/test_models.py:87``) and, under extreme
decay, 1e-3 (``tests/test_models.py:99``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as JR

from repro_torch.models import rwkv6 as TR

TOL = 1e-4
D, D_FF = 128, 256


@pytest.fixture(scope="module")
def layer():
    p = JR.init_rwkv6_layer(jax.random.PRNGKey(7), D, D_FF, jnp.float32)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(name, got, want, tol):
    got = got.detach().numpy()
    err = float(np.max(np.abs(got - np.asarray(want))))
    print(f"{name}: max abs err {err:.3e} (tol {tol})")
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=name)


def _inputs(b, l, seed, scale=1.0, state=True):
    x = _np((b, l, D), seed, scale)
    tail = _np((b, 1, D), seed + 1) if state else np.zeros((b, 1, D),
                                                           np.float32)
    s0 = _np((b, D // 64, 64, 64), seed + 2, 0.1) if state else \
        np.zeros((b, D // 64, 64, 64), np.float32)
    return x, tail, s0


@pytest.mark.parametrize("form", ["scan", "chunked"])
@pytest.mark.parametrize("b,l,state", [(2, 64, False), (1, 32, True),
                                       (2, 16, True)])
def test_timemix_matches_reference(layer, form, b, l, state):
    jp, tp = layer
    x, tail, s0 = _inputs(b, l, l + b, state=state)
    jf = getattr(JR, f"rwkv6_timemix_{form}")
    tf = getattr(TR, f"rwkv6_timemix_{form}")
    jy, js = jf(jp, jnp.asarray(x), jnp.asarray(tail), jnp.asarray(s0))
    ty, ts = tf(tp, *map(torch.from_numpy, (x, tail, s0)))
    assert ty.dtype == torch.float32 and ts.shape == (b, D // 64, 64, 64)
    _close(f"{form} y", ty, jy, TOL)
    _close(f"{form} state", ts, js, TOL)


def test_chunked_matches_scan(layer):
    """``tests/test_models.py:79``'s check, within the port."""
    _, tp = layer
    x, tail, s0 = _inputs(2, 128, 8, state=False)
    y1, s1 = TR.rwkv6_timemix_scan(tp, *map(torch.from_numpy, (x, tail, s0)))
    y2, s2 = TR.rwkv6_timemix_chunked(tp,
                                      *map(torch.from_numpy, (x, tail, s0)))
    _close("chunked vs scan y", y2, y1.numpy(), 5e-4)
    _close("chunked vs scan state", s2, s1.numpy(), 5e-4)


def test_chunked_stable_under_extreme_decay(layer):
    """Inputs scaled by 20 drive the data-dependent decay to extremes
    (``tests/test_models.py:87``): the chunked form stays finite and equal
    to the scan, and so does its gradient (the masked exponent goes to
    -inf before ``exp``, so no inf * 0 reaches the backward)."""
    _, tp = layer
    x, tail, s0 = _inputs(2, 128, 9, scale=20.0, state=False)
    y1, _ = TR.rwkv6_timemix_scan(tp, *map(torch.from_numpy, (x, tail, s0)))
    xt = torch.from_numpy(x).requires_grad_(True)
    params = {k: v.clone().requires_grad_(not k.startswith("cm_"))
              for k, v in tp.items()}
    y2, s2 = TR.rwkv6_timemix_chunked(params, xt, torch.from_numpy(tail),
                                      torch.from_numpy(s0))
    assert torch.isfinite(y2).all()
    _close("extreme decay chunked vs scan", y2, y1.numpy(), 1e-3)
    grads = torch.autograd.grad((y2.square().sum() + s2.sum()),
                                [xt] + [p for p in params.values()
                                        if p.requires_grad])
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0].abs().max()) > 0


def test_chunked_carries_initial_state(layer):
    """A nonzero incoming state and token-shift tail (serving resume,
    ``tests/test_models.py:99``): chunked equals scan."""
    _, tp = layer
    x, tail, s0 = _inputs(1, 64, 10)
    y1, s1 = TR.rwkv6_timemix_scan(tp, *map(torch.from_numpy, (x, tail, s0)))
    y2, s2 = TR.rwkv6_timemix_chunked(tp,
                                      *map(torch.from_numpy, (x, tail, s0)))
    _close("carried y", y2, y1.numpy(), 5e-4)
    _close("carried state", s2, s1.numpy(), 5e-4)


def test_chunked_needs_whole_chunks(layer):
    _, tp = layer
    x, tail, s0 = _inputs(1, 24, 11)
    with pytest.raises(ValueError, match="not divisible"):
        TR.rwkv6_timemix_chunked(tp, *map(torch.from_numpy, (x, tail, s0)))


@pytest.mark.parametrize("l", [1, 16, 33])
def test_channelmix_matches_reference(layer, l):
    jp, tp = layer
    x, tail, _ = _inputs(2, l, 20 + l)
    jy = JR.rwkv6_channelmix(jp, jnp.asarray(x), jnp.asarray(tail))
    ty = TR.rwkv6_channelmix(tp, torch.from_numpy(x), torch.from_numpy(tail))
    _close("channelmix", ty, jy, TOL)


def test_init_and_state_shapes_match_reference(layer):
    jp, _ = layer
    gen = torch.Generator().manual_seed(0)
    tp = TR.init_rwkv6_layer(gen, D, D_FF, torch.bfloat16, n_layers=4)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape, k
    # f32 where the reference keeps f32 whatever the model dtype
    assert tp["w0"].dtype == tp["u"].dtype == torch.float32
    assert tp["wr"].dtype == torch.bfloat16
    jst = JR.rwkv6_init_state(3, D, jnp.bfloat16)
    tst = TR.rwkv6_init_state(3, D, torch.bfloat16)
    for k, v in jst.items():
        assert tuple(tst[k].shape) == v.shape and not tst[k].any(), k
    assert tst["s"].dtype == torch.float32
    assert tst["tm_x"].dtype == torch.bfloat16
