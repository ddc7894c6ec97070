"""The port's ssm family (``RwkvLM``, reduced rwkv6-3b: 2 layers, d_model
128 = 2 heads of 64, d_ff 256, vocab 512, f32) on the CPU held to the JAX
reference's ``transformer`` ssm branches.

The reference's seeded weights are carried across with
``convert.lm_params_from_numpy``; inputs are numpy.  Lengths 64 run the
chunked time-mix (a multiple of 64), 17 and 31 the scan.  Tolerances (f32):
1e-4 on logits and every cache leaf (``tests/test_kernels.py:41``'s f32
tolerance); the port's own cross-form oracle within the reference's 3e-3
(``tests/test_models.py:72``).

The cross-form oracle's gap grows with depth, in the reference as in the
port, and in bf16 to the size of the logits:
``test_cross_form_gap_grows_with_depth`` holds both at 4 and 32 layers of
reduced width, and ``python tests/test_torch_models_ssm.py`` prints both
at full width, 4 and 8 layers (about 6 GB of host memory).
"""
import dataclasses
import sys

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

TOL = 1e-4
ORACLE_TOL = 3e-3
ARCH = "rwkv6-3b"


@pytest.fixture(scope="module")
def pair():
    jcfg = jreg.reduced(jreg.get_config(ARCH))
    tcfg = treg.reduced(treg.get_config(ARCH))
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return jcfg, params, tcfg, model


def _tokens(b, s, seed):
    a = np.random.default_rng(seed).integers(0, 512, (b, s), dtype=np.int32)
    return jnp.asarray(a), torch.as_tensor(a, dtype=torch.int64)


def _close(name, got, want, tol=TOL):
    got = got.detach().numpy()
    err = float(np.max(np.abs(got - np.asarray(want))))
    print(f"{name}: max abs err {err:.3e} (tol {tol})")
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=name)


def test_model_and_cache_layout(pair):
    _, params, tcfg, model = pair
    assert isinstance(model, TT.RwkvLM) and len(model.layers) == 2
    assert not any(p.requires_grad for p in model.parameters())
    cache = model.init_cache(3, 99)
    jcache = JT.init_cache(jreg.reduced(jreg.get_config(ARCH)), 3, 99)
    assert set(cache) == set(jcache) == {"rwkv"}
    for k, v in jcache["rwkv"].items():
        t = cache["rwkv"][k]
        assert tuple(t.shape) == v.shape, k
        assert t.shape[TT.BATCH_AXIS["rwkv"]] == 3
    assert cache["rwkv"]["s"].dtype == torch.float32


@pytest.mark.parametrize("s", [64, 17])
def test_forward_matches_reference(pair, s):
    jcfg, params, _, model = pair
    jt, tt = _tokens(2, s, s)
    jl, jaux = JT.forward(params, jcfg, tokens=jt)
    tl, taux = model(tokens=tt)
    assert tl.shape == (2, s, 512) and tl.dtype == torch.float32
    _close(f"forward({s}) logits", tl, jl)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("s", [64, 31])
def test_prefill_logits_and_state_match_reference(pair, s):
    jcfg, params, _, model = pair
    jt, tt = _tokens(2, s, 100 + s)
    jl, jc = JT.prefill(params, jcfg, tokens=jt)
    tl, tc = model.prefill(tokens=tt)
    _close(f"prefill({s}) logits", tl, jl)
    for k, want in jc["rwkv"].items():
        assert tuple(tc["rwkv"][k].shape) == want.shape, k
        _close(f"prefill({s}) state {k}", tc["rwkv"][k], want)


def test_decode_step_matches_reference(pair):
    """From the same prefilled state, two decode steps: logits and every
    state leaf, the port's state updated in place."""
    jcfg, params, _, model = pair
    jt, tt = _tokens(2, 19, 7)
    _, jc = JT.prefill(params, jcfg, tokens=jt[:, :17])
    tcache = {"rwkv": {k: torch.from_numpy(np.array(v))
                       for k, v in jc["rwkv"].items()}}
    for pos in (17, 18):
        jl, jc = JT.decode_step(params, jcfg, jc,
                                jnp.full((2,), pos, jnp.int32),
                                tokens=jt[:, pos:pos + 1])
        with torch.no_grad():
            tl, tnew = model.decode_step(tcache, torch.full((2,), pos),
                                         tokens=tt[:, pos:pos + 1])
        assert tnew is tcache and tl.shape == (2, 1, 512)
        _close(f"decode({pos}) logits", tl, jl)
        for k, want in jc["rwkv"].items():
            _close(f"decode({pos}) state {k}", tcache["rwkv"][k], want)


@pytest.mark.parametrize("s", [16, 65])
def test_port_decode_matches_forward(pair, s):
    """prefill(S-1) + decode(1) == forward(S) at the last position, in the
    port (the reference's cross-form oracle, tests/test_models.py:47);
    S = 65 prefills 64 tokens through the chunked form."""
    _, _, _, model = pair
    _, tt = _tokens(2, s, 200 + s)
    with torch.no_grad():
        full, _ = model(tokens=tt)
        _, cache = model.prefill(tokens=tt[:, :-1])
        dec, _ = model.decode_step(cache, torch.full((2,), s - 1),
                                   tokens=tt[:, -1:])
    _close(f"decode vs forward({s})", dec[:, 0], full[:, -1].numpy(),
           ORACLE_TOL)


def test_chunked_forward_matches_scan_forward(pair):
    """Forward at 64 tokens (chunked) against the same 64 tokens as 63 +
    1 (scan then one decode step)."""
    _, _, _, model = pair
    _, tt = _tokens(1, 64, 5)
    with torch.no_grad():
        full, _ = model(tokens=tt)
        part, _ = model(tokens=tt[:, :63])
    _close("chunked vs scan forward", full[:, :63], part.numpy(), 1e-4)


def test_bf16_model_is_finite():
    cfg = dataclasses.replace(treg.reduced(treg.get_config(ARCH)),
                              dtype="bfloat16")
    model = TT.init_params(cfg, seed=3, device="cpu")
    assert model.layers[0].mix["wr"].dtype == torch.bfloat16
    with torch.no_grad():
        logits, cache = model.prefill(tokens=torch.arange(64)[None] % 512)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert cache["rwkv"]["tm_x"].dtype == torch.bfloat16
    assert cache["rwkv"]["s"].dtype == torch.float32


def test_prefill_len_for_ssm():
    """The engine prefills the longest multiple of 64 (the chunked form)
    and decodes the rest; ``prefill`` itself takes any length."""
    cfg = treg.get_config(ARCH)
    assert [TT.prefill_len(cfg, n) for n in (0, 1, 63, 64, 65, 599, 600)] \
        == [0, 0, 0, 64, 64, 576, 576]
    assert all(TT.prefill_accepts(cfg, n) for n in (1, 17, 599))
    assert not TT.prefill_accepts(cfg, 0)


# -- the cross-form gap by depth ---------------------------------------------
def _gap(want, got) -> float:
    """max |got - want| / max |want| over f32 copies."""
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def ref_cross_form_gap(jcfg, params, toks: np.ndarray) -> float:
    """The reference's prefill(S-1) + decode_step against forward(S) at the
    last position, relative to max |logit|."""
    s = toks.shape[1]
    jt = jnp.asarray(toks)
    full, _ = JT.forward(params, jcfg, tokens=jt)
    _, cache = JT.prefill(params, jcfg, tokens=jt[:, :-1])
    dec, _ = JT.decode_step(params, jcfg, cache,
                            jnp.full((toks.shape[0],), s - 1, jnp.int32),
                            tokens=jt[:, -1:])
    return _gap(full[:, -1].astype(jnp.float32), dec[:, 0].astype(jnp.float32))


def port_cross_form_gap(model, toks: np.ndarray) -> float:
    """The same oracle in the port."""
    s = toks.shape[1]
    tt = torch.as_tensor(toks, dtype=torch.int64)
    with torch.no_grad():
        full, _ = model(tokens=tt)
        _, cache = model.prefill(tokens=tt[:, :-1])
        dec, _ = model.decode_step(cache, torch.full((toks.shape[0],), s - 1),
                                   tokens=tt[:, -1:])
    return _gap(full[:, -1].float().numpy(), dec[:, 0].float().numpy())


def cross_form_gaps(jcfg, params, model, depths, toks) -> dict:
    """``{depth: (reference gap, port gap)}`` over the first ``depth``
    layers of ``params`` (stacked) and ``model``."""
    out, layers = {}, model.layers
    try:
        for n in depths:
            jp = dict(params, layers=jax.tree.map(lambda a: a[:n],
                                                  params["layers"]))
            model.layers = torch.nn.ModuleList(layers[:n])
            out[n] = (ref_cross_form_gap(dataclasses.replace(jcfg,
                                                             n_layers=n),
                                         jp, toks),
                      port_cross_form_gap(model, toks))
    finally:
        model.layers = layers
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_form_gap_grows_with_depth(dtype):
    """Reduced rwkv6-3b deepened to 32 layers, the reference's weights in
    both: the oracle's gap grows with depth in both packages alike.  In
    f32 it stays within the reference's 3e-3; in bf16 it grows more than
    tenfold from 4 to 32 layers in both (on the CPU: 3.7e-3 to 0.30 in the
    reference, 6.3e-3 to 0.27 in the port), and the port's stays within
    4x of the reference's either way."""
    jcfg = dataclasses.replace(jreg.reduced(jreg.get_config(ARCH)),
                               n_layers=32, dtype=dtype)
    tcfg = dataclasses.replace(treg.reduced(treg.get_config(ARCH)),
                               n_layers=32, dtype=dtype)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = lm_params_from_numpy(
        tcfg, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                           params), device="cpu").to(getattr(torch, dtype))
    toks = np.random.default_rng(1).integers(0, 512, (2, 128),
                                             dtype=np.int32)
    gaps = cross_form_gaps(jcfg, params, model, (4, 32), toks)
    print(f"{dtype} gaps (reference, port) by depth: {gaps}")
    if dtype == "float32":
        assert all(g <= ORACLE_TOL for pair in gaps.values() for g in pair)
        return
    for side in (0, 1):
        assert gaps[32][side] > 10 * gaps[4][side], gaps
    for ref, port in gaps.values():
        assert ref / 4 <= port <= 4 * ref, gaps


if __name__ == "__main__":
    # full width (d_model 2560, d_ff 8960, vocab 65536) at 4 and 8 layers in
    # bf16, each package from its own seeded weights, 2 x 256 tokens
    depths = (4, 8) if len(sys.argv) < 2 else tuple(map(int, sys.argv[1:]))
    rng = np.random.default_rng(1)
    jcfg = dataclasses.replace(jreg.get_config(ARCH), n_layers=max(depths))
    toks = rng.integers(0, jcfg.vocab, (2, 256), dtype=np.int32)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    for n in depths:
        jp = dict(params, layers=jax.tree.map(lambda a: a[:n],
                                              params["layers"]))
        gap = ref_cross_form_gap(dataclasses.replace(jcfg, n_layers=n), jp,
                                 toks)
        print(f"reference {ARCH} bf16, {n} layers: {gap:.3e}", flush=True)
    del params, jp
    model = TT.init_params(dataclasses.replace(treg.get_config(ARCH),
                                               n_layers=max(depths)),
                           seed=0, device="cpu")
    layers = model.layers
    for n in depths:
        model.layers = torch.nn.ModuleList(layers[:n])
        print(f"port {ARCH} bf16, {n} layers: "
              f"{port_cross_form_gap(model, toks):.3e}", flush=True)
