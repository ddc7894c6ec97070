"""The port's LM kernels on the CPU (their plain PyTorch versions) held
against the JAX reference's Pallas kernels in interpret mode, and against
the reference's oracles.

Same numpy operands go to both packages.  Tolerances:
  * causal_conv1d, f32: rtol=atol=1e-5, the reference's own
    (tests/test_kernels.py:99); the port sums the taps in the Pallas
    kernel's order, the oracle forward from tap 0.
  * flash attention, f32: 2e-4, the reference's own
    (tests/test_flash_kernel.py:53); the port keeps the softmax weights in
    f32 as the Pallas kernel does.
  * bf16 against the f32 naive oracle: 2e-2.
The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each against its plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_bshd as jflash
from repro.kernels.ops import causal_conv1d_op as jconv_op
from repro.models.layers import flash_attention as jflash_chunked

from repro_torch.kernels import ref as tref
from repro_torch.kernels.causal_conv1d import (causal_conv1d,
                                               causal_conv1d_plain)
from repro_torch.kernels.flash_attention import (SUPPORTED_HEAD_DIMS,
                                                 flash_attention_bshd,
                                                 flash_attention_fwd)
from repro_torch.kernels.ops import causal_conv1d_op
from repro_torch.models import layers as TL

# tests/test_kernels.py:88-90: (B, L, D, K)
CONV_SHAPES = [(2, 32, 16, 4), (1, 7, 5, 3), (3, 100, 64, 4), (2, 16, 16, 2),
               (1, 64, 128, 4)]
# tests/test_flash_kernel.py:27-32: (B, S, T, Hq, Hkv, D)
FLASH_SHAPES = [(2, 64, 64, 4, 4, 32), (2, 64, 64, 8, 2, 32),
                (1, 128, 128, 4, 1, 64), (2, 96, 96, 2, 2, 16)]


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _naive(q, k, v, causal):
    """tests/test_flash_kernel.py's oracle, in numpy f64."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.astype(np.float64).reshape(b, s, hkv, g, d)
    scores = np.einsum("bqhgd,bkhd->bhgqk", qg, k.astype(np.float64)) \
        * d ** -0.5
    if causal:
        mask = np.tril(np.ones((s, k.shape[1]), bool))
        scores = np.where(mask, scores, -1e30)
    scores = scores - scores.max(-1, keepdims=True)
    p = np.exp(scores)
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bhgqk,bkhd->bqhgd", p, v.astype(np.float64))
    return out.reshape(b, s, hq, d)


# --------------------------------------------------------------------------
# causal_conv1d
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_causal_conv1d_matches_pallas_kernel(shape):
    b, l, d, k = shape
    x, w = _np((b, l, d), l * d), _np((k, d), l * d + 1)
    want = np.asarray(jconv_op(jnp.asarray(x), jnp.asarray(w), block_l=16,
                               block_d=8, interpret=True))
    got = causal_conv1d_op(_t(x), _t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_causal_conv1d_matches_oracles(shape):
    """Against the reference's oracle and the port's own (same formula)."""
    b, l, d, k = shape
    x, w = _np((b, l, d), 7 * l), _np((k, d), 7 * l + 1)
    want = np.asarray(jref.causal_conv1d_ref(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(causal_conv1d(_t(x), _t(w)).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tref.causal_conv1d_ref(_t(x), _t(w)).numpy(),
                               want, rtol=1e-6, atol=1e-6)


def test_causal_conv1d_is_causal():
    """Changing a future input must not change past outputs."""
    x, w = _np((1, 32, 8), 5), _np((4, 8), 6)
    y1 = causal_conv1d(_t(x), _t(w)).numpy()
    x2 = x.copy()
    x2[:, 20] += 100.0
    y2 = causal_conv1d(_t(x2), _t(w)).numpy()
    np.testing.assert_array_equal(y1[:, :20], y2[:, :20])
    assert not np.allclose(y1[:, 20:], y2[:, 20:])


def test_causal_conv1d_bf16_close_to_f32():
    x, w = _np((2, 40, 24), 8), _np((4, 24), 9)
    want = tref.causal_conv1d_ref(_t(x), _t(w))
    got = causal_conv1d(_t(x).bfloat16(), _t(w).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_causal_conv1d_rejects_bad_operands():
    x = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError):
        causal_conv1d(x, torch.zeros(5, 4))           # K > 4
    with pytest.raises(ValueError):
        causal_conv1d(x, torch.zeros(4, 3))           # D mismatch
    with pytest.raises(ValueError):
        causal_conv1d_plain(x[0], torch.zeros(4, 4))  # not [B, L, D]


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas_kernel(shape, causal):
    b, s, t, hq, hkv, d = shape
    seed = sum(shape)
    q = _np((b, s, hq, d), seed)
    k = _np((b, t, hkv, d), seed + 1)
    v = _np((b, t, hkv, d), seed + 2)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, block_q=32, block_k=32,
                             interpret=True))
    got = flash_attention_bshd(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, _naive(q, k, v, causal), rtol=2e-4,
                               atol=2e-4)


def test_flash_matches_reference_chunked_attention():
    """Against the reference's chunked JAX attention (models/layers.py),
    and the port's layers.flash_attention against the same."""
    q = _np((2, 128, 8, 32), 0)
    k = _np((2, 128, 2, 32), 1)
    v = _np((2, 128, 2, 32), 2)
    want = np.asarray(jflash_chunked(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True, q_chunk=32,
                                     kv_chunk=32))
    got = flash_attention_bshd(_t(q), _t(k), _t(v), causal=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    got_layer = TL.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                   q_chunk=32, kv_chunk=32).numpy()
    np.testing.assert_allclose(got_layer, want, rtol=2e-4, atol=2e-4)


def test_flash_bf16_close_to_naive():
    q = _np((1, 64, 4, 32), 11)
    k = _np((1, 64, 4, 32), 12)
    v = _np((1, 64, 4, 32), 13)
    qb, kb, vb = (_t(a).bfloat16() for a in (q, k, v))
    got = flash_attention_bshd(qb, kb, vb, causal=True)
    assert got.dtype == torch.bfloat16
    want = _naive(*(a.float().numpy() for a in (qb, kb, vb)), True)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_flash_layer_keeps_chunk_contract():
    """layers.flash_attention raises where the reference's does."""
    q = torch.zeros(1, 96, 2, 16)
    with pytest.raises(ValueError):
        TL.flash_attention(q, q, q, q_chunk=64, kv_chunk=64)


def test_flash_fwd_checks_shapes():
    q = torch.zeros(6, 8, 16)
    with pytest.raises(ValueError):
        flash_attention_fwd(q, torch.zeros(4, 8, 16), torch.zeros(4, 8, 16))
    with pytest.raises(ValueError):
        flash_attention_fwd(q, torch.zeros(3, 8, 32), torch.zeros(3, 8, 32))
    assert 112 in SUPPORTED_HEAD_DIMS


@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
def test_flash_plain_gqa_matches_naive(d):
    """Every head dim the kernel is built for, GQA 2:1, causal."""
    q = _np((2, 40, 4, d), d)
    k = _np((2, 40, 2, d), d + 1)
    v = _np((2, 40, 2, d), d + 2)
    got = flash_attention_bshd(_t(q), _t(k), _t(v), causal=True).numpy()
    np.testing.assert_allclose(got, _naive(q, k, v, True), rtol=2e-4,
                               atol=2e-4)
