"""The f32 flash forward's three-term TF32 arithmetic on the CPU.

On the card ``flash_fwd_kernel`` runs both products on the tensor cores in
three TF32 terms (each operand split into ``hi + lo``, ``lo hi + hi lo +
hi hi`` summed in f32).  ``flash_attention_3xtf32_plain`` spells that
arithmetic out with bit operations on int32 views; here it is held to the
reference's Pallas kernel in interpret mode at the reference's f32
tolerance (1e-4, tests/test_kernels.py:41) and to ``flash_attention_plain``
within 1e-5, on the reference's test shapes and ``chip_smoke.FLASH_SHAPES``,
causal and not.  The one-term variant misses the f32 tolerance of 2e-4,
which is why the kernel takes three; the split is exact to 2^-22; and the
kernel's source runs that arithmetic.  The kernel itself runs only on the
card, where ``chip_smoke.py`` holds it to both plain versions.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bshd as jflash

from repro_torch.kernels.flash_attention import (flash_attention_3xtf32_plain,
                                                 flash_attention_plain,
                                                 tf32_rna, tf32_split)

SRC = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
       / "csrc" / "flash_attention.cu").read_text()
# (B, S, T, Hq, Hkv, D): tests/test_flash_kernel.py:27-32, D = 112 with a
# ragged S, then those at D = 128: chip_smoke.FLASH_SHAPES
SHAPES = [(2, 64, 64, 4, 4, 32), (2, 64, 64, 8, 2, 32),
          (1, 128, 128, 4, 1, 64), (2, 96, 96, 2, 2, 16),
          (2, 255, 255, 8, 4, 112)]
SHAPES += [shape[:5] + (128,) for shape in SHAPES]
# (BH, S, D), causal: where one TF32 term shows its error
ONE_TERM_SHAPES = [(4, 128, 64), (8, 255, 112), (4, 256, 128),
                   (8, 512, 128)]


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _kernel_layout(x: np.ndarray) -> torch.Tensor:
    """(B, S, H, D) -> (B*H, S, D)."""
    b, s, h, d = x.shape
    return torch.from_numpy(x).transpose(1, 2).reshape(b * h, s, d)\
        .contiguous()


def _operands(shape):
    b, s, t, hq, hkv, d = shape
    seed = sum(shape)
    return (_np((b, s, hq, d), seed), _np((b, t, hkv, d), seed + 1),
            _np((b, t, hkv, d), seed + 2))


def _float64(q, k, v, causal):
    """The attention in float64: q (BH, S, D), k/v (BHkv, T, D)."""
    bh, s, d = q.shape
    bhkv, t, _ = k.shape
    qg = q.double().reshape(bhkv, bh // bhkv, s, d)
    scores = torch.einsum("hgsd,htd->hgst", qg, k.double()) * d ** -0.5
    if causal:
        scores = torch.where(torch.ones(s, t, dtype=torch.bool).tril(),
                             scores, -1e30)
    out = torch.einsum("hgst,htd->hgsd", torch.softmax(scores, -1),
                       v.double())
    return out.reshape(bh, s, d)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_plain_matches_pallas_kernel(shape, causal):
    q, k, v = _operands(shape)
    s = shape[1]
    block = 32 if s % 32 == 0 else s
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, block_q=block, block_k=block,
                             interpret=True))
    b, _, hq, d = q.shape
    got = flash_attention_3xtf32_plain(
        *map(_kernel_layout, (q, k, v)), causal=causal)
    got = got.reshape(b, hq, s, d).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_3xtf32_plain_matches_f32_plain(shape, causal):
    q, k, v = map(_kernel_layout, _operands(shape))
    got = flash_attention_3xtf32_plain(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("shape", ONE_TERM_SHAPES)
def test_one_tf32_term_misses_the_f32_tolerance(shape):
    """Against float64, on unit-normal operands: one TF32 term misses 2e-4
    (1.00e-3 to 1.60e-3 on these shapes), three terms keep plain f32's
    error (within 2e-6 where f32 is; the kernel's source quotes both)."""
    bh, s, d = shape
    q, k, v = (torch.from_numpy(_np((bh, s, d), bh + s + d + i))
               for i in range(3))
    exact = _float64(q, k, v, True)

    def err(out):
        return (out.double() - exact).abs().max().item()

    one = err(flash_attention_3xtf32_plain(q, k, v, causal=True, terms=1))
    three = err(flash_attention_3xtf32_plain(q, k, v, causal=True))
    f32 = err(flash_attention_plain(q, k, v, causal=True))
    assert one > 2e-4, one
    assert three < 2e-6 and f32 < 2e-6, (three, f32)


def test_the_split_is_exact_to_2_22():
    rng = np.random.default_rng(28)
    x = (rng.standard_normal(1 << 16)
         * np.exp2(rng.integers(-60, 60, 1 << 16))).astype(np.float32)
    x = torch.from_numpy(x)
    hi, lo = tf32_split(x)
    bits = torch.stack([hi, lo]).view(torch.int32)
    assert not (bits & 0x1FFF).any(), "hi and lo must be TF32 values"
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -22, rel
    # TF32 values split into themselves and zero
    assert torch.equal(tf32_split(hi)[0], hi)
    assert not tf32_split(hi)[1].any()


def test_tf32_rounding_is_to_nearest_ties_away():
    ulp = 2.0 ** -10                   # a TF32 ulp at 1.0
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2 ** -23,
                      1 + 3 * ulp / 2], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)


def test_bad_term_count_raises():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="terms"):
        flash_attention_3xtf32_plain(q, q, q, terms=2)


def _f32_forward_source() -> str:
    start = SRC.index("namespace f32 {")
    return SRC[start:SRC.index("}  // namespace f32", start)]


def test_f32_kernel_runs_three_tf32_terms():
    """The f32 forward's products are mma.sync tf32 on operands split by
    cvt.rna, with K/V staged by cp.async; no FMA product loop is left and
    nothing in the source adds atomically."""
    body = _f32_forward_source()
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in body
    assert "cvt.rna.tf32.f32" in body
    assert "cp_async16" in body and "cp.async.wait_group" in body
    assert "flash_fwd_kernel" in body
    assert "fmaf(" not in body
    kernel = body[body.index("flash_fwd_kernel("):]
    assert len(re.findall(r"mma1688\(", kernel)) == 6, \
        "three terms in each of Q K^T and P V"
    assert not re.search(r"atomicAdd|\bred\.|\batom\.", SRC)
