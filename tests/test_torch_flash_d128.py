"""Flash attention at head dim 128 (the dense configs' ``d_head``).

The CUDA source instantiates one kernel per head dim in two dispatch
switches (f32 ``flash_fwd_kernel`` and bf16 ``flash_fwd_bf16_kernel``);
the wrapper refuses any head dim outside ``SUPPORTED_HEAD_DIMS`` on the
card.  The switches are parsed here so that the two lists cannot drift
apart, and the plain version at D = 128 is held to the reference's Pallas
kernel in interpret mode at the reference's f32 tolerance (2e-4,
tests/test_flash_kernel.py:53).  The kernels themselves run only on the
card, where ``chip_smoke.py`` holds both instances to the plain version.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_bshd as jflash

from repro_torch.kernels.flash_attention import (SUPPORTED_HEAD_DIMS,
                                                 flash_attention_bshd,
                                                 flash_attention_fwd,
                                                 flash_attention_plain)

SRC = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
       / "csrc" / "flash_attention.cu").read_text()

# (B, S, T, Hq, Hkv, D): tests/test_flash_kernel.py's shapes at D = 128
D128_SHAPES = [(2, 64, 64, 4, 4, 128), (2, 64, 64, 8, 2, 128),
               (1, 96, 96, 2, 1, 128)]


def _dispatch_cases():
    """The head dims of each ``dispatch`` switch, in source order."""
    bodies = re.findall(r"cudaError_t dispatch\(int D,.*?default:", SRC,
                        flags=re.S)
    return [tuple(int(n) for n in re.findall(r"case (\d+):", b))
            for b in bodies]


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_both_dispatch_switches_equal_supported_head_dims():
    cases = _dispatch_cases()
    assert len(cases) == 2, "one switch per kernel (f32 and bf16)"
    for found in cases:
        assert found == SUPPORTED_HEAD_DIMS
    assert 128 in SUPPORTED_HEAD_DIMS


def test_bf16_instance_has_its_n128_product():
    """The bf16 kernel's P V at D = 128 needs the m64n128k16 overload."""
    assert "int_<128>" in SRC
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in SRC


@pytest.mark.parametrize("shape", D128_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_d128_matches_pallas_kernel(shape, causal):
    b, s, t, hq, hkv, d = shape
    seed = sum(shape)
    q, k, v = (_np((b, n, h, d), seed + i)
               for i, (n, h) in enumerate(((s, hq), (t, hkv), (t, hkv))))
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, block_q=32, block_k=32,
                             interpret=True))
    got = flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_cpu_wrapper_at_d128_is_the_plain_version():
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(4, 40, 128, generator=gen)
    kv = torch.randn(2, 40, 128, generator=gen)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, kv, kv, causal=True)
    assert torch.equal(got, flash_attention_plain(q, kv, kv, causal=True))
    assert flash_attention_fwd.launches == before
