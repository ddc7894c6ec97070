"""Flash attention's backward on the CPU: ``flash_attention_bwd_plain``
(the backward kernels' function, the CPU's backward and the card's
yardstick) against the reference.

The reference has no backward kernel: its training differentiates the
chunked JAX attention (``repro.models.layers.flash_attention``) with XLA, so
the plain backward is held to ``jax.vjp`` of that function, chunked and
unchunked, at the reference's f32 tolerance (1e-4,
``tests/test_kernels.py:41``), and to the port of the same function,
``flash_attention_vjp``.  The log-sum-exp the forward saves is held to
``torch.logsumexp``; ``FlashAttention`` must reach ``flash_attention_bwd``;
a sequence's gradients must not depend on the rest of its batch; bf16
operands stay within 2e-2 of max |g| of the f32 function.  The kernels
themselves run only on the card, where ``chip_smoke.py`` holds them to
``flash_attention_bwd_plain`` and to themselves from run to run.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

import repro_torch.kernels.flash_attention as FA
from repro_torch.kernels.flash_attention import (SUPPORTED_HEAD_DIMS,
                                                 FlashAttention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain,
                                                 flash_attention_vjp)

TOL = 1e-4
SRC = (Path(__file__).resolve().parent.parent / "src" / "repro_torch"
       / "csrc" / "flash_attention.cu").read_text()
GROUPS = (1, 2, 8)


def _operands(b, s, hq, hkv, d, seed, t=None):
    """q, k, v, dout in the model's (B, S, H, D) layout, f32, from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d),
                          (b, s, hq, d))]


def _kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B*H, S, D)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _model_layout(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B*H, S, D) -> (B, S, H, D)."""
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


def _plain_grads(q, k, v, dout, causal):
    """flash_attention_bwd_plain on numpy (B, S, H, D) operands, the
    forward's output and log-sum-exp from ``flash_attention_plain``;
    returned in the model's layout."""
    b = q.shape[0]
    qf, kf, vf, df = (_kernel_layout(torch.from_numpy(x))
                      for x in (q, k, v, dout))
    out, lse = flash_attention_plain(qf, kf, vf, causal=causal,
                                     return_lse=True)
    grads = flash_attention_bwd_plain(qf, kf, vf, out, lse, df,
                                      causal=causal)
    return [_model_layout(g, b) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("d", SUPPORTED_HEAD_DIMS)
def test_plain_backward_matches_the_reference_vjp(d, g, causal):
    """Against ``jax.vjp`` of the reference's chunked attention, chunked
    (q 16, kv 16) and unchunked, and against ``flash_attention_vjp``."""
    hkv = 1 if g == 8 else 2
    b, s = 2, 32
    q, k, v, dout = _operands(b, s, g * hkv, hkv, d, 100 * d + 10 * g
                              + causal)
    got = _plain_grads(q, k, v, dout, causal)
    for qc, kc in ((16, 16), (0, 0)):
        def ref_vjp(a, b_, c, ct):
            return jax.vjp(lambda a, b_, c: JL.flash_attention(
                a, b_, c, causal=causal, q_chunk=qc, kv_chunk=kc),
                a, b_, c)[1](ct)

        want = jax.jit(ref_vjp)(q, k, v, jnp.asarray(dout))
        for name, gt, j in zip("qkv", got, want):
            np.testing.assert_allclose(gt.numpy(), np.asarray(j), rtol=TOL,
                                       atol=TOL, err_msg=f"d{name} q_chunk "
                                       f"{qc} kv_chunk {kc}")
    ported = flash_attention_vjp(*(torch.from_numpy(x)
                                   for x in (q, k, v, dout)), causal, 16, 16)
    for gt, p in zip(got, ported):
        torch.testing.assert_close(gt, p, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(2, 40, 40, 4, 2, 16, True),
                                   (1, 70, 70, 8, 1, 32, True),
                                   (1, 24, 56, 2, 2, 64, True),
                                   (2, 33, 33, 4, 4, 112, False)])
def test_plain_lse_is_the_logsumexp_of_the_masked_scores(shape):
    b, s, t, hq, hkv, d, causal = shape
    q, k, v, _ = _operands(b, s, hq, hkv, d, sum(shape), t=t)
    qf, kf, vf = (_kernel_layout(torch.from_numpy(x)) for x in (q, k, v))
    out, lse = flash_attention_plain(qf, kf, vf, causal=causal,
                                     return_lse=True)
    assert lse.shape == (b * hq, s) and lse.dtype == torch.float32
    assert torch.equal(out, flash_attention_plain(qf, kf, vf,
                                                  causal=causal))
    g = hq // hkv
    scores = torch.einsum("hgsd,htd->hgst", qf.reshape(b * hkv, g, s, d),
                          kf) * d ** -0.5
    if causal:
        scores = scores.masked_fill(
            ~torch.ones(s, t, dtype=torch.bool).tril(), float("-inf"))
    want = torch.logsumexp(scores, dim=-1).reshape(b * hq, s)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


def test_flash_attention_goes_through_flash_attention_bwd(monkeypatch):
    """``FlashAttention``'s backward on the CPU is ``flash_attention_bwd``
    on the kernel layout (the plain version; no kernel launch counted),
    fed the forward's own output and log-sum-exp."""
    calls = []
    real = FA.flash_attention_bwd

    def spy(q, k, v, out, lse, dout, *, causal):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(lse.shape),
                      causal))
        torch.testing.assert_close(out, flash_attention_plain(
            q, k, v, causal=causal))
        return real(q, k, v, out, lse, dout, causal=causal)

    monkeypatch.setattr(FA, "flash_attention_bwd", spy)
    q, k, v, dout = (torch.from_numpy(x).requires_grad_(True)
                     for x in _operands(2, 48, 4, 2, 16, 7))
    launches = flash_attention_bwd.launches
    before = FlashAttention.backward_calls
    out = FlashAttention.apply(q, k, v, True, 16, 16)
    grads = torch.autograd.grad(out, (q, k, v), dout.detach())
    assert calls == [((8, 48, 16), (4, 48, 16), (8, 48), True)]
    assert FlashAttention.backward_calls == before + 1
    assert flash_attention_bwd.launches == launches
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]


def test_checkpointed_backward_reads_the_recomputation(monkeypatch):
    """Under ``torch.utils.checkpoint`` (the models' per-layer
    checkpointing) the forward runs again in the backward and rewrites
    the log-sum-exp: the backward must read the recomputation's own
    tensors, and give the gradients of the uncheckpointed function."""
    from torch.utils.checkpoint import checkpoint

    fwd_lse, bwd_lse = [], []
    real_fwd, real_bwd = FA.flash_attention_fwd, FA.flash_attention_bwd

    def fwd(*args, **kwargs):
        out, lse = real_fwd(*args, **kwargs)
        fwd_lse.append(lse)
        return out, lse

    def bwd(q, k, v, out, lse, dout, *, causal):
        bwd_lse.append(lse)
        return real_bwd(q, k, v, out, lse, dout, causal=causal)

    monkeypatch.setattr(FA, "flash_attention_fwd", fwd)
    monkeypatch.setattr(FA, "flash_attention_bwd", bwd)
    q, k, v, dout = (torch.from_numpy(x)
                     for x in _operands(1, 64, 4, 2, 32, 5))

    def grads(checkpointed):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

        def f(a, b_, c):
            return FlashAttention.apply(a * 1.0, b_ * 1.0, c, True, 16, 16)

        out = checkpoint(f, *leaves, use_reentrant=False) if checkpointed \
            else f(*leaves)
        return torch.autograd.grad(out, leaves, dout)

    want = grads(False)
    fwd_lse.clear()
    bwd_lse.clear()
    got = grads(True)
    assert len(fwd_lse) == 2 and len(bwd_lse) == 1
    assert bwd_lse[0].data_ptr() == fwd_lse[1].data_ptr() != \
        fwd_lse[0].data_ptr()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("causal", [True, False])
def test_a_sequence_is_bitwise_alone_and_in_a_batch(causal):
    """The gradients of a sequence inside a batch of 3 equal its gradients
    alone, bit for bit (the DP ring's bitwise check rests on it)."""
    q, k, v, dout = (torch.from_numpy(x)
                     for x in _operands(3, 80, 8, 2, 32, 11 + causal))

    def grads(sl):
        leaves = [x[sl].clone().requires_grad_(True) for x in (q, k, v)]
        out = FlashAttention.apply(*leaves, causal, 16, 16)
        return torch.autograd.grad(out, leaves, dout[sl])

    batch = grads(slice(0, 3))
    for i in range(3):
        alone = grads(slice(i, i + 1))
        for a, g in zip(alone, batch):
            assert torch.equal(a[0], g[i])


@pytest.mark.parametrize("d,g,causal", [(128, 8, True), (112, 1, True),
                                        (64, 2, False)])
def test_bf16_operands_within_2e_2_of_the_f32_function(d, g, causal):
    hkv = 1 if g == 8 else 2
    q, k, v, dout = _operands(1, 96, g * hkv, hkv, d, d + g)
    want = _plain_grads(q, k, v, dout, causal)
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v, dout)]
    qf, kf, vf, df = (_kernel_layout(x) for x in bf)
    out, lse = flash_attention_plain(qf, kf, vf, causal=causal,
                                     return_lse=True)
    got = flash_attention_bwd(qf, kf, vf, out, lse, df, causal=causal)
    for name, gt, w in zip("qkv", got, want):
        assert gt.dtype == torch.bfloat16
        rel = ((_model_layout(gt, 1).float() - w).abs().max()
               / w.abs().max()).item()
        assert rel <= 2e-2, f"d{name}: {rel} of max |g|"


def test_bad_operands_raise():
    q = torch.zeros(4, 32, 16)
    k = torch.zeros(2, 32, 16)
    lse = torch.zeros(4, 32)
    with pytest.raises(ValueError, match="shaped as q"):
        flash_attention_bwd(q, k, k, q, lse[:, :16], q)
    with pytest.raises(ValueError, match="shaped as q"):
        flash_attention_bwd(q, k, k, q[:, :16], lse, q)


def test_backward_dispatch_switches_equal_supported_head_dims():
    """One ``bwd_dispatch`` switch per dtype, each over
    ``SUPPORTED_HEAD_DIMS``: any other head dim raises on the card.  The
    bf16 backward's products run on wgmma (S and dP with both operands
    read from shared memory), none on the mma.sync m16n8k16 of its first
    version."""
    bodies = re.findall(r"cudaError_t bwd_dispatch\(int D,.*?default:", SRC,
                        flags=re.S)
    assert len(bodies) == 2
    for body in bodies:
        assert tuple(int(n) for n in re.findall(r"case (\d+):", body)) == \
            SUPPORTED_HEAD_DIMS
    assert "mma.sync.aligned.m16n8k16" not in SRC
    assert re.search(r"wgmma\.mma_async\.sync\.aligned\.m64n64k16\.f32\.bf16"
                     r"\.bf16 \{[^}]*\}, %32, %33,", SRC)
    # deterministic by construction: no atomic adds anywhere
    assert not re.search(r"atomicAdd|\bred\.|\batom\.", SRC)
