"""Flash attention (forward) for Hopper — wrappers, plain version, launches.

Port of ``repro.kernels.flash_attention``: the Pallas TPU kernel
``flash_attention_fwd`` (flash_attention.py:75, body ``_kernel`` :31)
becomes CUDA in ``csrc/flash_attention.cu`` (built by
``kernels.cuda_build`` at first use).  One block per (head, tile of 64
queries) loops over 64-key tiles, keeping the online-softmax state (f32
``m``, ``l``, ``acc``) in registers; under ``causal`` it stops at the
diagonal; grouped-query attention reads kv head ``h // g`` without
repeating K and V.  It is bound by operations, and the dtype picks the
kernel:

  bfloat16  ``flash_fwd_bf16_kernel``: both products on the tensor cores
            (wgmma, one warpgroup per 64 queries, f32 accumulators), K/V
            tiles double-buffered by cp.async in the 128-byte swizzled
            layout.  P is rounded to bf16 before the
            product with V, and ``l`` sums the rounded weights
            (``flash_attention_bf16p_plain`` spells that out; the source
            states the error bound).
  float32   ``flash_fwd_kernel``: f32 FMA on the CUDA cores, P kept in f32
            (TF32 tensor cores would miss the f32 tolerance).

Layouts as the reference's: ``flash_attention_fwd`` takes q ``(BH, S, D)``
and k, v ``(BHkv, T, D)``; ``flash_attention_bshd`` takes the model's
``(B, S, H, D)`` and reshapes.  The kernels' own tiles mask the ragged S
and T edges, so the reference's ``block_q``/``block_k`` divisibility has no
counterpart here.  Head dims: ``SUPPORTED_HEAD_DIMS`` (the kernels are
instantiated per D); any other raises on the card.

``flash_attention_plain`` (a full softmax in f32, P in f32 for the product
with V) is the Pallas kernel's function and the yardstick both kernels are
held to: the f32 kernel within 2e-4, the bf16 one within 2e-2.  The
reference's chunked JAX attention (``models/layers.py:219``) instead casts
``p`` to V's dtype.  On a CPU tensor the wrappers run the plain version; a
CUDA tensor launches a kernel or raises; a meta tensor (the dry run's)
gets an empty output and the kernel's closed-form cost reported to
``kernels.meta``.  Launches are counted in
``flash_attention_fwd.launches``.

Gradients: ``FlashAttention`` (a ``torch.autograd.Function``) runs the
forward through ``flash_attention_bshd`` (the kernel on the card) and
saves q, k and v.  The reference has no backward kernel: its training
differentiates the chunked JAX attention (``models/layers.py:176``) with
XLA.  So the backward recomputes that function, ported as
``flash_attention_chunked``, one query chunk at a time under autograd, and
returns its vector-Jacobian product.  Per query chunk the recomputation
holds ``q_chunk x T`` scores per head, never the full ``S x T`` softmax.
Backward passes are counted in ``FlashAttention.backward_calls``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import cuda_build, meta

SOURCE = "flash_attention.cu"
SUPPORTED_HEAD_DIMS = (16, 32, 64, 112, 128)
NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention_fwd takes q (BH, S, D) and k, v "
                         f"(BHkv, T, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] % k.shape[0] != 0:
        raise ValueError(f"BH {q.shape[0]} not a multiple of BHkv "
                         f"{k.shape[0]}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch: scores in f32 scaled by
    ``D**-0.5``, masked to -1e30 above the diagonal under ``causal``, a
    full softmax in f32, the product with V in f32, cast to q's dtype."""
    _check(q, k, v)
    bh, s, d = q.shape
    bhkv, t, _ = k.shape
    qg = q.float().reshape(bhkv, bh // bhkv, s, d)
    scores = torch.einsum("hgsd,htd->hgst", qg, k.float()) * d ** -0.5
    if causal:
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgst,htd->hgsd", p, v.float())
    return out.reshape(bh, s, d).to(q.dtype)


def flash_attention_bf16p_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                block_k: int = 64) -> torch.Tensor:
    """The bf16 kernel's rounding of P in plain PyTorch: the online softmax
    over ``block_k``-key tiles in f32, each tile's weights rounded to bf16
    before the product with V (accumulated in f32), ``l`` summing the
    rounded weights; cast to q's dtype.  Not a wrapper's fallback: it shows
    on the CPU what the kernel's extra rounding costs against
    ``flash_attention_plain``."""
    _check(q, k, v)
    bh, s, d = q.shape
    bhkv, t, _ = k.shape
    qg = q.float().reshape(bhkv, bh // bhkv, s, d)
    kf, vf = k.float(), v.float()
    m = torch.full((bhkv, bh // bhkv, s, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(bhkv, bh // bhkv, s, d, device=q.device)
    rows = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, t, block_k):
        kt, vt = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
        x = torch.einsum("hgsd,htd->hgst", qg, kt) * d ** -0.5
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[1], device=q.device)
            x = torch.where(keys[None, :] <= rows, x, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp(x - m_new).bfloat16().float()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("hgst,htd->hgsd", p, vt)
        m = m_new
    return (acc / l).reshape(bh, s, d).to(q.dtype)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared (builds on
    first call; see ``kernels.cuda_build``)."""
    lib = cuda_build.load(SOURCE)
    lib.flash_attention_fwd_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    lib.flash_attention_fwd_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention_fwd: operands must be on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention_fwd: operands must all be float32 "
                         f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_fwd: operands must be contiguous")
    bh, s, d = q.shape
    bhkv, t, _ = k.shape
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {d} has no kernel "
                         f"instance; supported: {SUPPORTED_HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_fwd: bf16 operands must start on "
                         "a 16-byte boundary (the kernel copies 16-byte "
                         "rows)")
    out = torch.empty_like(q)
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), bh, bhkv, s, t, d, d ** -0.5, int(causal), stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention_fwd launch failed for q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}: "
            f"{lib.flash_attention_error_string(rc).decode()} ({rc})")
    return out


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q ``(BH, S, D)``; k, v ``(BHkv, T, D)``; BH % BHkv == 0 ->
    ``(BH, S, D)`` in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        meta.record_flash(q, k, v, out, causal)
        return out
    out = _launch(q, k, v, causal)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Model-layout wrapper: q ``(B, S, H, D)``, k/v ``(B, T, Hkv, D)`` ->
    ``(B, S, H, D)``."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2).reshape(b * h, s, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * hkv, t, d).contiguous()
    vf = v.transpose(1, 2).reshape(b * hkv, t, d).contiguous()
    of = flash_attention_fwd(qf, kf, vf, causal=causal)
    return of.reshape(b, h, s, d).transpose(1, 2)


# ---------------------------------------------------------------------------
# Gradients: the reference's chunked attention, recomputed in the backward
# ---------------------------------------------------------------------------
def _chunks(s: int, t: int, q_chunk: int, kv_chunk: int) -> Tuple[int, int]:
    """The reference's chunk contract: 0 = unchunked, a chunk longer than
    the sequence is cut to it, and the lengths must divide."""
    q_chunk = min(q_chunk, s) if q_chunk else s
    kv_chunk = min(kv_chunk, t) if kv_chunk else t
    if s % q_chunk != 0 or t % kv_chunk != 0:
        raise ValueError(f"(S={s}, T={t}) not divisible by chunks "
                         f"(q_chunk={q_chunk}, kv_chunk={kv_chunk})")
    return q_chunk, kv_chunk


def _q_block(qi: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q0: int,
             causal: bool, kv_chunk: int) -> torch.Tensor:
    """One query chunk of ``flash_attention_chunked``: qi (B, qc, Hq, D)
    starting at position ``q0`` against k, v (B, T, Hkv, D) -> (B, qc, Hq,
    D) in q's dtype.  The online softmax walks the kv chunks in order, as
    the reference's ``lax.scan`` does; under ``causal`` the chunks wholly
    above the diagonal are not walked: each would add p = exp(-1e30 - m) =
    0 exactly and scale by corr = exp(0) = 1 (chunk 0 always holds key 0,
    so m is finite by then), so the result is the same."""
    b, qc, hq, d = qi.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = qi.reshape(b, qc, hkv, g, d).float()
    q_pos = q0 + torch.arange(qc, device=qi.device)
    n_kv = t // kv_chunk
    if causal:
        n_kv = min(n_kv, (q0 + qc - 1) // kv_chunk + 1)
    m = torch.full((b, hkv, g, qc), NEG_INF, dtype=torch.float32,
                   device=qi.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, qc, d), dtype=torch.float32,
                      device=qi.device)
    for j in range(n_kv):
        kj = k[:, j * kv_chunk:(j + 1) * kv_chunk]
        vj = v[:, j * kv_chunk:(j + 1) * kv_chunk]
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, kj.float()) \
            * d ** -0.5
        if causal:
            k_pos = j * kv_chunk + torch.arange(kv_chunk, device=qi.device)
            scores = torch.where(q_pos[:, None] >= k_pos[None, :], scores,
                                 NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vj.dtype).float(),
                          vj.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, qc, hq, d).to(qi.dtype)


def flash_attention_chunked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            q_chunk: int = 512,
                            kv_chunk: int = 1024) -> torch.Tensor:
    """Port of the reference's chunked online-softmax attention
    (``repro/models/layers.py:176``): q (B, S, Hq, D), k/v (B, T, Hkv, D)
    -> (B, S, Hq, D) in q's dtype; grouped GQA (K and V never repeated),
    scores and the running max/sum in f32, the weights cast to V's dtype
    before the product with V (f32 accumulation), the same ``ValueError``
    on chunks that do not divide the lengths.  Memory is O(q_chunk x
    kv_chunk) per (batch, head) per step.  Not a kernel and not a
    wrapper's fallback: ``FlashAttention`` differentiates it."""
    s, t = q.shape[1], k.shape[1]
    q_chunk, kv_chunk = _chunks(s, t, q_chunk, kv_chunk)
    return torch.cat([_q_block(q[:, i:i + q_chunk], k, v, i, causal,
                               kv_chunk) for i in range(0, s, q_chunk)], 1)


class FlashAttention(torch.autograd.Function):
    """Differentiable ``flash_attention_bshd``: the forward is the kernel
    (the plain version on a CPU tensor); the backward is the VJP of
    ``flash_attention_chunked`` (the reference's differentiated function)
    recomputed one query chunk at a time, dK and dV summed over the chunks
    in f32.  ``FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk)``
    with the model's (B, S, H, D) layout."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_chunk: int, kv_chunk: int):
        _chunks(q.shape[1], k.shape[1], q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v)
        ctx.attrs = (causal, q_chunk, kv_chunk)
        return flash_attention_bshd(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        FlashAttention.backward_calls += 1

        def vjp():
            return flash_attention_vjp(q, k, v, dout, *ctx.attrs)

        grads = meta.repeated((q, k, v, dout), ctx.attrs, vjp) \
            if q.device.type == "meta" else vjp()
        return grads + (None, None, None)


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        q_chunk: int = 512, kv_chunk: int = 1024
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_chunked`` for the cotangent
    ``dout``: each query chunk recomputed under autograd and
    differentiated on its own (the chunks are independent, as the
    reference's ``lax.map`` over them), dK and dV summed over the chunks
    in f32 and cast to K's and V's dtypes."""
    q_chunk, kv_chunk = _chunks(q.shape[1], k.shape[1], q_chunk, kv_chunk)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    with torch.enable_grad():
        kd = k.detach().requires_grad_(True)
        vd = v.detach().requires_grad_(True)
        for i in range(0, q.shape[1], q_chunk):
            qi = q[:, i:i + q_chunk].detach().requires_grad_(True)
            out = _q_block(qi, kd, vd, i, causal, kv_chunk)
            gq, gk, gv = torch.autograd.grad(out, (qi, kd, vd),
                                             dout[:, i:i + q_chunk])
            dq[:, i:i + q_chunk] = gq
            dk += gk
            dv += gv
    return dq, dk.to(k.dtype), dv.to(v.dtype)
