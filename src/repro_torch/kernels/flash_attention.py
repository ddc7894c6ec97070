"""Flash attention for Hopper — wrappers, plain versions, launches.

Port of ``repro.kernels.flash_attention``: the Pallas TPU kernel
``flash_attention_fwd`` (flash_attention.py:75, body ``_kernel`` :31)
becomes CUDA in ``csrc/flash_attention.cu`` (built by
``kernels.cuda_build`` at first use).  One block per (head, tile of
queries) loops over key tiles, keeping the online-softmax state (f32
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
  float32   ``flash_fwd_kernel``: in place of its first version's f32
            FMA on the CUDA cores (67 TFLOP/s), both products on the
            tensor cores in three TF32 terms (mma.sync m16n8k8, 495 / 3 =
            165 TFLOP/s): each operand and P split into ``hi = rna(x)``
            and ``lo = rna(x - hi)``, ``lo hi + hi lo + hi hi`` summed in
            f32, each product within about 2^-21 of the f32 one; K/V
            tiles double-buffered by cp.async.  That keeps f32 accuracy
            (one TF32 term, some 1e-3 off, would miss the f32
            tolerance); ``flash_attention_3xtf32_plain`` spells it out.
            Elsewhere the port's f32 products (``torch.matmul``) keep
            TF32 off.

Layouts as the reference's: ``flash_attention_fwd`` takes q ``(BH, S, D)``
and k, v ``(BHkv, T, D)``; ``flash_attention_bshd`` takes the model's
``(B, S, H, D)`` and reshapes.  The kernels' own tiles mask the ragged S
and T edges, so the reference's ``block_q``/``block_k`` divisibility has no
counterpart here.  Head dims: ``SUPPORTED_HEAD_DIMS`` (the kernels are
instantiated per D); any other raises on the card.

``flash_attention_plain`` (a full softmax in f32, P in f32 for the product
with V) is the Pallas kernel's function and the yardstick both kernels are
held to: the f32 kernel within 2e-4 (and within 5e-5 of
``flash_attention_3xtf32_plain``), the bf16 one within 2e-2.  The
reference's chunked JAX attention (``models/layers.py:219``) instead casts
``p`` to V's dtype.  On a CPU tensor the wrappers run the plain version; a
CUDA tensor launches a kernel or raises; a meta tensor (the dry run's)
gets an empty output and the kernel's closed-form cost reported to
``kernels.meta``.  Launches are counted in
``flash_attention_fwd.launches``.

Gradients: ``FlashAttention`` (a ``torch.autograd.Function``) runs the
forward kernel with ``return_lse=True`` (each row's log-sum-exp, f32
``(BH, S)``, natural log) and saves the kernel-layout q, k, v, the output
and the log-sum-exp; its backward is ``flash_attention_bwd``:

  on the card  hand-written kernels in ``csrc/flash_attention.cu``, every
               product on the tensor cores (bf16 on ``wgmma`` as the bf16
               forward, f32 on ``mma.sync`` in three TF32 terms as the f32
               forward): a dQ kernel that also writes ``delta = rowsum(dO
               o O)``, then a dK/dV kernel per (kv head, block of keys,
               segment) whose segment walks part of its group's q heads
               and query stages.  The walk is cut into segments by a
               function of S, T, D, the group and ``causal`` alone
               (``dkdv_split``, ``dkdv_split_bf16``), whose f32 partial
               sums a second pass adds in segment order (and, in bf16,
               rounds once).  No atomics: the gradients are bitwise from
               run to run and independent of the rest of the batch.
               ``flash_attention_bwd_bf16_plain`` and
               ``flash_attention_bwd_3xtf32_plain`` spell out the bf16 and
               f32 kernels' arithmetic; on the card the kernels are held
               to them and to the plain version (2e-2 / 2e-4 of max |g|).
  on the CPU   ``flash_attention_bwd_plain``, the kernels' function in f32.

The reference has no backward kernel: its training differentiates the
chunked JAX attention (``models/layers.py:176``) with XLA.  Its port,
``flash_attention_chunked`` and its vector-Jacobian product
``flash_attention_vjp`` (each query chunk recomputed under autograd), is
kept as the reference's differentiated function: an oracle in the tests
and the "before" time in ``chip_smoke.py``, on no training path.  Backward
passes are counted in ``FlashAttention.backward_calls``, the kernels'
launches in ``flash_attention_bwd.launches``.
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


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """f32 scores ``(BHkv, g, S, T)`` scaled by ``D**-0.5``, -1e30 above
    the diagonal under ``causal``."""
    bh, s, d = q.shape
    bhkv, t, _ = k.shape
    qg = q.float().reshape(bhkv, bh // bhkv, s, d)
    scores = torch.einsum("hgsd,htd->hgst", qg, k.float()) * d ** -0.5
    if causal:
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    return scores


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, return_lse: bool = False):
    """The kernel's function in plain PyTorch: scores in f32 scaled by
    ``D**-0.5``, masked to -1e30 above the diagonal under ``causal``, a
    full softmax in f32, the product with V in f32, cast to q's dtype.
    With ``return_lse``, also each row's log-sum-exp of the scores (f32
    ``(BH, S)``, natural log): ``(out, lse)``."""
    _check(q, k, v)
    bh, s, d = q.shape
    scores = _scores(q, k, causal)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgst,htd->hgsd", p, v.float())
    out = out.reshape(bh, s, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(scores, dim=-1).reshape(bh, s)


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


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to the
    nearest value with 10 mantissa bits, ties away from zero (adding half
    of the 13 dropped bits to the magnitude in the int32 view), the 13 low
    bits then cleared; an f32 tensor holding TF32 values."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 kernel's split of an operand: ``hi = rna(x)``, ``lo =
    rna(x - hi)`` (``x - hi`` is exact in f32), so ``hi + lo`` is within
    2^-22 |x| of ``x``."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)


def _tf32_product(eq: str, a, b, terms: int) -> torch.Tensor:
    """``einsum(eq)`` of two split operands in f32: ``lo_a hi_b + hi_a
    lo_b + hi_a hi_b`` (small terms first, as the kernel accumulates them;
    a product of two TF32 values is exact in f32), or ``hi_a hi_b`` alone
    with ``terms=1``."""
    (ah, al), (bh, bl) = a, b
    big = torch.einsum(eq, ah, bh)
    if terms == 1:
        return big
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + big


def flash_attention_3xtf32_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, *, causal: bool = True,
                                 block_k: int = 64,
                                 terms: int = 3) -> torch.Tensor:
    """The f32 kernel's arithmetic in plain PyTorch: q, k, v and each
    tile's weights P split by ``tf32_split``, both products summed in
    three TF32 terms (``_tf32_product``), the online softmax over
    ``block_k``-key tiles in f32 (``l`` sums the unsplit weights); cast to
    q's dtype.  ``terms=1`` keeps ``hi_a hi_b`` alone, one TF32 product,
    which shows on the CPU why the kernel takes three.  Not a wrapper's
    fallback: a second yardstick beside ``flash_attention_plain``."""
    _check(q, k, v)
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    bh, s, d = q.shape
    bhkv, t, _ = k.shape
    qs = tf32_split(q.float().reshape(bhkv, bh // bhkv, s, d))
    kh, kl = tf32_split(k)
    vh, vl = tf32_split(v)
    m = torch.full((bhkv, bh // bhkv, s, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(bhkv, bh // bhkv, s, d, device=q.device)
    rows = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, t, block_k):
        tile = slice(k0, k0 + block_k)
        x = _tf32_product("hgsd,htd->hgst", qs, (kh[:, tile], kl[:, tile]),
                          terms) * d ** -0.5
        if causal:
            keys = torch.arange(k0, k0 + x.shape[-1], device=q.device)
            x = torch.where(keys[None, :] <= rows, x, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        p = torch.exp(x - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _tf32_product("hgst,htd->hgsd", tf32_split(p),
                                         (vh[:, tile], vl[:, tile]), terms)
        m = m_new
    return (acc / l).reshape(bh, s, d).to(q.dtype)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared (builds on
    first call; see ``kernels.cuda_build``)."""
    lib = cuda_build.load(SOURCE)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd_launch.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
        ctypes.c_float, i32, ptr]
    lib.flash_attention_fwd_launch.restype = i32
    lib.flash_attention_bwd_launch.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ctypes.c_longlong, i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
    lib.flash_attention_bwd_launch.restype = i32
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_card(name: str, *ts: torch.Tensor) -> None:
    """The kernels' operand contract on the card: one CUDA device, one
    dtype of ``_DTYPE_CODE``, contiguous, a supported head dim, every
    operand starting on a 16-byte boundary."""
    q = ts[0]
    if not (q.is_cuda and all(t.device == q.device for t in ts)):
        raise ValueError(f"{name}: operands must be on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{name}: operands must all be float32 or "
                         f"bfloat16, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: operands must be contiguous")
    if q.shape[2] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[2]} has no kernel "
                         f"instance; supported: {SUPPORTED_HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name}: operands must start on a 16-byte "
                         f"boundary (the kernels copy 16-byte rows)")


def _raise_on(rc: int, lib, name: str, q: torch.Tensor,
              k: torch.Tensor) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed for q {tuple(q.shape)}, k "
            f"{tuple(k.shape)}: "
            f"{lib.flash_attention_error_string(rc).decode()} ({rc})")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, with_lse: bool):
    _check_card("flash_attention_fwd", q, k, v)
    bh, s, d = q.shape
    bhkv, t, _ = k.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device) \
        if with_lse else None
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), bh,
            bhkv, s, t, d, d ** -0.5, int(causal), stream)
    _raise_on(rc, lib, "flash_attention_fwd", q, k)
    return out, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, return_lse: bool = False):
    """q ``(BH, S, D)``; k, v ``(BHkv, T, D)``; BH % BHkv == 0 ->
    ``(BH, S, D)`` in q's dtype; with ``return_lse`` also each row's
    log-sum-exp, f32 ``(BH, S)`` (natural log): ``(out, lse)``."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     return_lse=return_lse)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        lse = torch.empty(q.shape[:2], dtype=torch.float32,
                          device="meta") if return_lse else None
        meta.record_flash(q, k, v, out, causal, lse)
        return (out, lse) if return_lse else out
    out, lse = _launch(q, k, v, causal, return_lse)
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """The model's ``(B, S, H, D)`` -> the kernels' contiguous
    ``(B*H, S, D)``."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def _heads_last(x: torch.Tensor, b: int) -> torch.Tensor:
    """The kernels' ``(B*H, S, D)`` -> a ``(B, S, H, D)`` view."""
    bh, s, d = x.shape
    return x.reshape(b, bh // b, s, d).transpose(1, 2)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """Model-layout wrapper: q ``(B, S, H, D)``, k/v ``(B, T, Hkv, D)`` ->
    ``(B, S, H, D)``."""
    of = flash_attention_fwd(*map(_heads_first, (q, k, v)), causal=causal)
    return _heads_last(of, q.shape[0])


# ---------------------------------------------------------------------------
# Gradients: the backward kernels, and the reference's chunked attention
# ---------------------------------------------------------------------------
def _check_bwd(q, k, v, out, lse, dout) -> None:
    _check(q, k, v)
    bh, s, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape or \
            tuple(lse.shape) != (bh, s):
        raise ValueError(f"flash_attention_bwd takes out and dout shaped as "
                         f"q {tuple(q.shape)} and lse ({bh}, {s}), got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernels' function in plain PyTorch, f32 throughout:
    ``P = exp(scores - lse)`` from the forward's log-sum-exp (masked
    scores give 0), ``delta = rowsum(dO o O)``, ``dV = P^T dO``, ``dP = dO
    V^T``, ``dS = P o (dP - delta)``, ``dQ = scale dS K``, ``dK = scale
    dS^T Q``, dK and dV summed over each kv head's group of q heads; cast
    to the operands' dtypes.  q, out, dout ``(BH, S, D)``; k, v ``(BHkv,
    T, D)``; lse f32 ``(BH, S)`` -> (dq, dk, dv)."""
    _check_bwd(q, k, v, out, lse, dout)
    bh, s, d = q.shape
    bhkv = k.shape[0]
    g = bh // bhkv
    scale = d ** -0.5
    p = torch.exp(_scores(q, k, causal)
                  - lse.float().reshape(bhkv, g, s, 1))
    do = dout.float().reshape(bhkv, g, s, d)
    delta = (do * out.float().reshape(bhkv, g, s, d)).sum(-1, keepdim=True)
    dv = torch.einsum("hgst,hgsd->htd", p, do)
    ds = p * (torch.einsum("hgsd,htd->hgst", do, v.float()) - delta)
    dq = torch.einsum("hgst,htd->hgsd", ds, k.float()) * scale
    dk = torch.einsum("hgst,hgsd->htd", ds,
                      q.float().reshape(bhkv, g, s, d)) * scale
    return dq.reshape(bh, s, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_bf16_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   lse: torch.Tensor, dout: torch.Tensor, *,
                                   causal: bool = True
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The bf16 backward kernels' rounding in plain PyTorch: the scores,
    ``P = exp(scores - lse)`` (masked scores give 0), ``dP = dO V^T``,
    ``delta = rowsum(dO o O)`` and ``dS = P o (dP - delta)`` in f32; P and
    dS each rounded once to bf16 before the products that take them
    (``dV = bf16(P)^T dO``, ``dQ = scale bf16(dS) K``, ``dK = scale
    bf16(dS)^T Q``), whose sums stay in f32; dK and dV summed over each kv
    head's group; each output rounded once to the operands' dtype.  Not a
    wrapper's fallback: a second yardstick beside
    ``flash_attention_bwd_plain``."""
    _check_bwd(q, k, v, out, lse, dout)
    bh, s, d = q.shape
    bhkv = k.shape[0]
    g = bh // bhkv
    scale = d ** -0.5
    p = torch.exp(_scores(q, k, causal)
                  - lse.float().reshape(bhkv, g, s, 1))
    do = dout.float().reshape(bhkv, g, s, d)
    delta = (do * out.float().reshape(bhkv, g, s, d)).sum(-1, keepdim=True)
    dv = torch.einsum("hgst,hgsd->htd", p.bfloat16().float(), do)
    ds = (p * (torch.einsum("hgsd,htd->hgst", do, v.float()) - delta)
          ).bfloat16().float()
    del p
    dq = torch.einsum("hgst,htd->hgsd", ds, k.float()) * scale
    dk = torch.einsum("hgst,hgsd->htd", ds,
                      q.float().reshape(bhkv, g, s, d)) * scale
    return dq.reshape(bh, s, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_3xtf32_plain(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, out: torch.Tensor,
                                     lse: torch.Tensor, dout: torch.Tensor,
                                     *, causal: bool = True, terms: int = 3
                                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """The f32 backward kernels' arithmetic in plain PyTorch: q, k, v and
    dout split by ``tf32_split``, the scores and dP summed in three TF32
    terms (``_tf32_product``), ``P = exp(scores - lse)`` (masked scores
    give 0), ``delta = rowsum(dO o O)`` in f32, ``dS = P o (dP -
    delta)``, then P and dS split in turn and ``dV = P^T dO``, ``dQ =
    scale dS K``, ``dK = scale dS^T Q`` in three terms, dK and dV summed
    over each kv head's group; f32 ``(dq, dk, dv)``.  ``terms=1`` keeps
    ``hi_a hi_b`` alone.  Not a wrapper's fallback: a second yardstick
    beside ``flash_attention_bwd_plain``."""
    _check_bwd(q, k, v, out, lse, dout)
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    bh, s, d = q.shape
    bhkv, t, _ = k.shape
    g = bh // bhkv
    scale = d ** -0.5
    qs = tf32_split(q.float().reshape(bhkv, g, s, d))
    dos = tf32_split(dout.float().reshape(bhkv, g, s, d))
    ks, vs = tf32_split(k), tf32_split(v)
    x = _tf32_product("hgsd,htd->hgst", qs, ks, terms) * scale
    if causal:
        x = torch.where(torch.ones(s, t, dtype=torch.bool,
                                   device=q.device).tril(), x, NEG_INF)
    p = torch.exp(x - lse.float().reshape(bhkv, g, s, 1))
    del x
    delta = (dout.float() * out.float()).sum(-1).reshape(bhkv, g, s, 1)
    ds = p * (_tf32_product("hgsd,htd->hgst", dos, vs, terms) - delta)
    dv = _tf32_product("hgst,hgsd->htd", tf32_split(p), dos, terms)
    del p
    dss = tf32_split(ds)
    del ds
    dq = _tf32_product("hgst,htd->hgsd", dss, ks, terms) * scale
    dk = _tf32_product("hgst,hgsd->htd", dss, qs, terms) * scale
    return dq.reshape(bh, s, d), dk, dv


# The backward kernels' blocks (``csrc/flash_attention.cu``; a test parses
# both).  f32 (``namespace bwd``): per head dim, the query rows of a dQ block
# and the keys of a dK/dV block (16 for each pair of warps), and the dK/dV
# kernel's query stage.  bf16 (``namespace tc``): the keys of a dK/dV block
# (64 for each warpgroup) and its query stage.  The dK/dV walk of a key
# block (its group's q heads times its query stages) is cut into segments
# of L stages: the heaviest key block's walk into about ``*SEG_TARGET``
# segments, at least ``*SEG_MIN`` stages each.
BWD_F32_BLOCK = {16: 32, 32: 32, 64: 32, 112: 64, 128: 64}
BWD_F32_BQ = 32
DKDV_SEG_TARGET = 32
DKDV_SEG_MIN = 4
BWD_BF16_BLOCK = {16: 64, 32: 64, 64: 64, 112: 128, 128: 128}
BWD_BF16_BQ = 64
DKDV_BF16_SEG_TARGET = 16
DKDV_BF16_SEG_MIN = 64


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _walk_split(s: int, t: int, keys: int, stage: int, target: int,
                minimum: int, group: int,
                causal: bool) -> Tuple[int, Tuple[int, ...]]:
    """``(L, counts)`` of a dK/dV walk over blocks of ``keys`` keys and
    query stages of ``stage`` queries: L the stages of a segment, the
    heaviest key block's walk in about ``target`` segments of at least
    ``minimum`` stages; ``counts[j]`` the segments of key block j (at least
    one)."""
    stages = max(minimum, _cdiv(group * _cdiv(s, stage), target))
    counts = []
    for j in range(_cdiv(t, keys)):
        q_begin = j * keys if causal else 0
        n_q = _cdiv(s - q_begin, stage) if q_begin < s else 0
        counts.append(max(1, _cdiv(group * n_q, stages)))
    return stages, tuple(counts)


def dkdv_split(s: int, t: int, d: int, group: int,
               causal: bool) -> Tuple[int, Tuple[int, ...]]:
    """The f32 dK/dV kernel's split for q ``(BH, s, d)``, k/v ``(BHkv, t,
    d)``, ``group = BH / BHkv``: ``(L, counts)``, L the query stages of a
    segment and ``counts[j]`` the segments of key block j (at least one).
    Segment i of key block j walks steps ``[i L, (i + 1) L)`` of its
    walk, step ``it`` being q head ``it // n_q`` of the group at query
    stage ``it % n_q`` from the diagonal (under ``causal``) on.  A
    function of the shapes of one sequence alone: the batch never changes
    how a sequence's gradients are summed."""
    return _walk_split(s, t, BWD_F32_BLOCK[d], BWD_F32_BQ, DKDV_SEG_TARGET,
                       DKDV_SEG_MIN, group, causal)


def dkdv_split_bf16(s: int, t: int, d: int, group: int,
                    causal: bool) -> Tuple[int, Tuple[int, ...]]:
    """``dkdv_split`` for the bf16 dK/dV kernel: its blocks of
    ``BWD_BF16_BLOCK[d]`` keys, query stages of ``BWD_BF16_BQ`` and
    ``DKDV_BF16_SEG_*``; the same walk and the same independence of the
    batch."""
    return _walk_split(s, t, BWD_BF16_BLOCK[d], BWD_BF16_BQ,
                       DKDV_BF16_SEG_TARGET, DKDV_BF16_SEG_MIN, group, causal)


def _partials(counts: Tuple[int, ...], keys: int, d: int) -> int:
    """f32 floats of the partial sums for one kv head: a slot of ``2 *
    keys * d`` (dK's and dV's) per segment of every key block, or 0 where
    no key block has more than one segment (the kernel then writes dk and
    dv itself)."""
    return 0 if max(counts) == 1 else sum(counts) * 2 * keys * d


def dkdv_partials(s: int, t: int, d: int, group: int, causal: bool) -> int:
    """f32 floats of the f32 dK/dV kernel's partial sums for one kv head
    (``_partials`` of ``dkdv_split``)."""
    _, counts = dkdv_split(s, t, d, group, causal)
    return _partials(counts, BWD_F32_BLOCK[d], d)


def dkdv_partials_bf16(s: int, t: int, d: int, group: int,
                       causal: bool) -> int:
    """f32 floats of the bf16 dK/dV kernel's partial sums for one kv head
    (``_partials`` of ``dkdv_split_bf16``)."""
    _, counts = dkdv_split_bf16(s, t, d, group, causal)
    return _partials(counts, BWD_BF16_BLOCK[d], d)


_SPLITS = {torch.float32: (dkdv_split, dkdv_partials, BWD_F32_BLOCK),
           torch.bfloat16: (dkdv_split_bf16, dkdv_partials_bf16,
                            BWD_BF16_BLOCK)}


def _launch_bwd(q, k, v, out, lse, dout, causal: bool):
    _check_card("flash_attention_bwd", q, k, v, out, dout)
    if not (lse.device == q.device and lse.dtype == torch.float32
            and lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous f32 "
                         f"on {q.device}, got {lse.dtype} on {lse.device}")
    bh, s, d = q.shape
    bhkv, t, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    n_part = bhkv * _SPLITS[q.dtype][1](s, t, d, bh // bhkv, causal)
    part = torch.empty(n_part, dtype=torch.float32, device=q.device) \
        if n_part else None
    lib = library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), dout.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            None if part is None else part.data_ptr(), n_part, bh, bhkv, s,
            t, d, d ** -0.5, int(causal), stream)
    _raise_on(rc, lib, "flash_attention_bwd", q, k)
    return dq, dk, dv


def _partial_slots(q: torch.Tensor, k: torch.Tensor,
                   causal: bool) -> Tuple[int, int, int]:
    """(slots, blocks, keys) of the dK/dV kernel's partial sums that the
    second pass reads, over every kv head: the segments of the key blocks
    walked by more than one, those key blocks, and the keys of a block;
    zeros where nothing is split or no kernel takes the operands."""
    bh, s, d = q.shape
    bhkv, t, _ = k.shape
    if q.dtype not in _SPLITS or d not in SUPPORTED_HEAD_DIMS:
        return 0, 0, 0
    split_rule, _, block = _SPLITS[q.dtype]
    _, counts = split_rule(s, t, d, bh // bhkv, causal)
    split = [c for c in counts if c > 1]
    return bhkv * sum(split), bhkv * len(split), block[d]


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_fwd`` for the cotangent ``dout``,
    from its operands, its output and its log-sum-exp (``return_lse``):
    q, out, dout ``(BH, S, D)``; k, v ``(BHkv, T, D)``; lse f32 ``(BH,
    S)``.  The kernels on a CUDA tensor (or a raise), the plain version on
    a CPU tensor, empty outputs and the kernels' closed-form cost on
    ``meta``."""
    _check_bwd(q, k, v, out, lse, dout)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                         causal=causal)
    if q.device.type == "meta":
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        meta.record_flash_bwd((q, k, v, out, lse, dout), grads, causal,
                              _partial_slots(q, k, causal))
        return grads
    grads = _launch_bwd(q, k, v, out, lse, dout, causal)
    flash_attention_bwd.launches += 1
    return grads


flash_attention_bwd.launches = 0


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
    wrapper's fallback, and on no training path: an oracle and the
    "before" time of the backward kernels (``flash_attention_vjp``)."""
    s, t = q.shape[1], k.shape[1]
    q_chunk, kv_chunk = _chunks(s, t, q_chunk, kv_chunk)
    return torch.cat([_q_block(q[:, i:i + q_chunk], k, v, i, causal,
                               kv_chunk) for i in range(0, s, q_chunk)], 1)


class FlashAttention(torch.autograd.Function):
    """Differentiable ``flash_attention_bshd``: the forward kernel with its
    log-sum-exp, the backward ``flash_attention_bwd`` (the kernels on the
    card, the plain version on a CPU tensor).  The forward saves the
    kernel-layout q, k, v, the output and the log-sum-exp, so the backward
    transposes only dout.  Under activation checkpointing the forward runs
    again and its recomputation saves tensors of its own.  The chunks are
    the reference's contract, checked here; the kernels tile on their own.
    ``FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk)`` with the
    model's (B, S, H, D) layout."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_chunk: int, kv_chunk: int):
        _chunks(q.shape[1], k.shape[1], q_chunk, kv_chunk)
        qf, kf, vf = map(_heads_first, (q, k, v))
        of, lse = flash_attention_fwd(qf, kf, vf, causal=causal,
                                      return_lse=True)
        ctx.save_for_backward(qf, kf, vf, of, lse)
        ctx.causal = causal
        return _heads_last(of, q.shape[0])

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, of, lse = ctx.saved_tensors
        FlashAttention.backward_calls += 1
        grads = flash_attention_bwd(qf, kf, vf, of, lse, _heads_first(dout),
                                    causal=ctx.causal)
        b = dout.shape[0]
        return tuple(_heads_last(g, b) for g in grads) + (None, None, None)


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, causal: bool = True,
                        q_chunk: int = 512, kv_chunk: int = 1024
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention_chunked`` for the cotangent
    ``dout``: each query chunk recomputed under autograd and
    differentiated on its own (the chunks are independent, as the
    reference's ``lax.map`` over them), dK and dV summed over the chunks
    in f32 and cast to K's and V's dtypes.  The reference's differentiated
    function: an oracle, on no training path."""
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
