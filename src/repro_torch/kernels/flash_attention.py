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
CUDA tensor launches a kernel or raises.  Launches are counted in
``flash_attention_fwd.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build

SOURCE = "flash_attention.cu"
SUPPORTED_HEAD_DIMS = (16, 32, 64, 112)
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
