"""Depthwise causal conv1d for Hopper — wrapper, plain version, launch count.

Port of ``repro.kernels.causal_conv1d``: the Pallas TPU kernel
``causal_conv1d`` (causal_conv1d.py:38, body ``_kernel`` :25) becomes the
CUDA kernel in ``csrc/causal_conv1d.cu`` (built by ``kernels.cuda_build``
at first use).  It computes, for x ``[B, L, D]`` and w ``[K, D]``,

    y[b, l, d] = sum_k w[k, d] * x[b, l - (K-1) + k, d]   (zeros left of 0)

with f32 accumulation, stored in x's dtype.  It is bound by memory: a thread
walks a run of positions of one channel with the K-1 previous inputs in
registers, so x is read once and y written once (see the source's note).
The kernel masks the causal left edge and the ragged L and D edges itself,
so unlike the reference (``kernels/ops.py:86-94``) nothing is padded to
blocks.

Both the kernel and ``causal_conv1d_plain`` sum the taps as the Pallas
kernel does: ``w[K-1]*x[l]`` first, then back in time, each product and
sum rounded on its own — so they agree bit for bit in f32.  (The oracle
``kernels.ref.causal_conv1d_ref`` sums forward from tap 0, as the
reference's does; it differs from both by rounding only.)

On a CPU tensor ``causal_conv1d`` runs the plain version; a CUDA tensor
launches the kernel or raises; a meta tensor (the dry run's) gets an empty
output and the kernel's closed-form cost reported to ``kernels.meta``.
Launches are counted in ``causal_conv1d.launches``.

Gradients: ``CausalConv1d`` (a ``torch.autograd.Function``) runs the
forward through ``causal_conv1d`` and the backward through
``causal_conv1d_bwd``: dx is the anti-causal conv of dy with the same taps,
dw the shifted x times dy summed over B and L.  On the card that is two
kernels of ``csrc/causal_conv1d.cu``, which replace no TPU kernel (the
reference's Mamba2 calls the plain ``causal_conv1d_ref`` on its model path,
``models/mamba2.py:149``, and XLA differentiates it): one fused pass that
reads x and dy once, writes dx and leaves dw's sums per segment of
``BWD_SEGMENT`` positions in an f32 workspace, then a second pass that adds
the segments in order.  ``causal_conv1d_bwd_plain`` sums in the same order
(dx's taps from ``w[K-1]*dy[m]`` on; dw position by position within a
segment, then segment by segment, (b, segment) order), so the two agree
bit for bit in f32 and in bf16.  A CPU tensor runs the plain version, a
meta tensor records ``meta.record_causal_conv1d_bwd``.  Backward passes
are counted in ``CausalConv1d.backward_calls``, the kernels' calls (each
launches both passes) in ``causal_conv1d_bwd.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build, meta

SOURCE = "causal_conv1d.cu"
MAX_TAPS = 4
# positions per dw segment of the backward: BWD_SEGMENT in the source
BWD_SEGMENT = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"causal_conv1d takes x [B, L, D] and w [K, D], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if not 1 <= w.shape[0] <= MAX_TAPS:
        raise ValueError(f"filter width {w.shape[0]} outside 1..{MAX_TAPS}")


def causal_conv1d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the kernel's order: f32,
    ``w[K-1]*x[l]`` first, then ``+ w[K-1-k]*x[l-k]`` for k = 1..K-1."""
    _check(x, w)
    kw, length = w.shape[0], x.shape[1]
    xf, wf = x.float(), w.float()
    acc = xf * wf[kw - 1]
    for k in range(1, min(kw, length + 1)):
        shifted = torch.zeros_like(xf)
        shifted[:, k:] = xf[:, :length - k]
        acc = acc + shifted * wf[kw - 1 - k]
    return acc.to(x.dtype)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared (builds on
    first call; see ``kernels.cuda_build``)."""
    lib = cuda_build.load(SOURCE)
    lib.causal_conv1d_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.causal_conv1d_launch.restype = ctypes.c_int
    lib.causal_conv1d_bwd_launch.argtypes = [
        ctypes.c_int, *[ctypes.c_void_p] * 6, *[ctypes.c_int] * 4,
        ctypes.c_void_p]
    lib.causal_conv1d_bwd_launch.restype = ctypes.c_int
    lib.causal_conv1d_error_string.argtypes = [ctypes.c_int]
    lib.causal_conv1d_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if not (x.is_cuda and w.device == x.device):
        raise ValueError(f"causal_conv1d: operands must be on one CUDA "
                         f"device, got {x.device} and {w.device}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"causal_conv1d: operands must both be float32 or "
                         f"bfloat16, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("causal_conv1d: operands must be contiguous")
    b, length, d = x.shape
    y = torch.empty_like(x)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.causal_conv1d_launch(_DTYPE_CODE[x.dtype], x.data_ptr(),
                                      w.data_ptr(), y.data_ptr(), b, length,
                                      d, w.shape[0], stream)
    if rc != 0:
        raise RuntimeError(
            f"causal_conv1d launch failed for x {tuple(x.shape)}: "
            f"{lib.causal_conv1d_error_string(rc).decode()} ({rc})")
    return y


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x ``[B, L, D]``, w ``[K, D]`` -> y ``[B, L, D]`` in x's dtype."""
    _check(x, w)
    if x.device.type == "cpu":
        return causal_conv1d_plain(x, w)
    if x.device.type == "meta":
        y = torch.empty_like(x)
        meta.record_causal_conv1d(x, w, y)
        return y
    y = _launch(x, w)
    causal_conv1d.launches += 1
    return y


causal_conv1d.launches = 0


def bwd_segments(b: int, length: int) -> int:
    """S, the backward's dw segments: ``ceil(L / BWD_SEGMENT)`` a row."""
    return b * -(-length // BWD_SEGMENT)


def _check_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor) -> None:
    _check(x, w)
    if dy.shape != x.shape:
        raise ValueError(f"causal_conv1d_bwd: dy {tuple(dy.shape)} is not "
                         f"x's shape {tuple(x.shape)}")


def causal_conv1d_bwd_plain(x: torch.Tensor, w: torch.Tensor,
                            dy: torch.Tensor):
    """(dx, dw) of ``y = causal_conv1d(x, w)`` for the cotangent ``dy``:
    the backward kernels' function in plain PyTorch, in their order, f32,
    cast to x's and w's dtypes.  With s = K-1-k the shift of tap k, ``dx[m]
    = w[K-1] dy[m] + w[K-2] dy[m+1] + ...`` (dy zero right of L-1), and
    dw[k] is ``x[l-s] dy[l]`` summed over l within each segment of
    ``BWD_SEGMENT`` positions of a row, then over the segments in (b,
    segment) order."""
    _check_bwd(x, w, dy)
    kw = w.shape[0]
    b, length, d = x.shape
    xf, wf, dyf = x.float(), w.float(), dy.float()
    dyp = torch.cat([dyf, dyf.new_zeros(b, kw - 1, d)], 1)
    dx = dyp[:, :length] * wf[kw - 1]
    for s in range(1, kw):
        dx = dx + dyp[:, s:s + length] * wf[kw - 1 - s]
    nseg = bwd_segments(1, length)
    span = nseg * BWD_SEGMENT
    # xp[:, k + l] = x[l - s] for tap k; zero left of 0 and right of L-1
    xp = torch.cat([xf.new_zeros(b, kw - 1, d), xf,
                    xf.new_zeros(b, span - length, d)], 1)
    xs = torch.stack([xp[:, k:k + span] for k in range(kw)], 2)
    xs = xs.view(b, nseg, BWD_SEGMENT, kw, d)
    dys = torch.cat([dyf, dyf.new_zeros(b, span - length, d)], 1)
    dys = dys.view(b, nseg, BWD_SEGMENT, 1, d)
    acc = xf.new_zeros(b, nseg, kw, d)
    for i in range(min(BWD_SEGMENT, length)):
        acc = acc + xs[:, :, i] * dys[:, :, i]
    parts = acc.reshape(b * nseg, kw, d)
    dw = parts[0].clone()
    for part in parts[1:]:
        dw += part
    return dx.to(x.dtype), dw.to(w.dtype)


def _launch_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    if not (x.is_cuda and w.device == x.device and dy.device == x.device):
        raise ValueError(f"causal_conv1d_bwd: operands must be on one CUDA "
                         f"device, got {x.device}, {w.device} and "
                         f"{dy.device}")
    if not (x.dtype == w.dtype == dy.dtype) or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"causal_conv1d_bwd: operands must all be float32 "
                         f"or bfloat16, got {x.dtype}, {w.dtype} and "
                         f"{dy.dtype}")
    if not (x.is_contiguous() and w.is_contiguous() and dy.is_contiguous()):
        raise ValueError("causal_conv1d_bwd: operands must be contiguous")
    b, length, d = x.shape
    kw = w.shape[0]
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    ws = torch.empty((bwd_segments(b, length), kw, d), dtype=torch.float32,
                     device=x.device)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.causal_conv1d_bwd_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), ws.data_ptr(), b, length, d, kw,
            stream)
    if rc != 0:
        raise RuntimeError(
            f"causal_conv1d_bwd launch failed for x {tuple(x.shape)}: "
            f"{lib.causal_conv1d_error_string(rc).decode()} ({rc})")
    return dx, dw


def causal_conv1d_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """x, dy ``[B, L, D]``, w ``[K, D]`` -> (dx in x's dtype, dw in w's):
    the backward kernels on a CUDA tensor (or raises), the plain version on
    a CPU one, empty outputs and the closed form on meta."""
    _check_bwd(x, w, dy)
    if x.device.type == "cpu":
        return causal_conv1d_bwd_plain(x, w, dy)
    if x.device.type == "meta":
        dx, dw = torch.empty_like(x), torch.empty_like(w)
        meta.record_causal_conv1d_bwd(x, w, dy, dx, dw,
                                      bwd_segments(*x.shape[:2]))
        return dx, dw
    dx, dw = _launch_bwd(x, w, dy)
    causal_conv1d_bwd.launches += 1
    return dx, dw


causal_conv1d_bwd.launches = 0


class CausalConv1d(torch.autograd.Function):
    """Differentiable ``causal_conv1d``: ``causal_conv1d`` forward,
    ``causal_conv1d_bwd`` backward (the kernels on the card, the plain
    versions on the CPU).  ``CausalConv1d.apply(x, w)``."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return causal_conv1d(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        CausalConv1d.backward_calls += 1
        return causal_conv1d_bwd(x, w, dy.contiguous())
