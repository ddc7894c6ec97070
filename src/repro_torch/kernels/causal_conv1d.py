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
forward through ``causal_conv1d`` (the kernel on the card) and computes
the backward in torch ops, ``causal_conv1d_grads``: dx is the anti-causal
conv of dy with the same taps, dw the shifted x times dy summed over B and
L.  The reference has no backward kernel either: its Mamba2 calls the
plain ``causal_conv1d_ref`` on the model path (``models/mamba2.py:146``)
and XLA differentiates it.  Backward passes are counted in
``CausalConv1d.backward_calls``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda_build, meta

SOURCE = "causal_conv1d.cu"
MAX_TAPS = 4
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


def causal_conv1d_grads(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """(dx, dw) of ``y = causal_conv1d(x, w)`` for the cotangent ``dy``, in
    f32, cast to x's and w's dtypes.  With s = K-1-k the shift of tap k,
    ``y[l] += w[k] x[l-s]``, so ``dx[m] += w[k] dy[m+s]`` and ``dw[k] =
    sum over b and l >= s of x[l-s] dy[l]``."""
    _check(x, w)
    kw, length = w.shape[0], x.shape[1]
    xf, wf, dyf = x.float(), w.float(), dy.float()
    dx = torch.zeros_like(xf)
    dw = torch.zeros_like(wf)
    for k in range(kw):
        s = kw - 1 - k
        if s >= length:
            continue
        dx[:, :length - s] += wf[k] * dyf[:, s:]
        dw[k] = (xf[:, :length - s] * dyf[:, s:]).sum((0, 1))
    return dx.to(x.dtype), dw.to(w.dtype)


class CausalConv1d(torch.autograd.Function):
    """Differentiable ``causal_conv1d``: the kernel (or, on a CPU tensor,
    the plain version) forward, ``causal_conv1d_grads`` backward.
    ``CausalConv1d.apply(x, w)``."""

    backward_calls = 0

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return causal_conv1d(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        CausalConv1d.backward_calls += 1
        return causal_conv1d_grads(x, w, dy)
