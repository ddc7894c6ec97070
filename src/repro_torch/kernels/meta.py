"""The LM kernels on the meta device: closed-form costs instead of a launch.

A tensor on ``meta`` has a shape and a dtype and no values.  The dry run
(``launch/dryrun.py``) traces a model step there and counts what each
PyTorch op would move and compute; a CUDA kernel is not a PyTorch op, so
its wrapper, given meta tensors, returns an empty output of the right
shape and reports the kernel's work here in closed form.  These are the
numbers ``chip_smoke.py``'s kernel rows take their bounds from:

  flash attention  ``4 * BH * S * T * D`` FLOPs (two products of 2 FLOPs
                   per multiply-add), halved under ``causal``; bytes q, k,
                   v read once and the output (and the log-sum-exp, when
                   asked for) written once.
  its backward     ``10 * BH * S * T * D`` FLOPs (the five products S, dP,
                   dV, dK, dQ, whatever a design recomputes), halved under
                   ``causal``; bytes q, k, v, o, dO and the log-sum-exp
                   read once, dq, dk and dv written once.
  causal_conv1d    ``2 * K * B * L * D`` FLOPs; bytes x and w read once,
                   y written once.
  its backward     ``4 * K * B * L * D`` FLOPs (dx's and dw's products);
                   bytes x, w and dy read once, dx and dw written once.
                   Listed apart as ``causal_conv1d_bwd_partials``: dw's
                   f32 partials ``[S, K, D]``, written and read once, and
                   the ``(S - 1) * K * D`` adds of the second pass.

The wrappers do not run their plain versions on ``meta``: the plain flash
attention materializes the ``S x T`` scores, which a kernel keeps on chip,
and would inflate the bytes and the peak memory of a trace about tenfold.

Who listens: ``recording(recorder)`` installs an object with the method
``kernel(name, flops, dtype, nbytes)`` for the duration of a block.  With
no recorder installed a meta call is still allowed (the output's shape is
all it returns).
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import torch

_RECORDERS: List[object] = []


def flash_flops(bh: int, s: int, t: int, d: int, causal: bool) -> int:
    """FLOPs of one flash-attention forward over q ``(bh, s, d)`` and k/v
    ``(bhkv, t, d)`` (every query head counted)."""
    flops = 4 * bh * s * t * d
    return flops // 2 if causal else flops


def flash_bwd_flops(bh: int, s: int, t: int, d: int, causal: bool) -> int:
    """FLOPs of one flash-attention backward over q ``(bh, s, d)`` and k/v
    ``(bhkv, t, d)``: five products of ``2 * bh * s * t * d``."""
    flops = 10 * bh * s * t * d
    return flops // 2 if causal else flops


def causal_conv1d_flops(b: int, length: int, c: int, k: int) -> int:
    """FLOPs of one depthwise causal conv1d over x ``[b, length, c]``
    with ``k`` taps."""
    return 2 * k * b * length * c


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def record(name: str, flops: int, dtype: torch.dtype, nbytes: int) -> None:
    """Report one kernel call's work to every installed recorder."""
    for rec in _RECORDERS:
        rec.kernel(name, flops, dtype, nbytes)


def record_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, causal: bool,
                 lse: Optional[torch.Tensor] = None) -> None:
    bh, s, d = q.shape
    written = (out,) if lse is None else (out, lse)
    record("flash_attention_fwd", flash_flops(bh, s, k.shape[1], d, causal),
           q.dtype, _nbytes(q, k, v, *written))


def record_flash_bwd(inputs: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor], causal: bool) -> None:
    """``inputs`` (q, k, v, out, lse, dout), ``grads`` (dq, dk, dv)."""
    q, k = inputs[0], inputs[1]
    bh, s, d = q.shape
    record("flash_attention_bwd",
           flash_bwd_flops(bh, s, k.shape[1], d, causal), q.dtype,
           _nbytes(*inputs, *grads))


def record_causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                         y: torch.Tensor) -> None:
    b, length, c = x.shape
    record("causal_conv1d", causal_conv1d_flops(b, length, c, w.shape[0]),
           x.dtype, _nbytes(x, w, y))


def record_causal_conv1d_bwd(x: torch.Tensor, w: torch.Tensor,
                             dy: torch.Tensor, dx: torch.Tensor,
                             dw: torch.Tensor, segments: int) -> None:
    """The backward of ``record_causal_conv1d``; ``segments`` S, the
    partials' leading dimension."""
    b, length, c = x.shape
    record("causal_conv1d_bwd",
           2 * causal_conv1d_flops(b, length, c, w.shape[0]), x.dtype,
           _nbytes(x, w, dy, dx, dw))
    n = w.numel()
    record("causal_conv1d_bwd_partials", (segments - 1) * n, torch.float32,
           2 * 4 * segments * n)


@contextlib.contextmanager
def recording(recorder) -> Iterator[None]:
    """Send every meta kernel call inside the block to ``recorder``."""
    _RECORDERS.append(recorder)
    try:
        yield
    finally:
        _RECORDERS.remove(recorder)
