"""The LM kernels on the meta device: closed-form costs instead of a launch.

A tensor on ``meta`` has a shape and a dtype and no values.  The dry run
(``launch/dryrun.py``) traces a model step there and counts what each
PyTorch op would move and compute; a CUDA kernel is not a PyTorch op, so
its wrapper, given meta tensors, returns an empty output of the right
shape and reports the kernel's work here in closed form.  These are the
numbers ``chip_smoke.py``'s kernel rows take their bounds from:

  flash attention  ``4 * BH * S * T * D`` FLOPs (two products of 2 FLOPs
                   per multiply-add), halved under ``causal``; bytes q, k,
                   v read once and the output written once.
  causal_conv1d    ``2 * K * B * L * D`` FLOPs; bytes x and w read once,
                   y written once.

The wrappers do not run their plain versions on ``meta``: the plain flash
attention materializes the ``S x T`` scores, which a kernel keeps on chip,
and would inflate the bytes and the peak memory of a trace about tenfold.

Who listens: ``recording(recorder)`` installs an object with the methods
``kernel(name, flops, dtype, nbytes)`` and ``repeat(key, fn)`` for the
duration of a block.  With no recorder installed a meta call is still
allowed (the output's shape is all it returns).

``repeated`` marks a call whose work and allocations follow from its
operands' shapes, strides and dtypes and its options alone:
``FlashAttention``'s backward, which recomputes the chunked attention in
PyTorch ops once per layer and microbatch.  The recorder may count the
first such call as executed and replay its counts for the later ones.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, List

import torch

_RECORDERS: List[object] = []


def flash_flops(bh: int, s: int, t: int, d: int, causal: bool) -> int:
    """FLOPs of one flash-attention forward over q ``(bh, s, d)`` and k/v
    ``(bhkv, t, d)`` (every query head counted)."""
    flops = 4 * bh * s * t * d
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
                 out: torch.Tensor, causal: bool) -> None:
    bh, s, d = q.shape
    record("flash_attention_fwd", flash_flops(bh, s, k.shape[1], d, causal),
           q.dtype, _nbytes(q, k, v, out))


def record_causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                         y: torch.Tensor) -> None:
    b, length, c = x.shape
    record("causal_conv1d", causal_conv1d_flops(b, length, c, w.shape[0]),
           x.dtype, _nbytes(x, w, y))


def repeated(tensors, options: tuple, fn: Callable[[], Any]) -> Any:
    """``fn()`` on meta ``tensors``, its work fixed by their shapes,
    strides and dtypes and ``options``: the installed recorder may replay
    an earlier call's counts (see the module docstring)."""
    if not _RECORDERS:
        return fn()
    key = tuple((tuple(t.shape), t.stride(), t.dtype) for t in tensors) \
        + tuple(options)
    return _RECORDERS[-1].repeat(key, fn)


@contextlib.contextmanager
def recording(recorder) -> Iterator[None]:
    """Send every meta kernel call inside the block to ``recorder``."""
    _RECORDERS.append(recorder)
    try:
        yield
    finally:
        _RECORDERS.remove(recorder)
