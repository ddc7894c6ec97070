"""The plain reference of the benchmark's conv layers, in plain PyTorch.

It imports nothing of the program under test.  It takes the filters and
operands the harness made and computes each direction of one layer with
``F.conv2d`` and its two adjoints, ``torch.nn.grad.conv2d_input`` and
``conv2d_weight``.

``precision`` picks the arithmetic: ``"f64"`` (the reference proper)
computes in float64; ``"tf32"`` in float32 with TF32 off and both operands
of every direction rounded to TF32's 10-bit mantissa first, as the card's
TF32 tensor cores take them.  ``"tf32"`` is the control: the nearest
precision below the f32 the configurations state.

Layouts are the program's: an input or an output ``[H, W, C, B]``, a
filter ``[fltH, fltW, IC, OC]``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

PRECISIONS = ("f64", "tf32")


@contextlib.contextmanager
def f32_mode():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to nearest-even at TF32's 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _operand(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if precision == "f64":
        return lambda t: t.double()
    if precision == "tf32":
        return lambda t: round_tf32(t.float())
    raise ValueError(f"unknown precision {precision!r}; have {PRECISIONS}")


def _nchw(t: torch.Tensor) -> torch.Tensor:          # [H, W, C, B] -> NCHW
    return t.permute(3, 2, 0, 1).contiguous()


def _plan(t: torch.Tensor) -> torch.Tensor:          # NCHW -> [H, W, C, B]
    return t.permute(2, 3, 1, 0).contiguous()


def layer(x: torch.Tensor, flt: torch.Tensor, dy: torch.Tensor,
          geometry: Mapping, precision: str = "f64", dgrad: bool = True
          ) -> Dict[str, Optional[torch.Tensor]]:
    """One layer's ``fprop`` (the output), ``dgrad`` (the input's gradient,
    None unless ``dgrad``) and ``wgrad`` (the filter's gradient) for input
    ``x``, filter ``flt`` and upstream gradient ``dy``, in plan layouts."""
    op = _operand(precision)
    stride = (geometry["stdH"], geometry["stdW"])
    padding = (geometry["padH"], geometry["padW"])
    xn, dyn = op(_nchw(x)), op(_nchw(dy))
    w = op(flt.permute(3, 2, 0, 1).contiguous())      # OIHW
    with f32_mode(), torch.no_grad():
        out = {"fprop": _plan(F.conv2d(xn, w, stride=stride,
                                       padding=padding)),
               "dgrad": None,
               "wgrad": torch.nn.grad.conv2d_weight(
                   xn, w.shape, dyn, stride=stride,
                   padding=padding).permute(2, 3, 1, 0).contiguous()}
        if dgrad:
            out["dgrad"] = _plan(torch.nn.grad.conv2d_input(
                xn.shape, w, dyn, stride=stride, padding=padding))
    return out
