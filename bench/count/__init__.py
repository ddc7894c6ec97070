"""The benchmark's own count of operations and bytes, and its table of peaks.

Everything here is computed from a configuration file's layer list, never
from the program under test, so a change to the program cannot change
what a cell's work is counted as.

A convolution of one direction does ``2 * outH * outW * fltH * fltW * IC *
OC * B`` operations: fprop, dgrad and wgrad contract the same products in
a different order.  Bytes count each input read once and each output
written once:

    fprop  reads IN and FLT,   writes OUT
    dgrad  reads dOUT and FLT, writes dIN
    wgrad  reads IN and dOUT,  writes dFLT

A transform that does fewer multiplies than direct convolution (Winograd,
FFT) would read above its roofline under this count; the count has to be
redone before such a kernel is measured against it.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Tuple

# NVIDIA H100 SXM data sheet, dense rates.  The f32 configurations are held
# against three TF32 terms, the least time at f32 accuracy on the card
# (495 / 3 TFLOP/s); 67 TFLOP/s is f32 on the CUDA cores.
PEAK_FLOPS = {"float32": 165e12, "bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}

DIRECTIONS = ("fprop", "dgrad", "wgrad")
GEOMETRY = ("IC", "OC", "inH", "inW", "fltH", "fltW", "padH", "padW",
            "stdH", "stdW")


def out_hw(layer: Mapping) -> Tuple[int, int]:
    """Output rows and columns of one layer of a configuration file."""
    oh = (layer["inH"] + 2 * layer["padH"] - layer["fltH"]) // layer["stdH"] + 1
    ow = (layer["inW"] + 2 * layer["padW"] - layer["fltW"]) // layer["stdW"] + 1
    return oh, ow


def conv_flops(layer: Mapping, batch: int) -> int:
    """Operations of one direction of one layer at ``batch`` images."""
    oh, ow = out_hw(layer)
    return (2 * oh * ow * layer["fltH"] * layer["fltW"] * layer["IC"]
            * layer["OC"] * batch)


def conv_bytes(layer: Mapping, direction: str, batch: int,
               dtype: str) -> int:
    """Bytes of one direction of one layer: inputs read once, the output
    written once."""
    oh, ow = out_hw(layer)
    size = ITEMSIZE[dtype]
    x = layer["inH"] * layer["inW"] * layer["IC"] * batch
    w = layer["fltH"] * layer["fltW"] * layer["IC"] * layer["OC"]
    y = oh * ow * layer["OC"] * batch
    elems = {"fprop": x + w + y, "dgrad": y + w + x, "wgrad": x + y + w}
    if direction not in elems:
        raise ValueError(f"unknown direction {direction!r}")
    return elems[direction] * size


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S)


def conv_bound_s(layer: Mapping, direction: str, batch: int,
                 dtype: str) -> float:
    return bound_s(conv_flops(layer, batch),
                   conv_bytes(layer, direction, batch, dtype), dtype)


def pass_calls(config: Mapping) -> Iterable[Tuple[int, str]]:
    """(layer index, direction) of every conv one pass over the layers
    runs, as a training step runs them: every fprop and wgrad, and every
    dgrad but the first layer's (images need no gradient)."""
    for i, _ in enumerate(config["layers"]):
        for d in DIRECTIONS:
            if not (i == 0 and d == "dgrad"):
                yield i, d


def pass_flops(config: Mapping, batch: int) -> int:
    """The operations of one pass over the layers at ``batch`` images."""
    return sum(conv_flops(config["layers"][i], batch)
               for i, _ in pass_calls(config))


def pass_bound_s(config: Mapping, batch: int) -> float:
    """The count's bound of one pass: the sum of its calls' bounds."""
    return sum(conv_bound_s(config["layers"][i], d, batch, config["dtype"])
               for i, d in pass_calls(config))


def match_layer(config: Mapping, geometry: Mapping) -> int:
    """Index of the configuration's layer whose geometry (channels, input
    size, filter, stride, padding) equals ``geometry``; -1 if none does."""
    for i, layer in enumerate(config["layers"]):
        if all(layer[k] == geometry.get(k) for k in GEOMETRY):
            return i
    return -1
