"""Operands and weights made from the seed, on the device, in a few large
calls.

Each stream of random numbers has a generator of its own, seeded from the
run's seed and the stream's name, so one seed always gives the same
weights and operands.  Layouts are the program's plan layouts: an input
or an output ``[H, W, C, B]``, a filter ``[fltH, fltW, IC, OC]``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch

from bench import count


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for one named stream of one run's seed."""
    tag = int.from_bytes(name.encode(), "little") % (2 ** 63)
    return int(np.random.SeedSequence([int(seed) % (2 ** 64), tag])
               .generate_state(1, np.uint64)[0]) % (2 ** 63)


def generator(seed: int, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, name))
    return gen


def _cut(flat: torch.Tensor, shapes: Mapping[str, tuple]
         ) -> Dict[str, torch.Tensor]:
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def he_weights(config: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """One ``[fltH, fltW, IC, OC]`` filter per layer, He normal (std
    ``sqrt(2 / fan_in)``), drawn in one call and cut into leaves."""
    shapes = {layer["name"]: (layer["fltH"], layer["fltW"], layer["IC"],
                              layer["OC"]) for layer in config["layers"]}
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()),
                       generator=generator(seed, "weights", device),
                       device=device)
    return {name: (w * math.sqrt(2.0 / (w.shape[0] * w.shape[1]
                                        * w.shape[2]))).contiguous()
            for name, w in _cut(flat, shapes).items()}


def operands(config: Mapping, batch: int, seed: int, index: int, device
             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Entry ``index`` of a pool: for every layer its input ``x``
    ``[inH, inW, IC, B]`` and upstream gradient ``dy`` ``[outH, outW, OC,
    B]``, N(0, 1), with relu on every input but the first layer's (the
    images), as after the previous layer's relu.  Two calls per entry."""
    xs, dys = {}, {}
    for layer in config["layers"]:
        oh, ow = count.out_hw(layer)
        xs[layer["name"]] = (layer["inH"], layer["inW"], layer["IC"], batch)
        dys[layer["name"]] = (oh, ow, layer["OC"], batch)
    flat = torch.randn(sum(math.prod(s) for s in xs.values()),
                       generator=generator(seed, f"x{index}", device),
                       device=device)
    flat[math.prod(next(iter(xs.values()))):].relu_()
    x = _cut(flat, xs)
    dy = _cut(torch.randn(sum(math.prod(s) for s in dys.values()),
                          generator=generator(seed, f"dy{index}", device),
                          device=device), dys)
    return {name: {"x": x[name], "dy": dy[name]} for name in xs}
