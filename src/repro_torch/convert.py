"""Carry per-layer weights from the reference package into the port.

The JAX package keeps one FLT array per layer in the paper layout
``[fltH, fltW, IC, OC]``; these turn such arrays (as numpy, e.g.
``np.asarray(jax_array)``) into the port's tensors, checking each shape
against its scene.  bf16 arrays arrive as numpy's ``ml_dtypes`` bfloat16,
which torch cannot wrap directly, so every array crosses as float32 (exact
for bf16 values) and is cast to the scene's dtype on the device.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.scene import ConvScene
from repro_torch.device import DeviceSpec, resolve_device, torch_dtype


def flt_from_numpy(arr, scene: ConvScene,
                   device: DeviceSpec = None) -> torch.Tensor:
    """One FLT array -> a contiguous tensor on ``device`` (default the
    card) in ``scene.dtype``.  Raises ``ValueError`` on a shape that is not
    ``scene.flt_shape()``."""
    dev = resolve_device(device)
    a = np.asarray(arr)
    if a.shape != scene.flt_shape():
        raise ValueError(f"weight shape {a.shape} does not match the "
                         f"scene's FLT layout {scene.flt_shape()}")
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(device=dev, dtype=torch_dtype(scene.dtype)).contiguous()


def net_weights_from_numpy(scenes: Mapping[str, ConvScene],
                           arrays: Mapping[str, object],
                           device: DeviceSpec = None
                           ) -> Dict[str, torch.Tensor]:
    """``{layer: FLT tensor}`` for every layer of ``scenes``; raises
    ``KeyError`` for a layer with no array."""
    dev = resolve_device(device)
    missing = [name for name in scenes if name not in arrays]
    if missing:
        raise KeyError(f"no weight array for layers {missing}")
    return {name: flt_from_numpy(arrays[name], sc, dev)
            for name, sc in scenes.items()}
