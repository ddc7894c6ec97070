"""Carry weights from the reference package into the port.

CNNs: the JAX package keeps one FLT array per layer in the paper layout
``[fltH, fltW, IC, OC]``; ``flt_from_numpy`` / ``net_weights_from_numpy``
turn such arrays (as numpy, e.g. ``np.asarray(jax_array)``) into the port's
tensors, checking each shape against its scene; ``cnn_params_from_numpy``
carries a trainable CNN's whole parameter dict (convs and head).

LMs: ``lm_params_from_numpy`` turns the reference's parameter pytree of
``transformer.init_params`` (as numpy) into the port's model of the
config's family: an ``AttnLM`` (dense, moe, vlm, audio), a ``HybridLM``
or an ``RwkvLM`` (ssm).

bf16 arrays arrive as numpy's ``ml_dtypes`` bfloat16, which torch cannot
wrap directly, so every array crosses as float32 (exact for bf16 values)
and is cast back to its own dtype on the device.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.scene import ConvScene
from repro_torch.device import DeviceSpec, resolve_device, torch_dtype
from repro_torch.models.transformer import LM, build, layer_counts


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


def cnn_params_from_numpy(params: Mapping[str, Any],
                          device: DeviceSpec = None) -> Dict[str, torch.Tensor]:
    """A trainable CNN's parameter dict of the reference (``models/cnn.py``:
    ``init_small_cnn`` / ``init_cnn_from_scenes``, as numpy, e.g.
    ``jax.tree.map(np.asarray, params)``) -> the port's ``{name: tensor}``
    on ``device`` (default the card), each leaf in its own dtype."""
    dev = resolve_device(device)
    return {name: _leaf(arr, dev) for name, arr in params.items()}


def _leaf(arr, dev: torch.device) -> torch.Tensor:
    a = np.asarray(arr)
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=dev, dtype=torch_dtype(a.dtype)).contiguous()


def _tree(node, dev: torch.device, index=()):
    """Every leaf of a nested dict, indexed along its leading axes by
    ``index`` and moved to ``dev``."""
    if isinstance(node, Mapping):
        return {k: _tree(v, dev, index) for k, v in node.items()}
    return _leaf(np.asarray(node)[index], dev)


def lm_params_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any],
                         device: DeviceSpec = None,
                         trainable: bool = False) -> LM:
    """The reference's LM parameter pytree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``) -> the port's ``AttnLM``,
    ``HybridLM`` or ``RwkvLM`` on ``device`` (default the card), its
    parameters frozen unless ``trainable``.

    The reference stacks its layers along leading axes
    (``transformer.py:99-128``): ``(n_layers, ...)`` under ``layers`` for
    the attention-block families and rwkv6 (``{"ln1", "ln2", "mix"}``), and
    for the hybrid the Mamba2 layers as ``(n_groups, attn_every, ...)``
    under ``layers`` and ``(tail, ...)`` under ``tail_layers``.  These are
    unstacked into one tree per layer.  Each leaf keeps its dtype (bf16
    weights; the f32 MoE router, the f32 ``A_log``, ``D`` and ``dt_bias``,
    and rwkv6's f32 ``w0`` and ``u``)."""
    dev = resolve_device(device)
    port = {k: _tree(tree[k], dev) for k in
            ("embed", "lm_head", "final_norm", "shared_attn") if k in tree}
    if cfg.family != "hybrid":
        port["layers"] = [_tree(tree["layers"], dev, (i,))
                          for i in range(cfg.n_layers)]
        return build(cfg, port, trainable)
    n_groups, tail = layer_counts(cfg)
    port["layers"] = [[_tree(tree["layers"], dev, (g, i))
                       for i in range(cfg.attn_every)]
                      for g in range(n_groups)]
    port["tail_layers"] = [_tree(tree["tail_layers"], dev, (i,))
                           for i in range(tail)]
    return build(cfg, port, trainable)
