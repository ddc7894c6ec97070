"""CNN zoo for the paper's own evaluation (Fig. 13) as lists of convolution
*scenes* — port of the scene side of ``repro.models.cnn``.  The trainable
CNNs wait for the training slice.

Layout: the plan layout is the paper's ``[H, W, C, B]``; ``nhwc_to_plan``
and ``plan_to_nhwc`` are the one entry and exit transposes.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from repro_torch.core.scene import ConvScene, ceil_div


def nhwc_to_plan(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> plan layout [H, W, C, B] (the paper's IN layout)."""
    return x.permute(1, 2, 3, 0)


def plan_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Plan layout [H, W, C, B] -> NHWC."""
    return x.permute(3, 0, 1, 2)


def _s(b, ic, oc, hw, f, pad, std, in_hw=None) -> ConvScene:
    return ConvScene(B=b, IC=ic, OC=oc, inH=in_hw or hw, inW=in_hw or hw,
                     fltH=f, fltW=f, padH=pad, padW=pad, stdH=std, stdW=std)


def cnn_scenes(batch: int = 128) -> Dict[str, List[ConvScene]]:
    """Representative conv layers of the six CNNs (paper Fig. 13 workload),
    identical to the reference's list."""
    b = batch
    return {
        "alexnet": [
            _s(b, 3, 64, 224, 11, 2, 4), _s(b, 64, 192, 27, 5, 2, 1),
            _s(b, 192, 384, 13, 3, 1, 1), _s(b, 384, 256, 13, 3, 1, 1),
            _s(b, 256, 256, 13, 3, 1, 1),
        ],
        "vgg": [
            _s(b, 3, 64, 224, 3, 1, 1), _s(b, 64, 64, 224, 3, 1, 1),
            _s(b, 64, 128, 112, 3, 1, 1), _s(b, 128, 128, 112, 3, 1, 1),
            _s(b, 128, 256, 56, 3, 1, 1), _s(b, 256, 256, 56, 3, 1, 1),
            _s(b, 256, 512, 28, 3, 1, 1), _s(b, 512, 512, 28, 3, 1, 1),
            _s(b, 512, 512, 14, 3, 1, 1),
        ],
        "googlenet": [
            _s(b, 3, 64, 224, 7, 3, 2), _s(b, 64, 192, 56, 3, 1, 1),
            _s(b, 192, 96, 28, 1, 0, 1), _s(b, 96, 128, 28, 3, 1, 1),
            _s(b, 16, 32, 28, 5, 2, 1),   # inception 3a/5x5 (paper's example)
            _s(b, 480, 192, 14, 1, 0, 1), _s(b, 112, 224, 14, 3, 1, 1),
        ],
        "resnet": [
            _s(b, 3, 64, 224, 7, 3, 2), _s(b, 64, 64, 56, 1, 0, 1),
            _s(b, 64, 64, 56, 3, 1, 1), _s(b, 64, 256, 56, 1, 0, 1),
            _s(b, 256, 128, 56, 1, 0, 2), _s(b, 128, 128, 28, 3, 1, 1),
            _s(b, 512, 256, 28, 1, 0, 2), _s(b, 256, 256, 14, 3, 1, 1),
            _s(b, 1024, 512, 14, 1, 0, 2), _s(b, 512, 512, 7, 3, 1, 1),
        ],
        "squeezenet": [
            _s(b, 3, 96, 224, 7, 2, 2), _s(b, 96, 16, 55, 1, 0, 1),
            _s(b, 16, 64, 55, 1, 0, 1), _s(b, 16, 64, 55, 3, 1, 1),
            _s(b, 128, 32, 27, 1, 0, 1), _s(b, 32, 128, 27, 3, 1, 1),
            _s(b, 256, 48, 13, 1, 0, 1), _s(b, 48, 192, 13, 3, 1, 1),
        ],
        "yolo": [
            _s(b, 3, 16, 448, 3, 1, 1), _s(b, 16, 32, 224, 3, 1, 1),
            _s(b, 32, 64, 112, 3, 1, 1), _s(b, 64, 128, 56, 3, 1, 1),
            _s(b, 128, 256, 28, 3, 1, 1), _s(b, 256, 512, 14, 3, 1, 1),
            _s(b, 512, 1024, 7, 3, 1, 1),
        ],
    }


def proxy_scene(scene: ConvScene, *, measure_batch: Optional[int] = None,
                measure_max_ch: Optional[int] = None,
                measure_max_hw: Optional[int] = None) -> ConvScene:
    """Channel/batch/spatial-capped stand-in for a scene — a local copy of
    ``repro.tune.measure.proxy_scene`` (the tune slice is not ported).  The
    cap keeps the filter window valid and never grows a dim."""
    d = dict(scene.__dict__)
    if measure_batch:
        d["B"] = min(scene.B, measure_batch)
    if measure_max_ch:
        d["IC"] = min(scene.IC, measure_max_ch)
        d["OC"] = min(scene.OC, measure_max_ch)
    if measure_max_hw:
        need_h = scene.dilated_fltH - 2 * scene.padH - scene.apadH
        need_w = scene.dilated_fltW - 2 * scene.padW - scene.apadW
        min_h = 1 + max(ceil_div(need_h - 1, scene.dilH), 0)
        min_w = 1 + max(ceil_div(need_w - 1, scene.dilW), 0)
        d["inH"] = min(scene.inH, max(measure_max_hw, min_h))
        d["inW"] = min(scene.inW, max(measure_max_hw, min_w))
    return ConvScene(**d)


def cnn_layer_scenes(nets=None, batch: int = 1, *,
                     max_hw: int = 0, max_ch: int = 0,
                     layers_per_net: int = 0) -> Dict[str, ConvScene]:
    """Flat ``{"net/L<i>": scene}`` over the paper CNNs (the serving layer
    list).  ``max_hw``/``max_ch`` cap dims through ``proxy_scene``; 0 =
    full paper scenes.  ``layers_per_net`` truncates each net (0 = all)."""
    all_scenes = cnn_scenes(batch)
    nets = tuple(all_scenes) if nets is None else tuple(nets)
    out: Dict[str, ConvScene] = {}
    for net in nets:
        if net not in all_scenes:
            raise KeyError(f"unknown net {net!r}; have {sorted(all_scenes)}")
        layers = all_scenes[net]
        if layers_per_net:
            layers = layers[:layers_per_net]
        for i, sc in enumerate(layers):
            if max_hw or max_ch:
                sc = proxy_scene(sc, measure_max_ch=max_ch or None,
                                 measure_max_hw=max_hw or None)
            out[f"{net}/L{i}"] = sc
    return out


def cnn_chain_scenes(net: str, batch: int = 1, *,
                     max_hw: int = 0, max_ch: int = 0,
                     layers_per_net: int = 0) -> Dict[str, ConvScene]:
    """A *chained* ``{"net/L<i>": scene}`` conv trunk for one paper CNN —
    the whole-model serving input.  Each layer keeps its filter/stride/
    pad/OC character but takes the previous layer's output geometry as its
    input (inter-layer pooling folded into the stride chain).  Caps apply
    during construction; filters clamp to the running spatial size and
    padding to ``f - 1``."""
    all_scenes = cnn_scenes(batch)
    if net not in all_scenes:
        raise KeyError(f"unknown net {net!r}; have {sorted(all_scenes)}")
    base = all_scenes[net]
    if layers_per_net:
        base = base[:layers_per_net]
    out: Dict[str, ConvScene] = {}
    hw = min(base[0].inH, max_hw) if max_hw else base[0].inH
    ic = min(base[0].IC, max_ch) if max_ch else base[0].IC
    for i, sc in enumerate(base):
        oc = min(sc.OC, max_ch) if max_ch else sc.OC
        f = min(sc.fltH, hw)
        pad = min(sc.padH, f - 1) if f > 1 else 0
        chained = ConvScene(B=batch, IC=ic, OC=oc, inH=hw, inW=hw,
                            fltH=f, fltW=f, padH=pad, padW=pad,
                            stdH=sc.stdH, stdW=sc.stdW, dtype=sc.dtype)
        out[f"{net}/L{i}"] = chained
        hw, ic = chained.outH, oc
    validate_scene_chain(out)
    return out


def validate_scene_chain(scenes: Mapping[str, ConvScene]) -> None:
    """Raise ``ValueError`` unless consecutive scenes chain: layer i's
    output channels and spatial dims must be layer i+1's input."""
    if not scenes:
        raise ValueError("a scenes-backed CNN needs at least one conv scene")
    items = list(scenes.items())
    for (na, a), (nb, b) in zip(items, items[1:]):
        if a.OC != b.IC:
            raise ValueError(f"scene chain breaks at {na} -> {nb}: "
                             f"OC={a.OC} feeds IC={b.IC}")
        if (a.outH, a.outW) != (b.inH, b.inW):
            raise ValueError(f"scene chain breaks at {na} -> {nb}: output "
                             f"{a.outH}x{a.outW} feeds input "
                             f"{b.inH}x{b.inW}")
        if a.B != b.B:
            raise ValueError(f"scene chain breaks at {na} -> {nb}: "
                             f"batch {a.B} vs {b.B}")
