"""CNN zoo for the paper's own evaluation (Fig. 13) as lists of convolution
*scenes*, plus the runnable trainable classifiers (the small 3-conv CNN and
scenes-backed nets such as the VGG-style one or a ``cnn_chain_scenes``
trunk) whose every convolution dispatches through prewarmed ``ConvPlan``
triples — port of ``repro.models.cnn``.

Layout: the plan layout is the paper's ``[H, W, C, B]``; ``nhwc_to_plan``
and ``plan_to_nhwc`` are the one entry and exit transposes.  The trainable
forward converts once at entry and never back: relu, the global average
pool and the head all speak plan layout.

Parameters are a flat ``{name: tensor}`` dict (one FLT ``[h, w, IC, OC]``
per conv, ``head`` ``[C, n_classes]``).  Initialisation draws from an
explicit CPU ``torch.Generator`` (a truncated normal at the reference's
std) and moves the result to ``device``, so one seed gives the same
weights on the CPU and on the card; they differ from JAX's for the same
seed (the tests carry the reference's with ``convert.cnn_params_from_numpy``).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from repro_torch.core.scene import ConvScene, dtype_name
from repro_torch.device import DeviceSpec, resolve_device
from repro_torch.models.layers import trunc_normal

Params = Dict[str, torch.Tensor]


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
                # the tune proxy shrinks a scene keeping its filter window
                # valid; imported lazily, as in the reference, so the
                # uncapped path never touches the tune package
                from repro_torch.tune.measure import proxy_scene
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


# ---------------------------------------------------------------------------
# Small runnable classifier on MG3MConv (end-to-end example / tests)
# ---------------------------------------------------------------------------
def _draw(gen: torch.Generator, shape, std: float, dtype,
          dev: torch.device) -> torch.Tensor:
    return trunc_normal(gen, shape, std, dtype).to(dev)


def init_small_cnn(gen: torch.Generator, *, in_ch: int = 3,
                   n_classes: int = 10, width: int = 16,
                   dtype=torch.float32, device: DeviceSpec = None) -> Params:
    """The small CNN's parameters, drawn from the CPU generator ``gen`` and
    placed on ``device`` (default the card)."""
    dev = resolve_device(device)
    return {
        "c1": _draw(gen, (3, 3, in_ch, width), 0.1, dtype, dev),
        "c2": _draw(gen, (3, 3, width, width * 2), 0.05, dtype, dev),
        "c3": _draw(gen, (3, 3, width * 2, width * 4), 0.05, dtype, dev),
        "head": _draw(gen, (width * 4, n_classes), 0.05, dtype, dev),
    }


_LAYER_STRIDES = {"c1": 1, "c2": 2, "c3": 2}


def small_cnn_scenes(p: Params, batch: int, res: int,
                     dtype: str = "float32") -> Dict[str, ConvScene]:
    """Per-layer ConvScenes of the small CNN for a given input geometry."""
    scenes = {}
    hw = res
    for name, stride in _LAYER_STRIDES.items():
        w = p[name]
        scenes[name] = ConvScene(B=batch, IC=w.shape[2], OC=w.shape[3],
                                 inH=hw, inW=hw, fltH=w.shape[0],
                                 fltW=w.shape[1], padH=1, padW=1,
                                 stdH=stride, stdW=stride, dtype=dtype)
        hw = scenes[name].outH
    return scenes


def small_cnn_plans(p: Params, batch: int, res: int, *,
                    dtype: str = "float32", policy=None,
                    device: DeviceSpec = None, registry=None,
                    devices=None) -> "ModelPlans":
    """Pre-build the (fprop, dgrad, wgrad) plan triple of every layer into
    one ``ModelPlans`` (one ``PlanRegistry.warm`` pass per policy) on
    ``registry`` or the default registry of ``device``; then every
    forward/backward step is pure dispatch.  ``devices`` raises until
    ``shard/`` is ported."""
    from repro_torch.core.autodiff import make_model_plans
    return make_model_plans(small_cnn_scenes(p, batch, res, dtype),
                            policy=policy, device=device, registry=registry,
                            devices=devices)


def small_cnn_forward(p: Params, x: torch.Tensor, *,
                      use_kernels: bool = False, schedule=None,
                      plans=None) -> torch.Tensor:
    """x ``[B, H, W, C]`` -> logits ``[B, n_classes]``; all convs MG3MConv,
    on ``x``'s device.

    ``use_kernels=False`` runs each conv through the torch reference
    (``mg3m_conv_nhwc(..., use_kernels=False)``, differentiable by
    autograd).  ``use_kernels=True`` routes through the differentiable
    plan path (``core/autodiff.apply_conv``) with the activation in plan
    layout across c1 -> c2 -> c3 -> pool -> head; pass ``plans`` (from
    ``small_cnn_plans``) or they come from the default registry of ``x``'s
    device."""
    from repro_torch.core.conv import mg3m_conv_nhwc
    if not use_kernels:
        z = x
        for name, stride in _LAYER_STRIDES.items():
            z = torch.relu(mg3m_conv_nhwc(z, p[name],
                                          stride=(stride, stride),
                                          padding=(1, 1), schedule=schedule,
                                          device=x.device,
                                          use_kernels=False))
        return z.mean(dim=(1, 2)) @ p["head"]
    if plans is None:
        plans = small_cnn_plans(p, x.shape[0], x.shape[1],
                                dtype=dtype_name(x.dtype),
                                policy=schedule, device=x.device)
    return cnn_forward_planned(p, x, plans, layer_order=tuple(_LAYER_STRIDES))


def cnn_forward_planned(p: Params, x: torch.Tensor, plans,
                        layer_order: Sequence[str] = ()) -> torch.Tensor:
    """Plan-layout forward shared by every trainable CNN here: one NHWC ->
    ``[H, W, C, B]`` permute at entry, per-layer ``apply_conv`` + relu with
    the activation in plan layout across the whole stack, global average
    pool over the leading spatial dims, then the linear head.

    ``plans`` is a ``ModelPlans`` (or any name -> triple mapping);
    ``layer_order`` defaults to the plans' own layer order."""
    from repro_torch.core.autodiff import apply_conv
    names = tuple(layer_order) or tuple(plans)
    z = nhwc_to_plan(x)
    for name in names:
        z = torch.relu(apply_conv(z, p[name], plans[name]))
    pooled = z.mean(dim=(0, 1))                  # [C, B] — still plan layout
    return pooled.T @ p["head"]


# ---------------------------------------------------------------------------
# Scenes-backed trainable CNN (VGG-style): the scene chain IS the model
# ---------------------------------------------------------------------------
def vgg_style_scenes(batch: int, res: int = 16, in_ch: int = 3,
                     stages: Sequence[Tuple[int, int]] = ((16, 1), (32, 2),
                                                          (64, 2)),
                     dtype: str = "float32") -> Dict[str, ConvScene]:
    """A chained VGG-style scene list: 3x3 pad-1 convs, widths and strides
    from ``stages`` (stride-2 convs in place of pooling).  The returned
    dict is a valid ``init_cnn_from_scenes``/``make_model_plans`` input."""
    scenes: Dict[str, ConvScene] = {}
    hw, ic = res, in_ch
    for i, (width, stride) in enumerate(stages):
        sc = ConvScene(B=batch, IC=ic, OC=width, inH=hw, inW=hw,
                       fltH=3, fltW=3, padH=1, padW=1,
                       stdH=stride, stdW=stride, dtype=dtype)
        scenes[f"v{i}"] = sc
        hw, ic = sc.outH, width
    return scenes


def init_cnn_from_scenes(gen: torch.Generator,
                         scenes: Mapping[str, ConvScene],
                         n_classes: int = 10, dtype=torch.float32,
                         device: DeviceSpec = None) -> Params:
    """Parameters of the scenes-backed CNN: one FLT ``[h, w, IC, OC]`` per
    scene (paper layout — no transpose between init and plan execution)
    plus the linear head off the global average pool; He-scaled std (0.1
    where IC <= 4), drawn from the CPU generator ``gen`` and placed on
    ``device`` (default the card)."""
    validate_scene_chain(scenes)
    dev = resolve_device(device)
    items = list(scenes.items())
    p: Params = {}
    for name, sc in items:
        std = 0.1 if sc.IC <= 4 else (2.0 / (sc.fltH * sc.fltW
                                             * sc.IC)) ** 0.5
        p[name] = _draw(gen, (sc.fltH, sc.fltW, sc.IC, sc.OC), std, dtype,
                        dev)
    p["head"] = _draw(gen, (items[-1][1].OC, n_classes), 0.05, dtype, dev)
    return p
