"""PyTorch oracles for the kernels (port of ``repro.kernels.ref``).

All reference functions use the paper's data layouts:
  IN  [inH, inW, IC, B]
  FLT [fltH, fltW, IC, OC]
  OUT [outH, outW, OC, B]

``conv_ref`` runs in float64 on the CPU.  On a card it runs in float32
with cuDNN's TF32 switched off for the call (cuDNN would otherwise round
the f32 operands to TF32's ten mantissa bits).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.scene import ConvScene


def conv_ref(inp: torch.Tensor, flt: torch.Tensor,
             scene: ConvScene) -> torch.Tensor:
    """Oracle via ``F.conv2d`` in the paper's layouts, covering the whole
    dilated scene family: ``dilH/dilW`` by zero-interleaving the input
    (lhs dilation), ``fdilH/fdilW`` by ``dilation=`` (rhs dilation), and
    ``apadH/apadW`` by extra high-side ``F.pad``."""
    work = torch.float64 if inp.device.type == "cpu" else torch.float32
    x = inp.to(work).permute(3, 2, 0, 1)           # -> [B, IC, H, W]
    if scene.dilH > 1 or scene.dilW > 1:
        xd = x.new_zeros(x.shape[0], x.shape[1], scene.dilated_inH,
                         scene.dilated_inW)
        xd[:, :, ::scene.dilH, ::scene.dilW] = x
        x = xd
    x = F.pad(x, (scene.padW, scene.padW + scene.apadW,
                  scene.padH, scene.padH + scene.apadH))
    w = flt.to(work).permute(3, 2, 0, 1)           # -> [OC, IC, fh, fw]
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(x, w, stride=(scene.stdH, scene.stdW),
                     dilation=(scene.fdilH, scene.fdilW))
    return y.permute(2, 3, 1, 0).contiguous().to(inp.dtype)


def conv_direct_ref(inp: np.ndarray, flt: np.ndarray,
                    scene: ConvScene) -> np.ndarray:
    """Literal 7-loop direct convolution (paper Fig. 1), numpy, tiny shapes
    only — the oracle of the oracle.  Tap (fh, fw) of output pixel (oh, ow)
    lands on *dilated* input coordinate ``oh*std + fh*fdil - pad``, a stored
    element iff it is a non-negative multiple of ``dil`` inside the input."""
    out = np.zeros(scene.out_shape(), dtype=np.float64)
    inp = np.asarray(inp, dtype=np.float64)
    flt = np.asarray(flt, dtype=np.float64)
    for b in range(scene.B):
        for oc in range(scene.OC):
            for oh in range(scene.outH):
                for ow in range(scene.outW):
                    acc = 0.0
                    for ic in range(scene.IC):
                        for fh in range(scene.fltH):
                            for fw in range(scene.fltW):
                                qh = oh * scene.stdH + fh * scene.fdilH - scene.padH
                                qw = ow * scene.stdW + fw * scene.fdilW - scene.padW
                                if qh % scene.dilH or qw % scene.dilW:
                                    continue   # dilation hole
                                ih, iw = qh // scene.dilH, qw // scene.dilW
                                if 0 <= ih < scene.inH and 0 <= iw < scene.inW:
                                    acc += inp[ih, iw, ic, b] * flt[fh, fw, ic, oc]
                    out[oh, ow, oc, b] = acc
    return out.astype(np.asarray(inp).dtype)


def mm_unit_ref(flt_mtx: torch.Tensor, in_mtx: torch.Tensor) -> torch.Tensor:
    """The paper's MM_unit: OUT[OC,B] = FLT[IC,OC]^T @ IN[IC,B] (Eq. 2),
    f32 accumulation, cast to the input's dtype."""
    return (flt_mtx.float().T @ in_mtx.float()).to(in_mtx.dtype)


def causal_conv1d_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d (Mamba2 conv), x: [B, L, D], w: [K, D].

    y[b, l, d] = sum_k w[k, d] * x[b, l - (K-1) + k, d], zeros off the left
    edge; f32, taps summed forward from k = 0 as the reference's oracle
    does; cast to x's dtype.
    """
    k = w.shape[0]
    xf = x.float()
    pad = F.pad(xf, (0, 0, k - 1, 0))
    y = torch.zeros_like(xf)
    for i in range(k):
        y = y + w[i].float()[None, None, :] * pad[:, i:i + x.shape[1]]
    return y.to(x.dtype)
