"""Device and dtype resolution shared by every public entry point.

The port's entry points (``make_plan``, ``PlanRegistry``, ``ConvServer``,
``ConvScheduler``, the weight converter) run on the card unless the caller
asks for the CPU: ``device=None`` means CUDA, and with no card present that
raises instead of quietly running the plain PyTorch versions.  ``"meta"``
(shapes without data) is a device a caller may ask for too: the dry run
(``launch/dryrun.py``) traces the LM steps there.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.core.scene import dtype_name

DeviceSpec = Union[None, str, torch.device]

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "float16": torch.float16, "bfloat16": torch.bfloat16}


def resolve_device(device: DeviceSpec = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the card.  Raises
    ``RuntimeError`` when CUDA is asked for (explicitly or by default) and
    no card is present, ``ValueError`` for a device type the port has no
    path for (``"meta"`` it has: shapes only, for the dry run)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: use 'cuda', 'cpu' or "
                         f"'meta'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run the plain PyTorch versions on the CPU")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """The ``torch.dtype`` of a scene dtype spelling (``"float32"`` ...)."""
    return _TORCH_DTYPES[dtype_name(dtype)]
