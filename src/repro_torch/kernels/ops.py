"""Public op wrappers around the port's kernels (port of
``repro.kernels.ops``).

Only ``causal_conv1d_op`` so far.  The reference pads x and w up to whole
``(block_l, block_d)`` blocks before its Pallas call and slices the result
back (ops.py:86-94); the CUDA kernel masks its own ragged edges, so the op
is the kernel wrapper itself.  ``mg3m_conv_op`` comes with the autodiff
slice (ROADMAP §1).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.causal_conv1d import causal_conv1d


def causal_conv1d_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d (Mamba2's conv), x ``[B, L, D]``, w
    ``[K, D]``: the CUDA kernel on a card tensor, its plain version on a
    CPU one — see ``kernels/causal_conv1d.py``."""
    return causal_conv1d(x, w)
