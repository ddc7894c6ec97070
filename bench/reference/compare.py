"""The numbers that decide ``correct``, each held against its limit.

For each direction, the worst over the checked layers and passes of
``max |program - reference| / max |reference|`` of one output: the
output of fprop, the input's gradient of dgrad, the filter's gradient of
wgrad.  An output of the wrong shape, or one that is not finite, reads
infinite.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from bench.count import DIRECTIONS


def gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """max |prog - ref| over max |ref|."""
    if tuple(prog.shape) != tuple(ref.shape):
        return math.inf
    prog, ref = prog.double(), ref.double()
    worst = float((prog - ref).abs().max() / ref.abs().max().clamp(
        min=1e-300))
    return worst if math.isfinite(worst) else math.inf


def names() -> tuple:
    return tuple(f"{d}_gap" for d in DIRECTIONS)


def verdict(numbers: Mapping[str, float],
            limits: Mapping[str, float]) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}``, every number with its limit."""
    missing = set(numbers) ^ set(limits)
    if missing:
        raise ValueError(f"numbers and limits differ on {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}


def passed(checks: Mapping[str, Mapping[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
