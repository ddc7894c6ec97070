"""Activation-sharding context (port of ``repro.parallel.ctx``).

Model code stays sharding-agnostic: it calls ``constrain(x, kind)`` where
the reference does (the residual stream, the logits, the attention heads,
the FFN hidden), and a launcher installs hooks with
``activation_sharding``.  With no hooks installed ``constrain`` is the
identity, as the reference's is.

The port runs one process on one device until ``torch.distributed`` lands
(ROADMAP §1 item 6), so ``residual_hooks`` gives identity hooks under the
reference's names for a one-device mesh and raises for a larger one.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional

import torch

HOOK_KINDS = ("residual", "logits", "hidden", "heads", "moe_dispatch")

_state = threading.local()


def _hooks() -> Optional[Dict[str, Callable]]:
    return getattr(_state, "hooks", None)


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` through the installed hook for ``kind`` (the identity when
    none is installed)."""
    hooks = _hooks()
    if hooks is None or kind not in hooks:
        return x
    return hooks[kind](x)


@contextlib.contextmanager
def activation_sharding(hooks: Dict[str, Callable]):
    """Install ``hooks`` for this thread inside the ``with`` block."""
    prev = _hooks()
    _state.hooks = hooks
    try:
        yield
    finally:
        _state.hooks = prev


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def residual_hooks(mesh) -> Dict[str, Callable]:
    """The reference's standard hook set (residual, logits, hidden, heads,
    moe_dispatch).  On a one-device mesh every constraint is the identity;
    a mesh of several devices raises ``NotImplementedError`` until the
    port shards (ROADMAP §1 item 6), which brings the reference's batch
    axes, sequence sharding and ``tp`` arguments with it."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"activation sharding over a {mesh.shape} mesh waits for "
            f"torch.distributed (ROADMAP §1 item 6)")
    return {kind: _identity for kind in HOOK_KINDS}
