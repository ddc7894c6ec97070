"""Activation-sharding context (port of ``repro.parallel.ctx``).

Model code stays sharding-agnostic: it calls ``constrain(x, kind)`` where
the reference does (the residual stream, the logits, the attention heads,
the FFN hidden), and a launcher installs hooks with
``activation_sharding``.  With no hooks installed ``constrain`` is the
identity, as the reference's is.

``residual_hooks`` takes the reference's arguments.  On a one-device
mesh its hooks are identities.  On a ring (``parallel/ring.py``) nothing
constrains a tensor in place: one process holds every shard, and the
ring module lays its tensors out itself.  There each hook records the
layout the reference's hook gives (``layout_rules``: batch over the DP
axes when divisible, the sequence over "model" under ``seq_shard``, the
logits' vocabulary, the heads and the FFN hidden over "model") in the
hooks' ``layouts``, and the ring module reads the same rules to choose
its layout.

A ring also installs a MoE routing set (``moe_routing_set``): the tokens
of one microbatch spread over several data positions, which the reference
routes as one set.  ``moe_routing(layer)`` gives MoE layer ``layer`` its
handle (``models.moe.route``), or None where each call routes its own
tokens, as on one device.
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


@contextlib.contextmanager
def moe_routing_set(routing):
    """Install ``routing`` (an object with ``handle(layer)``, see
    ``parallel/ring.py``) for this thread inside the ``with`` block."""
    prev = getattr(_state, "routing", None)
    _state.routing = routing
    try:
        yield
    finally:
        _state.routing = prev


def moe_routing(layer: int):
    """The installed routing set's handle for MoE layer ``layer``, or
    None without one."""
    routing = getattr(_state, "routing", None)
    return None if routing is None else routing.handle(layer)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _size(mesh, axes: tuple) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def layout_rules(mesh, dp: tuple = (), seq_shard: bool = True,
                 tp: bool = True) -> Dict[str, Callable]:
    """kind -> (shape -> spec): the ``PartitionSpec`` (a tuple) the
    reference's hook of that kind constrains a tensor of ``shape`` to, or
    None where it leaves the tensor alone (``repro.parallel.ctx``'s
    ``residual_hooks``).  ``tp=False`` (the DP grain): "model" joins the
    batch axes, no sequence sharding, vocabulary unsharded."""
    if not tp:
        dp = tuple(dp) + ("model",)
        seq_shard = False
    m = mesh.shape["model"]

    def bspec(b):
        return dp if (dp and b % _size(mesh, dp) == 0) else None

    def residual(shape):
        if len(shape) != 3:
            return None
        b, s, _ = shape
        sspec = "model" if (seq_shard and s % m == 0 and s > 1) else None
        return (bspec(b), sspec, None)

    def logits(shape):
        v = "model" if (tp and shape[-1] % m == 0) else None
        return (bspec(shape[0]), None, v)

    def hidden(shape):
        if not tp or len(shape) != 3 or shape[-1] % m:
            return None
        return (bspec(shape[0]), None, "model")

    def heads(shape):
        if not tp or len(shape) != 4 or shape[2] % m:
            return None
        return (bspec(shape[0]), None, "model", None)

    def moe_dispatch(shape):
        # the (E, C, d|f) expert buffers: E over "model" where it divides,
        # as a ring's expert-parallel shard j holds experts [j E / m,
        # (j + 1) E / m) and the buffers of the row's tokens routed there;
        # below that (TP inside the experts) every shard holds every
        # expert's buffer and d_ff_expert / m of its hidden
        if not tp or len(shape) != 3 or shape[0] % m:
            return None
        return ("model", None, None)

    return {"residual": residual, "logits": logits, "hidden": hidden,
            "heads": heads, "moe_dispatch": moe_dispatch}


class RingHooks(dict):
    """The hook set of a ring: kind -> hook, each returning its tensor
    and recording the reference's layout for it in ``layouts`` (kind ->
    the last spec, None for a tensor the reference leaves alone)."""

    def __init__(self, rules: Dict[str, Callable]):
        self.rules = rules
        self.layouts: Dict[str, Optional[tuple]] = {}

        def hook(kind):
            def fn(x: torch.Tensor) -> torch.Tensor:
                self.layouts[kind] = rules[kind](tuple(x.shape))
                return x
            return fn

        super().__init__({kind: hook(kind) for kind in HOOK_KINDS})


def residual_hooks(mesh, dp: tuple = (), seq_shard: bool = True,
                   tp: bool = True) -> Dict[str, Callable]:
    """The reference's standard hook set (residual, logits, hidden,
    heads, moe_dispatch) for ``mesh`` with batch axes ``dp``: identities
    on a one-device mesh, a ``RingHooks`` recording the reference's
    layouts on a ring."""
    if mesh.size == 1:
        return {kind: _identity for kind in HOOK_KINDS}
    return RingHooks(layout_rules(mesh, dp, seq_shard, tp))
