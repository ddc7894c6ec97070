"""Mixture-of-Experts FFN: top-k routing with capacity, scatter dispatch.

Port of ``repro.models.moe``: the same parameters (router f32 ``(d, E)``,
``w_gate``/``w_up`` ``(E, d, f)`` and ``w_down`` ``(E, f, d)`` in the
model dtype, the reference's init stds), routing, capacity, dispatch and
load-balance loss.  Tokens are scattered into ``(E, C, d)`` expert buffers
and the expert SwiGLU runs as three batched products over the experts,
which are plain ``torch`` products as in the reference (no Pallas kernel
there).  Design points, each decided to drop exactly the tokens the
reference drops:

  * **Token order.**  The reference's comment says "slot-major", but its
    code flattens ``idx (T, k)`` token-major (``moe.py:65-68``): the
    cumulative count then gives a later token the higher position in its
    expert, so later tokens are dropped first.  The port follows the code.
    ``jnp.repeat(x, k, axis=0)`` is ``repeat_interleave``.
  * **Scatter.**  ``buf.at[idx, pos].add`` is ``index_put_(...,
    accumulate=True)``.  A dropped (token, slot) adds a row of zeros at
    position 0 of its expert; every kept position receives exactly one
    row, so the buffer holds each kept token exactly (adding zeros changes
    no value).
  * **Ties in ``route_topk``.**  ``jax.lax.top_k`` takes the lower expert
    index on equal probabilities; ``torch.topk`` promises no order.  An
    all-zero token row gives uniform probabilities, where every expert
    ties, so the port takes the first ``k`` of a stable descending sort,
    which keeps equal values in index order.
  * **Capacity.**  ``max(1, int(cf * T * k / E))`` with ``cf`` the config's
    ``capacity_factor`` unless the caller passes one.  ``cf = E / k`` makes
    the capacity ``T``: nothing is dropped, which serving needs
    (``transformer`` passes it on decode, and ``serve.engine`` on the
    prefills that fill a slot).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import trunc_normal

F32 = torch.float32
Params = Mapping[str, torch.Tensor]


def init_moe(gen: torch.Generator, d: int, cfg: MoEConfig, dtype,
             n_layers: int = 1, device=None) -> Dict[str, torch.Tensor]:
    f, e = cfg.d_ff_expert, cfg.n_experts
    std_in, std_out = d ** -0.5, (f ** -0.5) / math.sqrt(2 * n_layers)
    return {
        "router": trunc_normal(gen, (d, e), std_in, F32, device),
        "w_gate": trunc_normal(gen, (e, d, f), std_in, dtype, device),
        "w_up": trunc_normal(gen, (e, d, f), std_in, dtype, device),
        "w_down": trunc_normal(gen, (e, f, d), std_out, dtype, device),
    }


def capacity(cfg: MoEConfig, n_tokens: int,
             capacity_factor: Optional[float] = None) -> int:
    """Rows per expert buffer for ``n_tokens`` tokens (the reference's
    ``max(1, int(cf * T * k / E))``)."""
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    return max(1, int(cf * n_tokens * cfg.top_k / cfg.n_experts))


def drop_free_factor(cfg: MoEConfig) -> float:
    """The capacity factor ``E / k`` at which the capacity is ``T``."""
    return cfg.n_experts / cfg.top_k


def route_topk(logits: torch.Tensor, top_k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (gates (T, k) f32 renormalized, expert_idx (T, k)),
    ties to the lower expert index."""
    probs = torch.softmax(logits.float(), -1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :top_k], idx[:, :top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx


class Route(NamedTuple):
    """Where each (token, slot) of ``T`` tokens goes (``route``)."""

    logits: torch.Tensor      # (T, E) f32
    gates: torch.Tensor       # (T, k) f32, renormalized
    flat_idx: torch.Tensor    # (T*k,) expert, token-major
    flat_pos: torch.Tensor    # (T*k,) row in its expert's buffer, 0 if dropped
    keep: torch.Tensor        # (T*k,) kept under the capacity
    rows: int                 # rows of each expert's buffer
    ce: torch.Tensor          # (E,) f32 the set's kept (token, slot)s / (T*k)
    drop_frac: torch.Tensor   # the set's share of (token, slot)s dropped


def gates_at(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The renormalized gates of ``logits`` (T, E) at the experts ``idx``
    (T, k): ``route_topk``'s gates where ``idx`` is its pick."""
    gates = torch.softmax(logits.float(), -1).gather(1, idx)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)


def route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
          capacity_factor: Optional[float] = None, routing=None) -> Route:
    """Route ``x`` (T, d).  ``routing`` None: the T tokens are the routing
    set (the reference's ``moe_ffn``).  Otherwise they are one member's
    share of a larger set (``parallel/ring.py``): ``routing.n_tokens`` is
    the set's size, which sets the capacity, and ``routing.route(logits)``
    gives ``(gates, idx, offset, total)``: the member's pick, the per-expert
    (token, slot) counts of the members before it and of the whole set.  A
    (token, slot)'s position in its expert is then its local cumulative
    count plus its expert's offset, its position in the set's token-major
    order; the buffer holds only this member's rows (``min(capacity, T)``:
    top-k experts are distinct, so no expert gets more than ``T``), and
    ``ce``/``drop_frac`` are the set's."""
    t, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = x.float() @ router                               # (T, E) f32
    if routing is None:
        cap = capacity(cfg, t, capacity_factor)
        gates, idx = route_topk(logits, k)                    # (T, k)
    else:
        cap = capacity(cfg, routing.n_tokens, capacity_factor)
        gates, idx, offset, total = routing.route(logits)

    # position of each (token, slot) in its expert, token-major order
    flat_idx = idx.reshape(-1)                                # (T*k,)
    pos = F.one_hot(flat_idx, e).cumsum(0) - 1                # (T*k, E)
    flat_pos = pos.gather(1, flat_idx[:, None])[:, 0]
    if routing is None:
        keep = flat_pos < cap
        rows = cap
    else:
        keep = flat_pos + offset[flat_idx] < cap
        rows = min(cap, t)
    flat_pos = torch.where(keep, flat_pos, 0)
    if routing is None:
        ce = torch.zeros(e, dtype=F32, device=x.device).index_add_(
            0, flat_idx, keep.float()) / max(t * k, 1)
        drop = 1.0 - keep.float().mean()
    else:
        kept = total.clamp(max=cap).float()
        ce = kept / max(routing.n_tokens * k, 1)
        drop = 1.0 - kept.sum() / max(routing.n_tokens * k, 1)
    return Route(logits, gates, flat_idx, flat_pos, keep, rows, ce, drop)


def _local(r: Route, e0: int, e1: int, n_experts: int):
    """(expert index within [e0, e1), kept and in that range) per (token,
    slot); the whole range is the reference's own indices."""
    if e0 == 0 and e1 == n_experts:
        return r.flat_idx, r.keep
    mine = r.keep & (r.flat_idx >= e0) & (r.flat_idx < e1)
    return (r.flat_idx - e0).clamp(0, e1 - e0 - 1), mine


def dispatch(x: torch.Tensor, r: Route, e0: int, e1: int) -> torch.Tensor:
    """The ``(e1 - e0, rows, d)`` buffers of experts [e0, e1): each kept
    token's row at its position (a dropped or foreign (token, slot) adds a
    row of zeros at position 0)."""
    k = r.gates.shape[1]
    idx, mine = _local(r, e0, e1, r.logits.shape[1])
    xk = x.repeat_interleave(k, dim=0)                        # (T*k, d)
    buf = x.new_zeros((e1 - e0, r.rows, x.shape[1]))
    buf.index_put_((idx, r.flat_pos),
                   torch.where(mine[:, None], xk, 0), accumulate=True)
    return buf


def experts(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """The expert SwiGLU over ``(E, C, d)`` buffers in the IO dtype (f32
    accumulation inside): ``(E, C, d)``."""
    gate = torch.bmm(buf, w_gate)
    up = torch.bmm(buf, w_up)
    h = (F.silu(gate.float()) * up.float()).to(buf.dtype)
    return torch.bmm(h, w_down).to(buf.dtype)


def combine(out_buf: torch.Tensor, r: Route, e0: int, e1: int
            ) -> torch.Tensor:
    """The gate-weighted sum over the slots of the outputs of experts
    [e0, e1), f32 ``(T, d)``: the whole output over every expert, a
    partial sum over a shard's."""
    t, k = r.gates.shape
    idx, mine = _local(r, e0, e1, r.logits.shape[1])
    yk = out_buf[idx, r.flat_pos]                             # (T*k, d)
    yk = torch.where(mine[:, None], yk, 0)
    return (yk.reshape(t, k, -1).float() * r.gates[..., None]).sum(1)


def lb_loss(r: Route) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss ``E * sum(me * ce)``, ``me``
    the mean router probabilities of these tokens."""
    me = torch.softmax(r.logits, -1).mean(0)                  # (E,)
    return r.ce.shape[0] * (me * r.ce).sum()


def moe_ffn(p: Params, x: torch.Tensor, cfg: MoEConfig,
            capacity_factor: Optional[float] = None, routing=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (T, d) flattened tokens -> (T, d), plus ``{"lb_loss",
    "drop_frac"}``.  Tokens over capacity are dropped (their output is 0;
    the residual upstream carries them through).  ``routing`` (see
    ``route``) makes ``x`` one member's share of a larger routing set."""
    e = cfg.n_experts
    r = route(x, p["router"], cfg, capacity_factor, routing)
    out_buf = experts(dispatch(x, r, 0, e), p["w_gate"], p["w_up"],
                      p["w_down"])
    y = combine(out_buf, r, 0, e).to(x.dtype)
    return y, {"lb_loss": lb_loss(r), "drop_frac": r.drop_frac}
