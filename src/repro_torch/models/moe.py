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
from typing import Dict, Mapping, Optional, Tuple

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


def moe_ffn(p: Params, x: torch.Tensor, cfg: MoEConfig,
            capacity_factor: Optional[float] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (T, d) flattened tokens -> (T, d), plus ``{"lb_loss",
    "drop_frac"}``.  Tokens over capacity are dropped (their output is 0;
    the residual upstream carries them through)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t, capacity_factor)

    logits = x.float() @ p["router"]                          # (T, E) f32
    gates, idx = route_topk(logits, k)                        # (T, k)

    # position of each (token, slot) in its expert, token-major order
    flat_idx = idx.reshape(-1)                                # (T*k,)
    pos = F.one_hot(flat_idx, e).cumsum(0) - 1                # (T*k, E)
    flat_pos = pos.gather(1, flat_idx[:, None])[:, 0]
    keep = flat_pos < cap
    flat_pos = torch.where(keep, flat_pos, 0)

    xk = x.repeat_interleave(k, dim=0)                        # (T*k, d)
    buf = x.new_zeros((e, cap, d))
    buf.index_put_((flat_idx, flat_pos),
                   torch.where(keep[:, None], xk, 0), accumulate=True)

    # expert SwiGLU in the IO dtype (f32 accumulation inside)
    gate = torch.bmm(buf, p["w_gate"])
    up = torch.bmm(buf, p["w_up"])
    h = (F.silu(gate.float()) * up.float()).to(x.dtype)
    out_buf = torch.bmm(h, p["w_down"]).to(x.dtype)

    yk = out_buf[flat_idx, flat_pos]                          # (T*k, d)
    yk = torch.where(keep[:, None], yk, 0)
    y = (yk.reshape(t, k, d).float() * gates[..., None]).sum(1).to(x.dtype)

    # Switch-style load-balance auxiliary loss
    me = torch.softmax(logits, -1).mean(0)                    # (E,)
    ce = torch.zeros(e, dtype=F32, device=x.device).index_add_(
        0, flat_idx, keep.float()) / max(t * k, 1)
    return y, {"lb_loss": e * (me * ce).sum(),
               "drop_frac": 1.0 - keep.float().mean()}
