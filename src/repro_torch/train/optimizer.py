"""AdamW with global-norm clipping, written out (port of
``repro.train.optimizer``).

Functions on flat ``{name: tensor}`` parameter dicts, with the reference's
f32 math in the reference's order: the gradient is scaled by the global
clip factor inside the per-leaf update, the moments update, bias
correction divides them, and decoupled weight decay adds ``wd * p`` to the
step before the learning rate multiplies it.  ``torch.optim.AdamW`` applies
the decay as a separate ``p *= 1 - lr * wd`` and clips nothing, so it is
not used.  The step count and the learning rate stay tensors on the
parameters' device, so an update reads nothing back to the host.  The
update is functional: it returns new tensors and leaves its inputs alone.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from repro_torch.device import torch_dtype

F32 = torch.float32
Tree = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # "bfloat16" halves optimizer-state memory; the update math still runs
    # in f32 (moments upcast per leaf).
    moments_dtype: str = "float32"


class OptState(NamedTuple):
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: torch.Tensor          # int32 scalar on the parameters' device


def _names(tree: Tree) -> Tuple[str, ...]:
    """Leaf order: sorted keys, the order of the reference's pytree
    flattening (it matters to the global norm's sum)."""
    return tuple(sorted(tree))


def init_opt_state(params: Tree, moments_dtype: str = "float32") -> OptState:
    dt = torch_dtype(moments_dtype)
    first = next(iter(params.values()))
    return OptState(
        m={k: torch.zeros(p.shape, dtype=dt, device=p.device)
           for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=dt, device=p.device)
           for k, p in params.items()},
        step=torch.zeros((), dtype=torch.int32, device=first.device))


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up -> cosine decay to ``min_lr_frac``."""
    step = step.to(F32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(tree[k].to(F32))) for k in _names(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scale, norm); the scale is applied per leaf inside the
    update, so no scaled copy of the gradient tree is ever built."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return scale, norm


def _step_scalars(cfg: AdamWConfig, grads: Tree, state: OptState):
    """(clip scale, grad norm, new step, lr, bias corrections 1 and 2)."""
    scale, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    step_f = step.to(F32)
    bc1 = 1 - torch.pow(torch.full_like(step_f, cfg.beta1), step_f)
    bc2 = 1 - torch.pow(torch.full_like(step_f, cfg.beta2), step_f)
    return scale, gnorm, step, lr, bc1, bc2


def _leaf_update(cfg: AdamWConfig, p, g, m, v, scale, lr, bc1, bc2):
    """One leaf's (param, m, v), f32 math, each stored at its own dtype."""
    b1, b2 = cfg.beta1, cfg.beta2
    g32 = g.to(F32) * scale
    m_new = b1 * m.to(F32) + (1 - b1) * g32
    v_new = b2 * v.to(F32) + (1 - b2) * torch.square(g32)
    mhat = m_new / bc1
    vhat = v_new / bc2
    p32 = p.to(F32)
    p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                      + cfg.weight_decay * p32)
    return p32.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree,
                 state: OptState):
    """Returns ``(new_params, new_state, metrics)``; all math f32 per
    leaf, moments stored at their own dtype, parameters at theirs."""
    scale, gnorm, step, lr, bc1, bc2 = _step_scalars(cfg, grads, state)
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        new_p[k], new_m[k], new_v[k] = _leaf_update(
            cfg, params[k], grads[k], state.m[k], state.v[k], scale, lr,
            bc1, bc2)
    return (new_p, OptState(new_m, new_v, step),
            {"grad_norm": gnorm, "lr": lr})


def adamw_update_(cfg: AdamWConfig, params: Tree, grads: Tree,
                  state: OptState) -> Dict[str, torch.Tensor]:
    """``adamw_update``'s arithmetic written into ``params`` and ``state``
    in place, one leaf at a time, so no second copy of the parameters and
    moments is ever held (a 3 B-parameter model's f32 moments alone are
    24.7 GB).  Returns the metrics."""
    scale, gnorm, step, lr, bc1, bc2 = _step_scalars(cfg, grads, state)
    with torch.no_grad():
        for k, p in params.items():
            new = _leaf_update(cfg, p, grads[k], state.m[k], state.v[k],
                               scale, lr, bc1, bc2)
            for dst, src in zip((p, state.m[k], state.v[k]), new):
                dst.copy_(src)
        state.step.copy_(step)
    return {"grad_norm": gnorm, "lr": lr}
