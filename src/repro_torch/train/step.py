"""LM train and serve steps on one device (port of ``repro.train.step``).

Train: gradient accumulation over microbatches (a Python loop where the
reference runs ``lax.scan``), per-layer activation checkpointing inside
the model (``models/transformer.py``), AdamW from ``train/optimizer.py``.
PyTorch runs eagerly, so there is nothing to jit: the step updates the
model's parameters and the moments in place, one leaf at a time
(``optimizer.adamw_update_``), which is what the reference's donated
state buys it.  Accumulation is in f32, or in bf16 under
``grad_compression="bf16"`` (halving the accumulator; the update math
stays f32); a single microbatch's gradients are used as they come, in the
parameters' dtype, as the reference's ``n_mb == 1`` branch does.

The model owns its parameters: ``TrainState.params`` is the model's own
``named_parameters()`` (``init_train_state``), so the step differentiates
the model directly and checkpointed layers recompute with the updated
weights.  The sharding hooks and specs are the reference's names at one
device (``parallel/``); ``lower_train_step`` and ``lower_serve_step`` wait
for the port of ``launch/dryrun`` (ROADMAP §1 item 4).

Serve: ``build_prefill_step`` (last-position logits and the cache) and
``build_decode_step`` (one token), both without gradients and both under
the mesh's hooks.  The reference's ``seq_shard_activations`` plan field
waits with the hooks' sharding for ROADMAP §1 item 6.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.models import transformer as T
from repro_torch.parallel import ctx, sharding
from repro_torch.train import optimizer as opt

F32 = torch.float32


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]      # the model's own parameters
    opt: opt.OptState


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """Per-(arch x shape) execution plan — the runtime knobs."""
    n_microbatches: int = 1
    grad_compression: Optional[str] = None   # None | "bf16"
    skip_update: bool = False                # grads only, no update
    tp: bool = True                          # False = small-scene DP grain


def default_plan(cfg: ArchConfig, shape_name: str, mesh) -> StepPlan:
    """The reference's cluster mapping: small-d_model trains take the DP
    grain (``tp=False``), microbatches sized so the per-shard microbatch
    stays small at big d_model (a divisor of the global batch), bf16
    gradient compression at 30 B parameters and above."""
    kind = SHAPES[shape_name]["kind"]
    tp = not (kind == "train" and cfg.d_model < 4096)
    b = SHAPES[shape_name]["global_batch"]
    dp = sharding.dp_size(mesh) * (1 if tp else
                                   sharding.model_axis_size(mesh))
    per_shard_target = 2 if cfg.d_model >= 6144 else 4
    n_mb = max(1, b // max(dp * per_shard_target, 1))
    while b % n_mb:
        n_mb -= 1
    compress = "bf16" if cfg.param_count() >= 30e9 else None
    return StepPlan(n_microbatches=n_mb, grad_compression=compress, tp=tp)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE as mask and sum instead of a gather (the reference's
    vocab-parallel-safe form)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, -1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    picked = torch.where(iota == labels[..., None].long(), logits,
                         0.0).sum(-1)
    return (lse - picked).mean()


def loss_fn(model: T.LM, batch: Mapping[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = model(tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"))
    ce = cross_entropy(logits, batch["labels"])
    return ce + T.AUX_LOSS_WEIGHT * aux, {"ce_loss": ce, "moe_aux": aux}


def init_train_state(model: T.LM, moments_dtype: str = "float32"
                     ) -> TrainState:
    """The model's parameters by name and zeroed AdamW moments."""
    params = dict(model.named_parameters())
    return TrainState(params, opt.init_opt_state(params, moments_dtype))


def to_device(batch: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``; integer leaves
    (tokens, labels) as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                            else v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# Train step builder
# ---------------------------------------------------------------------------
def build_train_step(cfg: ArchConfig, mesh, opt_cfg: opt.AdamWConfig,
                     plan: StepPlan, model: T.LM
                     ) -> Tuple[Callable, Dict[str, Callable]]:
    """Returns ``(train_step, hooks)``: ``train_step(state, batch) ->
    (state, metrics)`` over ``model`` (trainable, its parameters those of
    ``state.params``), the batch split into ``plan.n_microbatches``
    consecutive slices; call it under ``ctx.activation_sharding(hooks)``.
    ``metrics`` holds 0-d tensors: loss, ce_loss, moe_aux, grad_norm
    (before clipping), lr; under ``skip_update`` only loss and grads."""
    hooks = ctx.residual_hooks(mesh)
    names = [k for k, _ in model.named_parameters()]
    acc_dtype = torch.bfloat16 if plan.grad_compression == "bf16" else F32

    def one_microbatch(mb):
        leaves = [p for _, p in model.named_parameters()]
        with torch.enable_grad():
            loss, stats = loss_fn(model, mb)
            grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in stats.items()},
                dict(zip(names, grads)))

    def train_step(state: TrainState, batch):
        if any(state.params[k] is not p
               for k, p in model.named_parameters()):
            raise ValueError("state.params are not the model's own "
                             "parameters (build the state with "
                             "init_train_state(model))")
        batch = to_device(batch, next(iter(state.params.values())).device)
        n_mb = plan.n_microbatches
        if n_mb == 1:
            loss, stats, grads = one_microbatch(batch)
        else:
            grads, l_acc, all_stats = {}, 0.0, []
            for i in range(n_mb):
                mb = {k: v.reshape(n_mb, v.shape[0] // n_mb,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                loss, stats, g = one_microbatch(mb)
                for k in names:
                    if k in grads:
                        grads[k].add_(g.pop(k).to(acc_dtype))
                    else:
                        grads[k] = g.pop(k).to(acc_dtype)
                l_acc = l_acc + loss
                all_stats.append(stats)
            for g in grads.values():
                g.div_(n_mb)
            loss = l_acc / n_mb
            stats = {k: torch.stack([s[k] for s in all_stats]).mean()
                     for k in all_stats[0]}
        if plan.skip_update:
            return state, {"loss": loss, "grads": grads}
        metrics = opt.adamw_update_(opt_cfg, state.params, grads, state.opt)
        return state, dict(metrics, loss=loss, **stats)

    return train_step, hooks


def state_pspecs(cfg: ArchConfig, state: TrainState, mesh,
                 tp: bool = True) -> TrainState:
    """The state's specs: the moments mirror the parameters'."""
    pspec = sharding.param_pspecs(cfg, state.params, mesh, tp)
    return TrainState(params=pspec, opt=opt.OptState(m=pspec, v=pspec,
                                                     step=()))


def jit_train_step(cfg: ArchConfig, shape_name: str, mesh, plan: StepPlan,
                   opt_cfg: opt.AdamWConfig, model: T.LM
                   ) -> Tuple[Callable, Dict[str, Callable], TrainState]:
    """The reference jits the step with explicit shardings and the state
    donated.  Eagerly there is nothing to compile and the step already
    updates the state in place, so this returns ``build_train_step``'s
    step with its hooks and the state's specs: ``(step, hooks, sspec)``
    (``shape_name`` is kept for the reference's signature)."""
    if shape_name not in SHAPES:
        raise KeyError(f"unknown shape {shape_name!r}")
    step_fn, hooks = build_train_step(cfg, mesh, opt_cfg, plan, model)
    state = TrainState(dict(model.named_parameters()), None)
    return step_fn, hooks, state_pspecs(cfg, state, mesh, plan.tp)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------
def build_prefill_step(mesh) -> Callable:
    """``prefill_step(model, batch) -> (last-position logits, cache)``,
    run under ``mesh``'s hooks."""
    hooks = ctx.residual_hooks(mesh)

    @torch.no_grad()
    def prefill_step(model: T.LM, batch):
        with ctx.activation_sharding(hooks):
            logits, cache = model.prefill(tokens=batch.get("tokens"),
                                          embeds=batch.get("embeds"))
        return logits[:, -1], cache

    return prefill_step


def build_decode_step(mesh) -> Callable:
    """``decode_step(model, cache, batch) -> (logits, cache)``, run under
    ``mesh``'s hooks; the cache is updated in place."""
    hooks = ctx.residual_hooks(mesh)

    @torch.no_grad()
    def decode_step(model: T.LM, cache, batch):
        with ctx.activation_sharding(hooks):
            logits, new_cache = model.decode_step(
                cache, batch["position"], tokens=batch.get("tokens"),
                embeds=batch.get("embeds"))
        return logits[:, -1], new_cache

    return decode_step
