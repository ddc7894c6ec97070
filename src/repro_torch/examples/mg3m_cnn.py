"""Paper-faithful example: train a small CNN classifier whose every
convolution runs through MG3MConv, with the per-layer execution plans
(fprop + dgrad + wgrad, each through the multi-grained selector) built
once before training starts.

Port of ``examples/mg3m_cnn.py``, on the card unless ``--device cpu`` is
given.  Training always goes through the plans: on the card every
direction of every layer launches the MG3M kernels, with ``--device cpu``
the same plans run their plain versions.

    python -m repro_torch.examples.mg3m_cnn [--device cpu] --steps 30
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.cnn import (init_small_cnn, small_cnn_forward,
                                    small_cnn_plans)
from repro_torch.train import optimizer as O

Params = Dict[str, torch.Tensor]


def make_data(gen: torch.Generator, n: int, res: int,
              device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Separable synthetic task: each image = noise + its class template."""
    y = torch.randint(0, 10, (n,), generator=gen)
    templates = torch.randn((10, res, res, 3), generator=gen)
    x = 0.5 * torch.randn((n, res, res, 3), generator=gen) + templates[y]
    return x.to(device), y.to(device)


def loss_fn(p: Params, x: torch.Tensor, y: torch.Tensor,
            plans) -> torch.Tensor:
    """Mean cross-entropy of the planned forward."""
    logits = small_cnn_forward(p, x, use_kernels=True, plans=plans)
    lp = F.log_softmax(logits, dim=-1)
    return -lp.gather(1, y[:, None]).mean()


def train_steps(params: Params, opt_state: O.OptState, xs: torch.Tensor,
                ys: torch.Tensor, plans, opt_cfg: O.AdamWConfig, *,
                steps: int, batch: int,
                log: Optional[Callable[[int, float, float], None]] = None
                ) -> Tuple[Params, O.OptState, List[float]]:
    """``steps`` AdamW steps through ``plans`` on the reference's window
    of ``(xs, ys)`` at step i (rows ``[lo, lo + batch)``, ``lo = i * batch
    mod (n - batch)``); returns the new params, optimizer state and each
    step's loss.  ``log(i, loss, ms)`` sees every step."""
    names = sorted(params)
    n = xs.shape[0]
    losses = []
    for i in range(steps):
        lo = (i * batch) % (n - batch)
        t0 = time.perf_counter()
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(p, xs[lo:lo + batch], ys[lo:lo + batch], plans)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        with torch.no_grad():
            params, opt_state, _ = O.adamw_update(
                opt_cfg, params, dict(zip(names, grads)), opt_state)
        losses.append(float(loss.detach()))
        if log is not None:
            log(i, losses[-1], (time.perf_counter() - t0) * 1e3)
    return params, opt_state, losses


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.mg3m_cnn",
        description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--res", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Trains; returns the plans, every step's loss and the accuracy."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    params = init_small_cnn(torch.Generator().manual_seed(0), device=device)

    # Plan every layer ONCE, all three directions; training then never
    # re-runs schedule resolution, and the table shows what the selector
    # picked per layer and direction.
    plans = small_cnn_plans(params, args.batch, args.res, device=device)
    for name, triple in plans.items():
        print(f"{name}: fprop={triple.fprop.schedule or 'plain'} "
              f"dgrad={triple.dgrad.schedule or 'plain'} "
              f"wgrad={triple.wgrad.schedule or 'plain'} "
              f"for {triple.scene.describe()}")
    xs, ys = make_data(torch.Generator().manual_seed(1), 512, args.res,
                       device)

    # Adam via the framework optimizer (train/optimizer.py)
    opt_cfg = O.AdamWConfig(lr=args.lr, weight_decay=0.0, warmup_steps=2,
                            total_steps=args.steps)
    opt_state = O.init_opt_state(params)

    def log(i, loss, ms):
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d} loss={loss:.4f} ({ms:.0f}ms)")

    params, opt_state, losses = train_steps(
        params, opt_state, xs, ys, plans, opt_cfg, steps=args.steps,
        batch=args.batch, log=log)

    with torch.no_grad():
        logits = small_cnn_forward(params, xs[:256], use_kernels=True)
    acc = float((logits.argmax(-1) == ys[:256]).float().mean())
    print(f"train accuracy: {acc:.1%}")
    if not acc > 0.2:
        raise AssertionError("should beat 10% chance comfortably")
    print("OK")
    return {"plans": plans, "losses": losses, "acc": acc}


if __name__ == "__main__":
    main()
