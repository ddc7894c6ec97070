"""End-to-end LM training example.

Port of ``examples/train_lm.py``.  Default: a ~20M-parameter
qwen3-family model (the reduced config widened to ``--d-model`` and
``--layers``), 200 steps on synthetic data, with checkpointing every
``--ckpt-every`` steps and ``--resume`` from the latest checkpoint; a
``StragglerMonitor`` flags slow steps.  On the card unless ``--device
cpu`` is given.

    python -m repro_torch.examples.train_lm --steps 50 [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import List, Optional, Sequence

from repro_torch.configs.registry import get_config, reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import ctx
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as O
from repro_torch.train import step as S
from repro_torch.train.ft import StragglerMonitor, restore_into


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_lm",
        description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Trains; returns the loss of every step this run took."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = reduced(get_config(args.arch))
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model, n_layers=args.layers,
            d_ff=args.d_model * 4,
            n_heads=max(4, args.d_model // 64), n_kv_heads=2, d_head=64)
    mesh = make_host_mesh(device)
    plan = S.StepPlan(n_microbatches=1, tp=False)
    opt_cfg = O.AdamWConfig(lr=args.lr, warmup_steps=20,
                            total_steps=args.steps)
    model = T.init_params(cfg, seed=0, device=device, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M on {device.type}")
    step_fn, hooks = S.build_train_step(cfg, mesh, opt_cfg, plan, model)
    state = S.init_train_state(model)

    start = 0
    last = ckpt.latest_step(args.ckpt_dir) if args.resume else None
    if last is not None:
        state, extra = restore_into(args.ckpt_dir, last, state)
        start = extra["next_step"]
        print(f"resumed from step {start}")

    data = SyntheticLM(cfg.vocab, args.batch, args.seq)
    monitor = StragglerMonitor()
    losses = []
    with ctx.activation_sharding(hooks):
        for step in range(start, args.steps):
            batch = data.batch_at(step)
            t0 = time.time()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])            # waits for the device
            dt = time.time() - t0
            losses.append(loss)
            monitor.record(step, dt)
            if step % 10 == 0 or step == args.steps - 1:
                toks = args.batch * args.seq / dt
                print(f"step {step:4d} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f}ms {toks:.0f} tok/s")
            if (step + 1) % args.ckpt_every == 0:
                ckpt.save(args.ckpt_dir, step + 1, state,
                          extra={"next_step": step + 1})
                ckpt.retain(args.ckpt_dir)
    if monitor.flagged:
        print(f"straggler steps: {monitor.flagged}")
    print("done")
    return losses


if __name__ == "__main__":
    main()
