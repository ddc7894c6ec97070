"""LM training launcher (port of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch A [--smoke] [--steps N] \\
        [--shape train_4k] [--ckpt-dir D] [--ckpt-every N] [--device cpu]

``--smoke`` runs the reduced config at batch 8, seq 64 in 2 microbatches
(the reference's smoke setting).  Without it the full-width config trains
at the shape's sequence length (4096 for ``train_4k``) with the global
batch cut to what one card holds (``FULL_WIDTH_BATCH`` in
``FULL_WIDTH_MICROBATCHES`` microbatches: 2 of 1; the reference's 256
needs its 256-chip mesh), and the cut is printed.  Weights are seeded
(seed 0) on the device, the data is ``SyntheticLM``; moments are f32
below 30 B parameters and bf16 above, as the reference sets them.  ``--device`` defaults to the card;
``--device cpu`` runs the kernels' plain versions.  Checkpoints are
written only with ``--ckpt-dir`` (a run resumes from its latest).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional, Sequence

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ALIASES, get_config, reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.parallel import ctx
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as O
from repro_torch.train import step as S
from repro_torch.train.ft import StragglerMonitor, restore_into

# the full-width cut for one card: global batch 2 in 2 microbatches of 1
FULL_WIDTH_BATCH = 2
FULL_WIDTH_MICROBATCHES = 2


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(ALIASES))
    ap.add_argument("--shape", default="train_4k",
                    choices=[k for k, v in SHAPES.items()
                             if v["kind"] == "train"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, batch 8, seq 64, 2 microbatches")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Runs the launcher; returns the loss of every step it ran."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    mesh = make_host_mesh(device)
    if args.smoke:
        cfg = reduced(get_config(args.arch))
        batch_size, seq = 8, 64
        plan = S.StepPlan(n_microbatches=2, tp=False)
    else:
        cfg = get_config(args.arch)
        batch_size, seq = FULL_WIDTH_BATCH, SHAPES[args.shape]["seq_len"]
        # default_plan sizes its microbatches for the shape's global batch;
        # the cut batch takes the cut's microbatches
        plan = dataclasses.replace(S.default_plan(cfg, args.shape, mesh),
                                   n_microbatches=FULL_WIDTH_MICROBATCHES)
        print(f"{cfg.name}: global batch cut from "
              f"{SHAPES[args.shape]['global_batch']} to {batch_size} "
              f"({FULL_WIDTH_MICROBATCHES} microbatches of "
              f"{batch_size // FULL_WIDTH_MICROBATCHES}) at seq {seq}, to "
              f"fit one device")

    if not cfg.embed_inputs:
        raise SystemExit(f"{cfg.name} takes embeddings, not tokens; the "
                         f"launcher's data (SyntheticLM) is tokens")
    opt_cfg = O.AdamWConfig(total_steps=args.steps,
                            moments_dtype="bfloat16"
                            if cfg.param_count() >= 30e9 else "float32")
    data = SyntheticLM(cfg.vocab, batch_size, seq)
    monitor = StragglerMonitor()
    model = T.init_params(cfg, seed=0, device=device, trainable=True)
    state = S.init_train_state(model, opt_cfg.moments_dtype)
    jstep, hooks, _ = S.jit_train_step(cfg, args.shape, mesh, plan, opt_cfg,
                                       model)
    start = 0
    last = ckpt.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if last is not None:
        state, extra = restore_into(args.ckpt_dir, last, state)
        start = extra["next_step"]
        print(f"resumed at step {start}")
    losses = []
    with ctx.activation_sharding(hooks):
        for step in range(start, args.steps):
            batch = data.batch_at(step)
            t0 = time.time()
            state, metrics = jstep(state, batch)
            loss = float(metrics["loss"])            # waits for the device
            dt = time.time() - t0
            losses.append(loss)
            if monitor.record(step, dt):
                print(f"straggler at step {step}: {dt:.2f}s")
            if step % 10 == 0 or step + 1 == args.steps:
                print(f"step {step:5d} loss={loss:.4f} {dt * 1e3:.0f}ms")
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                ckpt.save(args.ckpt_dir, step + 1, state,
                          extra={"next_step": step + 1})
                ckpt.retain(args.ckpt_dir)
    print("training complete")
    return losses


if __name__ == "__main__":
    main()
