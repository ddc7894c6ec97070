"""Plan-driven CNN training launcher (port of ``repro.launch.train_cnn``).

    python -m repro_torch.launch.train_cnn [--device cpu] [--steps N] \
        [--model small|vgg] [--sharded] [--ckpt-dir DIR] \
        [--metrics-out PATH] [--check-loss] [--no-strict]

Every fprop/dgrad/wgrad of the run dispatches through a prewarmed
``ConvPlan`` (``train/cnn.py`` over a ``ModelPlans``): the plans are built
once for the microbatch geometry before step 0, the first step warms up,
and under ``--strict`` (the default) the remaining steps run inside a
``resolution_guard`` that raises if a schedule is resolved in steady
state.  The defaults train the small 3-conv CNN on step-indexed synthetic
images with class structure, so the loss genuinely descends
(``--check-loss`` fails the run otherwise).

``--device`` defaults to the card (``cuda``), where the convolutions run
on the MG3M CUDA kernels; ``--device cpu`` runs their plain versions.
``--sharded`` builds ring-sharded plan triples (``repro_torch.shard``)
over the device ring: every visible card, or on the CPU a ring of
``CPU_RING`` CPU devices (the reference's forced 8-device host).  The run
records the ``repro.train.*`` metrics, streams every plan's (predicted,
measured) seconds into the drift monitor, and can dump both as one obs
artifact (``--metrics-out``).
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.core.autodiff import make_model_plans
from repro_torch.data.pipeline import SyntheticImages
from repro_torch.device import resolve_device
from repro_torch.models import cnn as M
from repro_torch.obs.drift import default_monitor
from repro_torch.obs.metrics import default_metrics
from repro_torch.plan.registry import default_registry
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import cnn as tc
from repro_torch.train.optimizer import AdamWConfig


#: CPU devices in the ``--sharded`` ring with ``--device cpu``
CPU_RING = 8


def device_ring(args, device: torch.device):
    """The ``--sharded`` ring: every visible card, or ``CPU_RING`` copies
    of the CPU device; None when not sharded."""
    if not args.sharded:
        return None
    if device.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (device,) * CPU_RING


def build_model(args, device: torch.device):
    """(params, plans, layer_order) for the requested model/geometry —
    plans built for the *microbatch* batch size on ``device`` (over its
    ring with ``--sharded``)."""
    mb = args.batch // args.microbatches
    devices = device_ring(args, device)
    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "small":
        params = M.init_small_cnn(gen, in_ch=args.channels,
                                  n_classes=args.classes, width=args.width,
                                  device=device)
        plans = M.small_cnn_plans(params, mb, args.res, policy=args.policy,
                                  device=device, devices=devices)
    else:
        scenes = M.vgg_style_scenes(
            mb, res=args.res, in_ch=args.channels,
            stages=((args.width, 1), (args.width * 2, 2),
                    (args.width * 4, 2)))
        params = M.init_cnn_from_scenes(gen, scenes, n_classes=args.classes,
                                        device=device)
        plans = make_model_plans(scenes, policy=args.policy, device=device,
                                 devices=devices)
    return params, plans, plans.names()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train_cnn")
    ap.add_argument("--model", default="small", choices=("small", "vgg"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--res", type=int, default=8)
    ap.add_argument("--channels", type=int, default=3)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default="analytic")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the MG3M CUDA kernels) or cpu "
                         "(their plain PyTorch versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="kept for parity with the reference's launcher; "
                         "the defaults are smoke-sized")
    ap.add_argument("--sharded", action="store_true",
                    help="ring-sharded plan triples over every visible "
                         "card (with --device cpu: CPU_RING CPU devices)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="",
                    help="dump metrics + drift snapshot as one obs artifact")
    ap.add_argument("--check-loss", action="store_true",
                    help="exit nonzero unless the loss decreased")
    ap.add_argument("--no-strict", dest="strict", action="store_false",
                    help="disable the steady-state zero-resolution guard")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Run the launcher on ``argv`` (default ``sys.argv[1:]``); returns
    the loss of every step run."""
    args = parser().parse_args(argv)
    if args.batch % args.microbatches:
        raise ValueError(f"--batch {args.batch} not divisible by "
                         f"--microbatches {args.microbatches}")
    device = resolve_device(args.device)

    m = default_metrics()
    params, plans, layer_order = build_model(args, device)
    ref_ops = plans.reference_ops
    if ref_ops:
        print(f"reference fallbacks: {ref_ops}")
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=2,
                          total_steps=max(args.steps, 1))
    buckets = tc.make_grad_buckets(params)
    step_fn = tc.build_cnn_train_step(plans, opt_cfg,
                                      n_microbatches=args.microbatches,
                                      buckets=buckets,
                                      layer_order=layer_order)
    jstep = tc.jit_train_step(step_fn)
    state = tc.init_train_state(params)
    data = SyntheticImages(args.batch, args.res, args.channels,
                           args.classes, seed=args.seed, noise=0.3)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(device)
                for k, v in data.batch_at(i).items()}

    start = 0
    if args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            state, extra = ckpt.restore(args.ckpt_dir, last, state)
            start = extra["next_step"]
            print(f"resumed at step {start}")

    losses: List[float] = []

    def run_step(i):
        nonlocal state
        batch = batch_at(i)
        t0 = time.perf_counter()
        state, metrics = jstep(state, batch)
        loss = float(metrics["loss"])        # waits for the step to finish
        tc.observe_step(time.perf_counter() - t0, loss, args.batch, m)
        losses.append(loss)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={loss:.4f} "
                  f"acc={float(metrics['accuracy']):.2f}")
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, i + 1, state,
                      extra={"next_step": i + 1, "loss": loss})
            ckpt.retain(args.ckpt_dir)

    if start < args.steps:
        run_step(start)                      # warm-up (plans prewarmed)
    if args.strict:
        with tc.resolution_guard(m):
            for i in range(start + 1, args.steps):
                run_step(i)
    else:
        for i in range(start + 1, args.steps):
            run_step(i)

    # sharded triples build outside the registry — hit rate only means
    # something for the one-device plan path
    hit_rate = (tc.observe_plan_hit_rate(default_registry(device), metrics=m)
                if not args.sharded else float("nan"))
    if start < args.steps:
        mb = args.batch // args.microbatches
        mb_batch = {k: v[:mb] for k, v in batch_at(0).items()}
        breakdown = tc.profile_step_breakdown(state, mb_batch, plans,
                                              opt_cfg,
                                              layer_order=layer_order,
                                              metrics=m)
        fed = tc.feed_drift_from_plans(plans)
        print(f"plan_hit_rate={hit_rate:.3f} "
              f"grads_s={breakdown['grads_s']:.4f} "
              f"update_s={breakdown['update_s']:.4f} drift_pairs={fed}")
    if args.metrics_out:
        path = m.dump(args.metrics_out,
                      extra={"drift": default_monitor().snapshot()})
        print(f"metrics -> {path}")
    if args.check_loss and losses:
        first, last = losses[0], losses[-1]
        if not last < first:
            raise SystemExit(
                f"loss did not decrease: step0 {first:.4f} -> "
                f"final {last:.4f}")
        print(f"loss decreased: {first:.4f} -> {last:.4f}")
    print("training complete")
    return losses


if __name__ == "__main__":
    main()
