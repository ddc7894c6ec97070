"""Bursty multi-client whole-model CNN serving through a ``ConvScheduler``.

Port of ``examples/serve_cnn.py``, on the card unless ``--device cpu`` is
given.  Clients hold ``ModelSession`` handles against registered nets
(chained conv-scene pipelines from the paper CNNs) and fire single images
with per-client latency deadlines; the scheduler coalesces concurrent
requests along B, carries the activation through every layer in plan
layout, and flushes partial buckets when a deadline approaches.  Every
(layer x bucket) plan — pruned ladder and the full flush ladder — is
prewarmed at startup, from the scene lists or from a saved registry
artifact on restart, so the trace runs at steady state: zero plan builds,
zero schedule resolutions.

The trace has three phases: bursty deadline traffic, an **overload** burst
that exceeds the bounded queue (sheds are counted and surface as
``Overloaded`` at the submitter), and a recovery burst that must shed
nothing.  Every accepted result is asserted bitwise-identical (f32) to
dispatching the same image layer-by-layer through B=1 plans.

By default the nets are served at the paper's widths (``--max-hw`` and
``--max-ch`` 0: no cap); a CPU run passes caps.

    python -m repro_torch.examples.serve_cnn [--device cpu --max-hw 8 \\
        --max-ch 8] --nets alexnet,resnet --bursts 6 --clients 8 \\
        --artifact mg3m_serve_plans.json
"""
from __future__ import annotations

import argparse
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.cnn import cnn_chain_scenes
from repro_torch.serve.sched import ConvScheduler, Overloaded, SchedConfig

# per-client latency budget: a full-width pipeline dispatch takes a few
# milliseconds on the card (PERF.md §6), so 80 ms leaves deadline flushes
# room to gather requests
DEADLINE_S = 0.08


def build_scheduler(args) -> ConvScheduler:
    # slack=0 keeps the full pow2 ladder on these demo scenes (the model
    # would prune overhead-dominated rungs; see bucket_ladder); the
    # occupancy target then must be explicit — the unpruned sweet spot is
    # rung 1, which would flush every request solo and never exercise
    # deadline gathering
    sched = ConvScheduler(
        max_batch=args.max_batch, ladder_slack=0.0, strict=True,
        device=args.device,
        config=SchedConfig(max_queue=args.max_queue,
                           occupancy_target=args.max_batch,
                           flush_margin_s=0.01))
    for net in args.nets.split(","):
        sched.register_net(
            net, cnn_chain_scenes(net, max_hw=args.max_hw,
                                  max_ch=args.max_ch,
                                  layers_per_net=args.layers_per_net))
    return sched


def first_scene(sched: ConvScheduler, net: str):
    """The net's first-layer scene — the input-shape source for clients."""
    return sched._layers[sched.nets()[net][0]].base


def _image(sc, seed: int) -> torch.Tensor:
    return torch.randn((sc.inH, sc.inW, sc.IC),
                       generator=torch.Generator().manual_seed(seed))


def burst_phase(sched: ConvScheduler, sessions, *, bursts: int,
                clients: int, seed: int) -> List:
    """Each burst: 1..clients one-image requests against random nets, each
    carrying a deadline — the arrival pattern deadline flush exists for."""
    rng = random.Random(seed)
    nets = sorted(sessions)
    accepted = []
    for _ in range(bursts):
        reqs = []
        for _ in range(rng.randint(1, clients)):
            net = rng.choice(nets)
            x = _image(first_scene(sched, net), len(accepted) + len(reqs))
            reqs.append(sessions[net].submit(x, deadline_s=DEADLINE_S))
        sched.wait(reqs)
        accepted.extend(reqs)
    return accepted


def overload_phase(sched: ConvScheduler, sessions, *, max_queue: int
                   ) -> Tuple[List, int]:
    """Flood a stopped scheduler far past its bounded queue: the overflow
    sheds (``Overloaded`` at the submitter under reject-newest), the
    accepted prefix completes once the loop resumes — targeted loss, not
    unbounded queue growth."""
    sched.stop()
    net = sorted(sessions)[0]
    x = _image(first_scene(sched, net), 999)
    accepted, shed = [], 0
    for _ in range(2 * max_queue):
        try:
            accepted.append(sessions[net].submit(x))
        except Overloaded:
            shed += 1
    sched.start()
    sched.wait(accepted)
    return accepted, shed


def assert_parity(sched: ConvScheduler, reqs) -> None:
    """Every accepted result must be bitwise what layer-by-layer B=1
    dispatch produces — coalescing, padding, and pipelining are layout
    moves, never numeric ones."""
    for r in reqs:
        ref = r.x    # submit normalized this to [H, W, C, b] on the device
        for lname in sched.nets()[r.net]:
            fam = sched._layers[lname]
            plan = sched.registry.get_or_build(fam.base.with_batch(1))
            ref = plan.execute(ref, fam.flt)
        ref = ref[..., 0] if r._squeeze else ref
        if not torch.equal(r.out, ref):
            raise AssertionError(f"request {r.rid} (net {r.net}) diverged "
                                 f"from per-layer dispatch")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_cnn",
        description=__doc__.splitlines()[0])
    ap.add_argument("--nets", default="alexnet,resnet",
                    help="comma-separated subset of the six paper CNNs")
    ap.add_argument("--layers-per-net", type=int, default=3)
    ap.add_argument("--max-hw", type=int, default=0,
                    help="spatial cap (0: the paper's widths)")
    ap.add_argument("--max-ch", type=int, default=0,
                    help="channel cap (0: the paper's widths)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=16,
                    help="bounded-queue admission limit (overload phase "
                         "floods past it)")
    ap.add_argument("--bursts", type=int, default=6)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--artifact", default="",
                    help="registry artifact: prewarm from it when present, "
                         "save to it after (restart flow)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Runs the three phases; returns the scheduler, its stats after the
    bursts, the overload and the recovery, the accepted and shed counts,
    and the plans built at prewarm; every accepted result was checked
    bitwise against per-layer B=1 dispatch."""
    args = parse_args(argv)
    sched = build_scheduler(args)
    layers = sched._layers

    t0 = time.perf_counter()
    built = sched.prewarm(artifact=args.artifact or None, compile=True)
    print(f"prewarmed {len(layers)} layers in {time.perf_counter() - t0:.1f}s "
          f"({built} plans built, rest pinned from artifact)")
    print(sched.describe())

    sessions = {net: sched.session(net) for net in sched.nets()}
    sched.start()
    t0 = time.perf_counter()
    accepted = burst_phase(sched, sessions, bursts=args.bursts,
                           clients=args.clients, seed=args.seed)
    wall = time.perf_counter() - t0
    s = sched.stats()
    print(f"served {len(accepted)} model requests in {wall:.2f}s: "
          f"{s['dispatches']} pipeline dispatches, "
          f"{s['mean_batch']:.1f} req/dispatch, "
          f"deadline flushes {s['deadline_flushes']}, "
          f"misses {s['deadline_misses']}/{s['deadline_requests']}")

    over_accepted, shed = overload_phase(sched, sessions,
                                         max_queue=args.max_queue)
    s1 = sched.stats()
    print(f"overload: {len(over_accepted)} accepted, {shed} shed "
          f"(Overloaded at submitter), counter={s1['shed']:.0f}")
    if not (shed > 0 and s1["shed"] == shed):
        raise AssertionError("overload burst must shed")
    accepted.extend(over_accepted)

    recovered = burst_phase(sched, sessions, bursts=1,
                            clients=args.clients, seed=args.seed + 1)
    s2 = sched.stats()
    if s2["shed"] != s1["shed"]:
        raise AssertionError("recovery burst must not shed")
    print(f"recovered: {len(recovered)} requests, 0 shed")
    accepted.extend(recovered)
    sched.stop()

    assert_parity(sched, accepted)
    print(f"parity OK: {len(accepted)} accepted results bitwise-identical "
          f"to per-layer B=1 dispatch")
    print(f"steady state: plan_misses={s2['plan_misses']} "
          f"plan_builds={s2['plan_builds']} "
          f"registry hit_rate={s2['registry']['hit_rate']:.2f}")
    if s2["plan_misses"] != 0 or s2["plan_builds"] != 0:
        raise AssertionError(
            "a prewarmed scheduler must serve without building plans")

    if args.artifact:
        path = sched.save(args.artifact)
        print(f"saved plan repository -> {path} (next start prewarms from "
              f"it: pinned choices, zero schedule resolutions)")
    print("OK")
    return {"sched": sched, "built": built, "stats": (s, s1, s2),
            "accepted": len(accepted), "shed": shed}


if __name__ == "__main__":
    main()
