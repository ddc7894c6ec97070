"""Ring-sharded conv plans end to end (port of ``examples/shard_conv.py``).

Demonstrates the ``repro_torch.shard`` stack on a ring that repeats one
device ``SHARDS`` times (8, the reference's forced 8-device host), on the
card unless ``--device cpu`` is given:

  1. joint (schedule x partition) selection per direction, with the
     collective-aware fallback to n_shards=1;
  2. bitwise / tolerance parity of sharded execution vs the one-device
     plan on every feasible partition axis;
  3. a differentiable layer whose forward AND backward dispatches are
     sharded (``sharded_conv_with_plans``);
  4. ``ConvServer(mesh=...)``: coalesced request buckets partitioned
     across the mesh's data axis with zero steady-state plan resolution.

    python -m repro_torch.examples.shard_conv [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.mapping import select_schedule
from repro_torch.core.scene import ConvScene
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.plan import ConvOp, make_plan
from repro_torch.serve.conv import ConvRequest, server_from_scenes
from repro_torch.shard import (make_sharded_plan, make_sharded_training_plans,
                               pinned_shard_spec, shard_blocker,
                               shard_sub_scene, sharded_conv_with_plans)

SHARDS = 8
SCENE = ConvScene(B=16, IC=16, OC=32, inH=14, inW=14, fltH=3, fltW=3,
                  padH=1, padW=1, stdH=1, stdW=1)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.shard_conv",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Runs the four demonstrations; returns what each one found."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ring = (dev,) * SHARDS
    scene = SCENE
    print(f"ring: {SHARDS} x {dev}   scene: {scene.describe()}\n")
    gen = torch.Generator().manual_seed(0)
    inp = torch.randn(scene.in_shape(), generator=gen).to(dev)
    flt = torch.randn(scene.flt_shape(), generator=gen).to(dev)
    want = make_plan(scene, ConvOp.FPROP, device=dev).execute(inp, flt)

    # -- 1+2: every feasible partition matches the one-device plan --------
    print("forced partitions (parity vs one-device plan):")
    parity = {}
    for axis, n in (("batch", 8), ("oc", 8), ("h", 4), ("ic", 4)):
        if shard_blocker(scene, axis, n):
            continue
        choice = select_schedule(shard_sub_scene(scene, axis, n))
        plan = make_sharded_plan(
            scene, ConvOp.FPROP, devices=ring,
            spec=pinned_shard_spec(scene, ConvOp.FPROP, axis, n, choice))
        got = plan.execute(inp, flt)
        bitwise = torch.equal(got, want)
        if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{plan.shard_tag} differs from the "
                                 f"one-device plan")
        parity[plan.shard_tag] = "bitwise" if bitwise else "tolerance"
        print(f"  {plan.shard_tag:9s} {plan.schedule}  "
              f"coll={plan.spec.collective_bytes:6d}B  "
              f"{parity[plan.shard_tag]} OK")

    # -- joint selection: the selector may decline to shard ----------------
    auto = make_sharded_plan(scene, ConvOp.FPROP, devices=ring)
    print(f"\njoint selector picked: {auto.describe()}")

    # -- 3: sharded training plans + autograd ------------------------------
    plans = make_sharded_training_plans(scene, devices=ring)
    print(f"training partition tags (fprop/dgrad/wgrad): {plans.shard_tags}")
    x = inp.clone().requires_grad_(True)
    w = flt.clone().requires_grad_(True)
    sharded_conv_with_plans(x, w, plans).sum().backward()
    print(f"grad shapes: dIN={tuple(x.grad.shape)} "
          f"dFLT={tuple(w.grad.shape)}")

    # -- 4: mesh-mode serving ----------------------------------------------
    mesh = make_mesh_for(SHARDS, 1, devices=ring)
    server = server_from_scenes({"conv1": scene.with_batch(1)}, mesh=mesh,
                                max_batch=32, strict=True)
    server.prewarm()
    reqs = [ConvRequest(rid=i, layer="conv1",
                        x=torch.randn((scene.inH, scene.inW, scene.IC, b),
                                      generator=gen))
            for i, b in enumerate((3, 5, 8))]
    outs = server.serve(reqs)
    st = server.stats()
    tags = sorted(set(server._shard_tags.values()))
    print(f"\nmesh serving: {len(outs)} requests, "
          f"{st['dispatches']:.0f} dispatch(es), "
          f"plan_misses={st['plan_misses']:.0f} (strict mode), "
          f"tags={tags}")
    return {"parity": parity, "auto": auto.shard_tag,
            "training_tags": plans.shard_tags, "serve_tags": tags,
            "outs": outs, "stats": st}


if __name__ == "__main__":
    main()
