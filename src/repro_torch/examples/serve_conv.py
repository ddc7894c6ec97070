"""Conv serving with a warm-started plan repository.

Port of ``examples/serve_conv.py``, on the card unless ``--device cpu`` is
given.  A serving process must not pay schedule resolution per request:
it builds (or loads) the per-layer ``ConvPlan``s once, then every request
is pure kernel dispatch.  This example runs the full cycle on a 2-layer
conv model:

  1. warm: build fprop plans for both layers into a ``PlanRegistry``;
  2. serve a burst of requests through ``plan.execute`` and report the
     registry's hit/miss stats;
  3. save the registry as a JSON artifact;
  4. reload it into a FRESH registry (as a restarted server would) and
     serve again — zero plans are rebuilt, zero schedules re-resolved.

    python -m repro_torch.examples.serve_conv [--device cpu] \\
        [--plans mg3m_plans.json]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.scene import ConvScene
from repro_torch.device import resolve_device
from repro_torch.plan import ConvOp, PlanRegistry

LAYERS = {
    "layer0": ConvScene(B=8, IC=3, OC=16, inH=16, inW=16, fltH=3, fltW=3,
                        padH=1, padW=1),
    "layer1": ConvScene(B=8, IC=16, OC=32, inH=16, inW=16, fltH=3, fltW=3,
                        padH=1, padW=1),
}


def _one_pass(registry: PlanRegistry, flts, seed: int,
              device: torch.device) -> torch.Tensor:
    x = torch.randn(LAYERS["layer0"].in_shape(),
                    generator=torch.Generator().manual_seed(seed)).to(device)
    h = registry.get_or_build(LAYERS["layer0"]).execute(x, flts["layer0"])
    # layer0's OUT [outH, outW, OC, B] is exactly layer1's IN layout
    out = registry.get_or_build(LAYERS["layer1"]).execute(
        torch.relu(h), flts["layer1"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def serve_burst(registry: PlanRegistry, requests: int, device: torch.device
                ) -> Tuple[float, float, List[torch.Tensor]]:
    """Run 2-layer forward passes through registered plans.

    Returns ``(cold_ms, warm_ms, outputs)``: the first pass pays the
    one-time costs — on the card the CUDA library's load and, on a fresh
    checkout, the ``nvcc`` build of the kernels — and is reported on its
    own: folding it into the per-request mean would overstate steady-state
    request latency by orders of magnitude (a serving process pays it
    once, not per request)."""
    gen = torch.Generator().manual_seed(0)
    flts = {name: torch.randn(sc.flt_shape(), generator=gen).to(device)
            for name, sc in LAYERS.items()}
    t0 = time.perf_counter()
    outs = [_one_pass(registry, flts, 0, device)]
    cold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for r in range(requests):
        outs.append(_one_pass(registry, flts, 1 + r, device))
    warm_ms = (time.perf_counter() - t0) / requests * 1e3
    return cold_ms, warm_ms, outs


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_conv",
        description=__doc__.splitlines()[0])
    ap.add_argument("--plans",
                    default=os.path.join(tempfile.gettempdir(),
                                         "mg3m_plans.json"),
                    help="plan artifact path, saved then reloaded "
                         "(default: mg3m_plans.json in $TMPDIR)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Serves, saves, reloads and serves again; returns both processes'
    registry stats, cold and warm times and outputs."""
    args = parse_args(argv)
    device = resolve_device(args.device)

    # 1-2. warm build + serve
    reg = PlanRegistry(device=device)
    for name, sc in LAYERS.items():
        plan = reg.get_or_build(sc, ConvOp.FPROP)
        print(f"{name}: {plan.describe()}")
    cold_ms, warm_ms, outs = serve_burst(reg, args.requests, device)
    first = {"cold_ms": cold_ms, "warm_ms": warm_ms, "stats": reg.stats(),
             "outs": outs}
    pays = (", pays the CUDA library's load and, on a fresh checkout, the "
            "kernels' nvcc build" if device.type == "cuda" else "")
    print(f"cold process: cold-start {cold_ms:.1f} ms (first call{pays}), "
          f"then {warm_ms:.2f} ms/request warm, stats={first['stats']}")

    # 3. persist the repository
    path = reg.save(args.plans)
    print(f"saved {len(reg)} plans -> {path}")

    # 4. restart: a fresh registry warm-starts from the artifact
    fresh = PlanRegistry(device=device)
    n = fresh.load(path)
    cold_ms, warm_ms, outs = serve_burst(fresh, args.requests, device)
    stats = fresh.stats()
    print(f"warm-started process ({n} plans loaded): cold-start "
          f"{cold_ms:.1f} ms, then {warm_ms:.2f} ms/request warm, "
          f"stats={stats}")
    if stats["misses"] != 0:
        raise AssertionError("warm start must not rebuild any plan")
    print("OK")
    return {"path": path, "loaded": n, "first": first,
            "second": {"cold_ms": cold_ms, "warm_ms": warm_ms,
                       "stats": stats, "outs": outs}}


if __name__ == "__main__":
    main()
