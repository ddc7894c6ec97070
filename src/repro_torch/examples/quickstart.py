"""Quickstart: the MG3MConv public API — plan-once, execute-many.

Port of ``examples/quickstart.py``, on the card unless ``--device cpu`` is
given:

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core.conv import ConvOp, ConvScene, make_plan, mg3m_conv
from repro_torch.core.mapping import predicted_efficiency
from repro_torch.device import resolve_device
from repro_torch.kernels import ref

SCENE = ConvScene(B=32, IC=48, OC=64, inH=14, inW=14, fltH=3, fltW=3,
                  padH=1, padW=1)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Plans, executes and checks the scene; returns the output and its
    errors against the oracle and the one-shot call."""
    args = parse_args(argv)
    device = resolve_device(args.device)

    # 1. Describe the convolution scene (paper Table 1 symbols).
    scene = SCENE
    print(scene.describe())

    # 2. Build an execution plan ONCE: the multi-grained selector picks a TB
    #    granularity (paper Fig. 14), and every padded/aligned shape is
    #    precomputed into the frozen plan.
    plan = make_plan(scene, ConvOp.FPROP, device=device)
    choice = plan.choice
    print(f"planned {choice.schedule} blocks=({choice.bm},{choice.bn},"
          f"{choice.bk}) tile={choice.tile} bound={choice.bound} "
          f"predicted efficiency (the port's cost model, H100 datasheet "
          f"constants)={predicted_efficiency(scene, choice):.1%}")

    # 3. Execute MANY times — zero schedule resolutions, zero tune-cache IO,
    #    zero shape arithmetic per call (the CUDA kernel on the card, its
    #    plain version with --device cpu).  Both operands come from one
    #    seed, as the reference draws both from one key.
    inp = torch.randn(scene.in_shape(),
                      generator=torch.Generator().manual_seed(0)).to(device)
    flt = torch.randn(scene.flt_shape(),
                      generator=torch.Generator().manual_seed(0)).to(device)
    for _ in range(3):
        out = plan.execute(inp, flt)

    # 4. Validate against the plain PyTorch oracle.
    want = ref.conv_ref(inp, flt, scene)
    err = float((out - want).abs().max())
    print(f"output {tuple(out.shape)}, max |err| vs oracle = {err:.2e}")
    if not err < 1e-3:
        raise AssertionError(f"plan output {err:.2e} from the oracle")

    # 5. The one-shot call still works (it builds a plan under the hood);
    #    the backward directions are plans too — see ConvOp.DGRAD / WGRAD.
    one_shot = mg3m_conv(inp, flt, scene, device=device)
    one_shot_err = float((one_shot - out).abs().max())
    print(f"one-shot call vs plan: max |err| = {one_shot_err:.2e}")
    if not one_shot_err < 1e-5:
        raise AssertionError(f"one-shot call {one_shot_err:.2e} from the "
                             f"plan")
    print("OK")
    return {"out": out, "err": err, "one_shot_err": one_shot_err}


if __name__ == "__main__":
    main()
