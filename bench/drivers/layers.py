"""Layer traffic: every conv layer of a configuration, one after another,
as a training framework runs a layer.

Set-up plans every layer in all three directions at the mix's batch
(``core.autodiff.make_model_plans`` under the mix's policy), draws He
filters and a pool of operands from the seed on the device, and runs one
pass on each pool entry, which builds and warms every kernel the window
launches.

A pass takes the next pool entry and, layer by layer, runs the layer's
forward through ``conv_with_plans`` and its backward through
``torch.autograd.grad`` with the entry's upstream gradient: fprop, dgrad
(for every layer but the first, whose images need no gradient) and wgrad,
each one call into ``ConvPlan.execute``.  A synchronize follows every
``sync_every`` passes, as a training loop reads its loss every few steps,
and the window stops at the first one after ``seconds`` have passed;
``conv_pass_ms`` is the whole window over the passes in it.

The check: once the window has closed, the outputs of its last pass and
of one pass drawn from the seed among its first ``sample_from`` are held
against the reference, every layer and direction.  The warm passes of
set-up hold as many outputs at once as the window does, so that the
allocator reserves nothing inside the window.
"""
from __future__ import annotations

import time
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from bench import count, data, harness, reference, trace
from bench.reference import compare
from bench.scenes import scenes


def build_plans(config: Mapping, mix: Mapping, device):
    """The program's plan triple of every layer at the mix's batch."""
    from repro_torch.core.autodiff import make_model_plans
    from repro_torch.plan import PlanRegistry
    return make_model_plans(scenes(config, mix["batch"]),
                            registry=PlanRegistry(device=device),
                            policy=mix["policy"], device=device)


def weights(config: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    return {k: v.requires_grad_(True)
            for k, v in data.he_weights(config, seed, device).items()}


def pool(config: Mapping, mix: Mapping, seed: int, device) -> List[Dict]:
    """The pool's entries; every input but the first layer's takes a
    gradient."""
    first = config["layers"][0]["name"]
    entries = []
    for i in range(mix["pool"]):
        entry = data.operands(config, mix["batch"], seed, i, device)
        for name, ops in entry.items():
            ops["x"] = ops["x"].detach().requires_grad_(name != first)
        entries.append(entry)
    return entries


def one_pass(plans, flt: Mapping[str, torch.Tensor], entry: Mapping
             ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every layer's forward and backward; each layer's three outputs."""
    from repro_torch.core.autodiff import conv_with_plans
    outs = {}
    for name, ops in entry.items():
        x, w = ops["x"], flt[name]
        y = conv_with_plans(x, w, plans[name])
        wrt = (x, w) if x.requires_grad else (w,)
        grads = torch.autograd.grad(y, wrt, ops["dy"])
        outs[name] = {"fprop": y.detach(),
                      "dgrad": grads[0] if len(grads) == 2 else None,
                      "wgrad": grads[-1]}
    return outs


def held(config: Mapping, flt: Mapping[str, torch.Tensor],
         checked: Sequence[Tuple[Mapping, Mapping]]) -> Dict[str, float]:
    """Each direction's worst gap of the ``(entry, outputs)`` pairs against
    the reference, layer by layer."""
    numbers = {n: 0.0 for n in compare.names()}
    for entry, outs in checked:
        for i, layer in enumerate(config["layers"]):
            name = layer["name"]
            ops = entry[name]
            ref = reference.layer(ops["x"].detach(), flt[name].detach(),
                                  ops["dy"], layer, "f64", dgrad=i > 0)
            for d, r in ref.items():
                if r is None:
                    continue
                got = outs[name].get(d)
                g = float("inf") if got is None else compare.gap(got, r)
                numbers[f"{d}_gap"] = max(numbers[f"{d}_gap"], g)
            del ref
    return numbers


def run(ctx: harness.Ctx) -> Dict:
    config, mix, device = ctx.config, ctx.mix, ctx.device
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    marks = [("start", ctx.t_start), ("imports", time.perf_counter())]
    plans = build_plans(config, mix, device)
    marks.append(("plans", time.perf_counter()))
    flt = weights(config, ctx.seed, device)
    entries = pool(config, mix, ctx.seed, device)
    sync()
    marks.append(("operands", time.perf_counter()))
    # the window's live set: one kept pass's outputs beside the current
    # pass's, so the allocator has every block before the window opens
    outs = kept = None
    for k in range(len(entries) + 1):
        outs = None
        outs = one_pass(plans, flt, entries[k % len(entries)])
        if kept is None:
            kept = outs
    del outs, kept
    sync()
    marks.append(("warm passes", time.perf_counter()))
    gen = torch.Generator().manual_seed(data.stream_seed(ctx.seed, "sample"))
    sample = int(torch.randint(0, mix["sample_from"], (1,), generator=gen))

    calls: List = []
    kept, outs, n = None, None, 0
    with trace.capture(device, ctx.trace) as tr, \
            harness.conv_ranges(config, calls, ctx.trace):
        sync()
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_start
        while True:
            entry = entries[n % len(entries)]
            outs = None
            with harness.host_range("bench.pass", ctx.trace):
                outs = one_pass(plans, flt, entry)
            if n == sample:
                kept = (entry, outs)
            n += 1
            if n % mix["sync_every"] == 0:
                sync()
                if time.perf_counter() - t0 >= ctx.seconds:
                    break
        window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    checked = [(entry, outs)]
    if kept is not None and kept[1] is not outs:
        checked.insert(0, kept)
    t_ref = time.perf_counter()
    numbers = held(config, flt, checked)
    t_ref = time.perf_counter() - t_ref
    per_pass = sum(1 for _ in count.pass_calls(config))
    record = {"window_s": window_s, "passes": n,
              "pass_flops": count.pass_flops(config, mix["batch"]),
              "dtype": config["dtype"], "trace": tr,
              **harness.conv_work(config, calls)}
    bad = sum(1 for v in numbers.values() if v == float("inf"))
    return {"setup_s": setup_s,
            "end_to_end": {"conv_pass_ms": window_s / n * 1e3},
            "attempted": n * per_pass, "failed": bad, "numbers": numbers,
            "memory_peak_bytes": peak, "record": record,
            "notes": ["set-up: " + ", ".join(
                          f"{b[0]} {b[1] - a[1]:.3f} s"
                          for a, b in zip(marks, marks[1:])),
                      f"window {window_s:.4f} s, {n} passes of {per_pass} "
                      f"conv calls, checked passes {sample} and {n - 1}",
                      f"the reference's check took {t_ref:.3f} s"]}
