#!/usr/bin/env python3
"""Every grain at every compiled tile on CNN trunk layers, on one GPU: the
data the selector's cost model is fitted to and checked against.

    python3 chip_tile_sweep.py [--nets resnet] [--dtypes float32]
                               [--layers NAME ...] [--buckets 1 2 4 8]
                               [--out FILE]
    python3 chip_tile_sweep.py --fit FILE [FILE ...] [--starts 8]
    python3 chip_tile_sweep.py --segments 0 512 1024 ... [--nets resnet]
                               [--layers NAME ...] [--wgrad-batch 8]
                               [--out FILE]

For each trunk layer (``cnn_chain_scenes(net)``, seeded inputs) at each
bucket it forces TB11, TB18 and TB88 at every m-tile of the search space
and every compiled tile that runs it, and prints each kernel's device time
(``chip_smoke.device_ms``: 20 calls replayed from a CUDA graph) beside the
selector's modeled time for it, the selector's own pick and ``F.conv2d``
(TF32 off).  The first launch is held against the plain version (f32
within 1e-4, bf16 within 2e-2) and every other launch must equal it
bitwise: every grain and tile sums tap-major, k ascending.  Then, per
(net, dtype, bucket), the trunk's sum of the picks' device times against
the sum of the fastest measured configurations and of ``F.conv2d``.
``--out`` writes every measurement as JSON.

``--fit`` needs no GPU: it reads such JSON files (times of one
configuration in several files are averaged) and fits the cost model's
assumed constants (``FIT_GRID``) for speed alone: coordinate descent from
the current values and from ``--starts`` random points (``--seed``),
minimizing the mean over (net, dtype, bucket) of the picks' trunk sum over
the fastest measured configuration's, plus the same mean for each grain's
own pick where it is forced (``policy="TB18"``, ...) over that grain's
fastest.  It prints the constants found, each trunk's gaps and the grains
the picks serve.

``--segments`` sweeps the weight gradient's split (the length of a
reduction segment, ``core.scene.WGRAD_SEGMENT_R``; 0 = not split): for
each trunk layer's wgrad exec scene at ``--wgrad-batch`` and each length,
every TB11/TB88 configuration that fits is timed with its second pass
(the wrapper's launch and ``segment_sum``), held within 1e-4 of the plain
version split at the current length, beside the second pass alone, the
selector's pick at that length and ``conv2d_weight`` (TF32 off); then,
per length, the trunk's sum of the picks' and of the fastest device
times.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the assumed (not datasheet) constants of core/mapping and the values the
# fit tries for each; STEP_OVERHEAD_S reaches _score through CostModel
FIT_GRID = {
    "_FULL_RATE_WARPS": (4, 6, 8, 10, 12, 16, 20, 24, 32),
    "_ISSUE_EXPONENT": (0.2, 0.25, 0.3, 0.35, 0.4, 0.5, 0.6, 0.65, 0.75,
                        0.9, 1.0),
    "_ISSUE_PER_READ": (0.5, 1, 1.5, 2, 2.5, 3, 4, 5, 6, 8, 12),
    "_ISSUE_PER_COPY": (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                        192),
    "_ISSUE_PER_STORE": (8, 16, 24, 32, 48, 64, 96, 128, 192, 256),
    "L2_TO_SM_BW": (1e12, 2e12, 4e12, 8e12, 16e12, 32e12, 64e12),
    "STEP_OVERHEAD_S": (0, 25e-9, 50e-9, 100e-9, 150e-9, 200e-9, 300e-9,
                        400e-9, 500e-9, 800e-9, 1200e-9, 1600e-9, 2400e-9),
}


def _key(choice) -> str:
    return f"{choice.schedule}/{choice.bm}{tuple(choice.tile)}"


def _scene(chain, name, dtype, bucket):
    import dataclasses
    return dataclasses.replace(chain[name], dtype=dtype).with_batch(bucket)


def sweep(torch, nets, dtypes, buckets, layers):
    """Time every configuration of every selected layer; returns the rows
    and per-trunk sums of (picks, fastest, ``F.conv2d``) device ms."""
    import chip_smoke
    from repro_torch.core import mapping
    from repro_torch.kernels.mg3m_conv import conv_plain
    from repro_torch.models.cnn import cnn_chain_scenes
    from repro_torch.plan import make_plan

    F = torch.nn.functional
    gen = torch.Generator().manual_seed(11)
    rows, sums, unequal = [], {}, []
    for net in nets:
        chain = cnn_chain_scenes(net)
        names = [n for n in chain if not layers or n in layers]
        for dtype in dtypes:
            tdt = getattr(torch, dtype)
            for bucket in buckets:
                for name in names:
                    sc = _scene(chain, name, dtype, bucket)
                    x = torch.randn(sc.in_shape(), generator=gen).to(
                        "cuda", tdt)
                    w = (torch.randn(sc.flt_shape(), generator=gen)
                         * (sc.fltH * sc.fltW * sc.IC) ** -0.5).to(
                             "cuda", tdt)
                    pick = mapping.select_schedule(sc)
                    times, modeled, first = {}, {}, None
                    for grain in mapping.SCHEDULES:
                        for bm, bn, bk, tile in mapping.candidate_blocks(
                                sc, grain):
                            choice = mapping._score(sc, grain, bm, bn, bk,
                                                    tile=tile)
                            if choice is None or _key(choice) in times:
                                continue
                            plan = make_plan(sc, policy=choice)
                            fn, inp, flt, blocks = plan.kernel_call(x, w)
                            es = plan.exec_scene
                            # the plan pads OC and batch to its blocks
                            got = fn(inp, flt, es, **blocks)[
                                :, :, :sc.OC, :sc.B]
                            if first is None:
                                first = got
                                want = conv_plain(inp, flt, es)[
                                    :, :, :sc.OC, :sc.B]
                                tol = TOL[dtype]
                                if not torch.allclose(got.float(),
                                                      want.float(),
                                                      rtol=tol, atol=tol):
                                    err = (got.float() - want.float()
                                           ).abs().max().item()
                                    raise AssertionError(
                                        f"{_key(choice)} disagrees with its "
                                        f"plain version at {name} {dtype} "
                                        f"B={bucket} ({err})")
                            elif not torch.equal(got, first):
                                unequal.append(f"{name} {dtype} B={bucket} "
                                               f"{_key(choice)}")
                            times[_key(choice)] = chip_smoke.device_ms(
                                torch, lambda: fn(inp, flt, es, **blocks))
                            modeled[_key(choice)] = choice.predicted_s * 1e3
                    x_nchw = x.permute(3, 2, 0, 1).contiguous()
                    w_oihw = w.permute(3, 2, 0, 1).contiguous()
                    with torch.backends.cudnn.flags(enabled=True,
                                                    allow_tf32=False):
                        lib = chip_smoke.device_ms(torch, lambda: F.conv2d(
                            x_nchw, w_oihw, stride=(sc.stdH, sc.stdW),
                            padding=(sc.padH, sc.padW)))
                    best = min(times, key=times.get)
                    chosen = times[_key(pick)]
                    s = sums.setdefault((net, dtype, bucket), [0.0, 0.0, 0.0])
                    s[0] += chosen
                    s[1] += times[best]
                    s[2] += lib
                    order = sorted(times, key=times.get)
                    print(f"{name} {dtype} B={bucket}: pick {_key(pick)} "
                          f"{chosen:.4f} ms (modeled "
                          f"{modeled[_key(pick)]:.4f}); fastest {best} "
                          f"{times[best]:.4f}; F.conv2d {lib:.4f}; "
                          + ", ".join(f"{k} {times[k]:.4f} "
                                      f"({modeled[k]:.4f})" for k in order),
                          flush=True)
                    rows.append({"net": net, "layer": name, "dtype": dtype,
                                 "bucket": bucket, "pick": _key(pick),
                                 "fastest": best, "library_ms": lib,
                                 "ms": times, "modeled_ms": modeled})
    return rows, sums, unequal


def segment_sweep(torch, nets, lengths, layers, batch: int):
    """Time the wgrad exec scenes' split at each segment length (see the
    module docstring); returns the rows and per-length sums of (picks,
    fastest) device ms."""
    import chip_smoke
    from repro_torch.core import mapping
    from repro_torch.core import scene as scene_mod
    from repro_torch.kernels import mg3m_conv as K
    from repro_torch.models.cnn import cnn_chain_scenes
    from repro_torch.plan import make_plan
    from repro_torch.plan.build import grad_filter_scene, wgrad_operands
    from repro_torch.tune.space import enumerate_space

    grad = torch.nn.grad
    gen = torch.Generator().manual_seed(13)
    # each length is set as the scene module's WGRAD_SEGMENT_R, so every
    # plan splits as it would at that length; 0 runs the same dims as a
    # plain, unsplit ConvScene
    default = scene_mod.WGRAD_SEGMENT_R
    rows, sums = [], {}
    for net in nets:
        chain = cnn_chain_scenes(net)
        for name in [n for n in chain if not layers or n in layers]:
            sc = chain[name].with_batch(batch)
            scene_mod.WGRAD_SEGMENT_R = default
            es = grad_filter_scene(sc)
            want_seg = es.seg_taps
            whole = scene_mod.ConvScene(**es.__dict__)
            scale = (es.fltH * es.fltW * es.K) ** -0.5     # outputs O(1)
            a = torch.randn(sc.in_shape(), generator=gen).cuda()
            b = (torch.randn(sc.out_shape(), generator=gen) * scale).cuda()
            ea, eb = wgrad_operands(a, b)
            want, lib = None, None
            for length in lengths:
                scene_mod.WGRAD_SEGMENT_R = length or default
                sv = es if length else whole
                seg = sv.seg_taps
                pick = mapping.select_schedule(sv)
                times, modeled = {}, {}
                for pt in enumerate_space(sv):
                    choice = mapping._score(sv, pt.schedule, pt.bm, pt.bn,
                                            pt.bk, tile=pt.tile)
                    if choice is None or _key(choice) in times:
                        continue
                    plan = make_plan(sv, policy=choice)
                    fn, inp, flt, blocks = plan.kernel_call(ea, eb)
                    if want is None:
                        want = K.conv_plain(inp, flt, es, want_seg)
                    got = fn(inp, flt, sv, **blocks)
                    if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
                        raise AssertionError(
                            f"{name} wgrad {_key(choice)} at segment length "
                            f"{length} disagrees with its plain version "
                            f"({(got - want).abs().max().item():.3e})")
                    times[_key(choice)] = chip_smoke.device_ms(
                        torch, lambda: fn(inp, flt, sv, **blocks))
                    modeled[_key(choice)] = choice.predicted_s * 1e3
                n_seg = len(mapping.wgrad_segments(sv))
                second = 0.0
                if n_seg > 1:
                    parts = torch.randn((n_seg,) + tuple(want.shape),
                                        generator=gen).cuda()
                    second = chip_smoke.device_ms(
                        torch, lambda: K.segment_sum(parts, torch.float32))
                if lib is None:
                    xa = a.permute(3, 2, 0, 1).contiguous()
                    gb = b.permute(3, 2, 0, 1).contiguous()
                    with torch.backends.cudnn.flags(enabled=True,
                                                    allow_tf32=False):
                        lib = chip_smoke.device_ms(
                            torch, lambda: grad.conv2d_weight(
                                xa, (sc.OC, sc.IC, sc.fltH, sc.fltW), gb,
                                stride=(sc.stdH, sc.stdW),
                                padding=(sc.padH, sc.padW)))
                best = min(times, key=times.get)
                chosen = times[_key(pick)]
                s = sums.setdefault(length, [0.0, 0.0])
                s[0] += chosen
                s[1] += times[best]
                order = sorted(times, key=times.get)
                print(f"{name} wgrad B={batch} length {length} (S={n_seg}, "
                      f"{seg} taps): pick {_key(pick)} {chosen:.4f} ms "
                      f"(modeled {modeled[_key(pick)]:.4f}); fastest {best} "
                      f"{times[best]:.4f}; second pass {second:.4f}; "
                      f"conv2d_weight {lib:.4f}; "
                      + ", ".join(f"{k} {times[k]:.4f} ({modeled[k]:.4f})"
                                  for k in order), flush=True)
                rows.append({"net": net, "layer": name, "batch": batch,
                             "length": length, "segments": n_seg,
                             "seg_taps": seg, "pick": _key(pick),
                             "fastest": best, "second_pass_ms": second,
                             "library_ms": lib, "ms": times,
                             "modeled_ms": modeled})
            del a, b, ea, eb, want
    scene_mod.WGRAD_SEGMENT_R = default
    return rows, sums


def fit(paths, starts: int, seed: int = 0) -> None:
    """Fit ``FIT_GRID``'s constants to the sweeps in ``paths`` (CPU)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import mapping
    from repro_torch.models.cnn import cnn_chain_scenes

    merged = {}
    for path in paths:
        for r in json.loads(Path(path).read_text()):
            k = (r.get("net", "resnet"), r["layer"], r.get("dtype", "float32"),
                 r["bucket"])
            for cfg, ms in r["ms"].items():
                merged.setdefault(k, {}).setdefault(cfg, []).append(ms)
    data = []
    for (net, name, dtype, bucket), cfgs in merged.items():
        sc = _scene(cnn_chain_scenes(net), name, dtype, bucket)
        cands = [(g, bm, bn, bk, t) for g in mapping.SCHEDULES
                 for bm, bn, bk, t in mapping.candidate_blocks(sc, g)]
        ms = {c: sum(v) / len(v) for c, v in cfgs.items()}
        data.append(((net, dtype, bucket), name, sc, cands, ms))

    def picks(p):
        """(trunk, layer, grain, pick, its ms, the fastest ms) per row:
        grain None for the selector's pick, else its pick with only that
        grain allowed (a forced schedule)."""
        for n, v in p.items():
            if n != "STEP_OVERHEAD_S":
                setattr(mapping, n, v)
        model = mapping.CostModel(step_overhead_s=p["STEP_OVERHEAD_S"])
        out = []
        for trunk, name, sc, cands, ms in data:
            scored = [c for c in (mapping._score(sc, *cand[:4], model,
                                                 tile=cand[4])
                                  for cand in cands) if c is not None]
            for grain in (None,) + mapping.SCHEDULES:
                mine = [c for c in scored if grain in (None, c.schedule)]
                if not mine:
                    continue
                best = _key(min(mine, key=lambda c: c.predicted_s))
                if best not in ms:
                    return None
                out.append((trunk, name, grain, best, ms[best],
                            min(v for k, v in ms.items()
                                if grain is None or k.startswith(grain))))
        return out

    def gaps(p):
        """The objective: the mean over trunks of the selector's picks'
        trunk sum over the fastest's, plus the same mean over (trunk,
        grain) for the forced grains' picks."""
        got = picks(p)
        if got is None:
            return None, None
        sums = {}
        for trunk, _, grain, _, ms, best in got:
            s = sums.setdefault((trunk, grain), [0.0, 0.0])
            s[0] += ms
            s[1] += best
        g = {k: s[0] / s[1] - 1 for k, s in sums.items()}
        served = [v for (_, grain), v in g.items() if grain is None]
        forced = [v for (_, grain), v in g.items() if grain is not None]
        return (sum(served) / len(served) + sum(forced) / len(forced),
                (g, got))

    rng = random.Random(seed)
    now = {n: (mapping.DEFAULT_COST_MODEL.step_overhead_s
               if n == "STEP_OVERHEAD_S" else getattr(mapping, n))
           for n in FIT_GRID}
    found = []
    for start in range(starts + 1):
        cur = dict(now) if start == 0 else {n: rng.choice(v)
                                            for n, v in FIT_GRID.items()}
        val = gaps(cur)[0]
        val = float("inf") if val is None else val
        if start == 0:
            print(f"current constants: objective {val:+.2%}")
        better = True
        while better:
            better = False
            for n, values in FIT_GRID.items():
                for v in values:
                    q = {**cur, n: v}
                    qv = gaps(q)[0]
                    if qv is not None and qv < val - 1e-9:
                        cur, val, better = q, qv, True
        found.append((val, cur))
        print(f"start {start}: objective {val:+.2%} {cur}", flush=True)
    val, best = min(found, key=lambda t: t[0])
    g, got = gaps(best)[1]
    print(f"fitted constants (objective {val:+.2%}): {best}")
    for (trunk, grain), gap in sorted(g.items(), key=lambda t: (
            t[0][0], t[0][1] or "")):
        if grain is None:
            served = sorted({p[3].split("/")[0] for p in got
                             if p[0] == trunk and p[2] is None})
            forced = ", ".join(f"{gr} {g[(trunk, gr)]:+.2%}"
                               for gr in mapping.SCHEDULES
                               if (trunk, gr) in g)
            print(f"  {trunk}: picks {gap:+.2%} over the fastest measured, "
                  f"grains served {served}; forced: {forced}")
    for trunk, name, grain, cfg, ms, fastest in got:
        if grain is None and (cfg.startswith("TB11") or ms > 1.05 * fastest):
            print(f"  {name} {trunk[1]} B={trunk[2]}: pick {cfg} {ms:.4f} ms "
                  f"against the fastest {fastest:.4f} "
                  f"({ms / fastest - 1:+.1%})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nets", nargs="+", default=["resnet"])
    ap.add_argument("--dtypes", nargs="+", default=["float32"],
                    choices=sorted(TOL))
    ap.add_argument("--layers", nargs="+", default=[],
                    help="layer names to keep (default: every layer)")
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--out", default="", help="JSON file for the results")
    ap.add_argument("--fit", nargs="+", default=[],
                    help="fit the cost model to these sweep JSON files")
    ap.add_argument("--starts", type=int, default=8,
                    help="random starts of the fit besides the current "
                         "constants")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the fit's random starts")
    ap.add_argument("--segments", type=int, nargs="+", default=[],
                    help="sweep the wgrad split at these segment lengths "
                         "(reduction values; 0 = not split)")
    ap.add_argument("--wgrad-batch", type=int, default=8,
                    help="the forward batch of the swept wgrad scenes")
    args = ap.parse_args()
    if args.fit:
        fit(args.fit, args.starts, args.seed)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_tile_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_tile_sweep: no repro_torch under {ROOT / 'src'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import cuda_build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {chip_smoke.card_line()}")
    t0 = time.perf_counter()
    cuda_build.load_all(("mg3m_conv.cu",))
    print(f"build: mg3m_conv.cu in {time.perf_counter() - t0:.1f} s")
    if args.segments:
        rows, sums = segment_sweep(torch, args.nets, args.segments,
                                   args.layers, args.wgrad_batch)
        for length, (chosen, best) in sums.items():
            print(f"wgrad trunk at segment length {length}: selector's "
                  f"picks {chosen:.4f} ms, fastest measured {best:.4f} ms "
                  f"(device, second pass included)")
        if args.out:
            Path(args.out).write_text(json.dumps(rows))
        return 0
    rows, sums, unequal = sweep(torch, args.nets, args.dtypes, args.buckets,
                                args.layers)
    for (net, dtype, bucket), (chosen, best, lib) in sums.items():
        print(f"trunk {net} {dtype} B={bucket}: selector's picks "
              f"{chosen:.4f} ms, fastest measured {best:.4f} ms "
              f"(+{chosen / best - 1:.1%}), F.conv2d {lib:.4f} ms (device)")
    if args.out:
        Path(args.out).write_text(json.dumps(rows))
    if unequal:
        raise AssertionError(f"{len(unequal)} configurations differ bitwise "
                             f"from their layer's first: {unequal[:10]}")
    print(f"bitwise: every configuration of {len(rows)} layer-buckets equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
