#!/usr/bin/env python3
"""The bf16 flash backward's block shapes and segment lengths, on one GPU:

    python3 chip_bwd_sweep.py [--stages 16 32 64 128 0] [--out FILE]

Builds this checkout's ``csrc/flash_attention.cu`` into a second library
(``nvcc`` with ``cuda_build.NVCC_FLAGS``, into a temporary directory) with
an ``extern "C"`` switch over ``tc::bwd_launch<D, NQ, NK>``, NQ and NK (the
warpgroups of a dQ and of a dK/dV block) in 1 and 2, at the training
path's and zamba2-7b's flash shapes (``chip_smoke.TRAIN_FLASH``, D = 128;
q (32, 4096, 112), one query head a kv head; causal), and launches each
with each segment length L of ``--stages`` (query stages of 64 a segment
of the dK/dV walk; 0: one segment a key block, nothing split), beside the
L that ``kernels/flash_attention.dkdv_split_bf16``'s rule gives.  Every
variant is held within
``chip_smoke.XBF16_BWD_TOL`` of max |g| of
``flash_attention_bwd_bf16_plain`` and timed by device time
(``chip_smoke.device_ms``: 5 calls replayed from a CUDA graph) beside the
checkout's own ``flash_attention_bwd`` (its dispatch's pick) and SDPA's
backward.  Prints one line per variant, the card's name and power limit,
and the results as JSON (also to ``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BLOCKS = [(nq, nk) for nq in (1, 2) for nk in (1, 2)]
HEAD_DIMS = (128, 112)


def wrapper(source: Path) -> str:
    """The sweep's translation unit: the kernels' source and a switch over
    (D, NQ, NK), plus the partials' size for a segment length."""
    cases = []
    for i, (d, (nq, nk)) in enumerate((d, b) for d in HEAD_DIMS
                                      for b in BLOCKS):
        cases.append(f"    case {i}: return (int)tc::bwd_launch<{d}, {nq}, "
                     f"{nk}>(q, k, v, o, lse, dout, dq, dk, dv, delta, part, "
                     f"part_floats, BH, BHkv, S, Tk, scale, causal, L, "
                     f"static_cast<cudaStream_t>(stream));")
    return f"""#include "{source}"

extern "C" {{
long long sweep_part_floats(int keys, int D, int S, int Tk, int group,
                            int causal, int L) {{
  bool split;
  const long long slots = tc::bwd_split_slots(keys, S, Tk, group, causal, L,
                                              &split);
  return split ? slots * 2 * keys * D : 0;
}}

int sweep_bwd(int variant, const void* q, const void* k, const void* v,
              const void* o, const float* lse, const void* dout, void* dq,
              void* dk, void* dv, float* delta, float* part,
              long long part_floats, int BH, int BHkv, int S, int Tk,
              float scale, int causal, int L, void* stream) {{
  switch (variant) {{
{chr(10).join(cases)}
    default: return (int)cudaErrorInvalidValue;
  }}
}}
}}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", type=int, nargs="+",
                    default=[16, 32, 64, 128, 0],
                    help="query stages of a segment (0: no split)")
    ap.add_argument("--out", help="write the results to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_bwd_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels import flash_attention as FA

    card = chip_smoke.card_line()
    tmp = Path(tempfile.mkdtemp(prefix="bwd_sweep_"))
    (tmp / "sweep.cu").write_text(wrapper(cuda_build.CSRC / FA.SOURCE))
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           str(tmp / "libsweep.so"), str(tmp / "sweep.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr)
        return 1
    regs = chip_smoke.ptxas_kernels(proc.stdout + proc.stderr, "bf16_kernel")
    for name, (r, spill) in sorted(regs.items()):
        if "bwd" in name:
            print(f"ptxas: {name}: {r} registers, {spill} bytes spill stores")
    lib = ctypes.CDLL(str(tmp / "libsweep.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sweep_part_floats.argtypes = [i32] * 7
    lib.sweep_part_floats.restype = ctypes.c_longlong
    lib.sweep_bwd.argtypes = [i32] + [ptr] * 11 + [
        ctypes.c_longlong, i32, i32, i32, i32, ctypes.c_float, i32, i32, ptr]
    lib.sweep_bwd.restype = i32

    F = torch.nn.functional
    z = get_config(chip_smoke.HYBRID_TRAIN_ARCH)
    gen = torch.Generator().manual_seed(31)
    results = []
    for label, (b, s, t, h, hkv, d) in (
            ("training", chip_smoke.TRAIN_FLASH),
            (z.name, (1, chip_smoke.LM_TRAIN_SEQ, chip_smoke.LM_TRAIN_SEQ,
                      z.n_heads, z.n_kv_heads, z.d_head))):
        bh, bhkv, group = b * h, b * hkv, h // hkv
        q, k, v, do = (torch.randn(dims, generator=gen).to("cuda",
                                                            torch.bfloat16)
                       for dims in ((bh, s, d), (bhkv, t, d), (bhkv, t, d),
                                    (bh, s, d)))
        out, lse = FA.flash_attention_fwd(q, k, v, causal=True,
                                          return_lse=True)
        want = FA.flash_attention_bwd_bf16_plain(q, k, v, out, lse, do,
                                                 causal=True)
        base_ms = chip_smoke.device_ms(torch, lambda: FA.flash_attention_bwd(
            q, k, v, out, lse, do, causal=True), 5)
        q4, k4, v4 = (x.view(b, -1, x.shape[1], d) for x in (q, k, v))
        k4, v4 = (x.repeat_interleave(group, 1) for x in (k4, v4))
        leaves = [x.detach().requires_grad_(True) for x in (q4, k4, v4)]

        def sdpa():
            with torch.enable_grad():
                o = F.scaled_dot_product_attention(*leaves, is_causal=True)
                return torch.autograd.grad(o, leaves, do.view(b, h, s, d))

        sdpa_ms = chip_smoke.device_ms(torch, sdpa, 5) - chip_smoke.device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), 5)
        print(f"{label}: q {tuple(q.shape)} k {tuple(k.shape)} bf16 causal: "
              f"the checkout's pick {base_ms:.4f} ms, SDPA's backward "
              f"{sdpa_ms:.4f} ms")
        for i, (dd, (nq, nk)) in enumerate((dd, blk) for dd in HEAD_DIMS
                                           for blk in BLOCKS):
            if dd != d:
                continue
            rule = FA.dkdv_split_bf16(s, t, d, group, True)[0]
            for L in sorted({*args.stages, rule}):
                L = L or 1 << 30
                n_part = bhkv * lib.sweep_part_floats(64 * nk, d, s, t, group,
                                                      1, L)

                def run():
                    grads = (torch.empty_like(q), torch.empty_like(k),
                             torch.empty_like(v))
                    delta = torch.empty((bh, s), dtype=torch.float32,
                                        device="cuda")
                    part = torch.empty(max(n_part, 1), dtype=torch.float32,
                                       device="cuda")
                    rc = lib.sweep_bwd(
                        i, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), do.data_ptr(),
                        *(g.data_ptr() for g in grads), delta.data_ptr(),
                        part.data_ptr(), n_part, bh, bhkv, s, t, d ** -0.5,
                        1, L, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"sweep_bwd variant {i}: {rc}")
                    return grads

                got = run()
                torch.cuda.synchronize()
                err = max(((g.float() - w.float()).abs().max()
                           / w.float().abs().max()).item()
                          for g, w in zip(got, want))
                ms = chip_smoke.device_ms(torch, run, 5)
                row = {"shape": label, "D": d, "NQ": nq, "NK": nk,
                       "L": L, "rule": L == rule,
                       "partials_mb": 4 * n_part / 1e6, "ms": ms,
                       "xbf16_err": err, "ok": err <= chip_smoke.XBF16_BWD_TOL,
                       "pick_ms": base_ms, "sdpa_bwd_ms": sdpa_ms}
                results.append(row)
                print(f"  NQ {nq} NK {nk} L {L:3d}"
                      f"{' (the rule)' if L == rule else ''}: "
                      f"{ms:.4f} ms, partials {row['partials_mb']:.1f} MB, "
                      f"{err:.3e} of max |g| from the emulation"
                      f"{'' if row['ok'] else ' (over XBF16_BWD_TOL)'}")
        del q, k, v, do, out, lse, want, q4, k4, v4, leaves
        torch.cuda.empty_cache()
    print(card)
    line = json.dumps({"card": card, "results": results})
    if args.out:
        Path(args.out).write_text(line)
    print(line)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
