#!/usr/bin/env python3
"""The tensor cores' rate through ``mma.sync`` on one GPU:

    python3 chip_mma_rate.py [--iters N]

Builds a small CUDA source (with ``nvcc`` from the toolkit that
``repro_torch.kernels.cuda_build`` uses, into a temporary directory) whose
kernels issue nothing but ``mma.sync``: every warp runs 8 independent
accumulator chains of m16n8k8 tf32 (the f32 flash kernels' product) or
m16n8k16 bf16 (the bf16 backward's), ``--iters`` times, on operands held in
registers, with 8 warps on each SM sub-partition (4 blocks of 256 threads
an SM).  Prints the rate each reaches in TFLOP/s (2 m n k FLOPs an
instruction, device time between two CUDA events, the best of 5 launches)
beside the card's name and power limit, and a last JSON line.  The f32
flash kernels run three tf32 products for each f32 one, so a third of the
tf32 rate is their ceiling.
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

SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

constexpr int CHAINS = 8;

__global__ void __launch_bounds__(256) tf32_rate(float* out, int iters) {
  float acc[CHAINS][4] = {};
  const uint32_t x = 0x3f800000u + (threadIdx.x << 13);
  const uint32_t a[4] = {x, x ^ 0x2000u, x ^ 0x4000u, x ^ 0x6000u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[c & 3]),
            "r"(a[(c + 1) & 3]));
  }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 1234.5f) out[threadIdx.x] = s;  // keeps the chains live
}

__global__ void __launch_bounds__(256) bf16_rate(float* out, int iters) {
  float acc[CHAINS][4] = {};
  const uint32_t x = 0x3f803f80u + threadIdx.x;
  const uint32_t a[4] = {x, x ^ 1u, x ^ 2u, x ^ 3u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[c & 3]),
            "r"(a[(c + 1) & 3]));
  }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 1234.5f) out[threadIdx.x] = s;
}

extern "C" int mma_rate_launch(int kind, float* out, int iters, int blocks,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    tf32_rate<<<blocks, 256, 0, s>>>(out, iters);
  else
    bf16_rate<<<blocks, 256, 0, s>>>(out, iters);
  return (int)cudaGetLastError();
}
"""
# (name, kind, m n k of one instruction)
KINDS = (("mma.sync m16n8k8 tf32", 0, 16 * 8 * 8),
         ("mma.sync m16n8k16 bf16", 1, 16 * 8 * 16))
CHAINS, WARPS_A_BLOCK, BLOCKS_AN_SM = 8, 8, 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=4096,
                    help="loop trips of each warp's chains")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_mma_rate: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import cuda_build

    print(f"card: {chip_smoke.card_line()}")
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "mma_rate.cu", Path(tmp) / "mma_rate.so"
        src.write_text(SOURCE)
        subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(lib_path), str(src)], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.mma_rate_launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_AN_SM
    out = torch.zeros(256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, kind, mnk in KINDS:
        best = None
        for _ in range(6):              # the first launch warms up
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = lib.mma_rate_launch(kind, out.data_ptr(), args.iters,
                                     blocks, stream)
            end.record()
            end.synchronize()
            if rc:
                raise RuntimeError(f"{name}: launch failed ({rc})")
            ms = start.elapsed_time(end)
            best = ms if best is None else min(best, ms)
        n = blocks * WARPS_A_BLOCK * CHAINS * args.iters
        rates[name] = 2 * mnk * n / (best * 1e-3) / 1e12
        print(f"{name}: {n} instructions in {best:.3f} ms, "
              f"{rates[name]:.1f} TFLOP/s ({sms} SMs, "
              f"{WARPS_A_BLOCK * BLOCKS_AN_SM // 4} warps a sub-partition, "
              f"{CHAINS} chains a warp)")
    tf32 = rates[KINDS[0][0]]
    print(f"three tf32 terms: {tf32 / 3:.1f} TFLOP/s of f32 work")
    print(json.dumps({"card": chip_smoke.card_line(), "tflops": rates,
                      "three_tf32_terms_tflops": tf32 / 3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
