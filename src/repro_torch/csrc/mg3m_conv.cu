// MG3M multi-grained implicit-GEMM convolution for Hopper (sm_90a).
//
// Ports the three Pallas TPU kernels of repro/kernels/mg3m_conv.py:
//
//   mg3m_tb11_kernel  replaces conv_tb11 / _tb11_kernel (mg3m_conv.py:268,
//                     :288): the whole filter resident on chip.
//   mg3m_tb18_kernel  replaces conv_tb18 / _tb18_kernel (:302, :320): an
//                     OC slice of the filter resident on chip.
//   mg3m_tb88_kernel  replaces conv_tb88 / _tb88_kernel (:333, :352): a
//                     tiled GEMM, filter and input both streamed in tiles.
//
// All three compute, per output pixel (oh, ow),
//   OUT[oh, ow, m, n] = sum_{i, j, k} FLT[i, j, k, m] * IN[at(oh, ow, i, j), k, n]
// with f32 accumulation and a cast to the IO type on store.  Layouts are
// the reference's: IN [Hl, Wl, K, N], FLT [fh, fw, K, M], OUT [outH, outW,
// M, N] (M = OC, N = batch, K = IC; Hl/Wl are the launched input extents).
//
// Where the Pallas grid walks one pixel per step, a block here computes a
// BM x BC output tile whose BC columns run over the flattened (pixel,
// batch) axis: at batch 1 (serving) a per-pixel GEMM has a single column,
// so tiling pixels and batch together keeps a block busy.
//
// What bounds these kernels on an H100: at the ResNet trunk's shapes the
// arithmetic intensity is far above the card's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte), so their roofline bound is operations: f32
// FMA on the CUDA cores.  No tensor cores: every output sums its terms
// tap-major, k ascending, one fmaf each, from f32 values converted exactly
// from the IO type, so the three grains (and the plain version's order)
// give bitwise the same output whatever the batch a column is served in;
// f32 operands on tensor cores would need TF32.
//
// All three are built from the same pieces, for one limit: getting
// operands to the FMAs.
//   * A TM x TC register tile per thread, (BM / TM) x (BC / TC) threads:
//     a thread's filter rows are one or two 16-byte shared reads, its
//     input columns the same, so every shared load feeds 5 (TB18's 4 x 2)
//     to 16 (8 x 8) FMAs, with no conversion or bounds check in the loop
//     (what a tile does not cover is zero-filled in shared memory).
//   * The IN tile is double-buffered and staged by cp.async with zero-fill
//     (src-size 0) for masked taps, holes and reduction values past the
//     end; the next chunk's copies are in flight while this chunk's FMAs
//     run, one barrier per chunk.  At batch 1 it is column-major and a
//     copy is 16 bytes of a column's contiguous k values; at batch N > 1
//     it is k-major and a copy is up to 16 bytes of one pixel's N
//     contiguous batch entries.
//   * Input offsets are computed once per tile into tables, never per
//     element in the copy loops.  TB11/TB88 store a thread's outputs 16
//     bytes at a time where a column's rows (batch 1) or a pixel's batch
//     run (batch > 1) allow.
//   * The tile is one of the compiled (BM, BC, TM, TC) below, chosen in
//     Python by the selector (core/mapping prices every tile: masked rows
//     and columns, waves over the 132 SMs at the footprint's occupancy,
//     and the warps an SM holds) and passed in the Geom.
// TB18 (the OC slice resident) walks the reduction tap by tap in chunks
// of 32 k.  TB11 and TB88 share one body (gemm_body) that walks it as one
// axis r = tap * K + k in chunks of 32, which is exactly the tap-major,
// k-ascending order, and lets a chunk cross taps where K is small (the
// stem's 7 x 7 x 3 reduction is 5 chunks, not 49).  TB88 streams a
// [32 r][BM] filter tile beside the IN tile; TB11 holds the whole filter,
// zero-padded to the compiled BM and to whole chunks, in shared memory.
//
// The index map (the reference's _in_index_map, mg3m_conv.py:64-89) is the
// one device function in_coord.  Dense route: the input arrives
// pre-padded and pad = 0, dil = 1.  Lhs-dilated route: the input is the
// compact one and the coordinate is translated back through pad and dil.
// A dilation hole or an out-of-range tap is a masked load of zero; the
// reference instead reads an appended all-zero sentinel row/column, which
// this port therefore does not append.
//
// The weight gradient's exec scenes (plan/build.grad_filter_scene) contract
// up to 100 352 reduction values onto a few hundred output columns: one
// block per tile would walk all of it alone on 1-9 of the 132 SMs.  There
// the plan splits the reduction into g.nseg segments of g.seg_taps whole
// taps (core/mapping.wgrad_seg_taps): TB11 and TB88 give each segment
// blocks of their own, which walk r over [r0, r1) only, in chunks of G_KC
// from r0, tap-major and k ascending from zero as before, and store f32
// partials without the cast into a workspace [nseg][outH * outW * M * N].
// mg3m_segsum_kernel then adds each output's partials in the order s = 0,
// 1, ..., nseg - 1, one f32 add each, and casts: no atomics, no order that
// depends on which block finishes first, so every grain and the plain
// version sum in one order.  TB18 takes no split (the selector never
// offers it there).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmg3m_conv.so mg3m_conv.cu
// The C entry points take a Geom by pointer and return the CUDA error code
// of the launch (0 = launched), or -1 for arguments the kernels do not take.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

struct Geom {
  int Hl, Wl;        // launched input spatial extent
  int K, N, M;       // launched channel, batch and output-channel dims
  int outH, outW;
  int fh, fw;
  int stdH, stdW;
  int fdilH, fdilW;
  int padH, padW;    // 0 on the dense route (input pre-padded)
  int dilH, dilW;    // 1 on the dense route
  int bm;            // TB18 slice width / TB88 m-tile
  int bk;            // TB88 k block of the plan (the kernel does not read it)
  int grid;          // TB11/TB18: blocks along the column axis
  int bc;            // compiled tile: columns
  int tm, tc;        // compiled tile: thread tile
  int tbm;           // compiled tile: rows (TB11/TB88)
  int nseg;          // reduction segments (1 = not split; TB11/TB88)
  int seg_taps;      // taps per segment where nseg > 1
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The index map: input row (or column) read by output coordinate o at
// filter tap `tap`, or -1 when the tap lands on a dilation hole or outside
// the stored input.
__device__ __forceinline__ int in_coord(int o, int tap, int stride, int fdil,
                                        int pad, int dil, int extent) {
  int q = o * stride + tap * fdil - pad;
  if (dil != 1) {   // lhs-dilated route only: no integer division otherwise
    if (q < 0 || q % dil != 0) return -1;
    q /= dil;
  }
  return q >= 0 && q < extent ? q : -1;
}

__host__ __device__ constexpr size_t round16(size_t b) {
  return (b + 15) / 16 * 16;
}

// ---------------------------------------------------------------------------
// TB18 (replaces conv_tb18, mg3m_conv.py:320): block (column strip, OC
// slice); the slice [fh, fw, K, bm] is loaded once per block.
// ---------------------------------------------------------------------------
constexpr int T18_KC = 32;   // k chunk of the double-buffered IN tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// cp.async of 4, 8 or 16 bytes (16 bypass L1); src-size 0 zero-fills the
// target where masked
__device__ __forceinline__ void cp_async_n(void* dst, const void* src,
                                           int bytes, bool valid) {
  const uint32_t d = smem_u32(dst);
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
}

// NV contiguous values in shared memory as f32 (exact): 16-, 8- or 4-byte
// reads (a thread's filter rows, its k-major columns, a column's k values)
template <int NV>
__device__ __forceinline__ void ldv(const float* p, float* x) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int u = 0; u < NV / 4; ++u) {
      const float4 v = reinterpret_cast<const float4*>(p)[u];
      x[4 * u] = v.x; x[4 * u + 1] = v.y; x[4 * u + 2] = v.z;
      x[4 * u + 3] = v.w;
    }
  } else if constexpr (NV == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *p;
  }
}
template <int NV>
__device__ __forceinline__ void ldv(const __nv_bfloat16* p, float* x) {
  if constexpr (NV % 8 == 0) {
#pragma unroll
    for (int u = 0; u < NV / 8; ++u) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[u];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        x[8 * u + 2 * i] = f.x;
        x[8 * u + 2 * i + 1] = f.y;
      }
    }
  } else if constexpr (NV == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else if constexpr (NV == 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = f.x;
    x[1] = f.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}

// One element staged, zero where masked: a 4-byte cp.async for f32; a
// 2-byte bf16 is below cp.async's minimum and goes through registers.
template <typename T> struct Io;
template <> struct Io<float> {
  __device__ static void copy1(float* dst, const float* src, bool ok) {
    cp_async_n(dst, src, 4, ok);
  }
};
template <> struct Io<__nv_bfloat16> {
  __device__ static void copy1(__nv_bfloat16* dst,
                                    const __nv_bfloat16* src, bool ok) {
    *dst = ok ? *src : __float2bfloat16(0.f);
  }
};

// Row stride (elements) of TB18's IN tile: 32 k values and 16 bytes of
// padding, an odd number of 16-byte units, so 8 threads reading 16 bytes
// of 8 consecutive columns hit distinct banks.
template <typename T>
__host__ __device__ constexpr int t18_row() {
  return T18_KC + 16 / (int)sizeof(T);
}

// acc[r][s] += sum over the chunk's KC8 k (ascending) of
// filter(k, row tm*TM + r) * in(k, column tc + s*CT), one fmaf per term.
template <typename T, int BM, int TM, int TC, int CT, int KCP>
__device__ __forceinline__ void fma_chunk(float (&acc)[TM][TC], int kc8,
                                          const T* src, const T* fr,
                                          int tc) {
  constexpr int VK = 16 / (int)sizeof(T);   // a column's k values a read
  auto step = [&](int kk) {
    float b[TC][VK];
#pragma unroll
    for (int s = 0; s < TC; ++s)
      ldv<VK>(src + (tc + s * CT) * KCP + kk, b[s]);
#pragma unroll
    for (int j = 0; j < VK; ++j) {
      float a[TM];
      ldv<TM>(fr + (size_t)(kk + j) * BM, a);
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int s = 0; s < TC; ++s)
          acc[r][s] = fmaf(a[r], b[s][j], acc[r][s]);
    }
  };
  // a full chunk of the small tile unrolled, so its few FMAs per load
  // find the next loads already issued; the 8 x 4 tile has ILP enough
  // (and unrolled, it runs out of registers)
  if (TM * TC <= 8 && kc8 == T18_KC) {
#pragma unroll
    for (int kk = 0; kk < T18_KC; kk += VK) step(kk);
  } else {
#pragma unroll 1
    for (int kk = 0; kk < kc8; kk += VK) step(kk);
  }
}

// The same sums over the batch-major tile [KC][BC] (batch > 1): the
// thread's TC columns are contiguous, one shared read per k.
template <typename T, int BM, int BC, int TM, int TC>
__device__ __forceinline__ void fma_chunk_kmajor(float (&acc)[TM][TC],
                                                 int kc8, const T* src,
                                                 const T* fr, int tc) {
  auto step = [&](int kk) {
    float b[TC], a[TM];
    ldv<TC>(src + kk * BC + tc * TC, b);
    ldv<TM>(fr + (size_t)kk * BM, a);
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int s = 0; s < TC; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
  };
  if (kc8 == T18_KC) {
#pragma unroll 8
    for (int kk = 0; kk < T18_KC; ++kk) step(kk);
  } else {
#pragma unroll 1
    for (int kk = 0; kk < kc8; ++kk) step(kk);
  }
}

template <typename T, int BM, int BC, int TM, int TC>
__global__ void __launch_bounds__(BM / TM * (BC / TC))
    mg3m_tb18_kernel(const T* __restrict__ in, const T* __restrict__ flt,
                     T* __restrict__ out, float* __restrict__, Geom g) {
  constexpr int THR = BM / TM * (BC / TC);
  constexpr int V = 16 / (int)sizeof(T);   // elements per 16 bytes
  constexpr int KCP = t18_row<T>();
  constexpr int CT = BC / TC;
  extern __shared__ __align__(16) unsigned char smem[];
  const int taps = g.fh * g.fw;
  const int KP = (g.K + 7) & ~7;
  const int w0 = blockIdx.y * g.bm;
  T* flt_res = reinterpret_cast<T*>(smem);   // [taps * KP][BM]
  T* in_s = reinterpret_cast<T*>(
      smem + round16((size_t)taps * KP * BM * sizeof(T)));  // [2][BC][KCP]
  int* tab = reinterpret_cast<int*>(in_s + 2 * BC * KCP);   // [taps][BC]

  // the OC slice, zero-padded to BM rows and KP k per tap
  const int rows = taps * KP;
  if (g.M % V == 0 && g.bm % V == 0 &&
      reinterpret_cast<uintptr_t>(flt) % 16 == 0) {
    constexpr int SEG = BM / V;
    for (int e = threadIdx.x; e < rows * SEG; e += THR) {
      const int r = e / SEG, ml = e % SEG * V;
      const int t = r / KP, k = r - t * KP;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < g.K && ml < g.bm)
        val = *reinterpret_cast<const uint4*>(
            flt + ((size_t)t * g.K + k) * g.M + w0 + ml);
      *reinterpret_cast<uint4*>(flt_res + (size_t)r * BM + ml) = val;
    }
  } else {
    for (int e = threadIdx.x; e < rows * BM; e += THR) {
      const int r = e / BM, ml = e % BM;
      const int t = r / KP, k = r - t * KP;
      flt_res[e] = k < g.K && ml < g.bm
                       ? flt[((size_t)t * g.K + k) * g.M + w0 + ml]
                       : from_f<T>(0.f);
    }
  }

  const int C = g.outH * g.outW * g.N;
  const int n_ct = (C + BC - 1) / BC;
  const int nkc = (g.K + T18_KC - 1) / T18_KC;
  const int total = taps * nkc;
  const int tm = threadIdx.x % (BM / TM);
  const int tc = threadIdx.x / (BM / TM);
  // Column-major [BC][KCP]: 16-byte copies along k at batch 1, single
  // elements otherwise.  bf16 at batch > 1 goes k-major [KC][BC] instead,
  // where a copy takes R >= 4 bytes of one pixel's batch run (N contiguous
  // elements at each k) when the tile starts on a pixel and R divides the
  // run: a 2-byte element is below cp.async's minimum.  (For f32 the
  // k-major tile measured slower than single-element copies: PERF.md.)
  const bool kmajor = g.N > 1 && sizeof(T) == 2;
  const int run = g.N * (int)sizeof(T);
  const int R = run < 16 ? run : 16;
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const bool vec = g.N == 1 && g.K % V == 0 && aligned;
  const bool vec_n = kmajor && aligned && BC % g.N == 0 && run % R == 0 &&
                     (R == 4 || R == 8 || R == 16);

  auto stage = [&](int t, int k0, int buf) {
    T* dst = in_s + buf * BC * KCP;
    const int* tt = tab + t * BC;
    if (vec_n) {
      const int E = R / (int)sizeof(T);   // elements per copy
      const int per_k = BC / E;
      for (int e = threadIdx.x; e < T18_KC * per_k; e += THR) {
        const int kk = e / per_k, cc = (e - kk * per_k) * E;
        const int off = tt[cc], k = k0 + kk;
        const bool ok = off >= 0 && k < g.K;
        cp_async_n(dst + kk * BC + cc, in + (ok ? off + (size_t)k * g.N : 0),
                   R, ok);
      }
    } else if (kmajor) {
      for (int e = threadIdx.x; e < BC * T18_KC; e += THR) {
        const int kk = e / BC, cc = e % BC;
        const int off = tt[cc], k = k0 + kk;
        const bool ok = off >= 0 && k < g.K;
        Io<T>::copy1(dst + kk * BC + cc,
                     in + (ok ? off + (size_t)k * g.N : 0), ok);
      }
    } else if (vec) {
      constexpr int SEGS = T18_KC / V;
      for (int e = threadIdx.x; e < BC * SEGS; e += THR) {
        const int cc = e / SEGS, sg = e % SEGS;
        const int off = tt[cc], k = k0 + sg * V;
        const bool ok = off >= 0 && k < g.K;
        cp_async_n(dst + cc * KCP + sg * V, in + (ok ? off + k : 0), 16, ok);
      }
    } else {
      for (int e = threadIdx.x; e < BC * T18_KC; e += THR) {
        const int cc = e / T18_KC, kk = e % T18_KC;
        const int off = tt[cc], k = k0 + kk;
        const bool ok = off >= 0 && k < g.K;
        Io<T>::copy1(dst + cc * KCP + kk,
                          in + (ok ? off + (size_t)k * g.N : 0), ok);
      }
    }
  };

  for (int ct = blockIdx.x; ct < n_ct; ct += gridDim.x) {
    const int c0 = ct * BC;
    __syncthreads();  // the slice is in; the last tile is done with tab
    for (int e = threadIdx.x; e < taps * BC; e += THR) {
      const int t = e / BC, cc = e % BC, c = c0 + cc;
      int off = -1;
      if (c < C) {
        const int p = c / g.N, n = c - p * g.N;
        const int oh = p / g.outW, ow = p - oh * g.outW;
        const int i = t / g.fw, j = t - i * g.fw;
        const int ih = in_coord(oh, i, g.stdH, g.fdilH, g.padH, g.dilH, g.Hl);
        const int iw = in_coord(ow, j, g.stdW, g.fdilW, g.padW, g.dilW, g.Wl);
        if (ih >= 0 && iw >= 0) off = (ih * g.Wl + iw) * g.K * g.N + n;
      }
      tab[e] = off;
    }
    __syncthreads();
    stage(0, 0, 0);
    cp_async_commit();

    float acc[TM][TC];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int s = 0; s < TC; ++s) acc[r][s] = 0.f;
    int t = 0, k0 = 0;
    for (int q = 0; q < total; ++q) {
      cp_async_wait_all();
      __syncthreads();  // chunk q is in; every thread is done with q - 1
      int tn = t, kn = k0 + T18_KC;
      if (kn >= g.K) {
        kn = 0;
        ++tn;
      }
      if (q + 1 < total) stage(tn, kn, (q + 1) & 1);
      cp_async_commit();

      const int kc8 = (min(T18_KC, g.K - k0) + 7) & ~7;
      const T* src = in_s + (q & 1) * BC * KCP;
      const T* fr = flt_res + ((size_t)t * KP + k0) * BM + tm * TM;
      if (kmajor)
        fma_chunk_kmajor<T, BM, BC, TM, TC>(acc, kc8, src, fr, tc);
      else
        fma_chunk<T, BM, TM, TC, CT, KCP>(acc, kc8, src, fr, tc);
      t = tn;
      k0 = kn;
    }

#pragma unroll
    for (int s = 0; s < TC; ++s) {
      const int c = c0 + (kmajor ? tc * TC + s : tc + s * CT);
      if (c >= C) continue;
      const int p = c / g.N, n = c - p * g.N;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int ml = tm * TM + r;
        if (ml < g.bm)
          out[((size_t)p * g.M + w0 + ml) * g.N + n] = from_f<T>(acc[r][s]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// TB11 and TB88: one implicit-GEMM body over the flattened reduction
// r = tap * K + k, r < R = fh * fw * K, in chunks of G_KC.
// ---------------------------------------------------------------------------
constexpr int G_KC = 32;   // reduction values per chunk
static_assert(G_KC == T18_KC, "the IN tile's row stride is TB18's");

// NV f32 values stored as NV contiguous values of T: 16-, 8- or 4-byte
// stores (p aligned to them)
template <int NV>
__device__ __forceinline__ void stv(float* p, const float* x) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int u = 0; u < NV / 4; ++u)
      reinterpret_cast<float4*>(p)[u] =
          make_float4(x[4 * u], x[4 * u + 1], x[4 * u + 2], x[4 * u + 3]);
  } else if constexpr (NV == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}
template <int NV>
__device__ __forceinline__ void stv(__nv_bfloat16* p, const float* x) {
  if constexpr (NV >= 2) {
    __nv_bfloat162 h[NV / 2];
#pragma unroll
    for (int i = 0; i < NV / 2; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    if constexpr (NV == 8)
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
    else if constexpr (NV == 4)
      *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
    else
      *reinterpret_cast<__nv_bfloat162*>(p) = h[0];
  } else {
    *p = __float2bfloat16(x[0]);
  }
}

// Shared memory of one block (analysis/footprint.gemm_smem), in order:
//   filter  TB88: a ring of two [G_KC][BM] tiles; TB11: the whole filter
//           [nseg * nqs * G_KC][Mp] (each segment from a chunk of its own,
//           nqs chunks of a full segment; Mp = M rounded up to BM), the
//           pads zero;
//   IN      a ring of two tiles of BC * t18_row elements: column-major
//           [BC][t18_row] at batch 1, k-major [G_KC][BC] otherwise;
//   rtab    [2][G_KC] int4 per reduction value of the chunk being staged:
//           (tap row i * BC, tap column j * BC, k * N), i = -1 past R;
//   rowtab  [fh][BC] per column: ih * Wl * K * N, -1 where masked;
//   coltab  [fw][BC] per column: iw * K * N + n, -1 where masked.
// A column's input offset at (i, j, k) is rowtab + coltab + k * N.
template <typename T, int BM, int BC, int TM, int TC, bool RES>
__device__ __forceinline__ void gemm_body(const T* __restrict__ in,
                                          const T* __restrict__ flt,
                                          T* __restrict__ out,
                                          float* __restrict__ ws,
                                          const Geom& g) {
  constexpr int THR = BM / TM * (BC / TC);
  constexpr int V = 16 / (int)sizeof(T);   // elements per 16 bytes
  constexpr int VR = TM < V ? TM : V;      // filter rows per shared read
  constexpr int VC = TC < V ? TC : V;      // k-major columns per read
  constexpr int VK = 4;                    // column-major k values per read
  constexpr int MT = BM / TM;
  constexpr int CT = BC / TC;
  constexpr int KCP = t18_row<T>();
  static_assert(THR >= 2 * G_KC, "two chunks' rtab rows, one per thread");
  static_assert(TM % VR == 0 && TC % VC == 0 && G_KC % V == 0, "tile");
  extern __shared__ __align__(16) unsigned char smem[];

  const int taps = g.fh * g.fw;
  const int R = taps * g.K;
  const int nseg = g.nseg > 1 ? g.nseg : 1;
  const int seg_len = (nseg > 1 ? g.seg_taps : taps) * g.K;  // a full one
  const int nqs = (seg_len + G_KC - 1) / G_KC;   // its chunks
  const int C = g.outH * g.outW * g.N;
  const int n_ct = (C + BC - 1) / BC;
  const int Mp = RES ? (g.M + BM - 1) / BM * BM : BM;   // filter row stride
  const size_t flt_elems =
      RES ? (size_t)nseg * nqs * G_KC * Mp : (size_t)2 * G_KC * BM;
  T* flt_s = reinterpret_cast<T*>(smem);
  T* in_s = reinterpret_cast<T*>(smem + round16(flt_elems * sizeof(T)));
  int4* rtab = reinterpret_cast<int4*>(in_s + 2 * BC * KCP);
  int* rowtab = reinterpret_cast<int*>(rtab + 2 * G_KC);
  int* coltab = rowtab + g.fh * BC;

  const int tm = threadIdx.x % MT, tc = threadIdx.x / MT;
  const bool cmaj = g.N == 1;
  const bool in_al = reinterpret_cast<uintptr_t>(in) % 16 == 0;
  const bool flt_al = reinterpret_cast<uintptr_t>(flt) % 16 == 0;
  // column-major: 16-byte copies of V k values where K % V == 0
  const bool in_vec = cmaj && in_al && g.K % V == 0;
  // k-major: EB bytes (E columns of one pixel) per copy; bf16 single
  // elements (2 bytes, below cp.async's minimum) go through registers
  int EB = (int)sizeof(T);
  if (!cmaj && in_al && BC % g.N == 0) {
    const int run = g.N * (int)sizeof(T);
    EB = run % 16 == 0 ? 16 : run % 8 == 0 ? 8 : run % 4 == 0 ? 4 : EB;
  }
  const int E = EB / (int)sizeof(T);
  int pk_shift = 0;   // log2(BC / E): no division in the copy loop
  while ((E << pk_shift) < BC) ++pk_shift;
  const int pk_mask = (1 << pk_shift) - 1;
  // TB88's filter tile: 16-byte copies where the m-tile is whole vectors
  const bool flt_vec = flt_al && g.M % V == 0 && g.bm % V == 0;

  int c0 = 0, m0 = 0;
  int r0 = 0, r1 = R, nq = nqs;   // the tile's segment [r0, r1), its chunks

  auto in_off = [&](int4 s, int cc) {
    if (s.x < 0) return -1;
    const int a = rowtab[s.x + cc], b = coltab[s.y + cc];
    return a >= 0 && b >= 0 ? a + b + s.z : -1;
  };

  auto fill_r = [&](int q, int buf, int rr) {
    const int r = r0 + q * G_KC + rr;
    int4 s = make_int4(-1, 0, 0, 0);
    if (r < r1) {
      const int t = r / g.K, k = r - t * g.K;
      const int i = t / g.fw, j = t - i * g.fw;
      s = make_int4(i * BC, j * BC, k * g.N, 0);
    }
    rtab[buf * G_KC + rr] = s;
  };

  auto stage = [&](int q, int buf) {
    const int4* rt = rtab + buf * G_KC;
    T* dst = in_s + buf * BC * KCP;
    if (in_vec) {
      constexpr int SEGS = G_KC / V;
      for (int e = threadIdx.x; e < BC * SEGS; e += THR) {
        const int cc = e / SEGS, rr = e % SEGS * V;
        const int off = in_off(rt[rr], cc);
        cp_async_n(dst + cc * KCP + rr, in + (off >= 0 ? off : 0), 16,
                   off >= 0);
      }
    } else if (cmaj) {
      for (int e = threadIdx.x; e < BC * G_KC; e += THR) {
        const int cc = e / G_KC, rr = e % G_KC;
        const int off = in_off(rt[rr], cc);
        Io<T>::copy1(dst + cc * KCP + rr, in + (off >= 0 ? off : 0),
                     off >= 0);
      }
    } else {
      for (int e = threadIdx.x; e < (G_KC << pk_shift); e += THR) {
        const int rr = e >> pk_shift, cc = (e & pk_mask) * E;
        const int off = in_off(rt[rr], cc);
        T* d = dst + rr * BC + cc;
        const T* s = in + (off >= 0 ? off : 0);
        if (EB >= 4)
          cp_async_n(d, s, EB, off >= 0);
        else
          Io<T>::copy1(d, s, off >= 0);
      }
    }
    if constexpr (!RES) {
      T* fd = flt_s + buf * G_KC * BM;
      const int rc = r0 + q * G_KC;
      if (flt_vec) {
        constexpr int SEG = BM / V;
        for (int e = threadIdx.x; e < G_KC * SEG; e += THR) {
          const int rr = e / SEG, ml = e % SEG * V;
          const bool ok = rc + rr < r1 && ml < g.bm;
          cp_async_n(fd + rr * BM + ml,
                     flt + (ok ? (size_t)(rc + rr) * g.M + m0 + ml : 0), 16,
                     ok);
        }
      } else {
        for (int e = threadIdx.x; e < G_KC * BM; e += THR) {
          const int rr = e / BM, ml = e % BM;
          const bool ok = rc + rr < r1 && ml < g.bm;
          Io<T>::copy1(fd + e,
                       flt + (ok ? (size_t)(rc + rr) * g.M + m0 + ml : 0),
                       ok);
        }
      }
    }
  };

  if constexpr (RES) {
    // the whole filter, zero past R rows and M columns, once per block:
    // shared row i holds reduction value r = s * seg_len + rr of segment
    // s = i / (nqs * G_KC), rr = i % (nqs * G_KC) (r = i unsplit), zero
    // past the segment's end
    const int rows = nseg * nqs * G_KC;
    const int srows = nqs * G_KC;
    auto src_row = [&](int i) {
      const int sg = i / srows, rr = i - sg * srows;
      const int r = sg * seg_len + rr;
      return rr < seg_len && r < R ? r : -1;
    };
    if (flt_al && g.M % V == 0) {
      const int segs = Mp / V;
      for (int e = threadIdx.x; e < rows * segs; e += THR) {
        const int i = e / segs, m = (e - i * segs) * V;
        const int r = src_row(i);
        const bool ok = r >= 0 && m < g.M;
        cp_async_n(flt_s + (size_t)i * Mp + m,
                   flt + (ok ? (size_t)r * g.M + m : 0), 16, ok);
      }
    } else {
      for (int e = threadIdx.x; e < rows * Mp; e += THR) {
        const int i = e / Mp, m = e - i * Mp;
        const int r = src_row(i);
        const bool ok = r >= 0 && m < g.M;
        Io<T>::copy1(flt_s + e, flt + (ok ? (size_t)r * g.M + m : 0), ok);
      }
    }
  }

  // one BM x BC output tile of segment sg: the chunks of its reduction,
  // double-buffered
  auto tile = [&](int ct, int mt, int sg) {
    c0 = ct * BC;
    m0 = mt * (RES ? BM : g.bm);
    r0 = sg * seg_len;
    r1 = min(R, r0 + seg_len);
    nq = (r1 - r0 + G_KC - 1) / G_KC;
    __syncthreads();   // the last tile is done with the tables and buffers
    for (int e = threadIdx.x; e < (g.fh + g.fw) * BC; e += THR) {
      const int a = e / BC, c = c0 + e % BC;
      int v = -1;
      if (c < C) {
        const int p = c / g.N, n = c - p * g.N;
        const int oh = p / g.outW, ow = p - oh * g.outW;
        if (a < g.fh) {
          const int ih =
              in_coord(oh, a, g.stdH, g.fdilH, g.padH, g.dilH, g.Hl);
          if (ih >= 0) v = ih * g.Wl * g.K * g.N;
        } else {
          const int iw =
              in_coord(ow, a - g.fh, g.stdW, g.fdilW, g.padW, g.dilW, g.Wl);
          if (iw >= 0) v = iw * g.K * g.N + n;
        }
      }
      rowtab[e] = v;   // coltab follows rowtab
    }
    if (threadIdx.x < G_KC)
      fill_r(0, 0, threadIdx.x);
    else if (threadIdx.x < 2 * G_KC)
      fill_r(1, 1, threadIdx.x - G_KC);
    __syncthreads();
    stage(0, 0);
    cp_async_commit();

    float acc[TM][TC];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int s = 0; s < TC; ++s) acc[r][s] = 0.f;
    const int fs = RES ? Mp : BM;
    for (int q = 0; q < nq; ++q) {
      cp_async_wait_all();
      __syncthreads();   // chunk q is in; every thread is done with q - 1
      if (q + 1 < nq) stage(q + 1, (q + 1) & 1);
      cp_async_commit();

      const T* fr =
          (RES ? flt_s + ((size_t)sg * nqs + q) * G_KC * Mp + m0
               : flt_s + (q & 1) * G_KC * BM) + tm * VR;
      const T* src = in_s + (q & 1) * BC * KCP;
      if (cmaj) {
#pragma unroll 2
        for (int kk = 0; kk < G_KC; kk += VK) {
          float b[TC][VK];
#pragma unroll
          for (int s = 0; s < TC; ++s)
            ldv<VK>(src + (tc + s * CT) * KCP + kk, b[s]);
#pragma unroll
          for (int j = 0; j < VK; ++j) {
            float a[TM];
#pragma unroll
            for (int v = 0; v < TM / VR; ++v)
              ldv<VR>(fr + (kk + j) * fs + v * MT * VR, a + v * VR);
#pragma unroll
            for (int r = 0; r < TM; ++r)
#pragma unroll
              for (int s = 0; s < TC; ++s)
                acc[r][s] = fmaf(a[r], b[s][j], acc[r][s]);
          }
        }
      } else {
#pragma unroll 4
        for (int kk = 0; kk < G_KC; ++kk) {
          float a[TM], b[TC];
#pragma unroll
          for (int v = 0; v < TM / VR; ++v)
            ldv<VR>(fr + kk * fs + v * MT * VR, a + v * VR);
#pragma unroll
          for (int v = 0; v < TC / VC; ++v)
            ldv<VC>(src + kk * BC + (v * CT + tc) * VC, b + v * VC);
#pragma unroll
          for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int s = 0; s < TC; ++s)
              acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
        }
      }
      // the chunk after next reuses this chunk's rtab rows: its copies were
      // issued before this iteration's barrier
      if (threadIdx.x < G_KC && q + 2 < nq) fill_r(q + 2, q & 1, threadIdx.x);
    }

    // a thread's outputs: VR consecutive rows of a column are contiguous
    // at batch 1, VC consecutive columns of a row (one pixel's batch run)
    // at batch N > 1: one 16-byte (or narrower) store each where whole;
    // into `out` as T, or into segment sg's f32 partials
    const int mlim = RES ? min(BM, g.M - m0) : g.bm;
    auto store = [&](auto* dst) {
      using O = typename std::remove_pointer<decltype(dst)>::type;
      const bool dst_al = reinterpret_cast<uintptr_t>(dst) % 16 == 0;
      if (cmaj) {
        const bool vst = dst_al && g.M % VR == 0 && mlim % VR == 0;
#pragma unroll
        for (int s = 0; s < TC; ++s) {
          const int c = c0 + tc + s * CT;
          if (c >= C) continue;
#pragma unroll
          for (int v = 0; v < TM / VR; ++v) {
            const int ml = (v * MT + tm) * VR;
            O* o = dst + (size_t)c * g.M + m0 + ml;
            float x[VR];
#pragma unroll
            for (int u = 0; u < VR; ++u) x[u] = acc[v * VR + u][s];
            if (vst) {
              if (ml < mlim) stv<VR>(o, x);
            } else {
#pragma unroll
              for (int u = 0; u < VR; ++u)
                if (ml + u < mlim) o[u] = from_f<O>(x[u]);
            }
          }
        }
      } else {
        // SW columns a store: the thread's VC columns where they are one
        // pixel's, pairs of them where N is even
        const int sw = !dst_al || BC % g.N != 0 ? 1
                       : g.N % VC == 0          ? VC
                       : g.N % 2 == 0           ? 2
                                                : 1;
#pragma unroll
        for (int v = 0; v < TC / VC; ++v) {
          const int c = c0 + (v * CT + tc) * VC;
          size_t off[VC];   // each column's (pixel, batch) offset, -1 past C
#pragma unroll
          for (int u = 0; u < VC; ++u) {
            const int p = (c + u) / g.N, n = c + u - p * g.N;
            off[u] = c + u < C ? (size_t)p * g.M * g.N + n : ~(size_t)0;
          }
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const int ml = ((r / VR) * MT + tm) * VR + r % VR;
            if (ml >= mlim) continue;
            O* o = dst + (size_t)(m0 + ml) * g.N;
            const float* x = &acc[r][v * VC];
            if (sw == VC) {
              if (off[0] != ~(size_t)0) stv<VC>(o + off[0], x);
            } else if (sw == 2) {
#pragma unroll
              for (int u = 0; u < VC; u += 2)
                if (off[u] != ~(size_t)0) stv<2>(o + off[u], x + u);
            } else {
#pragma unroll
              for (int u = 0; u < VC; ++u)
                if (off[u] != ~(size_t)0) o[off[u]] = from_f<O>(x[u]);
            }
          }
        }
      }
    };
    if (nseg > 1)
      store(ws + (size_t)sg * C * g.M);
    else
      store(out);
  };

  if constexpr (RES) {
    // persistent: work items (segment, column tile, m-tile), x, x + grid,
    // ...; item w is segment w / (n_ct * n_mt), and of the rest v, column
    // tile v / n_mt, m-tile v % n_mt
    const int n_mt = Mp / BM;
    const int per_seg = n_ct * n_mt;
    for (int w = blockIdx.x; w < per_seg * nseg; w += gridDim.x) {
      const int sg = w / per_seg, v = w - sg * per_seg;
      tile(v / n_mt, v - v / n_mt * n_mt, sg);
    }
  } else {
    tile(blockIdx.x, blockIdx.y, blockIdx.z);
  }
}

// Threads of a TB11/TB88 block, and the blocks per SM its registers are
// sized for: 128 registers a thread, but an 8 x 8 tile's 64 accumulators
// get 170 (255 at 256 threads), under which it spills nothing.
__host__ __device__ constexpr int gemm_threads(int BM, int BC, int TM,
                                               int TC) {
  return BM / TM * (BC / TC);
}
__host__ __device__ constexpr int gemm_min_blocks(int BM, int BC, int TM,
                                                  int TC) {
  return (TM * TC >= 64 ? 384 : 512) / gemm_threads(BM, BC, TM, TC);
}

// TB11 (replaces conv_tb11, mg3m_conv.py:288): persistent blocks, each
// loading the whole filter once; feasible while it fits 227 KB.
template <typename T, int BM, int BC, int TM, int TC>
__global__ void __launch_bounds__(gemm_threads(BM, BC, TM, TC),
                                  gemm_min_blocks(BM, BC, TM, TC))
    mg3m_tb11_kernel(const T* __restrict__ in, const T* __restrict__ flt,
                     T* __restrict__ out, float* __restrict__ ws, Geom g) {
  gemm_body<T, BM, BC, TM, TC, true>(in, flt, out, ws, g);
}

// TB88 (replaces conv_tb88, mg3m_conv.py:352): block (column tile,
// m-tile, reduction segment), the filter streamed in [G_KC][BM] tiles
// beside the IN tile.  Nothing resident but the column tables.
template <typename T, int BM, int BC, int TM, int TC>
__global__ void __launch_bounds__(gemm_threads(BM, BC, TM, TC),
                                  gemm_min_blocks(BM, BC, TM, TC))
    mg3m_tb88_kernel(const T* __restrict__ in, const T* __restrict__ flt,
                     T* __restrict__ out, float* __restrict__ ws, Geom g) {
  gemm_body<T, BM, BC, TM, TC, false>(in, flt, out, ws, g);
}

// ---- segsum: begin.  This block is the same in mg3m_conv.cu and
// causal_conv1d.cu but for the kernel's name (tests/test_torch_causal_
// conv1d_bwd.py holds the two copies equal). ----
//
// The second pass of a reduction split into segments (replaces no TPU
// kernel: a Pallas grid walks a reduction in order on one core and carries
// its sum from step to step): out[i] = ws[0][i] + ws[1][i] + ... +
// ws[nseg - 1][i], one f32 add each in that order, cast to T.  No atomics:
// the order never depends on which block finishes first.
//
// Bound by bytes (every partial read once, every output written once).
// The splits give few outputs and many segments (the ResNet trunk's L2
// wgrad 36 864 outputs of 98 segments, L0's 9 408; the conv1d backward's
// dw 29 184 of 32), so the pass has to keep many loads in flight with few
// threads.  Two walks, picked by the number of segments (both measured on
// the H100 at the ResNet trunk's splits):
//   * up to SEGSUM_STAGE_MIN segments, a thread owns V outputs and loads
//     SEGSUM_AHEAD values of their segments at once (SEGSUM_AHEAD / V
//     segments), all independent, before it adds them in order; one
//     thread per output where there are fewer than SEGSUM_VEC_MIN (so a
//     small split still spreads over every SM), four (16-byte loads) from
//     there on, where the pointers allow;
//   * past that, where this walk would wait for more than two rounds of
//     loads, a block's threads copy all the segments of 32 neighbouring
//     outputs (SEGSUM_STAGE_ROWS at a time) into shared memory with
//     cp.async, all in flight at once, and its first warp adds them in
//     order.
constexpr int SEGSUM_THREADS = 128;
constexpr int SEGSUM_AHEAD = 32;
constexpr long long SEGSUM_VEC_MIN = 1 << 17;
constexpr int SEGSUM_STAGE_MIN = 64;
constexpr int SEGSUM_STAGE_ROWS = 128;

template <int V>
__device__ __forceinline__ void segsum_load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void segsum_store(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}
template <int V>
__device__ __forceinline__ void segsum_store(__nv_bfloat16* p,
                                             const float (&v)[V]) {
  if constexpr (V == 4) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                           __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void segsum_walk(const float* __restrict__ ws,
                                            T* __restrict__ out, int nseg,
                                            long long n) {
  constexpr int U = SEGSUM_AHEAD / V;
  const long long i =
      ((long long)blockIdx.x * SEGSUM_THREADS + threadIdx.x) * V;
  if (i >= n) return;
  const float* p = ws + i;
  float acc[V], b[U][V];
  segsum_load<V>(p, acc);
  for (int s = 1; s < nseg; s += U) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (s + u < nseg) segsum_load<V>(p + (size_t)(s + u) * n, b[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (s + u < nseg) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += b[u][j];
      }
  }
  segsum_store<V>(out + i, acc);
}

template <typename T>
__device__ __forceinline__ void segsum_staged(const float* __restrict__ ws,
                                              T* __restrict__ out, int nseg,
                                              long long n) {
  constexpr int WARPS = SEGSUM_THREADS / 32;
  __shared__ float buf[SEGSUM_STAGE_ROWS][32];
  const int col = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long c = (long long)blockIdx.x * 32 + col;
  const bool live = c < n;
  float acc[1] = {0.f};
  for (int r0 = 0; r0 < nseg; r0 += SEGSUM_STAGE_ROWS) {
    const int rows = min(SEGSUM_STAGE_ROWS, nseg - r0);
    if (live)
      for (int r = warp; r < rows; r += WARPS) {
        const unsigned d = (unsigned)__cvta_generic_to_shared(&buf[r][col]);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                     "l"(ws + (size_t)(r0 + r) * n + c) : "memory");
      }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (warp == 0 && live) {
      int r = 0;
      if (r0 == 0) acc[0] = buf[r++][col];
      for (; r < rows; ++r) acc[0] += buf[r][col];
    }
    __syncthreads();
  }
  if (warp == 0 && live) segsum_store<1>(out + c, acc);
}

template <typename T, int V, bool STAGED>
__global__ void __launch_bounds__(SEGSUM_THREADS) mg3m_segsum_kernel(
    const float* __restrict__ ws, T* __restrict__ out, int nseg,
    long long n) {
  if constexpr (STAGED)
    segsum_staged<T>(ws, out, nseg, n);
  else
    segsum_walk<T, V>(ws, out, nseg, n);
}

template <typename T, int V, bool STAGED>
static int segsum_run(const float* ws, void* out, int nseg, long long n,
                      cudaStream_t stream) {
  const long long per_block = STAGED ? 32 : (long long)SEGSUM_THREADS * V;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  const auto kernel = mg3m_segsum_kernel<T, V, STAGED>;
  kernel<<<blocks, SEGSUM_THREADS, 0, stream>>>(ws, static_cast<T*>(out),
                                                nseg, n);
  return (int)cudaGetLastError();
}

template <typename T>
static int segsum_pick(const float* ws, void* out, int nseg, long long n,
                       bool vec, cudaStream_t stream) {
  if (nseg > SEGSUM_STAGE_MIN)
    return segsum_run<T, 1, true>(ws, out, nseg, n, stream);
  return vec ? segsum_run<T, 4, false>(ws, out, nseg, n, stream)
             : segsum_run<T, 1, false>(ws, out, nseg, n, stream);
}

// out[i] = sum over s in order of ws[s][i], i < n; dtype 0 float32, 1
// bfloat16; -1 for arguments the kernel does not take
static int segsum_launch(int dtype, const void* ws, void* out, int nseg,
                         long long n, cudaStream_t stream) {
  if (!ws || !out || nseg < 1 || n < 1 || (dtype != 0 && dtype != 1))
    return -1;
  const float* w = static_cast<const float*>(ws);
  const size_t es = dtype == 0 ? 4 : 2;
  const bool vec = n >= SEGSUM_VEC_MIN && n % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(ws) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * es) == 0;
  if (dtype == 0) return segsum_pick<float>(w, out, nseg, n, vec, stream);
  return segsum_pick<__nv_bfloat16>(w, out, nseg, n, vec, stream);
}
// ---- segsum: end ----

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename T>
static int launch(void (*kernel)(const T*, const T*, T*, float*, Geom),
                  dim3 grid, size_t smem, const T* in, const T* flt, T* out,
                  float* ws, const Geom& g, cudaStream_t stream,
                  int threads) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(in, flt, out, ws, g);
  return (int)cudaGetLastError();
}

// TB11's and TB88's shared memory (analysis/footprint.gemm_smem): see
// gemm_body.
template <typename T>
static size_t gemm_smem(const Geom& g, int BM, int BC, bool res) {
  const int nseg = g.nseg > 1 ? g.nseg : 1;
  const size_t seg_len =
      (size_t)(nseg > 1 ? g.seg_taps : g.fh * g.fw) * g.K;
  const size_t nq = nseg * ((seg_len + G_KC - 1) / G_KC);
  const size_t flt = res ? nq * G_KC * (size_t)((g.M + BM - 1) / BM * BM)
                         : (size_t)2 * G_KC * BM;
  return round16(flt * sizeof(T)) + 2 * (size_t)BC * t18_row<T>() * sizeof(T) +
         2 * G_KC * sizeof(int4) + 4 * (size_t)(g.fh + g.fw) * BC;
}

template <typename T, int BM, int BC, int TM, int TC>
static int tb11_shape(const void* in, const void* flt, void* out, float* ws,
                      const Geom& g, cudaStream_t s) {
  return launch(mg3m_tb11_kernel<T, BM, BC, TM, TC>, dim3(g.grid),
                gemm_smem<T>(g, BM, BC, true), (const T*)in, (const T*)flt,
                (T*)out, ws, g, s, BM / TM * (BC / TC));
}

template <typename T, int BM, int BC, int TM, int TC>
static int tb88_shape(const void* in, const void* flt, void* out, float* ws,
                      const Geom& g, cudaStream_t s) {
  const int C = g.outH * g.outW * g.N;
  return launch(mg3m_tb88_kernel<T, BM, BC, TM, TC>,
                dim3((C + BC - 1) / BC, g.M / g.bm, g.nseg),
                gemm_smem<T>(g, BM, BC, false), (const T*)in, (const T*)flt,
                (T*)out, ws, g, s, BM / TM * (BC / TC));
}

// The compiled (BM, BC, TM, TC) tiles of each grain (footprint.TB11_SHAPES,
// TB18_SHAPES, TB88_SHAPES), each named once: a dispatcher defines
// <grain>_SHAPE for one tile, expands the list, and undefines it.
#define TB11_TILES                                                       \
  TB11_SHAPE(64, 128, 8, 8) TB11_SHAPE(64, 128, 8, 4)                    \
  TB11_SHAPE(64, 64, 8, 4) TB11_SHAPE(64, 64, 4, 4) TB11_SHAPE(64, 32, 4, 4)
#define TB18_TILES                                                       \
  TB18_SHAPE(32, 64, 8, 4) TB18_SHAPE(32, 128, 8, 4)                     \
  TB18_SHAPE(32, 256, 8, 4) TB18_SHAPE(64, 128, 8, 4)                    \
  TB18_SHAPE(128, 64, 8, 4) TB18_SHAPE(8, 64, 4, 2)                      \
  TB18_SHAPE(8, 128, 4, 2) TB18_SHAPE(16, 64, 4, 2)                      \
  TB18_SHAPE(16, 128, 4, 2) TB18_SHAPE(32, 64, 4, 2)
#define TB88_TILES                                                       \
  TB88_SHAPE(128, 64, 8, 8) TB88_SHAPE(64, 128, 8, 8)                    \
  TB88_SHAPE(64, 128, 8, 4) TB88_SHAPE(64, 64, 8, 4)                     \
  TB88_SHAPE(64, 64, 4, 4) TB88_SHAPE(32, 128, 8, 4)                     \
  TB88_SHAPE(64, 32, 4, 4) TB88_SHAPE(128, 32, 4, 4)

template <typename T>
static int tb11(const void* in, const void* flt, void* out, float* ws,
                const Geom& g, cudaStream_t s) {
#define TB11_SHAPE(BM_, BC_, TM_, TC_)                                \
  if (g.tbm == BM_ && g.bc == BC_ && g.tm == TM_ && g.tc == TC_)      \
    return tb11_shape<T, BM_, BC_, TM_, TC_>(in, flt, out, ws, g, s);
  TB11_TILES
#undef TB11_SHAPE
  return -1;
}

template <typename T>
static int tb88(const void* in, const void* flt, void* out, float* ws,
                const Geom& g, cudaStream_t s) {
#define TB88_SHAPE(BM_, BC_, TM_, TC_)                                \
  if (g.tbm == BM_ && g.bc == BC_ && g.tm == TM_ && g.tc == TC_)      \
    return tb88_shape<T, BM_, BC_, TM_, TC_>(in, flt, out, ws, g, s);
  TB88_TILES
#undef TB88_SHAPE
  return -1;
}
// TB18's shared memory (analysis/footprint.tb18_smem): the padded slice,
// the double-buffered IN tile and the offset table.
template <typename T>
static size_t tb18_smem(const Geom& g, int BM, int BC) {
  const size_t taps = (size_t)g.fh * g.fw;
  const size_t kp = (size_t)(g.K + 7) / 8 * 8;
  return round16(taps * kp * BM * sizeof(T)) +
         2 * (size_t)BC * t18_row<T>() * sizeof(T) + 4 * taps * BC;
}

template <typename T, int BM, int BC, int TM, int TC>
static int tb18_shape(const void* in, const void* flt, void* out,
                      const Geom& g, cudaStream_t s) {
  return launch(mg3m_tb18_kernel<T, BM, BC, TM, TC>,
                dim3(g.grid, g.M / g.bm), tb18_smem<T>(g, BM, BC),
                (const T*)in, (const T*)flt, (T*)out, nullptr, g, s,
                BM / TM * (BC / TC));
}

// TB18 runs the smallest compiled m-tile that holds its slice.
template <typename T>
static int tb18(const void* in, const void* flt, void* out, const Geom& g,
                cudaStream_t s) {
  const int bm = g.bm <= 8 ? 8 : g.bm <= 16 ? 16 : g.bm <= 32 ? 32
               : g.bm <= 64 ? 64 : 128;
#define TB18_SHAPE(BM_, BC_, TM_, TC_)                              \
  if (bm == BM_ && g.bc == BC_ && g.tm == TM_ && g.tc == TC_)       \
    return tb18_shape<T, BM_, BC_, TM_, TC_>(in, flt, out, g, s);
  TB18_TILES
#undef TB18_SHAPE
  return -1;
}

static bool valid(const Geom* g) {
  return g && g->K > 0 && g->N > 0 && g->M > 0 && g->outH > 0 &&
         g->outW > 0 && g->fh > 0 && g->fw > 0 && g->dilH > 0 &&
         g->dilW > 0 &&
         // the offset tables hold int32 input offsets
         (long long)g->Hl * g->Wl * g->K * g->N < (1ll << 31);
}

// The output as the grain stores it: `out` whole (nseg 1), or nseg
// segments of seg_taps taps (the last shorter) into the workspace `ws`.
static bool valid_store(const Geom* g, const void* out, const void* ws) {
  if (g->nseg == 1) return out != nullptr;
  const int taps = g->fh * g->fw;
  return g->nseg > 1 && g->nseg <= 65535 && g->seg_taps > 0 &&
         (taps + g->seg_taps - 1) / g->seg_taps == g->nseg && ws != nullptr;
}

// TB18 slices and TB88 m-tiles: a width that divides M.
static bool valid_bm(const Geom* g) {
  return g->bm > 0 && g->bm <= 128 && g->M % g->bm == 0;
}

// ---------------------------------------------------------------------------
// verifier hooks, for analysis/verify.py and chip_smoke.py only:
// mg3m_in_coord_table evaluates the device's own in_coord over one axis,
// mg3m_tile_attributes reports what the runtime says of one compiled tile
// instance (registers, limits, occupancy at the plan's shared memory)
// ---------------------------------------------------------------------------
__global__ void in_coord_table_kernel(Geom g, int axis, int* out) {
  const int taps = axis == 0 ? g.fh : g.fw;
  const int n_out = axis == 0 ? g.outH : g.outW;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_out * taps) return;
  const int o = e / taps, t = e - o * taps;
  out[e] = axis == 0
               ? in_coord(o, t, g.stdH, g.fdilH, g.padH, g.dilH, g.Hl)
               : in_coord(o, t, g.stdW, g.fdilW, g.padW, g.dilW, g.Wl);
}

// registers, max threads per block, max dynamic shared memory (after the
// opt-in to smem), resident blocks per SM at smem, local bytes per thread
template <typename K>
static int tile_attrs_of(K kernel, int smem, int threads, int* out) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = a.maxThreadsPerBlock;
  out[2] = a.maxDynamicSharedSizeBytes;
  out[3] = blocks;
  out[4] = (int)a.localSizeBytes;
  return 0;
}

// grain: 0 = TB11, 1 = TB18, 2 = TB88; t: the compiled (BM, BC, TM, TC)
template <typename T>
static int tile_attrs(int grain, const int* t, int smem, int* out) {
#define TB11_SHAPE(BM_, BC_, TM_, TC_)                                    \
  if (grain == 0 && t[0] == BM_ && t[1] == BC_ && t[2] == TM_ &&          \
      t[3] == TC_)                                                        \
    return tile_attrs_of(mg3m_tb11_kernel<T, BM_, BC_, TM_, TC_>, smem,   \
                         BM_ / TM_ * (BC_ / TC_), out);
  TB11_TILES
#undef TB11_SHAPE
#define TB18_SHAPE(BM_, BC_, TM_, TC_)                                    \
  if (grain == 1 && t[0] == BM_ && t[1] == BC_ && t[2] == TM_ &&          \
      t[3] == TC_)                                                        \
    return tile_attrs_of(mg3m_tb18_kernel<T, BM_, BC_, TM_, TC_>, smem,   \
                         BM_ / TM_ * (BC_ / TC_), out);
  TB18_TILES
#undef TB18_SHAPE
#define TB88_SHAPE(BM_, BC_, TM_, TC_)                                    \
  if (grain == 2 && t[0] == BM_ && t[1] == BC_ && t[2] == TM_ &&          \
      t[3] == TC_)                                                        \
    return tile_attrs_of(mg3m_tb88_kernel<T, BM_, BC_, TM_, TC_>, smem,   \
                         BM_ / TM_ * (BC_ / TC_), out);
  TB88_TILES
#undef TB88_SHAPE
  return -1;
}

extern "C" {

const char* mg3m_error_string(int code) {
  return code < 0 ? "arguments the kernels do not take"
                  : cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16.  ws: the f32 partials [nseg][outH *
// outW * M * N] of a split reduction (Geom.nseg > 1; out unused), else
// null.
int mg3m_tb11(int dtype, const void* in, const void* flt, void* out,
              void* ws, const Geom* g, void* stream) {
  if (!valid(g) || !valid_store(g, out, ws) || g->grid <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  float* w = (float*)ws;
  if (dtype == 0) return tb11<float>(in, flt, out, w, *g, s);
  if (dtype == 1) return tb11<__nv_bfloat16>(in, flt, out, w, *g, s);
  return -1;
}

int mg3m_tb18(int dtype, const void* in, const void* flt, void* out,
              void* ws, const Geom* g, void* stream) {
  if (!valid(g) || !valid_bm(g) || g->grid <= 0 || g->nseg != 1 || !out ||
      ws)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return tb18<float>(in, flt, out, *g, s);
  if (dtype == 1) return tb18<__nv_bfloat16>(in, flt, out, *g, s);
  return -1;
}

int mg3m_tb88(int dtype, const void* in, const void* flt, void* out,
              void* ws, const Geom* g, void* stream) {
  if (!valid(g) || !valid_bm(g) || !valid_store(g, out, ws) ||
      g->bm > g->tbm)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  float* w = (float*)ws;
  if (dtype == 0) return tb88<float>(in, flt, out, w, *g, s);
  if (dtype == 1) return tb88<__nv_bfloat16>(in, flt, out, w, *g, s);
  return -1;
}

// out[i] = sum over s in order of ws[s][i], i < n, cast (dtype as above)
int mg3m_segsum(int dtype, const void* ws, void* out, int nseg, long long n,
                void* stream) {
  return segsum_launch(dtype, ws, out, nseg, n, (cudaStream_t)stream);
}

// out: [outH][fh] (axis 0) or [outW][fw] (axis 1) int32 on the device
int mg3m_in_coord_table(const Geom* g, int axis, int* out, void* stream) {
  if (!valid(g) || !out || (axis != 0 && axis != 1)) return -1;
  const int n = axis == 0 ? g->outH * g->fh : g->outW * g->fw;
  in_coord_table_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      *g, axis, out);
  return (int)cudaGetLastError();
}

// out: the five values of tile_attrs_of; -1 for a tile not compiled
int mg3m_tile_attributes(int grain, const int* tile, int dtype, int smem,
                         int* out) {
  if (!tile || !out || smem < 0) return -1;
  if (dtype == 0) return tile_attrs<float>(grain, tile, smem, out);
  if (dtype == 1) return tile_attrs<__nv_bfloat16>(grain, tile, smem, out);
  return -1;
}

}  // extern "C"
