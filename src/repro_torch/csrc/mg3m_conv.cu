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
// TB11 and TB88 (first version): 256 threads, a 4 x 4 register tile per
// thread (BM * BC == 4096), every shared value feeding four FMAs, tiles
// staged by the threads between two barriers.
//
// TB18 (redesigned): the limit is getting operands to the FMAs, so
//   * a TM x TC register tile per thread, (BM / TM) x (BC / TC) threads,
//     8 x 4 or, where a layer has few outputs and needs more warps per SM,
//     4 x 2: the thread's 8 filter rows are one 16-byte shared read (bf16)
//     or two (f32), its IN operand is read as 4 (f32) or 8 (bf16) k values
//     of a column at once, so every shared load feeds 5 (4 x 2) to 10
//     (8 x 4) FMAs, with no conversion or bounds check of the filter in
//     the loop (the resident slice is padded with zeros to the compiled BM
//     and to K rounded up to 8); the 4 x 2 tile unrolls a full k chunk;
//   * the IN tile (32 k x BC columns) is double-buffered and staged by
//     cp.async with zero-fill (src-size 0) for masked taps, holes and k
//     past K.  At batch 1 it is column-major and a copy is 16 bytes of a
//     column's contiguous k values; f32 at batch > 1 copies single
//     elements; bf16 at batch N > 1 is k-major and a copy is up to 16 bytes
//     of one pixel's N contiguous batch entries (4 bytes at N = 2), since
//     a 2-byte element is below cp.async's minimum (bf16 shapes that allow
//     neither go through registers).  The next chunk's copies are in
//     flight while this chunk's FMAs run, one barrier per chunk;
//   * each column's input offset is computed once per tap per tile into a
//     [taps][BC] table, not per element;
//   * the tile is one of the compiled (BM, BC, TM, TC) below, chosen in
//     Python by the selector (core/mapping prices every tile: masked
//     columns, waves over the 132 SMs at the footprint's occupancy, and
//     the warps an SM holds) and passed in the Geom.
// Its bound at trunk L9, batch 1 (0.925 GFLOP): 0.0138 ms at 67 TFLOP/s.
//
// The index map (the reference's _in_index_map, mg3m_conv.py:64-89) is the
// one device function in_coord.  Dense route: the input arrives
// pre-padded and pad = 0, dil = 1.  Lhs-dilated route: the input is the
// compact one and the coordinate is translated back through pad and dil.
// A dilation hole or an out-of-range tap is a masked load of zero; the
// reference instead reads an appended all-zero sentinel row/column, which
// this port therefore does not append.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmg3m_conv.so mg3m_conv.cu
// The C entry points take a Geom by pointer and return the CUDA error code
// of the launch (0 = launched), or -1 for arguments the kernels do not take.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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
  int bk;            // TB88 k chunk
  int grid;          // TB11/TB18: blocks along the column axis
  int bc;            // TB18: column tile (a compiled width for bm)
  int tm, tc;        // TB18: thread tile (8 x 4 or 4 x 2)
};

constexpr int THREADS = 256;
constexpr int TM = 4;        // register tile rows (OC)
constexpr int TC = 4;        // register tile columns (pixel x batch)
constexpr int TILE = THREADS * TM * TC;
constexpr int RES_BK = 16;   // k chunk of the IN tile in TB11
constexpr int BK_MAX = 32;   // largest TB88 k chunk
constexpr int COL_TABLE = 3; // int (oh, ow, n) per tile column

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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

// Column table of the tile starting at column c0: (oh, ow, n) per column,
// oh = -1 past the last column.
template <int BC>
__device__ void fill_columns(int c0, const Geom& g, int* col_oh, int* col_ow,
                             int* col_n) {
  const int C = g.outH * g.outW * g.N;
  for (int cc = threadIdx.x; cc < BC; cc += THREADS) {
    const int c = c0 + cc;
    if (c < C) {
      const int p = c / g.N;
      col_n[cc] = c % g.N;
      col_oh[cc] = p / g.outW;
      col_ow[cc] = p % g.outW;
    } else {
      col_oh[cc] = -1;
      col_ow[cc] = 0;
      col_n[cc] = 0;
    }
  }
}

// Cooperative block copy of `total` elements, store(e, load(e)), with
// COPY_UNROLL independent loads in flight per thread: a single outstanding
// load per thread leaves the staging loops waiting on memory latency.
constexpr int COPY_UNROLL = 8;

template <typename V, typename Load, typename Store>
__device__ __forceinline__ void coop_copy(int total, Load load, Store store) {
  for (int e0 = threadIdx.x; e0 < total; e0 += THREADS * COPY_UNROLL) {
    V v[COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const int e = e0 + u * THREADS;
      if (e < total) v[u] = load(e);
    }
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const int e = e0 + u * THREADS;
      if (e < total) store(e, v[u]);
    }
  }
}

// in_s[kk][cc] = IN[at(col cc, tap (i, j)), k0 + kk, n(cc)] as f32, zero
// where masked.  kk runs fastest across threads (at batch 1 the k axis is
// the contiguous one), over a power-of-two stride so that splitting the
// element index takes a shift and a mask, not an integer division.
template <typename T, int BC>
__device__ void stage_in(const T* __restrict__ in, const Geom& g, int i, int j,
                         int k0, int kc, const int* col_oh, const int* col_ow,
                         const int* col_n, float* in_s) {
  int ks = 0;
  while ((1 << ks) < kc) ++ks;
  const int kmask = (1 << ks) - 1;
  coop_copy<float>(
      BC << ks,
      [&](int e) {
        const int kk = e & kmask;
        const int cc = e >> ks;
        const int oh = col_oh[cc];
        if (kk >= kc || oh < 0) return 0.f;
        const int ih = in_coord(oh, i, g.stdH, g.fdilH, g.padH, g.dilH, g.Hl);
        const int iw =
            in_coord(col_ow[cc], j, g.stdW, g.fdilW, g.padW, g.dilW, g.Wl);
        if (ih < 0 || iw < 0) return 0.f;
        return to_f(in[(((size_t)ih * g.Wl + iw) * g.K + k0 + kk) * g.N +
                       col_n[cc]]);
      },
      [&](int e, float v) {
        if ((e & kmask) < kc) in_s[(e & kmask) * BC + (e >> ks)] = v;
      });
}

// acc[r][s] += sum_kk flt_at(kk, row r) * in_s[kk][col s]; thread rows are
// tm + r * BM/TM and columns tc + s * BC/TC, so a warp's filter reads hit
// consecutive banks and its input reads broadcast.
template <int BM, int BC, typename FltAt>
__device__ __forceinline__ void fma_tile(float (&acc)[TM][TC], int kc,
                                         const float* in_s, FltAt flt_at,
                                         int tm, int tc) {
  constexpr int MT = BM / TM;
  constexpr int CT = BC / TC;
  for (int kk = 0; kk < kc; ++kk) {
    float a[TM], b[TC];
#pragma unroll
    for (int r = 0; r < TM; ++r) a[r] = flt_at(kk, tm + r * MT);
#pragma unroll
    for (int s = 0; s < TC; ++s) b[s] = in_s[kk * BC + tc + s * CT];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int s = 0; s < TC; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
  }
}

template <typename T, int BM, int BC>
__device__ void store_tile(T* __restrict__ out, const Geom& g,
                           const float (&acc)[TM][TC], int m0, int mlim,
                           int c0, int tm, int tc) {
  constexpr int MT = BM / TM;
  constexpr int CT = BC / TC;
  const int C = g.outH * g.outW * g.N;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int ml = tm + r * MT;
    if (ml >= mlim) continue;
#pragma unroll
    for (int s = 0; s < TC; ++s) {
      const int c = c0 + tc + s * CT;
      if (c >= C) continue;
      const int p = c / g.N;
      out[((size_t)p * g.M + m0 + ml) * g.N + c % g.N] = from_f<T>(acc[r][s]);
    }
  }
}

__host__ __device__ constexpr size_t round16(size_t b) {
  return (b + 15) / 16 * 16;
}

// TB11's body: filter columns [w0, w0 + W) of every tap
// stay resident in shared memory (in the IO type) while the block walks
// its strip of column tiles, m-tile by m-tile inside the resident width.
template <typename T, int BM>
__device__ void resident_body(const T* __restrict__ in,
                              const T* __restrict__ flt, T* __restrict__ out,
                              const Geom& g, int w0, int W) {
  constexpr int BC = TILE / BM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int taps = g.fh * g.fw;
  const size_t res_elems = (size_t)taps * g.K * W;
  T* flt_res = reinterpret_cast<T*>(smem);
  float* in_s = reinterpret_cast<float*>(smem + round16(res_elems * sizeof(T)));
  int* col_oh = reinterpret_cast<int*>(in_s + RES_BK * BC);
  int* col_ow = col_oh + BC;
  int* col_n = col_ow + BC;

  coop_copy<T>(
      (int)res_elems,
      [&](int e) { return flt[(size_t)(e / W) * g.M + w0 + e % W]; },
      [&](int e, T v) { flt_res[e] = v; });
  __syncthreads();

  const int tm = threadIdx.x % (BM / TM);
  const int tc = threadIdx.x / (BM / TM);
  const int n_ct = (g.outH * g.outW * g.N + BC - 1) / BC;
  for (int ct = blockIdx.x; ct < n_ct; ct += gridDim.x) {
    const int c0 = ct * BC;
    fill_columns<BC>(c0, g, col_oh, col_ow, col_n);
    __syncthreads();
    for (int m0 = 0; m0 < W; m0 += BM) {
      const int mlim = min(BM, W - m0);
      float acc[TM][TC] = {};
      for (int t = 0; t < taps; ++t) {
        const int i = t / g.fw, j = t % g.fw;
        for (int k0 = 0; k0 < g.K; k0 += RES_BK) {
          const int kc = min(RES_BK, g.K - k0);
          stage_in<T, BC>(in, g, i, j, k0, kc, col_oh, col_ow, col_n, in_s);
          __syncthreads();
          const T* fr = flt_res + ((size_t)t * g.K + k0) * W + m0;
          fma_tile<BM, BC>(
              acc, kc, in_s,
              [&](int kk, int ml) {
                return ml < mlim ? to_f(fr[(size_t)kk * W + ml]) : 0.f;
              },
              tm, tc);
          __syncthreads();
        }
      }
      store_tile<T, BM, BC>(out, g, acc, w0 + m0, mlim, c0, tm, tc);
    }
  }
}

// TB11 (replaces conv_tb11, repro/kernels/mg3m_conv.py:288): persistent
// blocks, each loading the whole filter once; feasible while it fits 227 KB.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    mg3m_tb11_kernel(const T* __restrict__ in, const T* __restrict__ flt,
                     T* __restrict__ out, Geom g) {
  resident_body<T, 64>(in, flt, out, g, 0, g.M);
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

// VK consecutive k values of one staged column (16 bytes) as f32, and the
// TM resident filter rows of one k (8 to 32 bytes) as f32, both exact;
// copy1 stages one element, zero where masked.
template <typename T> struct Io;
template <> struct Io<float> {
  static constexpr int VK = 4;
  __device__ static void in16(const float* p, float (&x)[VK]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  template <int TM>
  __device__ static void rows(const float* p, float (&x)[TM]) {
#pragma unroll
    for (int u = 0; u < TM / 4; ++u) {
      const float4 a = reinterpret_cast<const float4*>(p)[u];
      x[4 * u] = a.x; x[4 * u + 1] = a.y; x[4 * u + 2] = a.z;
      x[4 * u + 3] = a.w;
    }
  }
  template <int TC>
  __device__ static void cols(const float* p, float (&x)[TC]) {
    if constexpr (TC == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      x[0] = v.x; x[1] = v.y;
    }
  }
  __device__ static void copy1(float* dst, const float* src, bool ok) {
    cp_async_n(dst, src, 4, ok);
  }
};
template <> struct Io<__nv_bfloat16> {
  static constexpr int VK = 8;
  __device__ static void in16(const __nv_bfloat16* p, float (&x)[VK]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  template <int TM>
  __device__ static void rows(const __nv_bfloat16* p, float (&x)[TM]) {
    if constexpr (TM == 8) {
      in16(p, x);
    } else if constexpr (TM == 2) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      x[0] = f.x;
      x[1] = f.y;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int i = 0; i < TM / 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
      }
    }
  }
  template <int TC>
  __device__ static void cols(const __nv_bfloat16* p, float (&x)[TC]) {
    rows<TC>(p, x);
  }
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
  constexpr int VK = Io<T>::VK;
  auto step = [&](int kk) {
    float b[TC][VK];
#pragma unroll
    for (int s = 0; s < TC; ++s)
      Io<T>::in16(src + (tc + s * CT) * KCP + kk, b[s]);
#pragma unroll
    for (int j = 0; j < VK; ++j) {
      float a[TM];
      Io<T>::template rows<TM>(fr + (size_t)(kk + j) * BM, a);
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
    Io<T>::template cols<TC>(src + kk * BC + tc * TC, b);
    Io<T>::template rows<TM>(fr + (size_t)kk * BM, a);
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
                     T* __restrict__ out, Geom g) {
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

// TB88 (replaces conv_tb88, mg3m_conv.py:352): block (column tile,
// m-tile); the (tap, k-chunk) loop stages an f32 FLT tile [bk][BM] and an
// f32 IN tile [bk][BC] per step.  Nothing resident, so it fits any scene.
template <typename T, int BM>
__global__ void __launch_bounds__(THREADS)
    mg3m_tb88_kernel(const T* __restrict__ in, const T* __restrict__ flt,
                     T* __restrict__ out, Geom g) {
  constexpr int BC = TILE / BM;
  extern __shared__ __align__(16) unsigned char smem[];
  float* flt_s = reinterpret_cast<float*>(smem);
  float* in_s = flt_s + g.bk * BM;
  int* col_oh = reinterpret_cast<int*>(in_s + g.bk * BC);
  int* col_ow = col_oh + BC;
  int* col_n = col_ow + BC;

  const int c0 = blockIdx.x * BC;
  const int m0 = blockIdx.y * g.bm;
  const int mlim = g.bm;
  const int tm = threadIdx.x % (BM / TM);
  const int tc = threadIdx.x / (BM / TM);
  fill_columns<BC>(c0, g, col_oh, col_ow, col_n);
  __syncthreads();

  float acc[TM][TC] = {};
  const int taps = g.fh * g.fw;
  for (int t = 0; t < taps; ++t) {
    const int i = t / g.fw, j = t % g.fw;
    for (int k0 = 0; k0 < g.K; k0 += g.bk) {
      const int kc = min(g.bk, g.K - k0);
      coop_copy<float>(
          kc * BM,
          [&](int e) {
            const int kk = e / BM, ml = e % BM;
            return ml < mlim ? to_f(flt[((size_t)t * g.K + k0 + kk) * g.M +
                                        m0 + ml])
                             : 0.f;
          },
          [&](int e, float v) { flt_s[e] = v; });
      stage_in<T, BC>(in, g, i, j, k0, kc, col_oh, col_ow, col_n, in_s);
      __syncthreads();
      fma_tile<BM, BC>(
          acc, kc, in_s, [&](int kk, int ml) { return flt_s[kk * BM + ml]; },
          tm, tc);
      __syncthreads();
    }
  }
  store_tile<T, BM, BC>(out, g, acc, m0, mlim, c0, tm, tc);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
template <typename T>
static int launch(void (*kernel)(const T*, const T*, T*, Geom), dim3 grid,
                  size_t smem, const T* in, const T* flt, T* out,
                  const Geom& g, cudaStream_t stream, int threads = THREADS) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, threads, smem, stream>>>(in, flt, out, g);
  return (int)cudaGetLastError();
}

template <typename T>
static size_t resident_smem(const Geom& g, int W, int BM) {
  const int BC = TILE / BM;
  return round16((size_t)g.fh * g.fw * g.K * W * sizeof(T)) +
         sizeof(float) * (RES_BK * BC + COL_TABLE * BC);
}

template <typename T>
static int tb11(const void* in, const void* flt, void* out, const Geom& g,
                cudaStream_t s) {
  const size_t smem = resident_smem<T>(g, g.M, 64);
  return launch(mg3m_tb11_kernel<T>, dim3(g.grid), smem, (const T*)in,
                (const T*)flt, (T*)out, g, s);
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
                (const T*)in, (const T*)flt, (T*)out, g, s,
                BM / TM * (BC / TC));
}

// The compiled (BM, BC, TM, TC) tiles: analysis/footprint.TB18_SHAPES.
template <typename T>
static int tb18(const void* in, const void* flt, void* out, const Geom& g,
                cudaStream_t s) {
  const int bm = g.bm <= 8 ? 8 : g.bm <= 16 ? 16 : g.bm <= 32 ? 32
               : g.bm <= 64 ? 64 : 128;
#define TB18_SHAPE(BM_, BC_, TM_, TC_)                              \
  if (bm == BM_ && g.bc == BC_ && g.tm == TM_ && g.tc == TC_)       \
    return tb18_shape<T, BM_, BC_, TM_, TC_>(in, flt, out, g, s);
  TB18_SHAPE(32, 64, 8, 4) TB18_SHAPE(32, 128, 8, 4) TB18_SHAPE(32, 256, 8, 4)
  TB18_SHAPE(64, 128, 8, 4) TB18_SHAPE(128, 64, 8, 4)
  TB18_SHAPE(8, 64, 4, 2) TB18_SHAPE(8, 128, 4, 2)
  TB18_SHAPE(16, 64, 4, 2) TB18_SHAPE(16, 128, 4, 2)
  TB18_SHAPE(32, 64, 4, 2)
#undef TB18_SHAPE
  return -1;
}

template <typename T, int BM>
static int tb88_bm(const void* in, const void* flt, void* out, const Geom& g,
                   cudaStream_t s) {
  constexpr int BC = TILE / BM;
  const size_t smem =
      sizeof(float) * ((size_t)g.bk * BM + (size_t)g.bk * BC + COL_TABLE * BC);
  const int C = g.outH * g.outW * g.N;
  return launch(mg3m_tb88_kernel<T, BM>, dim3((C + BC - 1) / BC, g.M / g.bm),
                smem, (const T*)in, (const T*)flt, (T*)out, g, s);
}

// The compiled m-tile that runs a runtime width bm (footprint.kernel_bm),
// for TB88.
#define DISPATCH_BM(fn, T, bm, ...)                         \
  ((bm) <= 8     ? fn<T, 8>(__VA_ARGS__)                    \
   : (bm) <= 16  ? fn<T, 16>(__VA_ARGS__)                   \
   : (bm) <= 32  ? fn<T, 32>(__VA_ARGS__)                   \
   : (bm) <= 64  ? fn<T, 64>(__VA_ARGS__)                   \
   : (bm) <= 128 ? fn<T, 128>(__VA_ARGS__)                  \
                 : -1)

static bool valid(const Geom* g) {
  return g && g->K > 0 && g->N > 0 && g->M > 0 && g->outH > 0 &&
         g->outW > 0 && g->fh > 0 && g->fw > 0 && g->dilH > 0 &&
         g->dilW > 0;
}

// TB18 slices and TB88 m-tiles: a width that divides M.
static bool valid_bm(const Geom* g) {
  return g->bm > 0 && g->bm <= 128 && g->M % g->bm == 0;
}

extern "C" {

const char* mg3m_error_string(int code) {
  return code < 0 ? "arguments the kernels do not take"
                  : cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 = float32, 1 = bfloat16.
int mg3m_tb11(int dtype, const void* in, const void* flt, void* out,
              const Geom* g, void* stream) {
  if (!valid(g) || g->grid <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return tb11<float>(in, flt, out, *g, s);
  if (dtype == 1) return tb11<__nv_bfloat16>(in, flt, out, *g, s);
  return -1;
}

int mg3m_tb18(int dtype, const void* in, const void* flt, void* out,
              const Geom* g, void* stream) {
  // the offset table holds int32 input offsets
  if (!valid(g) || !valid_bm(g) || g->grid <= 0 ||
      (long long)g->Hl * g->Wl * g->K * g->N >= (1ll << 31))
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return tb18<float>(in, flt, out, *g, s);
  if (dtype == 1) return tb18<__nv_bfloat16>(in, flt, out, *g, s);
  return -1;
}

int mg3m_tb88(int dtype, const void* in, const void* flt, void* out,
              const Geom* g, void* stream) {
  if (!valid(g) || !valid_bm(g) || g->bk <= 0 || g->bk > BK_MAX ||
      g->K % g->bk != 0)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return DISPATCH_BM(tb88_bm, float, g->bm, in, flt, out, *g, s);
  if (dtype == 1)
    return DISPATCH_BM(tb88_bm, __nv_bfloat16, g->bm, in, flt, out, *g, s);
  return -1;
}

}  // extern "C"
