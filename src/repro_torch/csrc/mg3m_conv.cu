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
// so tiling pixels and batch together keeps the 256 threads busy.  Each
// thread holds a 4 x 4 register tile (BM * BC == 4096).
//
// What bounds these kernels on an H100: at the ResNet trunk's shapes the
// arithmetic intensity is far above the card's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte), so their roofline bound is operations — f32
// FMA on the CUDA cores, since this first version issues no tensor-core
// (wgmma) instruction.  Measured, they run at a few percent of that bound
// (PERF.md): the instructions that stage tiles into shared memory, not the
// FMAs, take most of the time.  The design answers with reuse (every
// shared-memory value feeds four FMAs from registers) and with staging
// loops free of integer division (power-of-two index splits, eight loads in
// flight per thread).  TMA, wgmma and pipelining are for a later version.
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
};

constexpr int THREADS = 256;
constexpr int TM = 4;        // register tile rows (OC)
constexpr int TC = 4;        // register tile columns (pixel x batch)
constexpr int TILE = THREADS * TM * TC;
constexpr int RES_BK = 16;   // k chunk of the IN tile in TB11/TB18
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

// TB11 and TB18 share this body: filter columns [w0, w0 + W) of every tap
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

// TB18 (replaces conv_tb18, mg3m_conv.py:320): block (column strip, OC
// slice); the slice [fh, fw, K, bm] is loaded once per block.
template <typename T, int BM>
__global__ void __launch_bounds__(THREADS)
    mg3m_tb18_kernel(const T* __restrict__ in, const T* __restrict__ flt,
                     T* __restrict__ out, Geom g) {
  resident_body<T, BM>(in, flt, out, g, blockIdx.y * g.bm, g.bm);
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
                  const Geom& g, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, THREADS, smem, stream>>>(in, flt, out, g);
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

template <typename T, int BM>
static int tb18_bm(const void* in, const void* flt, void* out, const Geom& g,
                   cudaStream_t s) {
  const size_t smem = resident_smem<T>(g, g.bm, BM);
  return launch(mg3m_tb18_kernel<T, BM>, dim3(g.grid, g.M / g.bm), smem,
                (const T*)in, (const T*)flt, (T*)out, g, s);
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

// The compiled m-tile that runs a runtime width bm (footprint.kernel_bm).
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

// TB18 slices and TB88 m-tiles: a compiled width that divides M.
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
  if (!valid(g) || !valid_bm(g) || g->grid <= 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return DISPATCH_BM(tb18_bm, float, g->bm, in, flt, out, *g, s);
  if (dtype == 1)
    return DISPATCH_BM(tb18_bm, __nv_bfloat16, g->bm, in, flt, out, *g, s);
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
