// Depthwise causal conv1d for Hopper (sm_90a): the Mamba2 conv of zamba2.
//
// Replaces the Pallas TPU kernel `causal_conv1d` (src/repro/kernels/
// causal_conv1d.py:38, body `_kernel` :25):
//
//   y[b, l, d] = sum_k w[k, d] * x[b, l - (K-1) + k, d],  zeros left of l = 0
//
// x, y [B, L, D] contiguous, w [K, D] contiguous, all float32 or all
// bfloat16; f32 accumulation, stored in x's dtype.
//
// What bounds it: memory.  Each output needs K <= 4 multiply-adds and the
// whole pass moves x once in and y once out (about 2 bytes of traffic per
// FLOP in bf16), far below the card's ~295 FLOP/byte ridge.  The design
// therefore only has to read x once and keep loads coalesced:
//   * a thread owns one channel d and a run of RUN consecutive positions;
//     its K-1 previous inputs ride along in registers, so every x element is
//     read from memory once (plus a K-1 halo per run), never K times;
//   * the 256 threads of a block take 256 neighbouring channels, so each
//     load of a warp is one contiguous segment of the row;
//   * the causal left edge and the ragged L and D edges are masked here, so
//     the wrapper passes the tensors as they are: no padding to blocks.
// Taps are summed as the Pallas kernel does, w[K-1]*x[l] first and then back
// in time, each product and sum rounded separately (__fmul_rn/__fadd_rn, no
// FMA contraction), so the plain PyTorch version in kernels/causal_conv1d.py
// matches this kernel bit for bit in f32.
//
// The backward (causal_conv1d_bwd_kernel + causal_conv1d_segsum_kernel)
// replaces no TPU kernel: the reference's Mamba2 calls the plain
// causal_conv1d_ref on its model path (src/repro/models/mamba2.py:149) and
// XLA differentiates it.  With s = K-1-k the shift of tap k,
//
//   dx[b, m, d] = sum_k w[k, d] * dy[b, m + s, d]    (zeros right of L-1)
//   dw[k, d]    = sum_{b, l >= s} x[b, l - s, d] * dy[b, l, d]
//
// dx in x's dtype, dw in w's; f32 sums.  Bound by bytes like the forward
// (x and dy read once, dx written once), so it is one fused pass:
//   * a thread owns one channel (a bf16 pair where D is even, for 4-byte
//     loads) and one segment of BWD_SEGMENT positions; it carries the K-1
//     preceding x values and the K-1 following dy values in registers and
//     loads BWD_AHEAD positions of both at a time before using them, so
//     each x and dy element is read once (plus a K-1 halo per segment)
//     with several loads in flight;
//   * 64-thread blocks, at least 16 held by each SM, so a training shape's
//     blocks all run in one wave;
//   * neighbouring threads take neighbouring channels (coalesced); the
//     ragged L and D edges are masked here, nothing is padded;
//   * dx is written as it goes; dw's K sums run over the segment's
//     positions in order and land, unreduced, in a workspace [S][K][D] f32,
//     S = B * ceil(L / BWD_SEGMENT) in (b, segment) order;
//   * causal_conv1d_segsum_kernel then adds the S partials in the order
//     s = 0, 1, ..., S-1 and casts: no atomics, no order that depends on
//     which block finishes first.  At zamba2-7b's training shape [1, 4096,
//     7296] the partials are 3.7 MB written and read, 4 % of the pass.
// dx's taps are summed s = 0, 1, ..., K-1 (w[K-1]*dy[m] first), each
// product and sum rounded on its own, so causal_conv1d_bwd_plain matches
// both passes bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // channels per block
constexpr int RUN = 16;       // positions per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
causal_conv1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, int L, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const int l0 = blockIdx.y * RUN;
  const size_t row = (size_t)blockIdx.z * L * D;
  const T* xb = x + row + d;
  T* yb = y + row + d;

  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wk[k] = to_f32(w[(size_t)k * D + d]);
  // win[j] = x[l - j]; win[1..K-1] carry the previous inputs (0 left of 0)
  float win[K];
#pragma unroll
  for (int j = 1; j < K; ++j) {
    const int l = l0 - j;
    win[j] = l >= 0 ? to_f32(xb[(size_t)l * D]) : 0.f;
  }
  const int l1 = min(l0 + RUN, L);
  for (int l = l0; l < l1; ++l) {
    win[0] = to_f32(xb[(size_t)l * D]);
    float acc = __fmul_rn(win[0], wk[K - 1]);
#pragma unroll
    for (int k = 1; k < K; ++k)
      acc = __fadd_rn(acc, __fmul_rn(win[k], wk[K - 1 - k]));
    store(yb + (size_t)l * D, acc);
#pragma unroll
    for (int j = K - 1; j > 0; --j) win[j] = win[j - 1];
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int B, int L,
                   int D, int K, cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, (L + RUN - 1) / RUN, B);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  switch (K) {
    case 1: causal_conv1d_kernel<T, 1><<<grid, THREADS, 0, stream>>>(xp, wp, yp, L, D); break;
    case 2: causal_conv1d_kernel<T, 2><<<grid, THREADS, 0, stream>>>(xp, wp, yp, L, D); break;
    case 3: causal_conv1d_kernel<T, 3><<<grid, THREADS, 0, stream>>>(xp, wp, yp, L, D); break;
    case 4: causal_conv1d_kernel<T, 4><<<grid, THREADS, 0, stream>>>(xp, wp, yp, L, D); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Sizes measured on the H100 at zamba2-7b's training shape, the fastest
// of the variants tried: small blocks held 16 to an SM (registers capped
// at 64), so the 1 824 blocks of [1, 4096, 7296] run in one wave, and six
// positions loaded ahead (the bf16 K = 4 instance spills 12 bytes at that
// cap and is still faster than with four).
constexpr int BWD_THREADS = 64;     // channels (or bf16 pairs) per block
constexpr int BWD_SEGMENT = 128;    // positions per thread: one dw segment
constexpr int BWD_AHEAD = 6;        // positions loaded before they are used
constexpr int BWD_MIN_BLOCKS = 16;  // blocks an SM must hold

// V neighbouring values of one row as f32, and back (V = 2: a bf16 pair)
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  v[0] = *p;
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 2) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  *p = v[0];
}
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 2)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  else
    *p = __float2bfloat16_rn(v[0]);
}

// block (channel block, segment, batch row); ws[(b * nseg + seg)][k][d]
template <typename T, int K, int V>
__global__ void __launch_bounds__(BWD_THREADS, BWD_MIN_BLOCKS)
causal_conv1d_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ ws, int L, int D) {
  const int d = (blockIdx.x * BWD_THREADS + threadIdx.x) * V;
  if (d >= D) return;
  const int seg = blockIdx.y, nseg = gridDim.y;
  const int l0 = seg * BWD_SEGMENT;
  const int l1 = min(l0 + BWD_SEGMENT, L);
  const size_t row = (size_t)blockIdx.z * L * D + d;
  const T* xb = x + row;
  const T* yb = dy + row;
  T* gb = dx + row;

  float wk[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) load_v<V>(w + (size_t)k * D + d, wk[k]);
  // xw[j] = x[m - j] (0 left of 0); yw[j] = dy[m + j] (0 right of L-1)
  float xw[K][V], yw[K][V], acc[K][V];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      xw[j][v] = 0.f;
      yw[j][v] = 0.f;
      acc[j][v] = 0.f;
    }
#pragma unroll
  for (int j = 1; j < K; ++j)
    if (l0 - j >= 0) load_v<V>(xb + (size_t)(l0 - j) * D, xw[j]);
#pragma unroll
  for (int j = 0; j + 1 < K; ++j)
    if (l0 + j < L) load_v<V>(yb + (size_t)(l0 + j) * D, yw[j]);

  for (int m0 = l0; m0 < l1; m0 += BWD_AHEAD) {
    float xs[BWD_AHEAD][V], ys[BWD_AHEAD][V];
#pragma unroll
    for (int u = 0; u < BWD_AHEAD; ++u) {
      const int m = m0 + u;
#pragma unroll
      for (int v = 0; v < V; ++v) xs[u][v] = ys[u][v] = 0.f;
      if (m < l1) load_v<V>(xb + (size_t)m * D, xs[u]);
      if (m < l1 && m + K - 1 < L)
        load_v<V>(yb + (size_t)(m + K - 1) * D, ys[u]);
    }
#pragma unroll
    for (int u = 0; u < BWD_AHEAD; ++u) {
      const int m = m0 + u;
      if (m >= l1) break;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        xw[0][v] = xs[u][v];
        yw[K - 1][v] = ys[u][v];
      }
      float g[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float a = __fmul_rn(wk[K - 1][v], yw[0][v]);
#pragma unroll
        for (int s = 1; s < K; ++s)
          a = __fadd_rn(a, __fmul_rn(wk[K - 1 - s][v], yw[s][v]));
        g[v] = a;
#pragma unroll
        for (int k = 0; k < K; ++k)
          acc[k][v] = __fadd_rn(acc[k][v],
                                __fmul_rn(xw[K - 1 - k][v], yw[0][v]));
      }
      store_v<V>(gb + (size_t)m * D, g);
#pragma unroll
      for (int j = K - 1; j > 0; --j)
#pragma unroll
        for (int v = 0; v < V; ++v) xw[j][v] = xw[j - 1][v];
#pragma unroll
      for (int j = 0; j + 1 < K; ++j)
#pragma unroll
        for (int v = 0; v < V; ++v) yw[j][v] = yw[j + 1][v];
    }
  }
  float* p = ws + ((size_t)blockIdx.z * nseg + seg) * K * D + d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if constexpr (V == 2)
      *reinterpret_cast<float2*>(p + (size_t)k * D) =
          make_float2(acc[k][0], acc[k][1]);
    else
      p[(size_t)k * D] = acc[k][0];
  }
}

template <typename T, int V>
cudaError_t launch_bwd_v(const T* x, const T* w, const T* dy, T* dx,
                         float* ws, int B, int L, int D, int K,
                         cudaStream_t stream) {
  const int lanes = (D + V - 1) / V;
  const dim3 grid((lanes + BWD_THREADS - 1) / BWD_THREADS,
                  (L + BWD_SEGMENT - 1) / BWD_SEGMENT, B);
  switch (K) {
    case 1: causal_conv1d_bwd_kernel<T, 1, V><<<grid, BWD_THREADS, 0, stream>>>(x, w, dy, dx, ws, L, D); break;
    case 2: causal_conv1d_bwd_kernel<T, 2, V><<<grid, BWD_THREADS, 0, stream>>>(x, w, dy, dx, ws, L, D); break;
    case 3: causal_conv1d_bwd_kernel<T, 3, V><<<grid, BWD_THREADS, 0, stream>>>(x, w, dy, dx, ws, L, D); break;
    case 4: causal_conv1d_bwd_kernel<T, 4, V><<<grid, BWD_THREADS, 0, stream>>>(x, w, dy, dx, ws, L, D); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy,
                       void* dx, float* ws, int B, int L, int D, int K,
                       cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* yp = static_cast<const T*>(dy);
  T* gp = static_cast<T*>(dx);
  if constexpr (sizeof(T) == 2) {
    // a bf16 pair per thread where every row starts 4-byte aligned
    const uintptr_t a = reinterpret_cast<uintptr_t>(xp) |
                        reinterpret_cast<uintptr_t>(wp) |
                        reinterpret_cast<uintptr_t>(yp) |
                        reinterpret_cast<uintptr_t>(gp);
    if (D % 2 == 0 && a % 4 == 0)
      return launch_bwd_v<T, 2>(xp, wp, yp, gp, ws, B, L, D, K, stream);
  }
  return launch_bwd_v<T, 1>(xp, wp, yp, gp, ws, B, L, D, K, stream);
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
__global__ void __launch_bounds__(SEGSUM_THREADS) causal_conv1d_segsum_kernel(
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
  const auto kernel = causal_conv1d_segsum_kernel<T, V, STAGED>;
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

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Returns the launch's cudaError_t (0 = ok).
int causal_conv1d_launch(int dtype, const void* x, const void* w, void* y,
                         int B, int L, int D, int K, void* stream) {
  if (B <= 0 || L <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, w, y, B, L, D, K, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, w, y, B, L, D, K, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's two passes on one stream: dx and the partials ws
// [B * ceil(L / 128)][K][D] f32 (the caller's workspace), then dw.
int causal_conv1d_bwd_launch(int dtype, const void* x, const void* w,
                             const void* dy, void* dx, void* dw, void* ws,
                             int B, int L, int D, int K, void* stream) {
  if (B <= 0 || L <= 0 || D <= 0 || K < 1 || K > 4 || !ws)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  const int nseg = B * ((L + BWD_SEGMENT - 1) / BWD_SEGMENT);
  cudaError_t e;
  if (dtype == 0)
    e = launch_bwd<float>(x, w, dy, dx, part, B, L, D, K, s);
  else if (dtype == 1)
    e = launch_bwd<__nv_bfloat16>(x, w, dy, dx, part, B, L, D, K, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  return segsum_launch(dtype, part, dw, nseg, (long long)K * D, s);
}

const char* causal_conv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
