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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

const char* causal_conv1d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
