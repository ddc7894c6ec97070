// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` (src/repro/kernels/
// flash_attention.py:75, body `_kernel` :31): attention with an online
// softmax whose running max m, sum l and output accumulator acc stay in f32
// on chip, an optional causal mask, and grouped-query attention that maps
// query head h to kv head h / g without repeating K and V.
//
//   q, o [BH, S, D]; k, v [BHkv, T, D]; BH = g * BHkv; all contiguous,
//   all float32 or all bfloat16; o = softmax(q k^T * D^-0.5 [+ mask]) v.
//
// Layout of the work: one block per (bh, tile of BQ = 64 queries).  The
// Pallas grid's sequential kv axis becomes a loop inside the block over
// tiles of BK = 64 keys staged in shared memory (as f32), so m, l and acc
// never leave registers.  Under `causal` the loop stops at the last tile
// that reaches the diagonal: tiles wholly above it are neither loaded nor
// computed (the Pallas kernel still fetches them).  Ragged S and T edges
// are masked in the kernel: rows past S are not stored, keys past T score
// -1e30 like masked ones, so no padding to tiles.
//
// 128 threads: thread (ty, tx) = (tid / 8, tid % 8) owns query rows
// 4*ty .. 4*ty+3, score columns tx + 8j (j < 8) of each key tile and output
// columns tx + 8j (j < D/8).  The eight threads of a row sit in one warp,
// so the row max and row sum are three xor-shuffles.  Q and K tiles are
// stored with a row stride of D+1 and the P tile with 65, which keeps the
// shared-memory reads of a warp on distinct banks.
//
// What bounds it: operations.  At zamba2-7b's prefill (BH = 64, S = T =
// 2048, D = 112, causal) it does 4*BH*S*T*D/2 = 60 GFLOP against 117 MB of
// operands, some 500 FLOP per byte, above the ridge even of the bf16 tensor
// cores.  This first version runs f32 FMA on the CUDA cores (wgmma and TMA
// come later), and every FMA's operand comes from shared memory, so it is
// bound by shared-memory load instructions well before the FMA rate; the
// 4 x 8 register tile of scores (and 4 x D/8 of outputs) is what lets one
// loaded value feed several FMAs.
//
// D is a template parameter (16, 32, 64, 112: the reference's tests and
// zamba2-7b); the C entry point refuses any other.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per staged tile
constexpr int THREADS = 128;
constexpr int TX = 8;        // threads sharing one query row
constexpr int RPT = 4;       // query rows per thread (BQ = THREADS / TX * RPT)
constexpr int CPT = BK / TX; // score columns per thread
constexpr int PS = BK + 1;   // row stride of the P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 1; off < TX; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < TX; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                          (size_t)BK * D + (size_t)BQ * PS);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                 int group, float scale, int causal) {
  static_assert(D % TX == 0, "head dim must be a multiple of 8");
  constexpr int DP = D + 1;
  constexpr int DPT = D / TX;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [BQ][DP]
  float* ks = qs + BQ * DP;    // [BK][DP]
  float* vs = ks + BK * DP;    // [BK][D]
  float* ps = vs + BK * D;     // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const T* qb = q + (size_t)bh * S * D;
  const T* kb = k + (size_t)(bh / group) * Tk * D;
  const T* vb = v + (size_t)(bh / group) * Tk * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    qs[r * DP + c] = q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * D + c]) : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous K, V, P
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const bool ok = k0 + r < Tk;
      const size_t at = (size_t)(k0 + r) * D + c;
      ks[r * DP + c] = ok ? to_f32(kb[at]) : 0.f;
      vs[r * D + c] = ok ? to_f32(vb[at]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty * RPT + i) * DP + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + TX * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty * RPT + i;
      const int qpos = q0 + r;
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + TX * j;
        float sv = s[i][j] * scale;
        if (kpos >= Tk || (causal && kpos > qpos)) sv = NEG_INF;
        s[i][j] = sv;
        tmax = fmaxf(tmax, sv);
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[r * PS + tx + TX * j] = p;
        rsum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(rsum);
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();  // the P tile is complete

    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ps[(ty * RPT + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = vs[c * D + tx + TX * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty * RPT + i;
    if (qpos >= S) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPT; ++j)
      store(ob + (size_t)qpos * D + tx + TX * j, acc[i][j] * inv_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int BHkv, int S, int Tk, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + BQ - 1) / BQ, BH);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, BH / BHkv, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int BH, int BHkv, int S, int Tk, float scale,
                     int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, BH, BHkv, S, Tk, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, BH, BHkv, S, Tk, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, BH, BHkv, S, Tk, scale, causal, stream);
    case 112: return launch<T, 112>(q, k, v, o, BH, BHkv, S, Tk, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Returns the launch's cudaError_t (0 =
// launched); cudaErrorInvalidValue for a head dim or shape it does not take.
int flash_attention_fwd_launch(int dtype, const void* q, const void* k,
                               const void* v, void* o, int BH, int BHkv,
                               int S, int Tk, int D, float scale, int causal,
                               void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || S <= 0 || Tk <= 0 ||
      BH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(D, q, k, v, o, BH, BHkv, S, Tk, scale, causal, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(D, q, k, v, o, BH, BHkv, S, Tk, scale,
                                        causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
