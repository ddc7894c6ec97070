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
// Two kernels share that contract.  Both keep the Pallas grid's sequential
// kv axis as a loop inside a block over 64-key tiles, so m, l and acc never
// leave registers; under `causal` the loop stops at the tile that reaches
// the diagonal (tiles wholly above it are neither loaded nor computed, and
// only the diagonal and ragged-T tiles are masked); ragged S and T edges are
// masked in the kernel, so nothing is padded to tiles.  Neither splits the
// kv axis nor uses atomics: the result is deterministic.
//
// flash_fwd_bf16_kernel (bf16, the LM path).  What bounds it: operations.
// At zamba2-7b's prefill (BH = 64, S = T = 2048, D = 112, causal) it does
// 4*BH*S*T*D/2 = 60 GFLOP against 117 MB of operands, some 500 FLOP per
// byte, above the ridge of the bf16 tensor cores (295): its bound is
// 60.1 GFLOP / 989 TFLOP/s = 0.061 ms.  So both products run on the tensor
// cores as wgmma: one block is one warpgroup (4 warps) per (head, 64
// queries), each warp 16 query rows.  Q K^T is wgmma m64n64k16 with Q as
// the register operand (its fragments loaded once by ldmatrix and held for
// the whole loop) and K read from shared memory by descriptor, f32
// accumulators in registers.  The online softmax works on the accumulator
// fragments (a row's max is reduced over the 4 threads of a quad by two
// xor-shuffles; its sum stays per thread until the end); P is rounded to
// bf16 and fed back as the register A operand of P V, wgmma m64nDk16 with
// V read N-major from the same layout.  K and V tiles sit in wgmma's
// 128-byte swizzled layout (rows cut into 64-element atoms; D = 112 pads
// its second atom, which no product reads), are double-buffered and staged
// by 16-byte cp.async with zero-fill past T, so the next tile's copy is in
// flight while this one's products run; one barrier per tile.  Each
// product is committed and waited for before its result is used: the
// block's own softmax does not overlap its products, but the two or three
// blocks an SM holds interleave.  Query tiles run heaviest first
// (blockIdx.y reversed).
//
// Where this kernel rounds: P is rounded once to bf16 before P V (the
// Pallas kernel keeps p in f32), and l sums the rounded weights, so o is an
// exact convex combination of V's rows with weights p~_j = p_j (1 + d_j),
// |d_j| <= 2^-9.  The error this adds to o is sum_j (p_j / l)(d_j - d) v_j
// with d the weighted mean of d_j: at most 2 * 2^-9 * max|v| = 0.0039 max|v|
// in the worst case and, with independent roundings, about 2^-9 * max|v| *
// sqrt(sum_j (p_j / l)^2) <= 2^-9 max|v| typically.  For the unit-normal
// operands of the checks (max|v| about 4.5 over 2048 keys) that is under
// 0.018 worst case and some 0.002 typical, inside the bf16 tolerance of
// 2e-2 against `flash_attention_plain` (the output's own bf16 rounding adds
// 2^-9 |o|).
//
// flash_fwd_kernel (f32, the first version, kept for f32 operands: TF32
// tensor cores would round the operands to 10 bits and miss the f32
// tolerance of 2e-4).  128 threads; thread (ty, tx) = (tid / 8, tid % 8)
// owns query rows 4*ty .. 4*ty+3, score columns tx + 8j (j < 8) of each key
// tile and output columns tx + 8j (j < D/8); f32 FMA on the CUDA cores,
// every operand from shared memory.  Q and K tiles use a row stride of D+1
// and the P tile 65, which keeps a warp's shared reads on distinct banks.
//
// D is a template parameter (16, 32, 64, 112: the reference's tests and
// zamba2-7b); the C entry point refuses any other.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma m64nNk16), cp.async double buffering
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;        // queries per block: one warpgroup, 16 a warp
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // one warpgroup

// Q is kept row-major with rows of D + 8 elements (an odd number of 16-byte
// units, so ldmatrix is conflict-free).  K and V tiles use wgmma's 128-byte
// swizzled layout: a key's row is cut into atoms of 64 d values (128
// bytes, the last one padded when D = 112), an atom holds the tile's BK
// keys at 128-byte rows (1024-byte groups of 8 keys), and 16-byte chunk c
// of key r sits at chunk c ^ (r % 8) of its row.  Both products read that
// one layout: Q K^T K-major, P V N-major.
template <int D>
struct Cfg {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int LD = D + 8;       // Q row stride in elements
  static constexpr int CH = D / 8;       // 16-byte chunks per row
  static constexpr int KSTEPS = D / 16;  // k16 steps of Q K^T
  static constexpr int NT = D / 8;       // n8 tiles of the output
  static constexpr int ATOM = BK * 64;   // elements of one swizzle atom
  static constexpr int TILE = (D + 63) / 64 * ATOM;  // one K or V tile
  // Q's rows (BQ * LD * 2 bytes: 3, 5, 9 or 15 KB) keep the tiles on
  // 1024-byte boundaries; 1024 more bytes align the base
  static constexpr size_t SMEM =
      sizeof(bf16) * ((size_t)BQ * LD + 4 * TILE) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src-size 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait for this thread's copies and make them visible to wgmma's reads
// (the async proxy); a barrier then publishes every thread's.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets in 16-byte units, layout type 1.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo,
                                              int sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) |
         ((uint64_t)(lbo & 0x3FFF) << 16) |
         ((uint64_t)(sbo & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of accumulators across the
// asynchronous products.
template <int NT>
__device__ __forceinline__ void fence_regs(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}

template <int N> struct int_ {};

// d += a (64 x 16, registers, the mma A-fragment layout per warp) * B
// (16 x N, shared memory by descriptor); TB = 0 reads B K-major, 1
// N-major.  d holds the warp's rows in the mma accumulator layout, n8
// tile by n8 tile.
template <int TB>
__device__ __forceinline__ void wgmma(float (&d)[2][4],
                                      const uint32_t (&a)[4],
                                      uint64_t desc, int_<16>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7"
      "}, {%8,%9,%10,%11}, %12, p, 1, 1, %13;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TB),
        "r"(1));
}
template <int TB>
__device__ __forceinline__ void wgmma(float (&d)[4][4],
                                      const uint32_t (&a)[4],
                                      uint64_t desc, int_<32>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
      "}, {%16,%17,%18,%19}, %20, p, 1, 1, %21;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TB),
        "r"(1));
}
template <int TB>
__device__ __forceinline__ void wgmma(float (&d)[8][4],
                                      const uint32_t (&a)[4],
                                      uint64_t desc, int_<64>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TB),
        "r"(1));
}
template <int TB>
__device__ __forceinline__ void wgmma(float (&d)[14][4],
                                      const uint32_t (&a)[4],
                                      uint64_t desc, int_<112>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55"
      "}, {%56,%57,%58,%59}, %60, p, 1, 1, %61;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TB),
        "r"(1));
}

// 2^x on the special-function unit (relative error about 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Round (lo, hi) to a bf16 pair (lo in the low half, the lower column of
// an mma fragment) and add the rounded values to `sum`.
__device__ __forceinline__ uint32_t round_pair(float lo, float hi,
                                               float& sum) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  sum += __low2float(v) + __high2float(v);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [r0, r0 + BQ) of Q into row-major shared rows of stride LD by
// 16-byte cp.async, rows past n_rows zero-filled.
template <int D>
__device__ __forceinline__ void stage_q(bf16* dst, const bf16* src, int r0,
                                        int n_rows) {
  constexpr int CH = Cfg<D>::CH, LD = Cfg<D>::LD;
  for (int e = threadIdx.x; e < BQ * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const bool ok = r0 + r < n_rows;
    const bf16* g = src + (size_t)(ok ? r0 + r : 0) * D + c * 8;
    cp_async16(smem_u32(dst + r * LD + c * 8), g, ok);
  }
}

// Keys [r0, r0 + BK) of K or V into the swizzled layout, keys past n_rows
// zero-filled.
template <int D>
__device__ __forceinline__ void stage_kv(bf16* dst, const bf16* src, int r0,
                                         int n_rows) {
  constexpr int CH = Cfg<D>::CH, ATOM = Cfg<D>::ATOM;
  for (int e = threadIdx.x; e < BK * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const bool ok = r0 + r < n_rows;
    const bf16* g = src + (size_t)(ok ? r0 + r : 0) * D + c * 8;
    cp_async16(smem_u32(dst + c / 8 * ATOM + r * 64 + ((c % 8) ^ (r & 7)) * 8),
               g, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                      int Tk, int group, float scale_log2, int causal) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, KSTEPS = C::KSTEPS, NT = C::NT, TILE = C::TILE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(
      smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024);  // [BQ][LD]
  bf16* ks = qs + BQ * LD;                                  // [2][TILE]
  bf16* vs = ks + 2 * TILE;                                 // [2][TILE]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const bf16* qb = q + (size_t)bh * S * D;
  const bf16* kb = k + (size_t)(bh / group) * Tk * D;
  const bf16* vb = v + (size_t)(bh / group) * Tk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;

  stage_q<D>(qs, qb, q0, S);
  stage_kv<D>(ks, kb, 0, Tk);
  stage_kv<D>(vs, vb, 0, Tk);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; every warp is done with it - 1
    if (it + 1 < n_tiles) {
      const int nb = (it + 1) & 1;
      stage_kv<D>(ks + nb * TILE, kb, (it + 1) * BK, Tk);
      stage_kv<D>(vs + nb * TILE, vb, (it + 1) * BK, Tk);
    }
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        ldsm_x4(smem_u32(qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                         (lane >> 4) * 8),
                qf[kk]);
    }
    const bf16* kt = ks + (it & 1) * TILE;
    const bf16* vt = vs + (it & 1) * TILE;
    const int k0 = it * BK;

    // S = Q K^T for the warpgroup's 64 rows x 64 keys; K read K-major,
    // k16 step kk at 32-byte offset kk % 4 of atom kk / 4, 8-key groups
    // 1024 bytes apart (SBO)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk)
      wgmma<0>(s, qf[kk],
               gmma_desc(kt + kk / 4 * C::ATOM + kk % 4 * 16, 1, 64),
               int_<64>());
    wgmma_commit_wait();
    fence_regs(s);

    // mask only the diagonal and ragged tiles; m lives in the exp2
    // domain (scores times scale_log2 > 0, which keeps the order)
    if (k0 + BK > Tk || (causal && k0 + BK - 1 > q0)) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          if (key >= Tk || (causal && key > row)) s[n][e] = NEG_INF;
        }
    }
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo * scale_log2);
    const float mn_hi = fmaxf(m_hi, mx_hi * scale_log2);
    const float c_lo = ex2(m_lo - mn_lo), c_hi = ex2(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    // P, rounded to bf16, laid out as the A operand (two n8 score tiles
    // make one k16 step of P V)
    uint32_t p[4][4];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t lo =
          round_pair(ex2(fmaf(s[n][0], scale_log2, -mn_lo)),
                     ex2(fmaf(s[n][1], scale_log2, -mn_lo)), sum_lo);
      const uint32_t hi =
          round_pair(ex2(fmaf(s[n][2], scale_log2, -mn_hi)),
                     ex2(fmaf(s[n][3], scale_log2, -mn_hi)), sum_hi);
      p[n / 2][(n & 1) * 2] = lo;
      p[n / 2][(n & 1) * 2 + 1] = hi;
    }
    l_lo = l_lo * c_lo + sum_lo;
    l_hi = l_hi * c_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= c_lo;
      acc[n][1] *= c_lo;
      acc[n][2] *= c_hi;
      acc[n][3] *= c_hi;
    }

    // O += P V, 16 keys per step; V read N-major: atoms of 64 d values
    // 8192 bytes apart (LBO), 8-key groups 1024 bytes apart (SBO)
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<1>(acc, p[kk], gmma_desc(vt + kk * 16 * 64, C::ATOM / 8, 64),
               int_<D>());
    wgmma_commit_wait();
    fence_regs(acc);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  bf16* ob = o + (size_t)bh * S * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_lo * D + col) =
          __floats2bfloat162_rn(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    if (row_hi < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_hi * D + col) =
          __floats2bfloat162_rn(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int BHkv, int S, int Tk, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = Cfg<D>::SMEM;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(BH, (S + BQ - 1) / BQ);
  flash_fwd_bf16_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Tk, BH / BHkv,
      scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, int BH, int BHkv, int S, int Tk, float scale,
                     int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, BH, BHkv, S, Tk, scale, causal, stream);
    case 32: return launch<32>(q, k, v, o, BH, BHkv, S, Tk, scale, causal, stream);
    case 64: return launch<64>(q, k, v, o, BH, BHkv, S, Tk, scale, causal, stream);
    case 112: return launch<112>(q, k, v, o, BH, BHkv, S, Tk, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

extern "C" {

// dtype: 0 float32 (flash_fwd_kernel), 1 bfloat16 (flash_fwd_bf16_kernel).
// Returns the launch's cudaError_t (0 = launched); cudaErrorInvalidValue
// for a head dim, shape or alignment it does not take.
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
  if (dtype == 1) {
    // cp.async copies 16-byte rows: every operand must start 16-aligned
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
        16)
      return (int)cudaErrorInvalidValue;
    return (int)tc::dispatch(D, q, k, v, o, BH, BHkv, S, Tk, scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
