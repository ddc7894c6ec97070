// Flash attention (forward and backward) for Hopper (sm_90a).
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
// kv axis as a loop inside a block over key tiles, so m, l and acc never
// leave registers; under `causal` the loop stops at the tile that reaches
// the diagonal (tiles wholly above it are neither loaded nor computed, and
// only the diagonal and ragged-T tiles are masked); ragged S and T edges are
// masked in the kernel, so nothing is padded to tiles.  Neither uses
// atomics (the f32 kernel's warps may split a block's key walk and merge in
// a fixed order): the result is deterministic.
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
// |d_j| <= 2^-8 (bf16's unit roundoff).  The error this adds to o is
// sum_j (p_j / l)(d_j - d) v_j with d the weighted mean of d_j: at most
// 2 * 2^-8 * max|v| = 0.0078 max|v| in the worst case and, with independent
// roundings, about 2^-8 * max|v| * sqrt(sum_j (p_j / l)^2) typically, which
// is far smaller when the weights spread over many keys.  For the
// unit-normal operands of the checks (max|v| about 4.5 over 2048 keys) the
// typical error is some 0.004, inside the bf16 tolerance of 2e-2 against
// `flash_attention_plain` (the output's own bf16 rounding adds 2^-8 |o|).
//
// The forward can also write each row's log-sum-exp (f32 [BH, S], natural
// log of sum_j exp(scale q.k_j) over the unmasked keys: m + log l, the bf16
// kernel's base-2 m converted), which the backward reads.  o is computed
// exactly as without it.
//
// The backward (flash_bwd_dq_bf16_kernel, flash_bwd_dkdv_bf16_kernel and
// flash_bwd_dkdv_sum_bf16_kernel in bf16, `namespace tc`;
// flash_bwd_dq_kernel, flash_bwd_dkdv_kernel and
// flash_bwd_dkdv_sum_kernel in f32, `namespace bwd`, last) is not the port
// of a TPU kernel: the reference has none, and its training differentiates
// the chunked JAX attention (src/repro/models/layers.py:176) with XLA.  It
// is the hand-written gradient of this file's forward.  What bounds it:
// operations, 10 BH S T D FLOPs (S, dP, dV, dK and dQ; halved under
// causal) against q, k, v, o, dO, lse read once and dq, dk, dv written
// once.  The dQ kernel recomputes S and dP (seven products in all), which
// buys the absence of atomics: every gradient element is summed in a fixed
// order (the dK/dV walk in segments whose f32 sums a second pass adds in
// order), so the gradients are bitwise the same from run to run and a
// sequence's do not depend on its batch.  Both dtypes run every product on
// the tensor cores: bf16 on wgmma m64nNk16 as flash_fwd_bf16_kernel does
// (at the training shape its seven products are 240.5 GFLOP, 0.243 ms at
// 989 TFLOP/s), f32 on mma.sync m16n8k8 tf32 in three terms as
// flash_fwd_kernel does (1.46 ms at 165 TFLOP/s).
//
// flash_fwd_kernel (f32: train_lm, serve_lm and the f32 copies of the oracles
// and rings; below `namespace tc`).  What bounds it: operations. At the
// training shape (q (16, 4096, 128), k/v (2, 4096, 128), causal) it does 68.72
// GFLOP against 75.5 MB of operands, some 900 FLOP per byte. Two rates bound
// it: the CUDA cores' f32 FMA at 67 TFLOP/s (1.026 ms there) and the tensor
// cores' TF32 at 495 TFLOP/s, of which three terms a product leave 165 (0.416
// ms).  This version replaces the first, which ran f32 FMA on the CUDA cores
// with every operand read from shared memory (PERF.md §6 row 5d).  Both
// products run on the tensor cores as mma.sync m16n8k8 tf32 in three terms
// (3xTF32, the split of CUTLASS's OpMultiplyAddFastF32, which PyTorch's f32
// memory-efficient attention runs): each operand x is split once into hi =
// rna(x) and lo = rna(x - hi) (cvt.rna.tf32.f32: to nearest, ties away from
// zero; the 13 low bits then cleared), and a b is summed as lo_a hi_b + hi_a
// lo_b + hi_a hi_b in f32 accumulators.
//
// Where it rounds: hi + lo is within 2^-22 |x| of x (each rounding keeps
// 11 significant bits), the dropped lo_a lo_b is below 2^-22 |a b|, and a
// product of two tf32 values is exact in f32, so each product is within
// about 2^-21 |a b| of the f32 one, no more than f32's own rounding of the
// sums over D or T terms.  On unit-normal operands (causal; (BH, S, D) =
// (4, 128, 64), (8, 255, 112), (4, 256, 128), (8, 512, 128)) the
// three-term emulation `flash_attention_3xtf32_plain` is within 0.56e-6 to
// 1.05e-6 of a float64 result where plain f32 is within 0.69e-6 to
// 1.33e-6, and one TF32 term within 1.00e-3 to 1.60e-3, which misses the
// f32 tolerance of 2e-4 (tests/test_torch_flash_f32.py).  The kernel is
// held to `flash_attention_plain` at that 2e-4, and to the emulation at
// 5e-5: both take the same exact products and differ only in the order of
// their f32 additions (u = 2^-24 each), exp's last bits and where the
// online softmax rescales.  With independent roundings a score's sum of
// 3D terms is off by about sqrt(3D) u sqrt(D) D^-0.5 = 1.2e-6 at D = 128
// (unit-normal q and k: partial sums near sqrt(D)), a relative error in
// p; a row of P V over 3T terms by about sqrt(3T) u |o| = 6.6e-6 at T =
// 4096 (|o| <= 1 over that many keys).  The largest of some 10^7 outputs
// sits about five such deviations out, 3.3e-5: 5e-5.
//
// Its layout.  A block is WQ x KS warps over BQ = 16 WQ queries: warp
// (wm, wk) owns query rows 16 wm .. 16 wm + 15 and, of each stage of KS x
// BK keys, the wk-th BK; with KS > 1 the warps' partial (m, l, acc) merge
// at the end in the order wk = 0, 1, ... (no atomics, the same sum from
// run to run).  Thread (g, t) = (lane / 4, lane % 4) holds mma's
// accumulator layout: rows g and g + 8, columns 2t and 2t + 1 of each n8
// tile.  The S accumulators feed the online softmax in registers (a row's
// max reduced over the quad by xor-shuffles, its sum kept per thread to the
// end, as the bf16 kernel does), and P is split and used as P V's A
// operand where it stands: A wants columns t and t + 4 where the thread
// holds 2t and 2t + 1, so P V's k = t is key 2t and k = t + 4 key 2t + 1,
// and V's B fragment is read in that order (rows 2t and 2t + 1, column g):
// no shuffle.  K and V stages are double-buffered by 16-byte cp.async with
// zero-fill past T, the next stage's copy in flight during this one's
// products; one barrier a stage.  Every tile (Q, K, V) has rows of LD = D
// + 4 floats: 16-byte aligned for cp.async, and LD mod 32 is 4 (D = 32,
// 64, 128) or 20 (D = 16, 112), 4 times an odd number, so a warp's
// fragment reads fall on 32 distinct banks: K's B (key g, column t) and
// Q's A (row g, column t) on banks 4g + t or 20g + t (mod 32), V's B (row
// 2t, column g) on 8t + g.  Q is split once: for D <= 64 into registers (D
// of them a thread); for D = 112 and 128, where D more registers beside the
// D / 2 of acc would spill, into shared memory (hi and lo, staged once and
// read as A fragments, 8 words a k8 step).  K and V are split as a warp
// reads its fragments.  Query tiles run heaviest first (blockIdx.y
// reversed); under `causal` a warp skips a key tile wholly above its rows.
// A row's o depends only on its query, its keys and its position.
//
// D is a template parameter (16, 32, 64, 112, 128: the reference's tests,
// zamba2-7b and the dense configs' d_head); the C entry point refuses any
// other.  The bf16 kernel's P V at D = 128 is wgmma m64n128k16 (64
// accumulator registers per thread), its K and V rows two whole swizzle
// atoms.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
  // Q's rows (BQ * LD * 2 bytes: 3, 5, 9, 15 or 17 KB) keep the tiles on
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

template <int TB>
__device__ __forceinline__ void wgmma(float (&d)[16][4],
                                      const uint32_t (&a)[4],
                                      uint64_t desc, int_<128>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %70, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, %69;\n}\n"
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
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TB),
        "r"(1));
}

// d = A (64 x 16) * B (16 x 64) + (accumulate ? d : 0), A and B both read
// K-major from shared memory by descriptor (the backward's S and dP, whose
// A operand is a staged tile); d as in `wgmma`.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a_desc,
                                         uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
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
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int S, int Tk, int group,
                      float scale_log2, int causal) {
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
  // m is in base-2 units: the natural log-sum-exp is (m + log2 l) ln 2
  if (lse != nullptr && t == 0) {
    if (row_lo < S)
      lse[(size_t)bh * S + row_lo] = (m_lo + log2f(fmaxf(l_lo, 1e-30f))) * LN2;
    if (row_hi < S)
      lse[(size_t)bh * S + row_hi] = (m_hi + log2f(fmaxf(l_hi, 1e-30f))) * LN2;
  }
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
                   float* lse, int BH, int BHkv, int S, int Tk, float scale,
                   int causal, cudaStream_t stream) {
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
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, Tk,
      BH / BHkv, scale * LOG2E, causal);
  return cudaGetLastError();
}

cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, float* lse, int BH, int BHkv, int S, int Tk,
                     float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, lse, BH, BHkv, S, Tk, scale, causal, stream);
    case 32: return launch<32>(q, k, v, o, lse, BH, BHkv, S, Tk, scale, causal, stream);
    case 64: return launch<64>(q, k, v, o, lse, BH, BHkv, S, Tk, scale, causal, stream);
    case 112: return launch<112>(q, k, v, o, lse, BH, BHkv, S, Tk, scale, causal, stream);
    case 128: return launch<128>(q, k, v, o, lse, BH, BHkv, S, Tk, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// Backward, bf16: tensor cores (wgmma m64nNk16), cp.async double buffering
// ---------------------------------------------------------------------------
// The same two kernels as the f32 backward (see `namespace bwd`), built on
// the forward's wgmma.  What bounds them: operations, 240.5 GFLOP of
// seven products at the training shape (q (16, 4096, 128), k/v (2, 4096,
// 128), causal), 0.243 ms at 989 TFLOP/s; against q, k, v, o, dO, lse
// read once and dq, dk, dv written once (60 MB) the work is some 4000 FLOP
// a byte, far above the ridge (295).  So every product runs as wgmma, and
// the design is about keeping the tensor cores fed:
//   dQ = scale dS K          one block per (q head, 64 NQ queries), NQ
//                            warpgroups of 64 queries each, walking the
//                            key tiles up to the diagonal;
//   dK = scale dS^T Q,       one block per (kv head, 64 NK keys, segment),
//   dV = P^T dO              NK warpgroups of 64 keys each, walking a
//                            segment of its group's (q head, query stage)
//                            pairs from the diagonal on.
// The warpgroups of a block share the walked tiles (K and V, or Q and dO),
// so a tile read from L2 feeds 64 NQ (or NK) rows.  A warpgroup never needs
// another's result: it owns its rows' accumulators (dQ; or dK and dV) in
// wgmma's accumulator layout, and one barrier a stage guards the
// double-buffered tiles.
//
// Layout.  Every tile is 64 rows in the forward's 128-byte swizzled layout
// (stage_tile, as stage_kv): the block's own rows (Q and dO, or K and V)
// staged once, the walked ones double-buffered by 16-byte cp.async with
// zero-fill past S or T.  Each product reads its operands where they lie:
//   S = Q K^T, dP = dO V^T (dQ kernel): wgmma m64n64k16, K and V read
//   K-major by descriptor; Q and dO as register A fragments at D = 112
//   and 128 (load_a once, as the forward holds Q: half the shared-memory
//   reads of the products that read both operands there), both operands
//   from shared memory below that (wgmma_ss);
//   S^T = K Q^T, dP^T = V dO^T (dK/dV kernel): wgmma_ss, A and B both
//   K-major from shared memory: K in registers too would add 32 to the
//   two D-wide accumulators and S^T, dP^T (242 registers a thread at D =
//   128), and spilled;
//   dQ += dS K, dV += P^T dO, dK += dS^T Q: wgmma m64nDk16 with A the
//   rounded dS, P^T or dS^T in registers where the accumulators left them
//   (to_a_frags: two n8 tiles of the 64 columns make a k16 step), and B
//   the walked (or staged) tile read N-major, as the forward's P V reads
//   V.
// Each batch of products (S and dP; then dQ, or dV and dK) is committed and
// waited for before its result is used, the next stage's copies issued in
// between; the two warpgroups of a block, and the blocks an SM holds,
// interleave.  A batch is issued on a straight path: a wgmma under a branch
// (a warpgroup skipping a stage) made ptxas serialize every wgmma of the
// kernel, and the warpgroup index is broadcast from lane 0 (`warpgroup`) so
// that the skip is seen as uniform.  The dQ kernel runs its query tiles
// heaviest first (blockIdx.y reversed); under `causal` a warpgroup skips a
// tile wholly above its rows.
//
// The dK/dV walk is split as the f32 backward's is (`namespace bwd`): key
// block j's walk (its group's q heads times its query stages of BQ = 64,
// `bwd_walk`) is cut into segments of L stages (`bwd_seg_stages`: at least
// BWD_SEG_MIN = 64 stages, and the heaviest key block's walk in at most
// about BWD_SEG_TARGET segments), each segment a block, enumerated key
// block by key block, the heaviest first.  So only walks of more than 4096
// query rows are cut: at qwen2.5-3b's training shape (a group of 8) key
// block j's 8 (64 - 2 j) stages go into up to 8 segments, and at zamba2-7b's
// (a group of 1) no walk is cut, where cutting cost more in partials than
// it won (PERF.md §6, row 5h).  L and the segments depend only on (S, T, D,
// group) and `causal`, never on BH or the batch
// (kernels/flash_attention.dkdv_split_bf16 repeats the rule).  A key block
// walked by one segment writes dk and dv itself; one walked by several
// writes each segment's f32 sums into `part`, and
// flash_bwd_dkdv_sum_bf16_kernel adds them in segment order and rounds
// once to bf16.  No atomics: dq, dk and dv are bitwise the same from run
// to run, and a sequence's gradients do not depend on its batch.
//
// Where this backward rounds: P and dS are rounded once to bf16 (unit
// roundoff u = 2^-8) before the products that take them; S, dP, delta and
// every sum stay in f32 (the partials too), and each output is rounded
// once.  A rounded weight p~ = p (1 + e), |e| <= u, so each gradient
// element is the exact sum of its terms each perturbed by at most u:
// |dV~ - dV| <= u sum_q p |dO| and |dK~ - dK| <= u scale sum_q |dS| |Q|, at
// most u = 0.0039 of the sums of |terms| and, with independent roundings,
// about u / sqrt(n) of them over n terms.  The outputs' own bf16 rounding
// adds u |g|.  For the unit-normal operands of the checks that is well
// inside 2e-2 of max |g| against `flash_attention_bwd_plain` (f32
// throughout); `flash_attention_bwd_bf16_plain` rounds where the kernels
// do, and chip_smoke.py derives its tolerance against it
// (`XBF16_BWD_TOL`).  The log-sum-exp is f32 from the forward, in
// natural-log units; the kernels use it as lse * log2(e) with exp2.

constexpr int BWD_SEG_TARGET = 16;  // segments of the heaviest key block's walk
constexpr int BWD_SEG_MIN = 64;     // the fewest query stages of a segment
constexpr int BWD_SUM_THREADS = 256;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulators of a 64 x 64 product (8 n8 tiles a warp), rounded to
// bf16 as the A fragments of a product over those 64 columns (4 k16 steps).
__device__ __forceinline__ void to_a_frags(const float (&x)[8][4],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// wgmma_commit_wait in two halves: close the group of the products issued
// so far, and (after other work) wait for it.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int NT>
__device__ __forceinline__ void zero(float (&d)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[n][e] = 0.f;
}

// The dK/dV walk's split (kernels/flash_attention.dkdv_split_bf16 repeats
// it).  L, the query stages of a segment.
__host__ __device__ inline int bwd_seg_stages(int S, int group) {
  const int stages = (group * ((S + BQ - 1) / BQ) + BWD_SEG_TARGET - 1) /
                     BWD_SEG_TARGET;
  return stages > BWD_SEG_MIN ? stages : BWD_SEG_MIN;
}
// The (q head, query stage) pairs key block j (of bkv keys) walks.
__host__ __device__ inline int bwd_walk(int j, int bkv, int S, int group,
                                        int causal) {
  const int q_begin = causal ? j * bkv : 0;
  return q_begin < S ? group * ((S - q_begin + BQ - 1) / BQ) : 0;
}
// Its segments: at least one, which writes zeros where the walk is empty.
__host__ __device__ inline int bwd_segments(int j, int bkv, int S, int group,
                                            int causal, int L) {
  const int n = (bwd_walk(j, bkv, S, group, causal) + L - 1) / L;
  return n > 1 ? n : 1;
}

// 4-byte async copy (lse, delta); src-size 0 zero-fills the destination.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Rows [r0, r0 + 64) of a [n_rows, D] operand into one swizzled tile by NTH
// threads (stage_kv's layout), rows past n_rows zero-filled.
template <int D, int NTH>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, int r0,
                                           int n_rows) {
  constexpr int CH = Cfg<D>::CH, ATOM = Cfg<D>::ATOM;
  for (int e = threadIdx.x; e < BK * CH; e += NTH) {
    const int r = e / CH, c = e % CH;
    const bool ok = r0 + r < n_rows;
    const bf16* g = src + (size_t)(ok ? r0 + r : 0) * D + c * 8;
    cp_async16(smem_u32(dst + c / 8 * ATOM + r * 64 + ((c % 8) ^ (r & 7)) * 8),
               g, ok);
  }
}

// A swizzled 64-row tile's descriptors: k16 step kk of its columns read
// K-major (32-byte offset kk % 4 of atom kk / 4, 8-row groups 1024 bytes
// apart), and rows 16 kk .. 16 kk + 15 read N-major (atoms of 64 columns
// ATOM * 2 bytes apart), as the forward reads K and V.
template <int D>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return gmma_desc(tile + kk / 4 * Cfg<D>::ATOM + kk % 4 * 16, 1, 64);
}
template <int D>
__device__ __forceinline__ uint64_t desc_n(const bf16* tile, int kk) {
  return gmma_desc(tile + kk * 16 * 64, Cfg<D>::ATOM / 8, 64);
}

// s = X Y^T (64 x 64) over D: X and Y swizzled 64-row tiles, both K-major
// (the first k16 step overwrites s).
template <int D>
__device__ __forceinline__ void issue_abt(float (&s)[8][4], const bf16* x,
                                          const bf16* y) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, desc_k<D>(x, kk), desc_k<D>(y, kk), kk > 0);
}

// The A fragments of k16 step kk for the warp's 16 rows of a swizzled
// 64-row tile, by ldmatrix as the forward loads Q (lane l gives the address
// of row l % 16, 16-byte chunk 2 kk + l / 16, where the swizzle put it).
// The "memory" clobber keeps the read after the barrier that publishes the
// tile.
template <int D>
__device__ __forceinline__ void load_a(const bf16* tile, int kk,
                                       uint32_t (&a)[4]) {
  const int lane = threadIdx.x % 32;
  const int r = threadIdx.x / 32 % 4 * 16 + (lane & 15), c = 2 * kk + lane / 16;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(tile + c / 8 * Cfg<D>::ATOM + r * 64 +
                     ((c % 8) ^ (r & 7)) * 8))
      : "memory");
}

// This thread's warpgroup, broadcast from lane 0 so that the compiler sees
// it uniform across the warp: a branch on it around wgmma is not divergent.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x / THREADS), 0);
}

// s = X Y^T (64 x 64) over D: X in A fragments (k16 step kk at x[kk]), Y a
// swizzled 64-row tile read K-major; s zeroed by the caller.
template <int D>
__device__ __forceinline__ void issue_rbt(float (&s)[8][4],
                                          const uint32_t (&x)[D / 16][4],
                                          const bf16* y) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma<0>(s, x[kk], desc_k<D>(y, kk), int_<64>());
}

// acc (64 x D) += X Y: X (64 x 64) in A fragments, Y a swizzled 64-row tile
// read N-major.
template <int D>
__device__ __forceinline__ void issue_xb(float (&acc)[D / 8][4],
                                         const uint32_t (&x)[4][4],
                                         const bf16* y) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma<1>(acc, x[kk], desc_n<D>(y, kk), int_<D>());
}

__device__ __forceinline__ bf16* align_1024(unsigned char* p) {
  return reinterpret_cast<bf16*>(p + (1024 - smem_u32(p) % 1024) % 1024);
}

// A backward block: NW warpgroups over ROWS = 64 NW rows of its own
// (queries in the dQ kernel, keys in the dK/dV kernel), NW tiles of each of
// its two own operands and two buffers of each walked one; 1024 bytes
// align the base, and the dK/dV kernel adds each stage's lse and delta.
template <int D, int NW>
struct BwdCfg {
  static constexpr int TILE = Cfg<D>::TILE;
  static constexpr int NTH = THREADS * NW;  // THREADS: a warpgroup's
  static constexpr int ROWS = BQ * NW;
  static constexpr size_t TILES = sizeof(bf16) * (2 * NW + 4) * (size_t)TILE;
  static constexpr size_t SMEM_DQ = TILES + 1024;
  static constexpr size_t SMEM_DKDV = TILES + sizeof(float) * 4 * BQ + 1024;
};

template <int D, int NW>
__global__ void __launch_bounds__(BwdCfg<D, NW>::NTH)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ delta, bf16* __restrict__ dq,
                         int S, int Tk, int group, float scale,
                         float scale_log2, int causal) {
  using C = BwdCfg<D, NW>;
  constexpr int NT = D / 8, TILE = C::TILE, NTH = C::NTH, ROWS = C::ROWS;
  // S and dP with Q and dO in registers (as the forward holds Q) at the LM
  // head dims; both operands from shared memory below them (the register
  // form read wrong scores at D = 64 on the H100, PERF.md §6 row 5h)
  constexpr bool QREG = D >= 112;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = align_1024(smem_raw);  // [NW][TILE]
  bf16* dos = qs + NW * TILE;        // [NW][TILE]
  bf16* ks = dos + NW * TILE;        // [2][TILE]
  bf16* vs = ks + 2 * TILE;          // [2][TILE]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // heaviest tiles first
  const size_t qoff = (size_t)bh * S * D;
  const bf16* kb = k + (size_t)(bh / group) * Tk * D;
  const bf16* vb = v + (size_t)(bh / group) * Tk * D;
  const int wg = warpgroup();
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + wg * BQ;  // the warpgroup's first query
  const int row_lo = wq0 + warp * 16 + g, row_hi = row_lo + 8;
  const int k_end = causal ? min(Tk, q0 + ROWS) : Tk;
  const int n_tiles = (k_end + BK - 1) / BK;

#pragma unroll
  for (int w = 0; w < NW; ++w) {
    stage_tile<D, NTH>(qs + w * TILE, q + qoff, q0 + w * BQ, S);
    stage_tile<D, NTH>(dos + w * TILE, dout + qoff, q0 + w * BQ, S);
  }
  cp_async_commit();
  stage_tile<D, NTH>(ks, kb, 0, Tk);
  stage_tile<D, NTH>(vs, vb, 0, Tk);
  cp_async_commit();

  // delta = rowsum(dO o O) of the thread's two rows (columns 8c + 2t, +1,
  // then the quad's sum), written once for the dK/dV kernel
  float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = c * 8 + 2 * t;
    if (row_lo < S) {
      const size_t at = qoff + (size_t)row_lo * D + col;
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dout + at));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + at));
      d_lo = fmaf(a.x, b.x, fmaf(a.y, b.y, d_lo));
    }
    if (row_hi < S) {
      const size_t at = qoff + (size_t)row_hi * D + col;
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dout + at));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(o + at));
      d_hi = fmaf(a.x, b.x, fmaf(a.y, b.y, d_hi));
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    d_lo += __shfl_xor_sync(0xffffffffu, d_lo, off);
    d_hi += __shfl_xor_sync(0xffffffffu, d_hi, off);
  }
  if (t == 0) {
    if (row_lo < S) delta[(size_t)bh * S + row_lo] = d_lo;
    if (row_hi < S) delta[(size_t)bh * S + row_hi] = d_hi;
  }
  const float l_lo = row_lo < S ? lse[(size_t)bh * S + row_lo] * LOG2E : 0.f;
  const float l_hi = row_hi < S ? lse[(size_t)bh * S + row_hi] * LOG2E : 0.f;

  // Q's and dO's A fragments (QREG), once their copies (the first group)
  // landed
  uint32_t qf[D / 16][4], df[D / 16][4];
  if constexpr (QREG) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      load_a<D>(qs + wg * TILE, kk, qf[kk]);
      load_a<D>(dos + wg * TILE, kk, df[kk]);
    }
  }
  float acc[NT][4];
  zero(acc);

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; every warpgroup is done with it - 1
    const int k0 = it * BK;
    const bf16* kt = ks + (it & 1) * TILE;
    const bf16* vt = vs + (it & 1) * TILE;
    // a warpgroup whose queries all precede the tile's keys sees none
    const bool skip = wq0 >= S || (causal && k0 > wq0 + BQ - 1);
    auto stage_next = [&]() {
      if (it + 1 < n_tiles) {
        const int nb = (it + 1) & 1;
        stage_tile<D, NTH>(ks + nb * TILE, kb, (it + 1) * BK, Tk);
        stage_tile<D, NTH>(vs + nb * TILE, vb, (it + 1) * BK, Tk);
      }
      cp_async_commit();
    };
    if (skip) {  // before the products: their path has no branch
      stage_next();
      continue;
    }
    float s[8][4], dp[8][4];
    if constexpr (QREG) {
      zero(s);
      zero(dp);
      fence_regs(s);
      fence_regs(dp);
    }
    wgmma_fence();
    if constexpr (QREG) {
      issue_rbt<D>(s, qf, kt);   // S = Q K^T
      issue_rbt<D>(dp, df, vt);  // dP = dO V^T
    } else {
      issue_abt<D>(s, qs + wg * TILE, kt);
      issue_abt<D>(dp, dos + wg * TILE, vt);
    }
    wgmma_commit();
    stage_next();  // the next tile's copies go out while the products run
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);
    // dS = P o (dP - delta), P = exp(scale S - lse); mask only the tiles
    // that reach past T or the warpgroup's diagonal
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > wq0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        float p = ex2(fmaf(s[n][e], scale_log2, -(e < 2 ? l_lo : l_hi)));
        if (edge && (key >= Tk || (causal && key > row))) p = 0.f;
        dp[n][e] = p * (dp[n][e] - (e < 2 ? d_lo : d_hi));
      }
    uint32_t xf[4][4];
    to_a_frags(dp, xf);
    fence_regs(acc);
    wgmma_fence();
    issue_xb<D>(acc, xf, kt);  // dQ += dS K
    wgmma_commit_wait();
    fence_regs(acc);
  }
  cp_async_wait_all();

  bf16* qb = dq + qoff;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(qb + (size_t)row_lo * D + col) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (row_hi < S)
      *reinterpret_cast<__nv_bfloat162*>(qb + (size_t)row_hi * D + col) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D, int NW>
__global__ void __launch_bounds__(BwdCfg<D, NW>::NTH)
flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           float* __restrict__ part, int S, int Tk, int group,
                           float scale, float scale_log2, int causal, int L) {
  using C = BwdCfg<D, NW>;
  constexpr int NT = D / 8, TILE = C::TILE, NTH = C::NTH, BKV = C::ROWS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = align_1024(smem_raw);  // [NW][TILE]
  bf16* vs = ks + NW * TILE;         // [NW][TILE]
  bf16* qs = vs + NW * TILE;         // [2][TILE]
  bf16* dos = qs + 2 * TILE;         // [2][TILE]
  float* ls = reinterpret_cast<float*>(dos + 2 * TILE);  // [2][BQ]: lse
  float* dl = ls + 2 * BQ;                               // [2][BQ]: delta

  // blockIdx.x enumerates the segments of key blocks 0, 1, ... in order
  const int hk = blockIdx.y;
  int j = 0, seg = blockIdx.x, n_seg;
  while (seg >= (n_seg = bwd_segments(j, BKV, S, group, causal, L))) {
    seg -= n_seg;
    ++j;
  }
  const int k0 = j * BKV;
  const int q_begin = causal ? k0 : 0;
  const int n_q = bwd_walk(j, BKV, S, group, causal) / group;
  const int it0 = seg * L;
  const int it1 = min(group * n_q, it0 + L);
  const size_t kvoff = (size_t)hk * Tk * D;
  const int wg = warpgroup();
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wk0 = k0 + wg * BK;  // the warpgroup's first key
  const int key_lo = wk0 + warp * 16 + g, key_hi = key_lo + 8;

  // step `it` of the walk: q head it / n_q of the group, query stage
  // it % n_q from q_begin
  auto stage = [&](int it, int buf) {
    const int bh = hk * group + it / n_q;
    const int q0 = q_begin + it % n_q * BQ;
    stage_tile<D, NTH>(qs + buf * TILE, q + (size_t)bh * S * D, q0, S);
    stage_tile<D, NTH>(dos + buf * TILE, dout + (size_t)bh * S * D, q0, S);
    for (int r = threadIdx.x; r < BQ; r += NTH) {
      const bool ok = q0 + r < S;
      const size_t at = (size_t)bh * S + (ok ? q0 + r : 0);
      cp_async4(smem_u32(ls + buf * BQ + r), lse + at, ok);
      cp_async4(smem_u32(dl + buf * BQ + r), delta + at, ok);
    }
  };

#pragma unroll
  for (int w = 0; w < NW; ++w) {
    stage_tile<D, NTH>(ks + w * TILE, k + kvoff, k0 + w * BK, Tk);
    stage_tile<D, NTH>(vs + w * TILE, v + kvoff, k0 + w * BK, Tk);
  }
  if (it0 < it1) stage(it0, 0);
  cp_async_commit();

  const bf16* kw = ks + wg * TILE;
  const bf16* vw = vs + wg * TILE;
  float dka[NT][4], dva[NT][4];
  zero(dka);
  zero(dva);

  for (int it = it0; it < it1; ++it) {
    cp_async_wait_all();
    __syncthreads();  // step `it` landed; every warpgroup is done with it - 1
    const int buf = (it - it0) & 1;
    const int q0 = q_begin + it % n_q * BQ;
    const bf16* qt = qs + buf * TILE;
    const bf16* dot = dos + buf * TILE;
    const float* lt = ls + buf * BQ;
    const float* dt = dl + buf * BQ;
    // under `causal` a warpgroup whose keys all follow the stage's queries
    // sees none of them
    const bool skip = wk0 >= Tk || (causal && wk0 > q0 + BQ - 1);
    auto stage_next = [&]() {
      if (it + 1 < it1) stage(it + 1, buf ^ 1);
      cp_async_commit();
    };
    if (skip) {  // before the products: their path has no branch
      stage_next();
      continue;
    }
    // S^T = K Q^T and dP^T = V dO^T: rows the warpgroup's keys, columns
    // the stage's queries
    float p[8][4], ds[8][4];
    wgmma_fence();
    issue_abt<D>(p, kw, qt);
    issue_abt<D>(ds, vw, dot);
    wgmma_commit();
    stage_next();  // the next step's copies go out while the products run
    wgmma_wait();
    fence_regs(p);
    fence_regs(ds);
    // P^T = exp(scale S^T - lse), dS^T = P^T o (dP^T - delta); mask only
    // where the queries reach past S or the keys cross the diagonal
    const bool edge = q0 + BQ > S || (causal && wk0 + BK - 1 > q0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const int key = e < 2 ? key_lo : key_hi;
        float x = ex2(fmaf(p[n][e], scale_log2, -(lt[c] * LOG2E)));
        if (edge && (q0 + c >= S || (causal && key > q0 + c))) x = 0.f;
        p[n][e] = x;
        ds[n][e] = x * (ds[n][e] - dt[c]);
      }
    uint32_t pf[4][4], sf[4][4];
    to_a_frags(p, pf);
    to_a_frags(ds, sf);
    fence_regs(dva);
    fence_regs(dka);
    wgmma_fence();
    issue_xb<D>(dva, pf, dot);  // dV += P^T dO
    issue_xb<D>(dka, sf, qt);   // dK += dS^T Q
    wgmma_commit_wait();
    fence_regs(dva);
    fence_regs(dka);
  }
  cp_async_wait_all();

  if (n_seg == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t;
      if (key_lo < Tk) {
        const size_t at = kvoff + (size_t)key_lo * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dka[n][0] * scale, dka[n][1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dva[n][0], dva[n][1]);
      }
      if (key_hi < Tk) {
        const size_t at = kvoff + (size_t)key_hi * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(dka[n][2] * scale, dka[n][3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(dva[n][2], dva[n][3]);
      }
    }
    return;
  }
  // the segment's f32 sums, unscaled, into its slot: [dK | dV] of [BKV][D]
  float* pk = part + ((size_t)hk * gridDim.x + blockIdx.x) * 2 * BKV * D;
  float* pv = pk + BKV * D;
  const int r = wg * BK + warp * 16 + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int lo = r * D + n * 8 + 2 * t, hi = lo + 8 * D;
    *reinterpret_cast<float2*>(pk + lo) = make_float2(dka[n][0], dka[n][1]);
    *reinterpret_cast<float2*>(pk + hi) = make_float2(dka[n][2], dka[n][3]);
    *reinterpret_cast<float2*>(pv + lo) = make_float2(dva[n][0], dva[n][1]);
    *reinterpret_cast<float2*>(pv + hi) = make_float2(dva[n][2], dva[n][3]);
  }
}

// The second pass: for each key block walked by several segments, dk =
// bf16(scale * (part_0 + part_1 + ...)) and dv = bf16(part_0 + part_1 +
// ...), one f32 add each in segment order and one rounding.  A block takes
// BWD_SUM_THREADS float4s of one key block's slot (so a training shape's
// few key blocks still fill the card), a thread one float4, loading 4
// segments ahead before it adds them.  Blocks of key blocks that one
// segment walked return at once.  Bound by bytes: every partial read once.
template <int D, int BKV>
__global__ void __launch_bounds__(BWD_SUM_THREADS)
flash_bwd_dkdv_sum_bf16_kernel(const float* __restrict__ part,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int S, int Tk, int group, float scale,
                               int causal, int L, int slots) {
  constexpr int N4 = 2 * BKV * D / 4, U = 4;
  constexpr int PIECES = (N4 + BWD_SUM_THREADS - 1) / BWD_SUM_THREADS;
  const int j = blockIdx.x / PIECES, hk = blockIdx.y;
  int seg0 = 0;
  for (int i = 0; i < j; ++i) seg0 += bwd_segments(i, BKV, S, group, causal, L);
  const int n_seg = bwd_segments(j, BKV, S, group, causal, L);
  if (n_seg == 1) return;
  const float4* p = reinterpret_cast<const float4*>(part) +
                    ((size_t)hk * slots + seg0) * N4;
  const int e = blockIdx.x % PIECES * BWD_SUM_THREADS + threadIdx.x;
  const int at = e * 4, half = at / (BKV * D);
  const int key = j * BKV + at % (BKV * D) / D;
  if (e >= N4 || key >= Tk) return;
  float4 acc = p[e];
  for (int s = 1; s < n_seg; s += U) {
    float4 b[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (s + u < n_seg) b[u] = p[(size_t)(s + u) * N4 + e];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (s + u < n_seg) {
        acc.x += b[u].x;
        acc.y += b[u].y;
        acc.z += b[u].z;
        acc.w += b[u].w;
      }
  }
  const float m = half ? 1.f : scale;
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(
      (half ? dv : dk) + ((size_t)hk * Tk + key) * D + at % D);
  out[0] = __floats2bfloat162_rn(acc.x * m, acc.y * m);
  out[1] = __floats2bfloat162_rn(acc.z * m, acc.w * m);
}

// The split walk's layout for bkv keys a block and segments of L stages:
// its blocks per kv head (every key block's segments) and whether any key
// block has more than one.
inline long long bwd_split_slots(int bkv, int S, int Tk, int group,
                                 int causal, int L, bool* split) {
  long long slots = 0;
  *split = false;
  for (int j = 0; j < (Tk + bkv - 1) / bkv; ++j) {
    const int n = bwd_segments(j, bkv, S, group, causal, L);
    slots += n;
    *split = *split || n > 1;
  }
  return slots;
}

// `part`: f32 scratch of part_floats = BHkv * (the segments of every key
// block) * 2 * 64 NK * D where some key block has more than one segment,
// else 0 (kernels/flash_attention.dkdv_partials_bf16); any other size
// refuses.  NQ, NK: the warpgroups of a dQ and a dK/dV block; L: the query
// stages of a segment (bwd_dispatch passes bwd_seg_stages').
template <int D, int NQ, int NK>
cudaError_t bwd_launch(const void* q, const void* k, const void* v,
                       const void* o, const float* lse, const void* dout,
                       void* dq, void* dk, void* dv, float* delta, float* part,
                       long long part_floats, int BH, int BHkv, int S, int Tk,
                       float scale, int causal, int L, cudaStream_t stream) {
  using CQ = BwdCfg<D, NQ>;
  using CK = BwdCfg<D, NK>;
  const int group = BH / BHkv;
  const int n_tiles = (S + CQ::ROWS - 1) / CQ::ROWS;
  const int n_kb = (Tk + CK::ROWS - 1) / CK::ROWS;
  bool split;
  const long long slots =
      bwd_split_slots(CK::ROWS, S, Tk, group, causal, L, &split);
  const long long need = split ? BHkv * slots * 2 * CK::ROWS * D : 0;
  if (n_tiles > 65535 || BHkv > 65535 || slots > 0x7fffffff ||
      part_floats != need || (need > 0 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<D, NQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CQ::SMEM_DQ);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<D, NK>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)CK::SMEM_DKDV);
  if (e != cudaSuccess) return e;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* db = static_cast<const bf16*>(dout);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  const float scale_log2 = scale * LOG2E;
  flash_bwd_dq_bf16_kernel<D, NQ><<<dim3(BH, n_tiles), CQ::NTH,
                                    CQ::SMEM_DQ, stream>>>(
      qb, kb, vb, static_cast<const bf16*>(o), db, lse, delta,
      static_cast<bf16*>(dq), S, Tk, group, scale, scale_log2, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_bf16_kernel<D, NK><<<dim3((unsigned)slots, BHkv),
                                      CK::NTH, CK::SMEM_DKDV, stream>>>(
      qb, kb, vb, db, lse, delta, dkb, dvb, part, S, Tk, group, scale,
      scale_log2, causal, L);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return e;
  constexpr int pieces =
      (2 * CK::ROWS * D / 4 + BWD_SUM_THREADS - 1) / BWD_SUM_THREADS;
  flash_bwd_dkdv_sum_bf16_kernel<D, CK::ROWS><<<dim3(n_kb * pieces, BHkv),
                                                BWD_SUM_THREADS, 0, stream>>>(
      part, dkb, dvb, S, Tk, group, scale, causal, L, (int)slots);
  return cudaGetLastError();
}

// The blocks per head dim: bwd_launch<D, NQ, NK> (kernels/flash_attention.
// BWD_BF16_BLOCK repeats 64 NK, a test parses both).
cudaError_t bwd_dispatch(int D, const void* q, const void* k, const void* v,
                         const void* o, const float* lse, const void* dout,
                         void* dq, void* dk, void* dv, float* delta,
                         float* part, long long part_floats, int BH, int BHkv,
                         int S, int Tk, float scale, int causal,
                         cudaStream_t stream) {
  const int L = bwd_seg_stages(S, BH / BHkv);
  switch (D) {
    case 16: return bwd_launch<16, 1, 1>(q, k, v, o, lse, dout, dq, dk, dv, delta, part, part_floats, BH, BHkv, S, Tk, scale, causal, L, stream);
    case 32: return bwd_launch<32, 1, 1>(q, k, v, o, lse, dout, dq, dk, dv, delta, part, part_floats, BH, BHkv, S, Tk, scale, causal, L, stream);
    case 64: return bwd_launch<64, 1, 1>(q, k, v, o, lse, dout, dq, dk, dv, delta, part, part_floats, BH, BHkv, S, Tk, scale, causal, L, stream);
    case 112: return bwd_launch<112, 2, 2>(q, k, v, o, lse, dout, dq, dk, dv, delta, part, part_floats, BH, BHkv, S, Tk, scale, causal, L, stream);
    case 128: return bwd_launch<128, 2, 2>(q, k, v, o, lse, dout, dq, dk, dv, delta, part, part_floats, BH, BHkv, S, Tk, scale, causal, L, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 forward: tensor cores in three TF32 terms (mma.sync m16n8k8)
// ---------------------------------------------------------------------------
namespace f32 {

using tc::cp_async16;
using tc::cp_async_commit;
using tc::smem_u32;

constexpr int BK = 32;  // keys a warp takes from each stage

// The block: WQ x KS warps over BQ = 16 WQ queries; warp (wm, wk) owns
// query rows 16 wm .. 16 wm + 15 and the wk-th BK keys of every stage of
// KS x BK keys.  Every tile has rows of LD = D + 4 floats.
template <int D, int WQ, int KS>
struct Cfg {
  static_assert(D % 8 == 0, "tiles are cut into 8 x 8 blocks");
  static constexpr int LD = D + 4;
  static constexpr int BQ = 16 * WQ;
  static constexpr int THREADS = 32 * WQ * KS;
  static constexpr int STAGE = KS * BK;      // keys staged per step
  static constexpr bool QREG = D <= 64;      // Q's splits in registers
  static constexpr int QTILE = BQ * LD;      // floats of one Q tile
  static constexpr int KVTILE = STAGE * LD;  // floats of one K or V stage
  static constexpr int SLOT = 16 * LD + 32;  // one warp's partial acc, m, l
  // Q (QREG), or Q's hi and lo; then K and V, double-buffered
  static constexpr size_t SMEM =
      sizeof(float) * ((QREG ? 1 : 2) * (size_t)QTILE + 4 * (size_t)KVTILE);
  static_assert(KS == 1 || (KS - 1) * WQ * SLOT <= 4 * KVTILE,
                "the partials of the key split reuse the K/V stages");
};

// The n8 tiles of P V whose V fragments are split and held at once: the
// largest divisor of NT = D / 8 up to 8.
__host__ __device__ constexpr int group_of(int nt) {
  return nt % 8 == 0   ? 8
         : nt % 7 == 0 ? 7
         : nt % 4 == 0 ? 4
         : nt % 2 == 0 ? 2
                       : 1;
}

// rna(x) as a tf32 bit pattern with its 13 low bits cleared, which is also
// the f32 value rna(x) exactly (cvt.rna clears them on the H100; the mask
// keeps x - hi exact should a target leave them).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = hi + lo + e, |e| <= 2^-22 |x|: hi = rna(x), lo = rna(x - hi), where
// x - hi is exact in f32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d (16 x 8, f32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col).
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + ROWS) of a [n_rows][D] operand into shared rows of stride
// D + 4 by 16-byte cp.async, rows past n_rows zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int n_rows) {
  constexpr int CH = D / 4, LD = D + 4;
  for (int e = threadIdx.x; e < ROWS * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const bool ok = r0 + r < n_rows;
    cp_async16(smem_u32(dst + r * LD + c * 4),
               src + (size_t)(ok ? r0 + r : 0) * D + c * 4, ok);
  }
}

template <int D, int WQ, int KS>
__global__ void __launch_bounds__(Cfg<D, WQ, KS>::THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int Tk, int group,
                 float scale, int causal) {
  using C = Cfg<D, WQ, KS>;
  constexpr int LD = C::LD, BQ = C::BQ, STAGE = C::STAGE;
  constexpr int THREADS = C::THREADS, KSTEPS = D / 8, NT = D / 8;
  constexpr int SN = BK / 8, NG = group_of(NT);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;  // [BQ][LD]: Q; unless QREG, then its hi and lo
  float* kbuf = smem + (C::QREG ? 1 : 2) * C::QTILE;      // [2][STAGE][LD]
  float* vbuf = kbuf + 2 * C::KVTILE;                     // [2][STAGE][LD]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest tiles first
  const float* kb = k + (size_t)(bh / group) * Tk * D;
  const float* vb = v + (size_t)(bh / group) * Tk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % WQ, wk = warp / WQ;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wm * 16;                        // the warp's rows in the tile
  const int first = q0 + r0, last = first + 15;  // and their positions
  const int row_lo = first + g, row_hi = row_lo + 8;

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int n_stages = (k_end + STAGE - 1) / STAGE;

  stage<D, BQ, THREADS>(qs, q + (size_t)bh * S * D, q0, S);
  stage<D, STAGE, THREADS>(kbuf, kb, 0, Tk);
  stage<D, STAGE, THREADS>(vbuf, vb, 0, Tk);
  cp_async_commit();

  uint32_t qh[C::QREG ? KSTEPS : 1][4], ql[C::QREG ? KSTEPS : 1][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  for (int it = 0; it < n_stages; ++it) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // stage `it` landed; every warp is done with it - 1
    if (it + 1 < n_stages) {
      const int nb = (it + 1) & 1;
      stage<D, STAGE, THREADS>(kbuf + nb * C::KVTILE, kb, (it + 1) * STAGE, Tk);
      stage<D, STAGE, THREADS>(vbuf + nb * C::KVTILE, vb, (it + 1) * STAGE, Tk);
    }
    cp_async_commit();
    if (it == 0) {
      if constexpr (C::QREG) {
        // A fragments: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const float* qr = qs + (r0 + g) * LD + kk * 8 + t;
          split(qr[0], qh[kk][0], ql[kk][0]);
          split(qr[8 * LD], qh[kk][1], ql[kk][1]);
          split(qr[4], qh[kk][2], ql[kk][2]);
          split(qr[8 * LD + 4], qh[kk][3], ql[kk][3]);
        }
      } else {
        for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
          const int at = e / D * LD + e % D;
          uint32_t hi, lo;
          split(qs[at], hi, lo);
          qs[at] = __uint_as_float(hi);
          qs[C::QTILE + at] = __uint_as_float(lo);
        }
        __syncthreads();
      }
    }
    const int kt0 = it * STAGE + wk * BK;  // the warp's first key this stage
    if (kt0 >= k_end || first >= S || (causal && kt0 > last)) continue;
    const float* kt = kbuf + (it & 1) * C::KVTILE + wk * BK * LD;
    const float* vt = vbuf + (it & 1) * C::KVTILE + wk * BK * LD;

    // S = Q K^T, 16 rows x BK keys, k8 step kk over d; B fragment of key
    // tile n: K[n * 8 + g][kk * 8 + t], K[n * 8 + g][kk * 8 + t + 4]
    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (C::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = qh[kk][e];
          al[e] = ql[kk][e];
        }
      } else {
        const float* qr = qs + (r0 + g) * LD + kk * 8 + t;
        ah[0] = __float_as_uint(qr[0]);
        ah[1] = __float_as_uint(qr[8 * LD]);
        ah[2] = __float_as_uint(qr[4]);
        ah[3] = __float_as_uint(qr[8 * LD + 4]);
        al[0] = __float_as_uint(qr[C::QTILE]);
        al[1] = __float_as_uint(qr[C::QTILE + 8 * LD]);
        al[2] = __float_as_uint(qr[C::QTILE + 4]);
        al[3] = __float_as_uint(qr[C::QTILE + 8 * LD + 4]);
      }
      uint32_t bh[SN][2], bl[SN][2];
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        const float* kr = kt + (n * 8 + g) * LD + kk * 8 + t;
        split(kr[0], bh[n][0], bl[n][0]);
        split(kr[4], bh[n][1], bl[n][1]);
      }
      // small terms first, each over every key tile before the next term
#pragma unroll
      for (int n = 0; n < SN; ++n) mma1688(s[n], al, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < SN; ++n) mma1688(s[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < SN; ++n) mma1688(s[n], ah, bh[n][0], bh[n][1]);
    }

    // scale; mask only the tiles that reach past T or the warp's diagonal
    const bool edge = kt0 + BK > Tk || (causal && kt0 + BK - 1 > first);
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int key = kt0 + n * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row_lo : row_hi;
          if (key >= Tk || (causal && key > row)) x = NEG_INF;
        }
        s[n][e] = x;
        if (e < 2)
          mx_lo = fmaxf(mx_lo, x);
        else
          mx_hi = fmaxf(mx_hi, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float c_lo = expf(m_lo - mn_lo), c_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < SN; ++n) {
      s[n][0] = expf(s[n][0] - mn_lo);
      s[n][1] = expf(s[n][1] - mn_lo);
      s[n][2] = expf(s[n][2] - mn_hi);
      s[n][3] = expf(s[n][3] - mn_hi);
      sum_lo += s[n][0] + s[n][1];
      sum_hi += s[n][2] + s[n][3];
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

    // O += P V, 8 keys a step.  P's accumulators are the A operand as they
    // stand: the thread holds keys 2t and 2t + 1 where A's k index is t
    // and t + 4, so k = t is key 2t and k = t + 4 key 2t + 1, and V's B
    // fragment is read in that order: rows 2t and 2t + 1, column g.
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);  // row g,     key 2t
      split(s[j][2], ph[1], pl[1]);  // row g + 8, key 2t
      split(s[j][1], ph[2], pl[2]);  // row g,     key 2t + 1
      split(s[j][3], ph[3], pl[3]);  // row g + 8, key 2t + 1
      const float* vr = vt + (j * 8 + 2 * t) * LD + g;
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += NG) {
        uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          split(vr[(n0 + n) * 8], bh[n][0], bl[n][0]);
          split(vr[LD + (n0 + n) * 8], bh[n][1], bl[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NG; ++n)
          mma1688(acc[n0 + n], pl, bh[n][0], bh[n][1]);
#pragma unroll
        for (int n = 0; n < NG; ++n)
          mma1688(acc[n0 + n], ph, bl[n][0], bl[n][1]);
#pragma unroll
        for (int n = 0; n < NG; ++n)
          mma1688(acc[n0 + n], ph, bh[n][0], bh[n][1]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  if constexpr (KS > 1) {
    // the key split's partials merge in the order wk = 1, 2, ... into warp
    // wk = 0's, through the K/V stages' space (no copy is in flight: the
    // last commit group was empty)
    __syncthreads();
    if (wk > 0) {
      float* p = kbuf + ((wk - 1) * WQ + wm) * C::SLOT;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<float2*>(p + g * LD + n * 8 + 2 * t) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(p + (g + 8) * LD + n * 8 + 2 * t) =
            make_float2(acc[n][2], acc[n][3]);
      }
      if (t == 0) {
        p[16 * LD + g] = m_lo;
        p[16 * LD + 8 + g] = m_hi;
        p[16 * LD + 16 + g] = l_lo;
        p[16 * LD + 24 + g] = l_hi;
      }
    }
    __syncthreads();
    if (wk > 0) return;
    for (int w = 1; w < KS; ++w) {
      const float* p = kbuf + ((w - 1) * WQ + wm) * C::SLOT;
      const float pm_lo = p[16 * LD + g], pm_hi = p[16 * LD + 8 + g];
      const float mn_lo = fmaxf(m_lo, pm_lo), mn_hi = fmaxf(m_hi, pm_hi);
      const float a_lo = expf(m_lo - mn_lo), b_lo = expf(pm_lo - mn_lo);
      const float a_hi = expf(m_hi - mn_hi), b_hi = expf(pm_hi - mn_hi);
      l_lo = l_lo * a_lo + p[16 * LD + 16 + g] * b_lo;
      l_hi = l_hi * a_hi + p[16 * LD + 24 + g] * b_hi;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 x =
            *reinterpret_cast<const float2*>(p + g * LD + n * 8 + 2 * t);
        const float2 y =
            *reinterpret_cast<const float2*>(p + (g + 8) * LD + n * 8 + 2 * t);
        acc[n][0] = acc[n][0] * a_lo + x.x * b_lo;
        acc[n][1] = acc[n][1] * a_lo + x.y * b_lo;
        acc[n][2] = acc[n][2] * a_hi + y.x * b_hi;
        acc[n][3] = acc[n][3] * a_hi + y.y * b_hi;
      }
      m_lo = mn_lo;
      m_hi = mn_hi;
    }
  }

  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  float* ob = o + (size_t)bh * S * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_lo < S)
      *reinterpret_cast<float2*>(ob + (size_t)row_lo * D + col) =
          make_float2(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    if (row_hi < S)
      *reinterpret_cast<float2*>(ob + (size_t)row_hi * D + col) =
          make_float2(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
  }
  if (lse != nullptr && t == 0) {
    if (row_lo < S)
      lse[(size_t)bh * S + row_lo] = m_lo + logf(fmaxf(l_lo, 1e-30f));
    if (row_hi < S)
      lse[(size_t)bh * S + row_hi] = m_hi + logf(fmaxf(l_hi, 1e-30f));
  }
}

template <int D, int WQ, int KS>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int BH, int BHkv, int S, int Tk, float scale,
                   int causal, cudaStream_t stream) {
  using C = Cfg<D, WQ, KS>;
  const int n_tiles = (S + C::BQ - 1) / C::BQ;
  if (n_tiles > 65535) return cudaErrorInvalidValue;
  if (C::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<D, WQ, KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
    if (e != cudaSuccess) return e;
  }
  flash_fwd_kernel<D, WQ, KS><<<dim3(BH, n_tiles), C::THREADS, C::SMEM,
                                    stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, Tk,
      BH / BHkv, scale, causal);
  return cudaGetLastError();
}

// The block per head dim (WQ query warps, KS key warps), chosen on the
// H100 by a sweep of WQ in 1, 2, 4, 8, KS in 1, 2, 4 and BK in 16, 32, 64
// (32 best at both shapes) at train_lm's shape (D = 64) and the training
// shape (D = 128) (PERF.md §6 row 5d).  D <= 64: 32 queries and a key
// walk split over two warps (2 x 2 warps): at train_lm's S = 256 the walk to
// the diagonal of one warp, not the card's rate, sets the time, and
// halving it beats every unsplit shape.  D = 112 and 128: 128 queries, 8
// warps, 32-key stages (203 KB of shared memory at D = 128, one block an
// SM): each staged K/V tile serves the most rows.
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, float* lse, int BH, int BHkv, int S, int Tk,
                     float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, 2, 2>(q, k, v, o, lse, BH, BHkv, S, Tk, scale, causal, stream);
    case 32: return launch<32, 2, 2>(q, k, v, o, lse, BH, BHkv, S, Tk, scale, causal, stream);
    case 64: return launch<64, 2, 2>(q, k, v, o, lse, BH, BHkv, S, Tk, scale, causal, stream);
    case 112: return launch<112, 8, 1>(q, k, v, o, lse, BH, BHkv, S, Tk, scale, causal, stream);
    case 128: return launch<128, 8, 1>(q, k, v, o, lse, BH, BHkv, S, Tk, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// Backward, f32: tensor cores in three TF32 terms (mma.sync m16n8k8)
// ---------------------------------------------------------------------------
// Both backward kernels take the forward's log-sum-exp (natural log of the
// row's sum of exp(scale * q.k) over its unmasked keys), so P = exp(scale *
// q.k - lse) is recomputed tile by tile and never stored; delta = rowsum(dO
// o O).  The dQ kernel runs first and writes delta, which the dK/dV kernel
// reads.  With dS = P o (dP - delta):
//   dQ = scale * dS K        one block per (q head, BQ rows), walking the
//                            key stages up to the diagonal;
//   dK = scale * dS^T Q,     one block per (kv head, BKV keys, segment),
//   dV = P^T dO              walking a segment of its group's (q head,
//                            query stage) pairs from the diagonal on.
// Every product (S and dP in each kernel, dQ, dV, dK) is mma.sync m16n8k8
// tf32 in three terms with the forward's split (f32::split, mma1688): lo_a
// hi_b + hi_a lo_b + hi_a hi_b in f32 accumulators.  What bounds it:
// operations, 240.5 GFLOP at the training shape (q (16, 4096, 128), k/v
// (2, 4096, 128), causal; seven products), 1.46 ms at the 165 TFLOP/s
// three TF32 terms leave of 495.  A block is W x CS warps: warp (w, c)
// owns 16 rows (queries in the dQ kernel, keys in the dK/dV kernel) and
// the c-th 1/CS of each stage's columns (keys, queries), so no product
// needs another warp's result; at the end the CS warps of the same rows
// add their sums in the order c = 1, 2, ... through shared memory
// (`merge_columns`).  Two warps on the same rows is what lets a block of
// 203 KB (D = 128, one an SM) run 8 warps: the stages and the split rows
// leave no room for more rows.  The block's own rows (Q and dO, or K and
// V) are staged once by cp.async and split once in shared memory (hi over
// the values, lo beside them), then read as A fragments; the walked stages
// (K and V, or Q and dO) are double-buffered by 16-byte cp.async with
// zero-fill and split as a warp reads its B fragments.  Every tile has rows
// of LD = D + 4 floats, so every fragment read falls on 32 distinct banks
// (see flash_fwd_kernel).  P and dS are made in the accumulators and split
// where they stand as the A operand of the next product, as the forward
// feeds P: A wants columns t and t + 4 where the thread holds 2t and 2t +
// 1, so B's rows are read in the order 2t, 2t + 1.  The dK/dV kernel
// computes S^T = K Q^T (keys as rows), so P^T dO and dS^T Q take their A
// operands from the accumulators too, with no transpose through shared
// memory.  The dQ kernel runs its query tiles heaviest first (blockIdx.y
// reversed).
//
// The dK/dV walk is split.  Under `causal` the key block at the start of a
// sequence walks every query stage of its group's q heads and the one at
// the end a single stage, so one block per key block leaves the card
// waiting on the first ones (at the training shape the first walked twice
// the mean).  The walk of key block j, its group's q heads times its query
// stages (`walk`), is cut into segments of L stages (`seg_stages`: the
// heaviest key block's walk in about SEG_TARGET segments, at least SEG_MIN
// stages each) and each segment is a block; the blocks are enumerated key
// block by key block, the heaviest first.  L and the segments depend only
// on (S, T, D, group) and `causal`, never on BH or the batch, which
// kernels/flash_attention.dkdv_split repeats for the wrapper's workspace.
// A key block walked by one segment writes dk and dv itself; one walked by
// several writes each segment's f32 sums into `part`, and
// flash_bwd_dkdv_sum_kernel adds them in segment order (the pattern of the
// segsum block of mg3m_conv.cu / causal_conv1d.cu, with a segment count
// per key block).  Every gradient element is summed in a fixed order, with
// no atomics: dq, dk and dv are bitwise the same from run to run, and a
// sequence's gradients do not depend on the other sequences of its batch.
//
// Where it rounds, against flash_attention_bwd_3xtf32_plain (the same
// split and exact products; the tests hold it within 1e-5 of max |g| of
// flash_attention_bwd_plain).  The two differ in the order and the rounding
// of their sums.  S and dP: about sqrt(3D) u (u = 2^-24) of their partial
// sums, 1.2e-6 of a score at D = 128 (see flash_fwd_kernel), a relative
// 1.2e-6 in P and dS, below the split's own 2^-22.  The gradients' long
// sums dominate: the tensor cores add each mma's exact products into the
// f32 accumulator with truncation rather than to nearest (as measured for
// earlier NVIDIA tensor cores by Fasi, Higham, Mikaitis and Pranesh, 2021;
// the readings at the training shape, some 30 times the f32 FMA
// kernels', bear it out), so an add loses up to 2^-23 of the running sum
// and 2^-24 on average, always toward zero, and the losses of m adds add
// up rather than cancel.  A dQ
// element takes m = 3 T / (8 CS) adds (768 at T = 4096, CS = 2), a dK or
// dV element 3 L BQ / (8 CS) a segment (192 at the training shape), then
// the merge's and the second pass's adds to nearest: 768 * 2^-24 = 4.6e-5
// of max |g| had every running sum been as large as max |g|.  Most are far
// smaller; the readings are 1e-6 to 2e-5.  chip_smoke.py holds the kernels
// to the emulation within 1e-4 of max |g| (`XTF32_BWD_TOL`), beside the
// f32 tolerance of 2e-4 against flash_attention_bwd_plain.
namespace bwd {

using f32::mma1688;
using f32::split;
using f32::stage;
using tc::cp_async_commit;

constexpr int BK = 32;          // keys a dQ stage holds
constexpr int BQ = 32;          // queries a dK/dV stage holds
constexpr int CS = 2;           // warps that share 16 rows, a stage each half
constexpr int SEG_TARGET = 32;  // segments of the heaviest key block's walk
constexpr int SEG_MIN = 4;      // the fewest query stages of a segment
constexpr int SUM_THREADS = 256;

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The n8 tiles of a product whose B fragments are split and held at once:
// the largest of 4, 2, 1 that divides NT (fewer registers than the
// forward's group_of, beside the dK/dV kernel's two D-wide accumulators).
__host__ __device__ constexpr int group4(int nt) {
  return nt % 4 == 0 ? 4 : nt % 2 == 0 ? 2 : 1;
}

// The dK/dV walk's split (kernels/flash_attention.dkdv_split repeats it).
// L, the query stages of a segment.
__host__ __device__ inline int seg_stages(int S, int group) {
  const int stages = (group * ((S + BQ - 1) / BQ) + SEG_TARGET - 1) /
                     SEG_TARGET;
  return stages > SEG_MIN ? stages : SEG_MIN;
}
// The (q head, query stage) pairs key block j (of bkv keys) walks.
__host__ __device__ inline int walk(int j, int bkv, int S, int group,
                                    int causal) {
  const int q_begin = causal ? j * bkv : 0;
  return q_begin < S ? group * ((S - q_begin + BQ - 1) / BQ) : 0;
}
// Its segments: at least one, which writes zeros where the walk is empty.
__host__ __device__ inline int segments(int j, int bkv, int S, int group,
                                        int causal, int L) {
  const int n = (walk(j, bkv, S, group, causal) + L - 1) / L;
  return n > 1 ? n : 1;
}

// A [ROWS][D + 4] tile of f32 values split in place: hi over the values,
// lo `tile` floats later.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void split_tile(float* x, int tile) {
  constexpr int LD = D + 4;
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int at = e / D * LD + e % D;
    uint32_t hi, lo;
    split(x[at], hi, lo);
    x[at] = __uint_as_float(hi);
    x[tile + at] = __uint_as_float(lo);
  }
}

// s[n] += X Y^T over k8 step kk of D, n < SN: X the warp's 16 rows of a
// split tile (x at its first row, lo `tile` floats after hi), A fragments
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); Y's rows n * 8 + g raw at
// y, split here as B fragments (columns t, t + 4).  Small terms first,
// each over every n8 tile before the next term.
template <int D, int SN>
__device__ __forceinline__ void abt_step(const float* x, int tile,
                                         const float* y, int kk,
                                         float (&s)[SN][4]) {
  constexpr int LD = D + 4;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const float* xr = x + g * LD + kk * 8 + t;
  uint32_t ah[4], al[4];
  ah[0] = __float_as_uint(xr[0]);
  ah[1] = __float_as_uint(xr[8 * LD]);
  ah[2] = __float_as_uint(xr[4]);
  ah[3] = __float_as_uint(xr[8 * LD + 4]);
  al[0] = __float_as_uint(xr[tile]);
  al[1] = __float_as_uint(xr[tile + 8 * LD]);
  al[2] = __float_as_uint(xr[tile + 4]);
  al[3] = __float_as_uint(xr[tile + 8 * LD + 4]);
  uint32_t bh[SN][2], bl[SN][2];
#pragma unroll
  for (int n = 0; n < SN; ++n) {
    const float* yr = y + (n * 8 + g) * LD + kk * 8 + t;
    split(yr[0], bh[n][0], bl[n][0]);
    split(yr[4], bh[n][1], bl[n][1]);
  }
#pragma unroll
  for (int n = 0; n < SN; ++n) mma1688(s[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < SN; ++n) mma1688(s[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < SN; ++n) mma1688(s[n], ah, bh[n][0], bh[n][1]);
}

// s[n] += X Y^T over D (`abt_step`): the even k8 steps sum into s, the odd
// ones into a second set added at the end, two independent chains of mma
// a tile where one chain would wait on each product's latency.
template <int D, int SN>
__device__ __forceinline__ void abt(const float* x, int tile, const float* y,
                                    float (&s)[SN][4]) {
  static_assert(D % 16 == 0, "the k8 steps pair up");
  float s1[SN][4];
#pragma unroll
  for (int n = 0; n < SN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s1[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 8; kk += 2) {
    abt_step<D, SN>(x, tile, y, kk, s);
    abt_step<D, SN>(x, tile, y, kk + 1, s1);
  }
#pragma unroll
  for (int n = 0; n < SN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += s1[n][e];
}

// acc (16 x D) += X Y: X (16 x 8 SN) in the accumulators x, split here and
// fed as A where it stands (k = t is column 2t, k = t + 4 column 2t + 1 of
// each n8 tile); Y's rows 0 .. 8 SN - 1 raw at y, B read in that order
// (rows 2t and 2t + 1 of each k8 step, column g).
template <int D, int SN>
__device__ __forceinline__ void xb(const float (&x)[SN][4], const float* y,
                                   float (&acc)[D / 8][4]) {
  constexpr int LD = D + 4, NT = D / 8, NG = group4(NT);
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < SN; ++j) {
    uint32_t xh[4], xl[4];
    split(x[j][0], xh[0], xl[0]);  // row g,     column 2t
    split(x[j][2], xh[1], xl[1]);  // row g + 8, column 2t
    split(x[j][1], xh[2], xl[2]);  // row g,     column 2t + 1
    split(x[j][3], xh[3], xl[3]);  // row g + 8, column 2t + 1
    const float* yr = y + (j * 8 + 2 * t) * LD + g;
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += NG) {
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        split(yr[(n0 + n) * 8], bh[n][0], bl[n][0]);
        split(yr[LD + (n0 + n) * 8], bh[n][1], bl[n][1]);
      }
#pragma unroll
      for (int n = 0; n < NG; ++n) mma1688(acc[n0 + n], xl, bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < NG; ++n) mma1688(acc[n0 + n], xh, bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < NG; ++n) mma1688(acc[n0 + n], xh, bh[n][0], bh[n][1]);
    }
  }
}

// The dQ kernel's block: WQ x CS warps over BQ = 16 WQ query rows; warp
// (wm, wc) owns rows 16 wm .. 16 wm + 15 and, of each stage of BK keys,
// the wc-th CK = BK / CS.
template <int D, int WQ>
struct DqCfg {
  static_assert(D % 8 == 0, "tiles are cut into 8 x 8 blocks");
  static constexpr int LD = D + 4;
  static constexpr int BQ = 16 * WQ;
  static constexpr int THREADS = 32 * WQ * CS;
  static constexpr int CK = BK / CS;      // keys a warp takes of a stage
  static_assert(CK % 8 == 0, "a warp takes whole n8 tiles of keys");
  static constexpr int QTILE = BQ * LD;   // floats of Q's (or dO's) hi
  static constexpr int KVTILE = BK * LD;  // floats of one K or V stage
  // Q and dO, each split (hi, lo); then K and V, double-buffered
  static constexpr size_t SMEM =
      sizeof(float) * (4 * (size_t)QTILE + 4 * (size_t)KVTILE);
  static_assert((CS - 1) * WQ * 16 * D <= 4 * (QTILE + KVTILE),
                "the column split's partials reuse the tiles");
};

// The dK/dV kernel's block: WK x CS warps over BKV = 16 WK keys; warp
// (wk, wc) owns keys 16 wk .. 16 wk + 15 and, of each stage of BQ
// queries, the wc-th CQ = BQ / CS.
template <int D, int WK>
struct DkdvCfg {
  static_assert(D % 8 == 0, "tiles are cut into 8 x 8 blocks");
  static constexpr int LD = D + 4;
  static constexpr int BKV = 16 * WK;
  static constexpr int THREADS = 32 * WK * CS;
  static constexpr int CQ = BQ / CS;      // queries a warp takes of a stage
  static_assert(CQ % 8 == 0, "a warp takes whole n8 tiles of queries");
  static_assert(BKV % BQ == 0, "a causal walk starts on a query stage");
  static constexpr int KTILE = BKV * LD;  // floats of K's (or V's) hi
  static constexpr int QTILE = BQ * LD;   // floats of one Q or dO stage
  // K and V, each split (hi, lo); Q and dO stages double-buffered; each
  // stage's lse and delta
  static constexpr size_t SMEM =
      sizeof(float) * (4 * (size_t)KTILE + 4 * (size_t)QTILE + 4 * BQ);
  static_assert((CS - 1) * WK * 16 * D <= 4 * (KTILE + QTILE),
                "the column split's partials reuse the tiles");
};

// The column split's merge: warps wc = 1, 2, ... leave their n accumulator
// tiles (a warp's 16 rows by 8 n columns) in `buf`, and warp wc = 0 of the
// same rows adds them in that order, so the sum is the same from run to
// run.  Every warp of the block calls it; warps wc > 0 are done after it.
template <int NTILES, int W>
__device__ __forceinline__ void merge_columns(float (&acc)[NTILES][4],
                                              float* buf, int wr, int wc) {
  constexpr int F = NTILES * 8 * 16;  // floats a warp leaves
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  __syncthreads();  // every warp is done with the tiles `buf` overlays
  if (wc > 0) {
    float* p = buf + ((wc - 1) * W + wr) * F;
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
      *reinterpret_cast<float2*>(p + g * NTILES * 8 + n * 8 + 2 * t) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(p + (g + 8) * NTILES * 8 + n * 8 + 2 * t) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();
  if (wc > 0) return;
  for (int w = 1; w < CS; ++w) {
    const float* p = buf + ((w - 1) * W + wr) * F;
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
      const float2 x =
          *reinterpret_cast<const float2*>(p + g * NTILES * 8 + n * 8 + 2 * t);
      const float2 y = *reinterpret_cast<const float2*>(
          p + (g + 8) * NTILES * 8 + n * 8 + 2 * t);
      acc[n][0] += x.x;
      acc[n][1] += x.y;
      acc[n][2] += y.x;
      acc[n][3] += y.y;
    }
  }
}

template <int D, int WQ>
__global__ void __launch_bounds__(DqCfg<D, WQ>::THREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int S, int Tk, int group,
                    float scale, int causal) {
  using C = DqCfg<D, WQ>;
  constexpr int LD = C::LD, BQR = C::BQ, THREADS = C::THREADS, NT = D / 8;
  constexpr int CK = C::CK, SN = CK / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [BQR][LD]: Q; split: hi, then lo
  float* ds = smem + 2 * C::QTILE;     // [BQR][LD]: dO; split likewise
  float* kbuf = smem + 4 * C::QTILE;   // [2][BK][LD]
  float* vbuf = kbuf + 2 * C::KVTILE;  // [2][BK][LD]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQR;  // heaviest tiles first
  const size_t qoff = (size_t)bh * S * D;
  const float* kb = k + (size_t)(bh / group) * Tk * D;
  const float* vb = v + (size_t)(bh / group) * Tk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % WQ, wc = warp / WQ;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wm * 16;                        // the warp's rows in the tile
  const int first = q0 + r0, last = first + 15;  // and their positions
  const int row_lo = first + g, row_hi = row_lo + 8;
  const int k_end = causal ? min(Tk, q0 + BQR) : Tk;
  const int n_stages = (k_end + BK - 1) / BK;

  stage<D, BQR, THREADS>(qs, q + qoff, q0, S);
  stage<D, BQR, THREADS>(ds, dout + qoff, q0, S);
  stage<D, BK, THREADS>(kbuf, kb, 0, Tk);
  stage<D, BK, THREADS>(vbuf, vb, 0, Tk);
  cp_async_commit();

  // delta = rowsum(dO o O) of the thread's two rows (columns 8c + 2t, +1,
  // then the quad's sum), written once for the dK/dV kernel
  float d_lo = 0.f, d_hi = 0.f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = c * 8 + 2 * t;
    if (row_lo < S) {
      const size_t at = qoff + (size_t)row_lo * D + col;
      const float2 a = *reinterpret_cast<const float2*>(dout + at);
      const float2 b = *reinterpret_cast<const float2*>(o + at);
      d_lo = fmaf(a.x, b.x, fmaf(a.y, b.y, d_lo));
    }
    if (row_hi < S) {
      const size_t at = qoff + (size_t)row_hi * D + col;
      const float2 a = *reinterpret_cast<const float2*>(dout + at);
      const float2 b = *reinterpret_cast<const float2*>(o + at);
      d_hi = fmaf(a.x, b.x, fmaf(a.y, b.y, d_hi));
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    d_lo += __shfl_xor_sync(0xffffffffu, d_lo, off);
    d_hi += __shfl_xor_sync(0xffffffffu, d_hi, off);
  }
  if (t == 0 && wc == 0) {
    if (row_lo < S) delta[(size_t)bh * S + row_lo] = d_lo;
    if (row_hi < S) delta[(size_t)bh * S + row_hi] = d_hi;
  }
  const float l_lo = row_lo < S ? lse[(size_t)bh * S + row_lo] : 0.f;
  const float l_hi = row_hi < S ? lse[(size_t)bh * S + row_hi] : 0.f;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_stages; ++it) {
    cp_async_wait();
    __syncthreads();  // stage `it` landed; every warp is done with it - 1
    if (it + 1 < n_stages) {
      const int nb = (it + 1) & 1;
      stage<D, BK, THREADS>(kbuf + nb * C::KVTILE, kb, (it + 1) * BK, Tk);
      stage<D, BK, THREADS>(vbuf + nb * C::KVTILE, vb, (it + 1) * BK, Tk);
    }
    cp_async_commit();
    if (it == 0) {
      split_tile<D, BQR, THREADS>(qs, C::QTILE);
      split_tile<D, BQR, THREADS>(ds, C::QTILE);
      __syncthreads();
    }
    const int k0 = it * BK + wc * CK;  // the warp's first key this stage
    if (first >= S || k0 >= k_end || (causal && k0 > last)) continue;
    const float* kt = kbuf + (it & 1) * C::KVTILE + wc * CK * LD;
    const float* vt = vbuf + (it & 1) * C::KVTILE + wc * CK * LD;

    float s[SN][4], dp[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    abt<D, SN>(qs + r0 * LD, C::QTILE, kt, s);   // S = Q K^T
    abt<D, SN>(ds + r0 * LD, C::QTILE, vt, dp);  // dP = dO V^T
    // dS = P o (dP - delta); mask only the keys that reach past T or the
    // warp's diagonal
    const bool edge = k0 + CK > Tk || (causal && k0 + CK - 1 > first);
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? row_lo : row_hi;
        float p = expf(fmaf(s[n][e], scale, -(e < 2 ? l_lo : l_hi)));
        if (edge && (key >= Tk || (causal && key > row))) p = 0.f;
        s[n][e] = p * (dp[n][e] - (e < 2 ? d_lo : d_hi));
      }
    xb<D, SN>(s, kt, acc);  // dQ += dS K
  }
  cp_async_wait();
  merge_columns<NT, WQ>(acc, smem, wm, wc);
  if (wc > 0) return;

  float* qb = dq + qoff;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (row_lo < S)
      *reinterpret_cast<float2*>(qb + (size_t)row_lo * D + col) =
          make_float2(acc[n][0] * scale, acc[n][1] * scale);
    if (row_hi < S)
      *reinterpret_cast<float2*>(qb + (size_t)row_hi * D + col) =
          make_float2(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D, int WK>
__global__ void __launch_bounds__(DkdvCfg<D, WK>::THREADS)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ part, int S,
                      int Tk, int group, float scale, int causal, int L) {
  using C = DkdvCfg<D, WK>;
  constexpr int LD = C::LD, BKV = C::BKV, THREADS = C::THREADS, NT = D / 8;
  constexpr int CQ = C::CQ, SN = CQ / 8;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [BKV][LD]: K; split: hi, then lo
  float* vs = smem + 2 * C::KTILE;    // [BKV][LD]: V; split likewise
  float* qbuf = smem + 4 * C::KTILE;  // [2][BQ][LD]
  float* dbuf = qbuf + 2 * C::QTILE;  // [2][BQ][LD]
  float* ls = dbuf + 2 * C::QTILE;    // [2][BQ]: lse
  float* dl = ls + 2 * BQ;            // [2][BQ]: delta

  // blockIdx.x enumerates the segments of key blocks 0, 1, ... in order
  const int hk = blockIdx.y;
  int j = 0, seg = blockIdx.x, n_seg;
  while (seg >= (n_seg = segments(j, BKV, S, group, causal, L))) {
    seg -= n_seg;
    ++j;
  }
  const int k0 = j * BKV;
  const int q_begin = causal ? k0 : 0;
  const int n_q = walk(j, BKV, S, group, causal) / group;
  const int it0 = seg * L;
  const int it1 = min(group * n_q, it0 + L);
  const size_t kvoff = (size_t)hk * Tk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = warp % WK, wc = warp / WK;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wk * 16;                  // the warp's keys in the block
  const int first = k0 + r0, last = first + 15;
  const int key_lo = first + g, key_hi = key_lo + 8;

  // step `it` of the walk: q head it / n_q of the group, query stage
  // it % n_q from q_begin
  auto stage_q = [&](int it, int buf) {
    const int bh = hk * group + it / n_q;
    const int q0 = q_begin + it % n_q * BQ;
    stage<D, BQ, THREADS>(qbuf + buf * C::QTILE, q + (size_t)bh * S * D, q0,
                          S);
    stage<D, BQ, THREADS>(dbuf + buf * C::QTILE, dout + (size_t)bh * S * D,
                          q0, S);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const bool ok = q0 + r < S;
      ls[buf * BQ + r] = ok ? lse[(size_t)bh * S + q0 + r] : 0.f;
      dl[buf * BQ + r] = ok ? delta[(size_t)bh * S + q0 + r] : 0.f;
    }
  };

  stage<D, BKV, THREADS>(ks, k + kvoff, k0, Tk);
  stage<D, BKV, THREADS>(vs, v + kvoff, k0, Tk);
  if (it0 < it1) stage_q(it0, 0);
  cp_async_commit();

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = it0; it < it1; ++it) {
    cp_async_wait();
    __syncthreads();  // step `it` landed; every warp is done with it - 1
    const int buf = (it - it0) & 1;
    if (it + 1 < it1) stage_q(it + 1, buf ^ 1);
    cp_async_commit();
    if (it == it0) {
      split_tile<D, BKV, THREADS>(ks, C::KTILE);
      split_tile<D, BKV, THREADS>(vs, C::KTILE);
      __syncthreads();
    }
    const int q0 = q_begin + it % n_q * BQ + wc * CQ;  // the warp's queries
    // under `causal` a warp whose keys all follow its queries sees none
    if (first >= Tk || q0 >= S || (causal && first > q0 + CQ - 1)) continue;
    const float* qt = qbuf + buf * C::QTILE + wc * CQ * LD;
    const float* dt = dbuf + buf * C::QTILE + wc * CQ * LD;
    const float* lt = ls + buf * BQ + wc * CQ;
    const float* et = dl + buf * BQ + wc * CQ;

    // S^T = K Q^T and dP^T = V dO^T: rows the warp's keys, columns its
    // queries, two independent products side by side
    float p[SN][4], ds[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = ds[n][e] = 0.f;
    abt<D, SN>(ks + r0 * LD, C::KTILE, qt, p);
    abt<D, SN>(vs + r0 * LD, C::KTILE, dt, ds);
    // P^T = exp(scale S^T - lse), dS^T = P^T o (dP^T - delta); mask only
    // where the queries reach past S or the keys cross the diagonal
    const bool edge = q0 + CQ > S || (causal && last > q0);
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        const int key = e < 2 ? key_lo : key_hi;
        float x = expf(fmaf(p[n][e], scale, -lt[c]));
        if (edge && (q0 + c >= S || (causal && key > q0 + c))) x = 0.f;
        p[n][e] = x;
        ds[n][e] = x * (ds[n][e] - et[c]);
      }
    xb<D, SN>(p, dt, dva);  // dV += P^T dO
    xb<D, SN>(ds, qt, dka);  // dK += dS^T Q
  }
  cp_async_wait();
  merge_columns<NT, WK>(dka, smem, wk, wc);
  merge_columns<NT, WK>(dva, smem, wk, wc);
  if (wc > 0) return;

  if (n_seg == 1) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t;
      if (key_lo < Tk) {
        const size_t at = kvoff + (size_t)key_lo * D + col;
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(dka[n][0] * scale, dka[n][1] * scale);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(dva[n][0], dva[n][1]);
      }
      if (key_hi < Tk) {
        const size_t at = kvoff + (size_t)key_hi * D + col;
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(dka[n][2] * scale, dka[n][3] * scale);
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(dva[n][2], dva[n][3]);
      }
    }
    return;
  }
  // the segment's sums, unscaled, into its slot: [dK | dV] of [BKV][D]
  float* pk = part + ((size_t)hk * gridDim.x + blockIdx.x) * 2 * BKV * D;
  float* pv = pk + BKV * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int lo = (r0 + g) * D + n * 8 + 2 * t, hi = lo + 8 * D;
    *reinterpret_cast<float2*>(pk + lo) = make_float2(dka[n][0], dka[n][1]);
    *reinterpret_cast<float2*>(pk + hi) = make_float2(dka[n][2], dka[n][3]);
    *reinterpret_cast<float2*>(pv + lo) = make_float2(dva[n][0], dva[n][1]);
    *reinterpret_cast<float2*>(pv + hi) = make_float2(dva[n][2], dva[n][3]);
  }
}

// The second pass: for each key block walked by several segments, dk =
// scale * (part_0 + part_1 + ...) and dv = part_0 + part_1 + ..., one f32
// add each in segment order; a thread owns 4 neighbouring floats and loads
// 4 segments ahead before it adds them.  Blocks of key blocks that one
// segment walked return at once.  Bound by bytes: every partial read once.
template <int D, int BKV>
__global__ void __launch_bounds__(SUM_THREADS)
flash_bwd_dkdv_sum_kernel(const float* __restrict__ part,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int S, int Tk, int group, float scale, int causal,
                          int L, int slots) {
  constexpr int N4 = 2 * BKV * D / 4, U = 4;
  const int j = blockIdx.x, hk = blockIdx.y;
  int seg0 = 0;
  for (int i = 0; i < j; ++i) seg0 += segments(i, BKV, S, group, causal, L);
  const int n_seg = segments(j, BKV, S, group, causal, L);
  if (n_seg == 1) return;
  const float4* p = reinterpret_cast<const float4*>(part) +
                    ((size_t)hk * slots + seg0) * N4;
  for (int e = threadIdx.x; e < N4; e += SUM_THREADS) {
    float4 acc = p[e];
    for (int s = 1; s < n_seg; s += U) {
      float4 b[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (s + u < n_seg) b[u] = p[(size_t)(s + u) * N4 + e];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (s + u < n_seg) {
          acc.x += b[u].x;
          acc.y += b[u].y;
          acc.z += b[u].z;
          acc.w += b[u].w;
        }
    }
    const int at = e * 4, half = at / (BKV * D);
    const int key = j * BKV + at % (BKV * D) / D;
    if (key >= Tk) continue;
    const float m = half ? 1.f : scale;
    *reinterpret_cast<float4*>((half ? dv : dk) + ((size_t)hk * Tk + key) * D +
                               at % D) =
        make_float4(acc.x * m, acc.y * m, acc.z * m, acc.w * m);
  }
}

// The split walk's layout for bkv keys a block: its blocks per kv head
// (every key block's segments) and whether any key block has more than one.
inline long long split_slots(int bkv, int S, int Tk, int group, int causal,
                             bool* split) {
  const int L = seg_stages(S, group);
  long long slots = 0;
  *split = false;
  for (int j = 0; j < (Tk + bkv - 1) / bkv; ++j) {
    const int n = segments(j, bkv, S, group, causal, L);
    slots += n;
    *split = *split || n > 1;
  }
  return slots;
}

// `part`: f32 scratch of part_floats = BHkv * (the segments of every key
// block) * 2 * BKV * D where some key block has more than one segment,
// else 0 (kernels/flash_attention.dkdv_partials); any other size refuses.
template <int D, int W>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, void* dq, void* dk,
                   void* dv, float* delta, float* part, long long part_floats,
                   int BH, int BHkv, int S, int Tk, float scale, int causal,
                   cudaStream_t stream) {
  using CQ = DqCfg<D, W>;
  using CK = DkdvCfg<D, W>;
  const int group = BH / BHkv;
  const int n_tiles = (S + CQ::BQ - 1) / CQ::BQ;
  const int L = seg_stages(S, group);
  const int n_kb = (Tk + CK::BKV - 1) / CK::BKV;
  bool split;
  const long long slots = split_slots(CK::BKV, S, Tk, group, causal, &split);
  const long long need = split ? BHkv * slots * 2 * CK::BKV * D : 0;
  if (n_tiles > 65535 || BHkv > 65535 || slots > 0x7fffffff ||
      part_floats != need || (need > 0 && part == nullptr))
    return cudaErrorInvalidValue;
  if (CQ::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CQ::SMEM);
    if (e != cudaSuccess) return e;
  }
  if (CK::SMEM > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)CK::SMEM);
    if (e != cudaSuccess) return e;
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  flash_bwd_dq_kernel<D, W><<<dim3(BH, n_tiles), CQ::THREADS, CQ::SMEM,
                              stream>>>(
      qf, kf, vf, static_cast<const float*>(o), df, lse, delta,
      static_cast<float*>(dq), S, Tk, group, scale, causal);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flash_bwd_dkdv_kernel<D, W><<<dim3((unsigned)slots, BHkv), CK::THREADS,
                                CK::SMEM, stream>>>(
      qf, kf, vf, df, lse, delta, dkf, dvf, part, S, Tk, group, scale, causal,
      L);
  e = cudaGetLastError();
  if (e != cudaSuccess || !split) return e;
  flash_bwd_dkdv_sum_kernel<D, CK::BKV><<<dim3(n_kb, BHkv), SUM_THREADS, 0,
                                          stream>>>(
      part, dkf, dvf, S, Tk, group, scale, causal, L, (int)slots);
  return cudaGetLastError();
}

// The block per head dim: launch<D, W>, W x CS warps in each kernel over
// 16 W query rows (dQ) or keys (dK/dV) (kernels/flash_attention.
// BWD_F32_BLOCK repeats 16 W), chosen on the H100 by a sweep of W in 2, 4
// and CS in 1, 2, 4 for each kernel at train_lm's shape (D = 64) and the
// training shape (D = 128) (PERF.md §6 row 5i).  D <= 64: W = 2, so
// train_lm's shape (q (32, 256, 64), 8 query tiles a head) gives the dQ
// kernel 256 blocks and the dK/dV kernel 320, three blocks an SM.  D = 112
// and 128: W = 4 (203 KB of shared memory at D = 128, one block of 8 warps
// an SM): each staged tile serves 64 rows.
cudaError_t bwd_dispatch(int D, const void* q, const void* k, const void* v,
                         const void* o, const float* lse, const void* dout,
                         void* dq, void* dk, void* dv, float* delta,
                         float* part, long long part_floats, int BH, int BHkv,
                         int S, int Tk, float scale, int causal,
                         cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, 2>(q, k, v, o, lse, dout, dq, dk, dv, delta, part, part_floats, BH, BHkv, S, Tk, scale, causal, stream);
    case 32: return launch<32, 2>(q, k, v, o, lse, dout, dq, dk, dv, delta, part, part_floats, BH, BHkv, S, Tk, scale, causal, stream);
    case 64: return launch<64, 2>(q, k, v, o, lse, dout, dq, dk, dv, delta, part, part_floats, BH, BHkv, S, Tk, scale, causal, stream);
    case 112: return launch<112, 4>(q, k, v, o, lse, dout, dq, dk, dv, delta, part, part_floats, BH, BHkv, S, Tk, scale, causal, stream);
    case 128: return launch<128, 4>(q, k, v, o, lse, dout, dq, dk, dv, delta, part, part_floats, BH, BHkv, S, Tk, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd

}  // namespace

extern "C" {

// dtype: 0 float32 (flash_fwd_kernel), 1 bfloat16 (flash_fwd_bf16_kernel).
// lse: null, or f32 [BH, S] for each row's natural-log log-sum-exp of the
// scaled, masked scores (what the backward reads).  Returns the launch's
// cudaError_t (0 = launched); cudaErrorInvalidValue for a head dim, shape or
// alignment it does not take.
int flash_attention_fwd_launch(int dtype, const void* q, const void* k,
                               const void* v, void* o, void* lse, int BH,
                               int BHkv, int S, int Tk, int D, float scale,
                               int causal, void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || S <= 0 || Tk <= 0 ||
      BH > 65535)
    return (int)cudaErrorInvalidValue;
  // both kernels copy 16-byte rows by cp.async: every operand must start
  // 16-aligned
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) %
      16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)f32::dispatch(D, q, k, v, o, static_cast<float*>(lse), BH,
                              BHkv, S, Tk, scale, causal, s);
  if (dtype == 1)
    return (int)tc::dispatch(D, q, k, v, o, static_cast<float*>(lse), BH,
                             BHkv, S, Tk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: dq [BH, S, D] and dk, dv [BHkv, Tk, D] of the forward's o
// for the cotangent dout [BH, S, D], from q, k, v, o and the forward's lse
// (f32 [BH, S]); delta is f32 [BH, S] scratch.  dtype 0 float32
// (flash_bwd_dq_kernel, flash_bwd_dkdv_kernel and, where the dK/dV walk is
// split, flash_bwd_dkdv_sum_kernel over `part`, f32 scratch of part_floats
// floats: kernels/flash_attention.dkdv_partials, any other size refuses),
// 1 bfloat16 (flash_bwd_dq_bf16_kernel, flash_bwd_dkdv_bf16_kernel and,
// where split, flash_bwd_dkdv_sum_bf16_kernel over `part`:
// kernels/flash_attention.dkdv_partials_bf16, any other size refuses);
// launches on `stream`, the dQ kernel first.  Returns the first failed
// launch's cudaError_t, else 0.
int flash_attention_bwd_launch(int dtype, const void* q, const void* k,
                               const void* v, const void* o, const void* lse,
                               const void* dout, void* dq, void* dk, void* dv,
                               void* delta, void* part, long long part_floats,
                               int BH, int BHkv, int S, int Tk, int D,
                               float scale, int causal, void* stream) {
  if (BH <= 0 || BHkv <= 0 || BH % BHkv != 0 || S <= 0 || Tk <= 0 ||
      BH > 65535)
    return (int)cudaErrorInvalidValue;
  // cp.async, the float2 / float4 and bf16x2 accesses take 16-byte rows
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv) |
       reinterpret_cast<uintptr_t>(part)) %
      16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)bwd::bwd_dispatch(D, q, k, v, o, ls, dout, dq, dk, dv, dl,
                                  static_cast<float*>(part), part_floats, BH,
                                  BHkv, S, Tk, scale, causal, s);
  if (dtype == 1)
    return (int)tc::bwd_dispatch(D, q, k, v, o, ls, dout, dq, dk, dv, dl,
                                 static_cast<float*>(part), part_floats, BH,
                                 BHkv, S, Tk, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
