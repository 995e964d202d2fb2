// Fused multi-head attention for the ViT encoder, forward (K1) and
// backward (K2), and the forward's two softmax variants (K4), hand-written
// for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas kernels cosa_tpu/kernels/flash.py:
//   _fwd_kernel (via _attend_fwd / mha)  ->  attn_fwd_kernel<NWG, EXACT>
//   _bwd_kernel (via _attend_bwd)        ->  attn_bwd_pre_kernel +
//                                            attn_bwd_delta_kernel +
//                                            attn_bwd_kernel +
//                                            attn_bwd_post_kernel
// and scripts/microbench_softmax.py's attend_variant (Pallas body
// _fwd_variant) -> attn_fwd_kernel<NWG, BF16EXP | NOMAX>: K1's mainloop,
// ring, products and epilogue, with only the softmax swapped:
//
//   BF16EXP  p = exp2 of the bf16 rounding of (s * qscale - m), evaluated
//            on bf16 pairs by the PTX instruction ex2.approx.ftz.bf16x2
//            (cuda_bf16.h's h2exp2 in CUDA 12.8 unpacks the pair and runs
//            two f32 ex2.approx instead). The pairs are one row's
//            neighbouring keys, so the results are the PV product's
//            register A operand as they are. The row sum l is an f32 sum of
//            the bf16 p values, taken as the TPU kernel takes it: a product
//            against a column of ones with f32 accumulation, one wgmma
//            m64n8k16 per 16 keys on the same A registers (8 tensor-core
//            instructions per tile, where unpacking and adding in f32 takes
//            two ALU instructions per score). The running max and the
//            rescale of o and l stay in f32. sm_90 still issues one MUFU per
//            element of the pair (64 MUFU.EX2.BF16 per tile, as many as
//            EXACT's MUFU.EX2). At 128 queries per block, under the
//            128-register cap of two blocks per SM, this mode spills 84
//            bytes (ptxas -v).
//   NOMAX    p = exp2(s * qscale - 30) in f32: a fixed shift in place of
//            the row max, no max pass and no rescale. l is the f32 sum of
//            the f32 p; p is rounded to bf16 for the PV product. As in the
//            TPU kernel there is no guard: p overflows f32 where s (in log2
//            units) exceeds 30 + 128 = 158, i.e. a raw logit scale * q.k
//            above about 109.5 ("|s| > ~120" in the JAX script's
//            docstring), and a row whose every score lies below 30 - 149
//            sums to 0 and divides by it.
//
// Neither variant writes the log-sum-exp (they have no backward). Keys at
// or past n_valid and the ragged N edge are masked as in K1; the JAX
// variant needs its caller to pad N to a multiple of 128, the port does not.
//
// What it computes, per (batch, head): o = softmax(scale * q k^T) v over the
// keys below n_valid, with scores in f32 and the softmax on exp2, bf16
// probabilities into the PV product with f32 accumulation, and the division
// by the row sum at the end (as the TPU kernel does). One difference: the
// TPU kernel rounds q * scale * log2(e) to bf16 before the product; here the
// raw bf16 q enters the product and the f32 scores take the factor inside
// exp2's argument (one FMA per score), so they carry no rounding of the
// scale. The forward also stores the per-row log-sum-exp (base 2) so the
// backward recomputes the probabilities without a second max pass. The
// backward rounds dS to bf16 before the dq and dk products, as the TPU
// kernel does, but forms dS = P (dP - delta) from the f32 P, with delta =
// rowsum(P * dP) summed over the same f32 P, where the TPU kernel takes
// the bf16 P and delta = rowsum(dO * O) of the bf16 output O. The sum of dS
// over a query's keys is then zero to f32 rounding, as it is in exact
// arithmetic: with the TPU's form it is not, and dq = dS K takes that
// residue times the attention-weighted mean key. Where keys and values
// share a large mean, as they do in a trained ViT, that term dominated dq
// (relative error against float64 up to 0.14 at the states of a ShapesWSSS
// training run on an H100, where the plain bf16 path reads up to 0.03;
// cli/audit_attention.py).
//
// Layouts: qkv is the raw (B, N, 3, H, 64) bf16 projection (no fold copies);
// o and dO are (B, N, H, 64) bf16; lse and delta are (B, H, N) f32; the
// gradient dqkv is written straight into the (B, N, 3, H, 64) layout; dq is
// summed in an int64 scratch (B, N, H, 64) that the wrapper allocates.
//
// What bounds it on the H100. At CoSA's shapes (N = 197 / 442 / 785 / 1226
// / 1765, head dim 64) attention is bound by the tensor-core work of the
// N x N x 64 products (2 forward, 5 backward) and the exp2 over the N x N
// scores; q, k, v and o are read or written once and are small (only at
// N = 197 and 442 do the bytes weigh more than the operations). So both
// kernels are built to keep the tensor cores fed:
//
//  * wgmma. Every product is a warpgroup wgmma (m64nNk16, bf16 in, f32
//    accumulators in registers), the only path to the card's full bf16
//    rate. Each warpgroup owns 64 rows (queries in K1, keys in K2).
//    Operands from shared memory use the 128-byte swizzle, one layout that
//    wgmma reads both K-major and, with its transpose flag, MN-major: V in
//    the forward and q, dO, dS^T and k in the backward are the transposed
//    operands, and none of them is copied into a [d][row] tile. The P and
//    dS operands of the PV, dV and dK products are the score accumulators
//    repacked in registers (wgmma's register A). No product is left on
//    mma.sync, so no fragment is loaded by ldmatrix.
//  * An asynchronous copy ring. K/V tiles (forward) and q/dO/lse/delta
//    tiles (backward) stream through a 2-stage ring in dynamic shared
//    memory by cp.async.cg 16-byte copies, so tile j+1 is in flight while
//    tile j is multiplied. cp.async rather than TMA: each thread writes the
//    swizzled address itself, the ragged last tile is zero-filled by the
//    copy's src-size 0, and no tensor map (cuTensorMapEncodeTiled) has to
//    be encoded per call. Every thread issues copies and every thread
//    computes; there is no producer warp.
//  * Tiles. K1 takes 128-key tiles (two 64-key wgmma halves) and 64 or 128
//    queries per block (one or two warpgroups). The caller picks 64 up to
//    N = 1024 and 128 above (kernels/flash.py::block_rows): chip_smoke.py
//    times both at every shape the paths launch, and on an H100 SXM 64
//    read faster at N = 197 and 785 (within 1% at 442) and 128 at N = 1226
//    and 1765, at each B*H of 48 to 192. K4 runs at K1's block size for
//    the same N. K2 takes 128 keys per block (two warpgroups) and 64-query
//    tiles.
//  * The pipeline's prologue. The first tile's copy is not hidden: at
//    N = 197 a query row has 2 key tiles in K1 (K2: 4 query tiles), so the
//    copy of half (a quarter) of the data waits in the open; at N >= 785 it
//    is one tile in seven (thirteen) or fewer.
//
// The backward is one key-major pass with 5 products per tile: each block
// keeps its keys' dK and dV in registers and streams the query tiles:
//   S^T = K Q^T, P^T = exp2(S^T * c - lse), dV += P^T dO,
//   dP^T = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q,
//   dQ += dS K  (dS^T staged once in shared memory, read transposed).
// Before it, a pre-kernel zeroes the dq scratch and a query-major delta
// kernel computes delta = rowsum(P * dP) with 2 products per key tile (S =
// Q K^T and dP = dO V^T, both K-major); a post-kernel scales dq and writes
// it into qkv's layout as bf16.
// Determinism: the key blocks' shares of dq meet in the scratch in an
// order that varies from run to run. They are added as 64-bit fixed point
// with 44 fraction bits (one bulk reduce-add, cp.reduce.async.bulk .add.u64,
// per query row and warpgroup), and integer sums do not depend on their
// order, so K2 is bitwise deterministic. Each share is rounded to a
// multiple of 2^-44 (error at most 2.8e-14, under f32's own rounding of the
// sum wherever |dq| > 5e-7 before the scale); the sum must stay within
// +-2^19 (5.2e5), far above any dq of a training run (a share beyond it
// saturates in the conversion).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;          // head dim (the only one the kernels take)
constexpr int ROW = D * 2;     // bytes of one head's row, one swizzle row
constexpr int BKF = 128;       // forward: keys per ring stage
constexpr int BQB = 64;        // backward: queries per ring stage
constexpr int STAGES = 2;
constexpr float NEG = -1e30f;
// the forward's softmax: K1's, or one of K4's variants
constexpr int EXACT = 0, BF16EXP = 1, NOMAX = 2;
constexpr float NOMAX_SHIFT = 30.f;            // microbench_softmax.py:56
constexpr uint32_t BF16X2_ONES = 0x3F803F80u;  // two bf16 1.0
// dq's partial sums are added as 64-bit fixed point with 44 fraction bits:
// integer adds are associative, so the sum is the same in any order
constexpr float DQ_ONE = 17592186044416.f;        // 2^44
constexpr float DQ_INV = 5.684341886080802e-14f;  // 2^-44

// ------------------------------------------------------------- helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// exp2 of the bf16 roundings of (lo, hi), on bf16 pairs
__device__ __forceinline__ uint32_t exp2_bf16x2(float lo, float hi) {
  const uint32_t x = pack2(lo, hi);
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes (cp.async, st.shared) -> visible to wgmma and to
// the bulk copy engine
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// global[0 .. bytes) += shared[0 .. bytes), int64 elementwise, by the bulk
// copy engine (one instruction for the whole row)
__device__ __forceinline__ void bulk_add_u64(void* dst, uint32_t src,
                                             int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.u64 [%0], "
      "[%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk reductions have read their shared-memory source
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// barrier of one warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Copy ROWS rows of one head (128 B each) from the token-strided tensor
// `src` (row n at src + n * stride) into a 128B-swizzled tile at `dst`:
// 16-byte chunk c of row r lands at r * 128 + ((c ^ (r % 8)) * 16). Rows
// >= n_rows are zero-filled.
template <int ROWS, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          size_t stride, int row0,
                                          int n_rows) {
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * 8; c += NT) {
    const int r = c >> 3, ch = c & 7, n = row0 + r;
    const bool ok = n < n_rows;
    cp_async16(dst + r * ROW + ((ch ^ (r & 7)) << 4),
               src + (size_t)(ok ? n : 0) * stride + ch * 8, ok);
  }
}

// 64 f32 of a (B, H, N) row into shared memory; entries >= N are zero.
__device__ __forceinline__ void load_vec(uint32_t dst, const float* src,
                                         int n0, int N) {
  if (threadIdx.x < 64) {
    const int n = n0 + threadIdx.x;
    const bool ok = n < N;
    cp_async4(dst + threadIdx.x * 4, src + (ok ? n : 0), ok);
  }
}

// wgmma shared-memory descriptor of a 128B-swizzled tile: start address,
// leading offset, stride offset 1024 B (8 rows of 128 B), layout B128.
// K-major operands step along k by +32 B; MN-major ones by +16 rows.
// For MN-major tiles both offsets are the 8-row stride: with one 64-wide
// swizzle atom along MN only the stride between 8-row groups is read.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)64 << 16) |
         ((uint64_t)64 << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define R8(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float d[32], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32], both from shared memory.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss32(float d[16], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : R8(0), R8(8)
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d[64 x 64] += A[64 x 16] (registers, the mma.sync A-fragment layout per
// warp) B[16 x 64] from shared memory.
template <int TB>
__device__ __forceinline__ void wgmma_rs64(float d[32], const uint32_t a[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : R8(0), R8(8), R8(16), R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
}

// d[64 x 8] += A[64 x 16] (registers, as above) B[16 x 8] from shared memory.
__device__ __forceinline__ void wgmma_rs8(float d[4], const uint32_t a[4],
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef R8

// Accumulator layout of m64nN (per thread, i = 4 * j + e): row
// 16 * warp + g + 8 * (e >> 1), column 8 * j + 2 * t + (e & 1), where
// g = lane / 4, t = lane % 4. Columns 16 kc .. 16 kc + 15 of it, as the
// register A operand of the next product:
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float* s,
                                         int kc) {
  a[0] = pack2(s[8 * kc + 0], s[8 * kc + 1]);
  a[1] = pack2(s[8 * kc + 2], s[8 * kc + 3]);
  a[2] = pack2(s[8 * kc + 4], s[8 * kc + 5]);
  a[3] = pack2(s[8 * kc + 6], s[8 * kc + 7]);
}

__device__ __forceinline__ uint32_t align1k(uint32_t a) {
  return (a + 1023u) & ~1023u;
}

// ---------------------------------------------------------------- forward
// BF16EXP adds one 1 KB tile of bf16 ones: the B operand of l's product
// (wgmma reads 8 rows of 128 B from it; every element is 1, so the
// swizzle's order does not matter)
template <int NWG, int MODE>
struct FwdSmem {
  static constexpr int Q = NWG * 64 * ROW;
  static constexpr int KV = BKF * ROW;
  static constexpr int ONES = MODE == BF16EXP ? 1024 : 0;
  static constexpr int BYTES = Q + STAGES * 2 * KV + ONES + 1024;
};

// MODE: EXACT (K1, writes lse), BF16EXP or NOMAX (K4, lse unused)
template <int NWG, int MODE>
__global__ void __launch_bounds__(NWG * 128, NWG == 2 ? 2 : 3)
    attn_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                    float* __restrict__ lse, int N, int H, int n_valid,
                    float qscale) {
  constexpr int NT = NWG * 128;
  typedef FwdSmem<NWG, MODE> L;
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = align1k(smem_u32(smem));
  const uint32_t sK0 = sQ + L::Q, sV0 = sK0 + STAGES * L::KV;
  const uint32_t sOnes = sV0 + STAGES * L::KV;
  if constexpr (MODE == BF16EXP) {  // visible to wgmma after the loop's fence
    uint4* ones = reinterpret_cast<uint4*>(smem + (sOnes - smem_u32(smem)));
    for (int c = threadIdx.x; c < L::ONES / 16; c += NT)
      ones[c] = make_uint4(BF16X2_ONES, BF16X2_ONES, BF16X2_ONES, BF16X2_ONES);
  }

  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * NWG * 64;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t tok = (size_t)3 * H * D;  // qkv elements per token
  const bf16* qb = qkv + (size_t)b * N * tok + (size_t)h * D;
  const bf16* kb = qb + (size_t)H * D;
  const bf16* vb = qb + (size_t)2 * H * D;
  const int T = (n_valid + BKF - 1) / BKF;

  load_tile<NWG * 64, NT>(sQ, qb, tok, q0, N);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < T) {
      load_tile<BKF, NT>(sK0 + st * L::KV, kb, tok, st * BKF, N);
      load_tile<BKF, NT>(sV0 + st * L::KV, vb, tok, st * BKF, N);
    }
    cp_async_commit();
  }

  const uint32_t sQw = sQ + wg * 64 * ROW;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  // BF16EXP: l's accumulator of the ones product (m64n8: [0], [1] row g,
  // [2], [3] row g + 8, each the whole row's sum)
  float lacc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int j = 0; j < T; ++j) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    const int nj = j + STAGES - 1;
    if (nj < T) {
      const int sl = nj % STAGES;
      load_tile<BKF, NT>(sK0 + sl * L::KV, kb, tok, nj * BKF, N);
      load_tile<BKF, NT>(sV0 + sl * L::KV, vb, tok, nj * BKF, N);
    }
    cp_async_commit();
    const uint32_t sK = sK0 + (j % STAGES) * L::KV;
    const uint32_t sV = sV0 + (j % STAGES) * L::KV;

    // S = Q K^T, two 64-key halves
    float s[BKF / 64][32];
    wgmma_fence();
#pragma unroll
    for (int hf = 0; hf < BKF / 64; ++hf)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_ss64<0, 0>(s[hf], desc_k(sQw + 32 * k),
                         desc_k(sK + hf * 64 * ROW + 32 * k), k);
    wgmma_commit();
    wgmma_wait<0>();

    // online softmax in log2 units: the raw scores' row max, then
    // p = exp2(s * qscale - m) as one FMA per score (qscale > 0)
    const int k0 = j * BKF;
    const bool ragged = k0 + BKF > n_valid;
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int hf = 0; hf < BKF / 64; ++hf)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + hf * 64 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (ragged && key >= n_valid) s[hf][i] = NEG;
        if constexpr (MODE != NOMAX) {
          if (i & 2)
            mx1 = fmaxf(mx1, s[hf][i]);
          else
            mx0 = fmaxf(mx0, s[hf][i]);
        }
      }
    uint32_t pa[BKF / 16][4];  // P, the PV product's register A operand
    if constexpr (MODE == NOMAX) {
      // a fixed shift in place of the row max: no max pass, no rescale
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int hf = 0; hf < BKF / 64; ++hf)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[hf][i] = exp2f(fmaf(s[hf][i], qscale, -NOMAX_SHIFT));
          if (i & 2)
            rs1 += s[hf][i];
          else
            rs0 += s[hf][i];
        }
      l0 += rs0;
      l1 += rs1;
    } else {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      mx0 = fmaxf(m0, mx0 * qscale);
      mx1 = fmaxf(m1, mx1 * qscale);
      const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      if constexpr (MODE == EXACT) {
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int hf = 0; hf < BKF / 64; ++hf)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            if (i & 2) {
              s[hf][i] = exp2f(fmaf(s[hf][i], qscale, -m1));
              rs1 += s[hf][i];
            } else {
              s[hf][i] = exp2f(fmaf(s[hf][i], qscale, -m0));
              rs0 += s[hf][i];
            }
          }
        l0 = l0 * a0 + rs0;
        l1 = l1 * a1 + rs1;
      } else {
        // p on bf16 pairs of one row's neighbouring keys (acc_to_a's
        // pairs: a[e] holds row g + 8 * (e & 1)), straight into A
#pragma unroll
        for (int kk = 0; kk < BKF / 16; ++kk) {
          const float* sk = s[kk / 4] + 8 * (kk % 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float m = (e & 1) ? m1 : m0;
            pa[kk][e] = exp2_bf16x2(fmaf(sk[2 * e], qscale, -m),
                                    fmaf(sk[2 * e + 1], qscale, -m));
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) lacc[e] *= (e & 2) ? a1 : a0;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? a1 : a0;
    }

    // O += P V: P from registers, V read MN-major (transposed) in place;
    // BF16EXP also l += P 1 on the same registers
    if constexpr (MODE != BF16EXP) {
#pragma unroll
      for (int kk = 0; kk < BKF / 16; ++kk) acc_to_a(pa[kk], s[kk / 4], kk % 4);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKF / 16; ++kk)
      wgmma_rs64<1>(o, pa[kk], desc_mn(sV + kk * 16 * ROW));
    if constexpr (MODE == BF16EXP) {
#pragma unroll
      for (int kk = 0; kk < BKF / 16; ++kk)
        wgmma_rs8(lacc, pa[kk], desc_k(sOnes));
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();

  if constexpr (MODE == BF16EXP) {
    l0 = lacc[0];
    l1 = lacc[2];
  } else {
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int na = q0 + wg * 64 + w * 16 + g, nb = na + 8;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const int d = jn * 8 + 2 * t;
    if (na < N)
      *reinterpret_cast<uint32_t*>(out + ((size_t)(b * N + na) * H + h) * D +
                                   d) =
          pack2(o[4 * jn] * inv0, o[4 * jn + 1] * inv0);
    if (nb < N)
      *reinterpret_cast<uint32_t*>(out + ((size_t)(b * N + nb) * H + h) * D +
                                   d) =
          pack2(o[4 * jn + 2] * inv1, o[4 * jn + 3] * inv1);
  }
  if constexpr (MODE == EXACT) {
    if (t == 0) {
      if (na < N) lse[(size_t)bh * N + na] = m0 + log2f(l0);
      if (nb < N) lse[(size_t)bh * N + nb] = m1 + log2f(l1);
    }
  }
}

// ---------------------------------------- backward, pre-kernel: dq = 0
// One 8-element chunk of a (b, n, h) row of the scratch per thread.
__global__ void __launch_bounds__(256)
    attn_bwd_pre_kernel(long long* __restrict__ dq_acc, int rows) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = c >> 3, col = (c & 7) * 8;
  if (row >= rows) return;
  longlong4* acc = reinterpret_cast<longlong4*>(dq_acc + (size_t)row * D + col);
  acc[0] = make_longlong4(0, 0, 0, 0);
  acc[1] = make_longlong4(0, 0, 0, 0);
}

// ------------------------------- backward, delta kernel: rowsum(P * dP)
// One warpgroup per 64 queries streams the key and value tiles through
// K1's ring: S = Q K^T and dP = dO V^T (dO and V read K-major, as Q and K
// are), P = exp2(S * c - lse) in f32, delta += rowsum(P * dP) over the
// keys below n_valid. One 64-key half at a time keeps two accumulators.
struct DeltaSmem {
  static constexpr int Q = 64 * ROW;  // the query tile; dO's likewise
  static constexpr int KV = BKF * ROW;
  static constexpr int BYTES = 2 * Q + STAGES * 2 * KV + 1024;
};

__global__ void __launch_bounds__(128, 2)
    attn_bwd_delta_kernel(const bf16* __restrict__ qkv,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ delta, int N, int H,
                          int n_valid, float qscale) {
  constexpr int NT = 128;
  typedef DeltaSmem L;
  extern __shared__ uint8_t smem[];
  const uint32_t sQ = align1k(smem_u32(smem));
  const uint32_t sO = sQ + L::Q, sK0 = sO + L::Q, sV0 = sK0 + STAGES * L::KV;
  const int tid = threadIdx.x, w = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * 64;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t tok = (size_t)3 * H * D;
  const size_t otok = (size_t)H * D;
  const bf16* qb = qkv + (size_t)b * N * tok + (size_t)h * D;
  const bf16* kb = qb + (size_t)H * D;
  const bf16* vb = qb + (size_t)2 * H * D;
  const bf16* gb = dout + (size_t)b * N * otok + (size_t)h * D;
  const int T = (n_valid + BKF - 1) / BKF;

  load_tile<64, NT>(sQ, qb, tok, q0, N);
  load_tile<64, NT>(sO, gb, otok, q0, N);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < T) {
      load_tile<BKF, NT>(sK0 + st * L::KV, kb, tok, st * BKF, N);
      load_tile<BKF, NT>(sV0 + st * L::KV, vb, tok, st * BKF, N);
    }
    cp_async_commit();
  }
  const int na = q0 + w * 16 + g, nb = na + 8;
  const float l0 = na < N ? lse[(size_t)bh * N + na] : 0.f;
  const float l1 = nb < N ? lse[(size_t)bh * N + nb] : 0.f;
  float d0 = 0.f, d1 = 0.f;

  for (int j = 0; j < T; ++j) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    const int nj = j + STAGES - 1;
    if (nj < T) {
      const int sl = nj % STAGES;
      load_tile<BKF, NT>(sK0 + sl * L::KV, kb, tok, nj * BKF, N);
      load_tile<BKF, NT>(sV0 + sl * L::KV, vb, tok, nj * BKF, N);
    }
    cp_async_commit();
    const uint32_t sK = sK0 + (j % STAGES) * L::KV;
    const uint32_t sV = sV0 + (j % STAGES) * L::KV;
#pragma unroll
    for (int hf = 0; hf < BKF / 64; ++hf) {
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_ss64<0, 0>(s, desc_k(sQ + 32 * k), desc_k(sK + hf * 64 * ROW + 32 * k), k);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_ss64<0, 0>(dp, desc_k(sO + 32 * k), desc_k(sV + hf * 64 * ROW + 32 * k), k);
      wgmma_commit();
      wgmma_wait<0>();
      const int k0 = j * BKF + hf * 64;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        if (key < n_valid) {
          if (i & 2)
            d1 += exp2f(fmaf(s[i], qscale, -l1)) * dp[i];
          else
            d0 += exp2f(fmaf(s[i], qscale, -l0)) * dp[i];
        }
      }
    }
  }
  cp_async_wait<0>();
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  if (t == 0) {
    if (na < N) delta[(size_t)bh * N + na] = d0;
    if (nb < N) delta[(size_t)bh * N + nb] = d1;
  }
}

// ------------------------------ backward, post-kernel: dq -> bf16 slot 0
__global__ void __launch_bounds__(256)
    attn_bwd_post_kernel(const long long* __restrict__ dq_acc,
                         bf16* __restrict__ dqkv, int rows, int H,
                         float scale) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = c >> 3, col = (c & 7) * 8;
  if (row >= rows) return;
  const longlong4* a = reinterpret_cast<const longlong4*>(dq_acc + (size_t)row * D + col);
  const longlong4 x = a[0], y = a[1];
  const float f = scale * DQ_INV;
  uint4 v;
  v.x = pack2(__ll2float_rn(x.x) * f, __ll2float_rn(x.y) * f);
  v.y = pack2(__ll2float_rn(x.z) * f, __ll2float_rn(x.w) * f);
  v.z = pack2(__ll2float_rn(y.x) * f, __ll2float_rn(y.y) * f);
  v.w = pack2(__ll2float_rn(y.z) * f, __ll2float_rn(y.w) * f);
  const int tokn = row / H, h = row % H;
  *reinterpret_cast<uint4*>(dqkv + (size_t)tokn * 3 * H * D + (size_t)h * D + col) = v;
}

// --------------------------------- backward, main kernel: one key-major pass
constexpr int NWG_B = 2;  // backward: warpgroups per block, 64 keys each

struct BwdSmem {
  static constexpr int KT = NWG_B * 64 * ROW;  // sK, sV, sDS
  static constexpr int QT = BQB * ROW;        // one ring stage of q or dO
  static constexpr int VEC = BQB * 4;         // one stage of lse or delta
  static constexpr int DQROW = D * 8 + 16;    // int64 dq row, padded
  static constexpr int BYTES =
      3 * KT + STAGES * (2 * QT + 2 * VEC) + BQB * DQROW + 1024;
};

__global__ void __launch_bounds__(NWG_B * 128, 1)
    attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    long long* __restrict__ dq_acc, bf16* __restrict__ dqkv,
                    int N, int H, int n_valid,
                    float qscale, float scale) {
  constexpr int NWG = NWG_B, NT = NWG * 128;
  constexpr int NQ = 64 / NWG;  // dq columns (head dims) per warpgroup
  typedef BwdSmem L;
  extern __shared__ uint8_t smem[];
  const uint32_t base = align1k(smem_u32(smem));
  uint8_t* const gbase = smem + (base - smem_u32(smem));
  const uint32_t sK = base, sV = sK + L::KT, sDS = sV + L::KT;
  const uint32_t sQ0 = sDS + L::KT, sO0 = sQ0 + STAGES * L::QT;
  const uint32_t sL0 = sO0 + STAGES * L::QT, sD0 = sL0 + STAGES * L::VEC;
  const uint32_t sDQ = sD0 + STAGES * L::VEC;  // dq share of one query tile
  uint8_t* const gDQ = gbase + (sDQ - base);
  const float* gL0 = reinterpret_cast<const float*>(gbase + (sL0 - base));
  const float* gD0 = reinterpret_cast<const float*>(gbase + (sD0 - base));
  uint8_t* const gDS = gbase + (sDS - base);

  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * NWG * 64;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t tok = (size_t)3 * H * D;
  const size_t otok = (size_t)H * D;
  const bf16* qb = qkv + (size_t)b * N * tok + (size_t)h * D;
  const bf16* kb = qb + (size_t)H * D;
  const bf16* vb = qb + (size_t)2 * H * D;
  const bf16* gb = dout + (size_t)b * N * otok + (size_t)h * D;
  const float* lb = lse + (size_t)bh * N;
  const float* db = delta + (size_t)bh * N;
  bf16* const dkb = dqkv + (size_t)b * N * tok + (size_t)H * D + (size_t)h * D;

  if (k0 >= n_valid) {  // every key masked: dk = dv = 0
    for (int c = tid; c < NWG * 64 * 16; c += NT) {
      const int r = c >> 4, n = k0 + r, col = (c & 7) * 8;
      if (n < N)
        *reinterpret_cast<uint4*>(dkb + (size_t)n * tok + (c & 8 ? H * D : 0) +
                                  col) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const int Tq = (N + BQB - 1) / BQB;
  load_tile<NWG * 64, NT>(sK, kb, tok, k0, N);
  load_tile<NWG * 64, NT>(sV, vb, tok, k0, N);
  load_tile<BQB, NT>(sQ0, qb, tok, 0, N);
  load_tile<BQB, NT>(sO0, gb, otok, 0, N);
  load_vec(sL0, lb, 0, N);
  load_vec(sD0, db, 0, N);
  cp_async_commit();

  const int r0 = w * 16 + g;  // this thread's first key row in its warpgroup
  const bool ok0 = k0 + wg * 64 + r0 < n_valid;
  const bool ok1 = k0 + wg * 64 + r0 + 8 < n_valid;
  const uint32_t sKw = sK + wg * 64 * ROW, sVw = sV + wg * 64 * ROW;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  for (int it = 0; it < Tq; ++it) {
    cp_async_wait<0>();
    bulk_wait_read();
    fence_proxy_async();
    __syncthreads();  // tile it landed; sDS, sDQ and slot (it+1)%2 are free
    if (it + 1 < Tq) {
      const int sl = (it + 1) % STAGES, n0 = (it + 1) * BQB;
      load_tile<BQB, NT>(sQ0 + sl * L::QT, qb, tok, n0, N);
      load_tile<BQB, NT>(sO0 + sl * L::QT, gb, otok, n0, N);
      load_vec(sL0 + sl * L::VEC, lb, n0, N);
      load_vec(sD0 + sl * L::VEC, db, n0, N);
    }
    cp_async_commit();
    const int sl = it % STAGES, q0 = it * BQB;
    const uint32_t sQ = sQ0 + sl * L::QT, sO = sO0 + sl * L::QT;
    const float* sL = gL0 + sl * BQB;
    const float* sD = gD0 + sl * BQB;

    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss64<0, 0>(st, desc_k(sKw + 32 * k), desc_k(sQ + 32 * k), k);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss64<0, 0>(dpt, desc_k(sVw + 32 * k), desc_k(sO + 32 * k), k);
    wgmma_commit();
    wgmma_wait<0>();

    // P^T (f32; the dV product takes its bf16 rounding) and dS^T
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int c = 8 * jn + 2 * t;
      const float2 lq = *reinterpret_cast<const float2*>(sL + c);
      const float2 dq2 = *reinterpret_cast<const float2*>(sD + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jn + e;
        const float l = (e & 1) ? lq.y : lq.x, dl = (e & 1) ? dq2.y : dq2.x;
        const bool ok = (e & 2) ? ok1 : ok0;
        const float p = ok ? exp2f(fmaf(st[i], qscale, -l)) : 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - dl);
      }
    }
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      acc_to_a(pa[kc], st, kc);
      acc_to_a(sa[kc], dpt, kc);
    }
    // dS^T (bf16) into sDS[key][query], swizzled, for dQ += dS K. Written
    // before the dK product is issued: the registers of a wgmma's A
    // operand may not be read while it is in flight.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = wg * 64 + r0 + 8 * hi;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int ch = 2 * kc + half;  // 8-query chunk
          *reinterpret_cast<uint32_t*>(gDS + r * ROW + ((ch ^ (r & 7)) << 4) +
                                       4 * t) = sa[kc][2 * half + hi];
        }
      }
    fence_proxy_async();
    // dV += P^T dO, dK += dS^T Q: dO and Q read MN-major (transposed)
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs64<1>(dv, pa[kc], desc_mn(sO + kc * 16 * ROW));
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs64<1>(dk, sa[kc], desc_mn(sQ + kc * 16 * ROW));
    wgmma_commit();
    __syncthreads();  // both warpgroups' dS^T are in sDS

    // dQ[64 q x NQ d] = dS K over this block's keys: dS^T read MN-major
    // (transposed) as A, K read MN-major as B; warpgroup wg takes head
    // dims wg * NQ .. wg * NQ + NQ - 1
    float dq[NQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NWG * 4; ++kk)
      wgmma_ss32<1, 1>(dq, desc_mn(sDS + kk * 16 * ROW),
                       desc_mn(sK + kk * 16 * ROW + wg * NQ * 2), kk);
    wgmma_commit();
    wgmma_wait<0>();
    // this warpgroup's dq columns as int64 into sDQ, then one bulk
    // reduce-add per query row into the scratch
#pragma unroll
    for (int jn = 0; jn < NQ / 8; ++jn) {
      const int d = wg * NQ + 8 * jn + 2 * t;
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        *reinterpret_cast<longlong2*>(gDQ + (r0 + 8 * hi) * L::DQROW + d * 8) =
            make_longlong2(__float2ll_rn(dq[4 * jn + 2 * hi] * DQ_ONE),
                           __float2ll_rn(dq[4 * jn + 2 * hi + 1] * DQ_ONE));
    }
    fence_proxy_async();
    wg_sync(wg);
    const int lt = tid & 127, q = q0 + lt;
    if (lt < BQB && q < N) {
      bulk_add_u64(dq_acc + ((size_t)(b * N + q) * H + h) * D + wg * NQ,
                   sDQ + lt * L::DQROW + wg * NQ * 8, NQ * 8);
      bulk_commit();
    }
  }
  bulk_wait();

  const int na = k0 + wg * 64 + r0, nb = na + 8;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn) {
    const int d = jn * 8 + 2 * t;
    if (na < N) {
      bf16* row = dkb + (size_t)na * tok + d;
      *reinterpret_cast<uint32_t*>(row) = pack2(dk[4 * jn] * scale, dk[4 * jn + 1] * scale);
      *reinterpret_cast<uint32_t*>(row + H * D) = pack2(dv[4 * jn], dv[4 * jn + 1]);
    }
    if (nb < N) {
      bf16* row = dkb + (size_t)nb * tok + d;
      *reinterpret_cast<uint32_t*>(row) = pack2(dk[4 * jn + 2] * scale, dk[4 * jn + 3] * scale);
      *reinterpret_cast<uint32_t*>(row + H * D) = pack2(dv[4 * jn + 2], dv[4 * jn + 3]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int NWG, int MODE>
cudaError_t launch_fwd(const bf16* qkv, bf16* out, float* lse, int B, int N,
                       int H, int n_valid, float qscale, cudaStream_t stream) {
  typedef FwdSmem<NWG, MODE> L;
  static cudaError_t set = allow_smem(attn_fwd_kernel<NWG, MODE>, L::BYTES);
  if (set != cudaSuccess) return set;
  dim3 grid((N + NWG * 64 - 1) / (NWG * 64), B * H);
  attn_fwd_kernel<NWG, MODE><<<grid, NWG * 128, L::BYTES, stream>>>(
      qkv, out, lse, N, H, n_valid, qscale);
  return cudaGetLastError();
}

// block: queries per block, 64 or 128 (kernels/flash.py::block_rows)
template <int MODE>
int launch_fwd_rows(const void* qkv, void* out, void* lse, int B, int N,
                    int H, int n_valid, float scale, int block,
                    cudaStream_t stream) {
  const float qscale = scale * 1.4426950408889634f;
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* o = static_cast<bf16*>(out);
  float* l = static_cast<float*>(lse);
  if (block == 128)
    return (int)launch_fwd<2, MODE>(q, o, l, B, N, H, n_valid, qscale, stream);
  if (block == 64)
    return (int)launch_fwd<1, MODE>(q, o, l, B, N, H, n_valid, qscale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// qkv (B, N, 3, H, 64) bf16 -> out (B, N, H, 64) bf16, lse (B, H, N) f32.
int cosa_attn_fwd(const void* qkv, void* out, void* lse, int B, int N, int H,
                  int n_valid, float scale, int block, cudaStream_t stream) {
  return launch_fwd_rows<EXACT>(qkv, out, lse, B, N, H, n_valid, scale, block,
                                stream);
}

// K4: qkv (B, N, 3, H, 64) bf16 -> out (B, N, H, 64) bf16 with a softmax
// variant, mode 0 = bf16exp, 1 = nomax (kernels/flash_variants.py::MODES).
int cosa_attn_fwd_variant(const void* qkv, void* out, int B, int N, int H,
                          int n_valid, float scale, int mode, int block,
                          cudaStream_t stream) {
  if (mode == 0)
    return launch_fwd_rows<BF16EXP>(qkv, out, nullptr, B, N, H, n_valid, scale,
                                    block, stream);
  if (mode == 1)
    return launch_fwd_rows<NOMAX>(qkv, out, nullptr, B, N, H, n_valid, scale,
                                  block, stream);
  return (int)cudaErrorInvalidValue;
}

// Gradient of cosa_attn_fwd: dout (B, N, H, 64) -> dqkv (B, N, 3, H, 64).
// delta (B, H, N) f32 and dq_acc (B, N, H, 64) int64 are scratch.
int cosa_attn_bwd(const void* qkv, const void* dout, const void* lse,
                  void* delta, void* dq_acc, void* dqkv, int B, int N, int H,
                  int n_valid, float scale, cudaStream_t stream) {
  static const cudaError_t set = allow_smem(attn_bwd_kernel, BwdSmem::BYTES);
  if (set != cudaSuccess) return (int)set;
  static const cudaError_t set_d =
      allow_smem(attn_bwd_delta_kernel, DeltaSmem::BYTES);
  if (set_d != cudaSuccess) return (int)set_d;
  const int rows = B * N * H;
  const int blocks = (rows * 8 + 255) / 256;
  long long* acc = static_cast<long long*>(dq_acc);
  attn_bwd_pre_kernel<<<blocks, 256, 0, stream>>>(acc, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float qscale = scale * 1.4426950408889634f;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* g = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  bf16* dx = static_cast<bf16*>(dqkv);
  attn_bwd_delta_kernel<<<dim3((N + 63) / 64, B * H), 128, DeltaSmem::BYTES,
                          stream>>>(q, g, l, dl, N, H, n_valid, qscale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + NWG_B * 64 - 1) / (NWG_B * 64), B * H);
  attn_bwd_kernel<<<grid, NWG_B * 128, BwdSmem::BYTES, stream>>>(
      q, g, l, dl, acc, dx, N, H, n_valid, qscale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_post_kernel<<<blocks, 256, 0, stream>>>(acc, dx, rows, H, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
