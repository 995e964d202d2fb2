// Fused multi-head attention for the ViT encoder, forward (K1) and
// backward (K2), hand-written for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas kernels cosa_tpu/kernels/flash.py:
//   _fwd_kernel (via _attend_fwd / mha)  ->  attn_fwd_kernel
//   _bwd_kernel (via _attend_bwd)        ->  attn_bwd_dq_kernel + attn_bwd_dkdv_kernel
//
// What it computes, per (batch, head): o = softmax(scale * q k^T) v over the
// keys below n_valid, with scores in f32 and the softmax on exp2, bf16
// probabilities into the PV product with f32 accumulation, and the division
// by the row sum at the end (as the TPU kernel does). One difference: the
// TPU kernel rounds q * scale * log2(e) to bf16 before the product; here the
// raw bf16 q enters the product and the f32 scores take the factor (one
// multiply per score), so the scores carry no rounding of the scale.
// The forward also stores the per-row log-sum-exp (base 2) so the backward
// recomputes the probabilities without a second max pass.
//
// Layouts: qkv is the raw (B, N, 3, H, 64) bf16 projection (no fold copies);
// o and dO are (B, N, H, 64) bf16; lse and delta are (B, H, N) f32; the
// gradient dqkv is written straight into the (B, N, 3, H, 64) layout.
//
// What bounds it on the H100: at CoSA's shapes (N = 197 / 785 / 1765,
// head dim 64) attention is bound by the tensor-core work of the two (four
// in the backward, five with the recompute) N x N x 64 products and the
// exp2 over the N x N scores; the bytes (q, k, v, o once) are small.
// The TPU design holds a whole (BQ, N) f32 score block in VMEM; at
// N = 1765 that does not fit in 227 KB of shared memory, so this kernel
// streams 64-key tiles with the online-softmax rescale and keeps scores,
// probabilities and the output accumulator in registers (mma.sync
// m16n8k16 bf16 fragments; the score accumulator is reused as the PV
// A-operand without going through shared memory).
//
// The backward cannot accumulate dk/dv across a sequential query axis as
// the TPU does (CUDA blocks run unordered), so it runs two passes:
//   1. query-major: delta = rowsum(dO * O), then dq = scale * dS k with
//      dS = p (dP - delta), recomputing p from the saved log-sum-exp;
//   2. key-major: each block owns 64 keys and loops over all queries,
//      accumulating dv = p^T dO and dk = scale * dS^T q in registers.
// dq takes its own pass rather than f32 atomicAdd from pass 2: the result
// is deterministic and needs no f32 scratch or conversion pass, at the cost
// of recomputing S and dP once more (7 products instead of 5).
//
// A first, simple version: synchronous tile loads, no TMA, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int D = 64;       // head dim (the only one the kernels take)
constexpr int BQ = 64;      // query rows per block (16 per warp)
constexpr int BK = 64;      // key rows per tile
constexpr int LD = D + 8;   // shared row stride: conflict-free 32-bit loads
constexpr int THREADS = 128;
constexpr float NEG = -1e30f;

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// A fragment (16 x 16, row-major tile T[row][k]) for rows r0.., k-chunk kc.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* T, int r0,
                                       int kc, int g, int t) {
  const bf16* p = T + (r0 + g) * LD + kc * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B fragment (16 x 8) from an n-major tile Bm[n][k], n-tile nt, k-chunk kc.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* Bm, int nt, int kc, int g,
                                       int t) {
  const bf16* p = Bm + (nt * 8 + g) * LD + kc * 16 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// Score-layout accumulators (8 n-tiles of 8 columns) -> A fragments of the
// next product, for k-chunk kc (columns 16 kc .. 16 kc + 15).
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float s[8][4],
                                         int kc) {
  a[0] = pack2(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack2(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack2(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack2(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// Copy 64 rows x 64 bf16 of one head from the token-strided tensor `src`
// (row n at src + n * stride) into a row-major shared tile; rows >= n_rows
// are zero.
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t stride, int row0,
                                          int n_rows) {
  for (int c = threadIdx.x; c < 64 * 8; c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8, n = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)n * stride + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = v;
  }
}

// Same rows, stored transposed: dst[d][row].
__device__ __forceinline__ void load_rows_t(bf16* dst, const bf16* src,
                                            size_t stride, int row0,
                                            int n_rows) {
  for (int c = threadIdx.x; c < 64 * 8; c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8, n = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)n * stride + col);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(col + i) * LD + r] = e[i];
  }
}

// ---------------------------------------------------------------- forward
__global__ void __launch_bounds__(THREADS)
    attn_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                    float* __restrict__ lse, int N, int H, int n_valid,
                    float qscale) {
  __shared__ __align__(16) bf16 sQ[BQ * LD];
  __shared__ __align__(16) bf16 sK[BK * LD];
  __shared__ __align__(16) bf16 sVt[D * LD];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t tok = (size_t)3 * H * D;  // qkv elements per token
  const bf16* qb = qkv + (size_t)b * N * tok + (size_t)h * D;
  const bf16* kb = qb + (size_t)H * D;
  const bf16* vb = qb + (size_t)2 * H * D;

  load_rows(sQ, qb, tok, q0, N);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qa[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) load_a(qa[kc], sQ, r0, kc, g, t);

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < n_valid; k0 += BK) {
    __syncthreads();
    load_rows(sK, kb, tok, k0, N);
    load_rows_t(sVt, vb, tok, k0, N);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t b0, b1;
        load_b(b0, b1, sK, nt, kc, g, t);
        mma16816(s[nt], qa[kc], b0, b1);
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + nt * 8 + 2 * t + j < n_valid;
        s[nt][j] = ok ? s[nt][j] * qscale : NEG;
        s[nt][2 + j] = ok ? s[nt][2 + j] * qscale : NEG;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
      o[nt][0] *= a0;
      o[nt][1] *= a0;
      o[nt][2] *= a1;
      o[nt][3] *= a1;
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      acc_to_a(pa, s, kc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, sVt, nt, kc, g, t);
        mma16816(o[nt], pa, b0, b1);
      }
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int na = q0 + r0 + g, nb = na + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int d = nt * 8 + 2 * t;
    if (na < N)
      *reinterpret_cast<uint32_t*>(out + ((size_t)(b * N + na) * H + h) * D +
                                   d) = pack2(o[nt][0] * inv0, o[nt][1] * inv0);
    if (nb < N)
      *reinterpret_cast<uint32_t*>(out + ((size_t)(b * N + nb) * H + h) * D +
                                   d) = pack2(o[nt][2] * inv1, o[nt][3] * inv1);
  }
  if (t == 0) {
    if (na < N) lse[(size_t)bh * N + na] = m0 + log2f(l0);
    if (nb < N) lse[(size_t)bh * N + nb] = m1 + log2f(l1);
  }
}

// ------------------------------------------------- backward, pass 1: dq
__global__ void __launch_bounds__(THREADS)
    attn_bwd_dq_kernel(const bf16* __restrict__ qkv,
                       const bf16* __restrict__ out,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, bf16* __restrict__ dqkv,
                       int N, int H, int n_valid, float qscale, float scale) {
  __shared__ __align__(16) bf16 sQ[BQ * LD];
  __shared__ __align__(16) bf16 sdO[BQ * LD];
  __shared__ __align__(16) bf16 sK[BK * LD];
  __shared__ __align__(16) bf16 sKt[D * LD];
  __shared__ __align__(16) bf16 sV[BK * LD];
  __shared__ float sLse[BQ], sDelta[BQ];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t tok = (size_t)3 * H * D;
  const size_t otok = (size_t)H * D;
  const bf16* qb = qkv + (size_t)b * N * tok + (size_t)h * D;
  const bf16* kb = qb + (size_t)H * D;
  const bf16* vb = qb + (size_t)2 * H * D;
  const bf16* ob = out + (size_t)b * N * otok + (size_t)h * D;
  const bf16* gb = dout + (size_t)b * N * otok + (size_t)h * D;

  load_rows(sQ, qb, tok, q0, N);
  // dO rows into shared memory, and delta = rowsum(dO * O) on the way
  for (int c = threadIdx.x; c < BQ * 8; c += THREADS) {
    const int r = c >> 3, col = (c & 7) * 8, n = q0 + r;
    uint4 gv = make_uint4(0u, 0u, 0u, 0u), ov = gv;
    if (n < N) {
      gv = *reinterpret_cast<const uint4*>(gb + (size_t)n * otok + col);
      ov = *reinterpret_cast<const uint4*>(ob + (size_t)n * otok + col);
    }
    *reinterpret_cast<uint4*>(sdO + r * LD + col) = gv;
    const bf16* ge = reinterpret_cast<const bf16*>(&gv);
    const bf16* oe = reinterpret_cast<const bf16*>(&ov);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      part += __bfloat162float(ge[i]) * __bfloat162float(oe[i]);
    // the 8 chunks of row r sit in 8 neighbouring lanes
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    part += __shfl_xor_sync(0xffffffffu, part, 4);
    if ((c & 7) == 0) {
      sDelta[r] = part;
      if (n < N) delta[(size_t)bh * N + n] = part;
    }
  }
  if (threadIdx.x < BQ) {
    const int n = q0 + threadIdx.x;
    // +inf makes p = 0 on rows past the sequence end
    sLse[threadIdx.x] = n < N ? lse[(size_t)bh * N + n] : __int_as_float(0x7f800000);
  }
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qa[4][4], da[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    load_a(qa[kc], sQ, r0, kc, g, t);
    load_a(da[kc], sdO, r0, kc, g, t);
  }
  const float lse0 = sLse[r0 + g], lse1 = sLse[r0 + g + 8];
  const float dl0 = sDelta[r0 + g], dl1 = sDelta[r0 + g + 8];

  float dq[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int k0 = 0; k0 < n_valid; k0 += BK) {
    __syncthreads();
    load_rows(sK, kb, tok, k0, N);
    load_rows_t(sKt, kb, tok, k0, N);
    load_rows(sV, vb, tok, k0, N);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t b0, b1;
        load_b(b0, b1, sK, nt, kc, g, t);
        mma16816(s[nt], qa[kc], b0, b1);
        load_b(b0, b1, sV, nt, kc, g, t);
        mma16816(dp[nt], da[kc], b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + nt * 8 + 2 * t + j < n_valid;
        // p as the TPU kernel feeds it: normalized, rounded to bf16
        const float pa = ok ? bf16_round(exp2f(fmaf(s[nt][j], qscale, -lse0))) : 0.f;
        const float pb = ok ? bf16_round(exp2f(fmaf(s[nt][2 + j], qscale, -lse1))) : 0.f;
        s[nt][j] = pa * (dp[nt][j] - dl0);
        s[nt][2 + j] = pb * (dp[nt][2 + j] - dl1);
      }
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t sa[4];
      acc_to_a(sa, s, kc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, sKt, nt, kc, g, t);
        mma16816(dq[nt], sa, b0, b1);
      }
    }
  }
  const int na = q0 + r0 + g, nb = na + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int d = nt * 8 + 2 * t;
    if (na < N)
      *reinterpret_cast<uint32_t*>(dqkv + (size_t)(b * N + na) * tok +
                                   (size_t)h * D + d) =
          pack2(dq[nt][0] * scale, dq[nt][1] * scale);
    if (nb < N)
      *reinterpret_cast<uint32_t*>(dqkv + (size_t)(b * N + nb) * tok +
                                   (size_t)h * D + d) =
          pack2(dq[nt][2] * scale, dq[nt][3] * scale);
  }
}

// --------------------------------------------- backward, pass 2: dk, dv
__global__ void __launch_bounds__(THREADS)
    attn_bwd_dkdv_kernel(const bf16* __restrict__ qkv,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dqkv, int N, int H, int n_valid,
                         float qscale, float scale) {
  __shared__ __align__(16) bf16 sQs[BQ * LD];  // q, [q][d]
  __shared__ __align__(16) bf16 sQt[D * LD];   // raw q, [d][q]
  __shared__ __align__(16) bf16 sdO[BQ * LD];  // [q][d]
  __shared__ __align__(16) bf16 sdOt[D * LD];  // [d][q]
  __shared__ float sLse[BQ], sDelta[BQ];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const size_t tok = (size_t)3 * H * D;
  const size_t otok = (size_t)H * D;
  const bf16* qb = qkv + (size_t)b * N * tok + (size_t)h * D;
  const bf16* kb = qb + (size_t)H * D;
  const bf16* vb = qb + (size_t)2 * H * D;
  const bf16* gb = dout + (size_t)b * N * otok + (size_t)h * D;

  // this block's 64 keys and values, as A fragments (rows = keys)
  load_rows(sQs, kb, tok, k0, N);
  load_rows(sdO, vb, tok, k0, N);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t ka[4][4], va[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    load_a(ka[kc], sQs, r0, kc, g, t);
    load_a(va[kc], sdO, r0, kc, g, t);
  }
  const bool key0_ok = k0 + r0 + g < n_valid;
  const bool key1_ok = k0 + r0 + g + 8 < n_valid;

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int q0 = 0; q0 < N; q0 += BQ) {
    __syncthreads();
    load_rows(sQs, qb, tok, q0, N);
    load_rows_t(sQt, qb, tok, q0, N);
    load_rows(sdO, gb, otok, q0, N);
    load_rows_t(sdOt, gb, otok, q0, N);
    if (threadIdx.x < BQ) {
      const int n = q0 + threadIdx.x;
      sLse[threadIdx.x] =
          n < N ? lse[(size_t)bh * N + n] : __int_as_float(0x7f800000);
      sDelta[threadIdx.x] = n < N ? delta[(size_t)bh * N + n] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t b0, b1;
        load_b(b0, b1, sQs, nt, kc, g, t);
        mma16816(st[nt], ka[kc], b0, b1);
        load_b(b0, b1, sdO, nt, kc, g, t);
        mma16816(dpt[nt], va[kc], b0, b1);
      }
    }
    // st[key][query] -> p^T (bf16-rounded), dpt -> dS^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = nt * 8 + 2 * t + j;
        const float l = sLse[qi], dl = sDelta[qi];
        const float p0 = key0_ok ? bf16_round(exp2f(fmaf(st[nt][j], qscale, -l))) : 0.f;
        const float p1 = key1_ok ? bf16_round(exp2f(fmaf(st[nt][2 + j], qscale, -l))) : 0.f;
        st[nt][j] = p0;
        st[nt][2 + j] = p1;
        dpt[nt][j] = p0 * (dpt[nt][j] - dl);
        dpt[nt][2 + j] = p1 * (dpt[nt][2 + j] - dl);
      }
    }
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, st, kc);
      acc_to_a(sa, dpt, kc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, sdOt, nt, kc, g, t);
        mma16816(dv[nt], pa, b0, b1);
        load_b(b0, b1, sQt, nt, kc, g, t);
        mma16816(dk[nt], sa, b0, b1);
      }
    }
  }
  const int na = k0 + r0 + g, nb = na + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int d = nt * 8 + 2 * t;
    if (na < N) {
      bf16* row = dqkv + (size_t)(b * N + na) * tok + (size_t)h * D + d;
      *reinterpret_cast<uint32_t*>(row + (size_t)H * D) =
          pack2(dk[nt][0] * scale, dk[nt][1] * scale);
      *reinterpret_cast<uint32_t*>(row + (size_t)2 * H * D) =
          pack2(dv[nt][0], dv[nt][1]);
    }
    if (nb < N) {
      bf16* row = dqkv + (size_t)(b * N + nb) * tok + (size_t)h * D + d;
      *reinterpret_cast<uint32_t*>(row + (size_t)H * D) =
          pack2(dk[nt][2] * scale, dk[nt][3] * scale);
      *reinterpret_cast<uint32_t*>(row + (size_t)2 * H * D) =
          pack2(dv[nt][2], dv[nt][3]);
    }
  }
}

}  // namespace

extern "C" {

// qkv (B, N, 3, H, 64) bf16 -> out (B, N, H, 64) bf16, lse (B, H, N) f32.
int cosa_attn_fwd(const void* qkv, void* out, void* lse, int B, int N, int H,
                  int n_valid, float scale, cudaStream_t stream) {
  const float log2e = 1.4426950408889634f;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  attn_fwd_kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      static_cast<float*>(lse), N, H, n_valid, scale * log2e);
  return (int)cudaGetLastError();
}

// Gradient of cosa_attn_fwd: dout (B, N, H, 64) -> dqkv (B, N, 3, H, 64).
// delta (B, H, N) f32 is scratch written by the first pass.
int cosa_attn_bwd(const void* qkv, const void* out, const void* dout,
                  const void* lse, void* delta, void* dqkv, int B, int N,
                  int H, int n_valid, float scale, cudaStream_t stream) {
  const float log2e = 1.4426950408889634f;
  dim3 grid_q((N + BQ - 1) / BQ, B * H);
  attn_bwd_dq_kernel<<<grid_q, THREADS, 0, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dqkv), N, H, n_valid,
      scale * log2e, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_k((N + BK - 1) / BK, B * H);
  attn_bwd_dkdv_kernel<<<grid_k, THREADS, 0, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dqkv), N, H, n_valid, scale * log2e, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
