// Swin's window attention (K6), forward and backward, hand-written for
// Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package's window attention
// (cosa_tpu/models/zoo/swin.py:107-127) leaves the chain to XLA. In PyTorch
// the chain is about a dozen library launches a call (the q scale, two
// einsums and their permute copies, the f32 cast, the bias gather and add,
// the mask add, the softmax, the bf16 cast), and autograd replays as many in
// the backward; the scores pass through device memory in f32 six or seven
// times. A Swin-B training step makes 96 such calls, 24 of them with a
// backward.
//
// What it computes, for each window b and head of the (B*nW, n, 3, h, hd)
// output of the qkv dense (n = w^2 tokens, w <= 8, hd a multiple of 8 up to
// 32, the widest head of the port's Swin configurations), the f32 bias
// table ((2w-1)^2, h) read through the relative-position index (computed
// here: (ri - rj + w-1) * (2w-1) + (ci - cj + w-1) for tokens i = ri*w + ci,
// j = rj*w + cj, as models/zoo/swin.py's index) and
// the optional additive f32 mask (nW, n, n), window b taking mask b mod nW:
//   s = round(q * hd^-0.5) k^T, rounded to the storage type
//   s = (s + bias) + mask                      in f32
//   p = exp(s - max) / sum                     in f32, as torch's softmax
//   o = round(p) v, rounded to the storage type
// It rounds where the plain version (kernels/window_attn.py) rounds, so the
// two stay close on the card. The forward can save each row's max and sum,
// from which the backward recomputes p bit for bit, and then
//   dv = round(p)^T do,  dp = round(do v^T),  g = dp * p,
//   ds = g - p * rowsum(g)                    (torch's softmax backward),
//   dq = round(round(round(ds) k) * hd^-0.5),  dk = round(ds)^T round(q hd^-0.5),
// written into the qkv layout, and the table's gradient: per head, the sum
// of ds over every window through the index, as f32 partials of a block
// (fixed order) summed by a second pass (fixed order): deterministic.
//
// What bounds it on the H100: bytes. Its floor is q, k, v and o read or
// written once in the storage type, the table and the mask once: at Swin-B's
// training step (96 calls, 47 masked) 3.21 GB, 0.957 ms at 3.35 TB/s,
// against 0.078 TFLOP of products. The design keeps everything between the
// loads and the output on chip: a block works on one (window, head) at a
// time, its q, k and v tiles (64 rows, the window padded from n), the
// table's column and the mask in shared memory, the 64 x 64 scores, the
// softmax and p in registers, the products on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 sums) for bf16 storage. Each of four warps holds
// 16 query rows against all 64 keys. A forward block stays resident and
// takes one item after another, copying the next one's tiles (cp.async)
// while it computes the current one: with a block an item, the blocks of a
// wave waited for their loads all at once and then computed all at once,
// and the forward took 1.3x as long (H100, Swin-B's shapes). The backward
// keeps p and ds of all rows in shared memory for the key-major products dv
// and dk. With f32 storage the products run on the CUDA cores in full f32
// (TF32 would change the result): one thread a query row, then one a key
// row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NP = 64;             // a window's tokens, padded (w <= 8)
constexpr int THREADS = 128;       // bf16 blocks: 4 warps of 16 query rows
constexpr int F32_THREADS = NP;    // f32 blocks: a thread a row
constexpr int MAX_TABLE = 228;     // (2w - 1)^2 at w = 8, padded to 16 bytes
constexpr int PT = NP + 8;         // row stride of the bf16 p and ds tiles (144 B)
constexpr int SF = NP + 1;         // row stride of the f32 score tiles

struct Dims {
  int bn, n, w, h, hd, nw;  // windows, tokens, window side, heads, head width, masks
  float scale;
};

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, past the registers; zeros where !live (nothing read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group of this thread's copies but the newest has landed
__device__ __forceinline__ void cp_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// x / y rounded to nearest, from r = y's rounded reciprocal: the rounded
// product corrected by its exact remainder (Markstein), three instructions
// where the division takes about eight
__device__ __forceinline__ float div_rn(float x, float y, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, y, x), r, q);
}

// the table row of token pair (i, j) is rel_row(i) - rel_col(j)
__device__ __forceinline__ int rel_row(int i, int w) {
  return (i / w + w - 1) * (2 * w - 1) + i % w + w - 1;
}
__device__ __forceinline__ int rel_col(int j, int w) { return (j / w) * (2 * w - 1) + j % w; }

// One head's column of the bias table into shared memory, asynchronously
__device__ __forceinline__ void load_table(float* tab, const float* table, const Dims& d, int hh,
                                           int tid, int nthreads) {
  const int t = (2 * d.w - 1) * (2 * d.w - 1);
  for (int i = tid; i < t; i += nthreads) cp4(tab + i, table + i * d.h + hh);
}

// Each token's rel_row and rel_col (rel[i], rel[NP + i]), so that a score
// finds its bias with one subtraction and one shared load
__device__ __forceinline__ void fill_rel(int* rel, const Dims& d, int tid, int nthreads) {
  for (int i = tid; i < NP; i += nthreads) {
    rel[i] = i < d.n ? rel_row(i, d.w) : 0;
    rel[NP + i] = i < d.n ? rel_col(i, d.w) : 0;
  }
}

// A block's share of the table gradient: for each table row, the sum of ds
// over the token pairs that read it, in a fixed order (query-major).
__device__ void table_partials(float* part, const float* ds, int ld, const Dims& d, int tid,
                               int nthreads) {
  const int w = d.w, tw = 2 * w - 1;
  for (int i = tid; i < tw * tw; i += nthreads) {
    const int dr = i / tw - (w - 1), dc = i % tw - (w - 1);
    float acc = 0.f;
    for (int q = 0; q < d.n; ++q) {
      const int rj = q / w - dr, cj = q % w - dc;
      if (rj >= 0 && rj < w && cj >= 0 && cj < w) acc += ds[q * ld + rj * w + cj];
    }
    part[i] = acc;
  }
}

// ------------------------------------------------------------- bf16 path

// Rows [0, NP) x columns [0, HDP) of one head's matrix (row stride `stride`
// elements from `src`) into a shared tile of row stride HDP + 8, zero past
// n rows and hd columns, asynchronously: every copy of the block is in
// flight at once, and a thread waits for its own before reading them.
template <int HDP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t stride,
                                          const Dims& d) {
  constexpr int LD = HDP + 8, CH = HDP / 8;
  for (int i = threadIdx.x; i < NP * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    const bool live = r < d.n && c * 8 < d.hd;
    cp16(dst + r * LD + c * 8, live ? src + r * stride + c * 8 : src, live);
  }
}

// Once this thread's copies have landed: each value of the q chunks it
// copied rounded from value * scale, as the plain version's q * hd^-0.5
template <int HDP>
__device__ __forceinline__ void scale_tile(bf16* qs, const Dims& d) {
  constexpr int LD = HDP + 8, CH = HDP / 8;
  for (int i = threadIdx.x; i < NP * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    if (r < d.n && c * 8 < d.hd) {
      uint4* p = reinterpret_cast<uint4*>(qs + r * LD + c * 8);
      uint4 v = *p;
      bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) e[k] = __float2bfloat16_rn(__bfloat162float(e[k]) * d.scale);
      *p = v;
    }
  }
}

// This window's (n, n) mask into shared memory, asynchronously
__device__ __forceinline__ void load_mask(float* ms, const float* maskw, const Dims& d) {
  for (int i = threadIdx.x; i < d.n * d.n; i += THREADS) cp4(ms + i, maskw + i);
}

// This warp's 16 query rows of the scores against all 64 keys, in the mma
// accumulator layout (s[j]: keys 8j..8j+7; rows g and g+8 of the warp's
// tile, columns 2t, 2t+1), rounded, biased and masked; padded keys -inf.
template <int HDP>
__device__ __forceinline__ void scores(float (&s)[8][4], const bf16* qs, const bf16* ks,
                                       const float* tab, const int* rel, const float* maskw,
                                       const Dims& d) {
  constexpr int LD = HDP + 8;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, qs + (m0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t b[4];
      ldsm_x4(b, ks + (16 * jj + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
      mma(s[2 * jj], a, b[0], b[1]);
      mma(s[2 * jj + 1], a, b[2], b[3]);
    }
  }
  int cc[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    cc[j][0] = rel[NP + 8 * j + 2 * t];
    cc[j][1] = rel[NP + 8 * j + 2 * t + 1];
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + g + 8 * half;
    const bool live = r < d.n;
    const int rr = rel[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        float v = s[j][2 * half + e];
        if (c >= d.n) {
          v = -INFINITY;
        } else {
          v = rbf(v);
          if (live) {
            v = v + tab[rr - cc[j][e]];
            if (maskw) v = v + maskw[r * d.n + c];
          }
        }
        s[j][2 * half + e] = v;
      }
    }
  }
}

// Shared memory of one stage of the forward: the q, k and v tiles, the
// table's column, and the mask where there is one
template <int HDP>
__host__ __device__ constexpr size_t fwd_tiles_bytes() {
  return 3 * NP * (HDP + 8) * sizeof(bf16);
}

template <int HDP>
__host__ __device__ size_t fwd_stage_bytes(bool masked, int n) {
  return fwd_tiles_bytes<HDP>() + MAX_TABLE * sizeof(float) +
         (masked ? (n * n * sizeof(float) + 15) / 16 * 16 : 0);
}

// Persistent: a block takes (window, head) items gridDim.x apart, copying
// the next item's tiles into the other stage while it computes this one's,
// so that the card's loads and products overlap.
template <int HDP>
__global__ void __launch_bounds__(THREADS)
    winattn_fwd_bf16(const bf16* __restrict__ qkv, const float* __restrict__ table,
                     const float* __restrict__ mask, bf16* __restrict__ out,
                     float* __restrict__ stats, Dims d) {
  constexpr int LD = HDP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rel[2 * NP];
  const size_t stage = fwd_stage_bytes<HDP>(mask != nullptr, d.n);
  const int items = d.bn * d.h;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16, g = lane >> 2, t = lane & 3;
  const size_t stride = 3 * (size_t)d.h * d.hd, ostride = (size_t)d.h * d.hd;
  fill_rel(rel, d, threadIdx.x, THREADS);

  auto issue = [&](int it, unsigned char* st) {
    const int b = it / d.h, hh = it % d.h;
    bf16* qs = reinterpret_cast<bf16*>(st);
    const bf16* src = qkv + (size_t)b * d.n * stride + (size_t)hh * d.hd;
    load_tile<HDP>(qs, src, stride, d);
    load_tile<HDP>(qs + NP * LD, src + ostride, stride, d);
    load_tile<HDP>(qs + 2 * NP * LD, src + 2 * ostride, stride, d);
    float* tab = reinterpret_cast<float*>(st + fwd_tiles_bytes<HDP>());
    load_table(tab, table, d, hh, threadIdx.x, THREADS);
    if (mask) load_mask(tab + MAX_TABLE, mask + (size_t)(b % d.nw) * d.n * d.n, d);
  };

  int it = blockIdx.x;
  if (it < items) issue(it, smem);
  cp_commit();
  for (int k = 0; it < items; ++k, it += gridDim.x) {
    unsigned char* cur = smem + (k & 1) * stage;
    if (it + (int)gridDim.x < items) issue(it + gridDim.x, smem + ((k + 1) & 1) * stage);
    cp_commit();
    cp_wait_prior();
    bf16* qs = reinterpret_cast<bf16*>(cur);
    const bf16* ks = qs + NP * LD;
    const bf16* vs = ks + NP * LD;
    const float* tab = reinterpret_cast<const float*>(cur + fwd_tiles_bytes<HDP>());
    scale_tile<HDP>(qs, d);
    __syncthreads();

    const int b = it / d.h, hh = it % d.h;
    float s[8][4];
    scores<HDP>(s, qs, ks, tab, rel, mask ? tab + MAX_TABLE : nullptr, d);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (m0 + 8 * half >= d.n) {  // no live row: p is never read
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j][2 * half] = s[j][2 * half + 1] = 0.f;
        continue;
      }
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = 8 * j < d.n ? expf(s[j][2 * half + e] - mx) : 0.f;
          s[j][2 * half + e] = x;
          sum += x;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float rs = __frcp_rn(sum);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * half] = div_rn(s[j][2 * half], sum, rs);
        s[j][2 * half + 1] = div_rn(s[j][2 * half + 1], sum, rs);
      }
      const int r = m0 + g + 8 * half;
      if (stats && t == 0 && r < d.n) {
        float* st = stats + (((size_t)b * d.h + hh) * d.n + r) * 2;
        st[0] = mx;
        st[1] = sum;
      }
    }

    float o[HDP / 8][4];
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jd = 0; jd < HDP / 8; jd += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + 8 * jd +
                          (lane >> 4) * 8);
        mma(o[jd], a, bv[0], bv[1]);
        mma(o[jd + 1], a, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + g + 8 * half;
      if (r >= d.n) continue;
      bf16* dst = out + ((size_t)b * d.n + r) * ostride + (size_t)hh * d.hd;
#pragma unroll
      for (int jd = 0; jd < HDP / 8; ++jd) {
        const int c = 8 * jd + 2 * t;
        if (c < d.hd)
          *reinterpret_cast<__nv_bfloat162*>(dst + c) =
              __floats2bfloat162_rn(o[jd][2 * half], o[jd][2 * half + 1]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
}

template <int HDP>
constexpr size_t bwd_bf16_smem() {
  return 4 * NP * (HDP + 8) * sizeof(bf16) + 2 * NP * PT * sizeof(bf16) +
         NP * SF * sizeof(float) + MAX_TABLE * sizeof(float) + 2 * NP * sizeof(int);
}

// One (window, head): dq (query-major, each warp its 16 rows), then dv and
// dk (key-major, each warp 16 keys, summed over all queries from p and ds in
// shared memory), then the block's table partials.
template <int HDP>
__global__ void __launch_bounds__(THREADS)
    winattn_bwd_bf16(const bf16* __restrict__ qkv, const float* __restrict__ table,
                     const float* __restrict__ mask, const float* __restrict__ stats,
                     const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                     float* __restrict__ part, Dims d) {
  constexpr int LD = HDP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + NP * LD;
  bf16* vs = ks + NP * LD;
  bf16* os = vs + NP * LD;  // the output's cotangent
  bf16* pt = os + NP * LD;  // round(p), [query][key]
  bf16* dt = pt + NP * PT;  // round(ds), [query][key]
  float* sf = reinterpret_cast<float*>(dt + NP * PT);  // ds in f32, [query][key]
  float* tab = sf + NP * SF;
  int* rel = reinterpret_cast<int*>(tab + MAX_TABLE);
  const int b = blockIdx.x, hh = blockIdx.y;
  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16, g = lane >> 2, t = lane & 3;
  const size_t stride = 3 * (size_t)d.h * d.hd, ostride = (size_t)d.h * d.hd;
  const bf16* src = qkv + (size_t)b * d.n * stride + (size_t)hh * d.hd;
  load_tile<HDP>(qs, src, stride, d);
  load_tile<HDP>(ks, src + ostride, stride, d);
  load_tile<HDP>(vs, src + 2 * ostride, stride, d);
  load_tile<HDP>(os, dout + (size_t)b * d.n * ostride + (size_t)hh * d.hd, ostride, d);
  // the mask shares its shared memory with ds, which is written after the scores
  if (mask) load_mask(sf, mask + (size_t)(b % d.nw) * d.n * d.n, d);
  load_table(tab, table, d, hh, threadIdx.x, THREADS);
  fill_rel(rel, d, threadIdx.x, THREADS);
  cp_wait();
  scale_tile<HDP>(qs, d);
  __syncthreads();

  float p[8][4];
  scores<HDP>(p, qs, ks, tab, rel, mask ? sf : nullptr, d);
  float dp[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, os + (m0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t bv[4];
      ldsm_x4(bv, vs + (16 * jj + (lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma(dp[2 * jj], a, bv[0], bv[1]);
      mma(dp[2 * jj + 1], a, bv[2], bv[3]);
    }
  }
  __syncthreads();  // every warp's scores have read the mask; ds may take its place
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = m0 + g + 8 * half;
    float mx = 0.f, sum = 1.f;  // padded rows: any finite p (their do is 0)
    if (r < d.n) {
      const float* st = stats + (((size_t)b * d.h + hh) * d.n + r) * 2;
      mx = st[0];
      sum = st[1];
    }
    const bool live = m0 + 8 * half < d.n;  // some row of the half is live
    const float inv = __frcp_rn(sum);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pv = live && 8 * j < d.n ? div_rn(expf(p[j][2 * half + e] - mx), sum, inv)
                                             : 0.f;
        const float gv = rbf(dp[j][2 * half + e]) * pv;
        p[j][2 * half + e] = pv;
        dp[j][2 * half + e] = gv;
        rs += gv;
      }
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * half + e;
        dp[j][k] = dp[j][k] - p[j][k] * rs;
      }
      const int c = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(pt + r * PT + c) = pack(p[j][2 * half], p[j][2 * half + 1]);
      *reinterpret_cast<uint32_t*>(dt + r * PT + c) = pack(dp[j][2 * half], dp[j][2 * half + 1]);
      sf[r * SF + c] = dp[j][2 * half];
      sf[r * SF + c + 1] = dp[j][2 * half + 1];
    }
  }

  // dq = round(round(ds) k) * scale, this warp's rows
  {
    float acc[HDP / 8][4];
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack(dp[2 * kk][0], dp[2 * kk][1]),
                             pack(dp[2 * kk][2], dp[2 * kk][3]),
                             pack(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                             pack(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int jd = 0; jd < HDP / 8; jd += 2) {
        uint32_t bk[4];
        ldsm_x4_t(bk, ks + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + 8 * jd +
                          (lane >> 4) * 8);
        mma(acc[jd], a, bk[0], bk[1]);
        mma(acc[jd + 1], a, bk[2], bk[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + g + 8 * half;
      if (r >= d.n) continue;
      bf16* dst = dqkv + ((size_t)b * d.n + r) * stride + (size_t)hh * d.hd;
#pragma unroll
      for (int jd = 0; jd < HDP / 8; ++jd) {
        const int c = 8 * jd + 2 * t;
        if (c < d.hd)
          *reinterpret_cast<__nv_bfloat162*>(dst + c) =
              __floats2bfloat162_rn(rbf(acc[jd][2 * half]) * d.scale,
                                    rbf(acc[jd][2 * half + 1]) * d.scale);
      }
    }
  }
  __syncthreads();

  // dv = round(p)^T do and dk = round(ds)^T round(q scale), this warp's 16 keys
  {
    const int k0 = m0;
    float av[HDP / 8][4], ak[HDP / 8][4];
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      av[j][0] = av[j][1] = av[j][2] = av[j][3] = 0.f;
      ak[j][0] = ak[j][1] = ak[j][2] = ak[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ap[4], ad[4];
      const int off = (16 * kk + (lane & 7) + (lane >> 4) * 8) * PT + k0 + ((lane >> 3) & 1) * 8;
      ldsm_x4_t(ap, pt + off);
      ldsm_x4_t(ad, dt + off);
#pragma unroll
      for (int jd = 0; jd < HDP / 8; jd += 2) {
        const int boff = (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + 8 * jd +
                         (lane >> 4) * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, os + boff);
        ldsm_x4_t(bq, qs + boff);
        mma(av[jd], ap, bo[0], bo[1]);
        mma(av[jd + 1], ap, bo[2], bo[3]);
        mma(ak[jd], ad, bq[0], bq[1]);
        mma(ak[jd + 1], ad, bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = k0 + g + 8 * half;
      if (r >= d.n) continue;
      bf16* dst = dqkv + ((size_t)b * d.n + r) * stride + (size_t)hh * d.hd;
#pragma unroll
      for (int jd = 0; jd < HDP / 8; ++jd) {
        const int c = 8 * jd + 2 * t;
        if (c < d.hd) {
          *reinterpret_cast<__nv_bfloat162*>(dst + ostride + c) =
              __floats2bfloat162_rn(ak[jd][2 * half], ak[jd][2 * half + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dst + 2 * ostride + c) =
              __floats2bfloat162_rn(av[jd][2 * half], av[jd][2 * half + 1]);
        }
      }
    }
  }
  const int tw = 2 * d.w - 1;
  table_partials(part + ((size_t)b * d.h + hh) * tw * tw, sf, SF, d, threadIdx.x, THREADS);
}

// -------------------------------------------------------------- f32 path

template <int HDP>
constexpr size_t fwd_f32_smem() {
  return (2 * NP * HDP + NP * SF + MAX_TABLE) * sizeof(float) + 2 * NP * sizeof(int);
}

template <int HDP>
constexpr size_t bwd_f32_smem() {
  return (4 * NP * HDP + 2 * NP * SF + MAX_TABLE) * sizeof(float) + 2 * NP * sizeof(int);
}

// rows [0, NP) x [0, HDP) of one head's f32 matrix into a shared tile of row
// stride HDP, zero past n rows and hd columns, times `scale` where given
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, size_t stride,
                                              const Dims& d, int hdp, float scale) {
  for (int i = threadIdx.x; i < NP * hdp; i += F32_THREADS) {
    const int r = i / hdp, c = i % hdp;
    dst[i] = (r < d.n && c < d.hd) ? src[r * stride + c] * scale : 0.f;
  }
}

// This thread's query row: its f32 score against key j, biased and masked
template <int HDP>
__device__ __forceinline__ float score_f32(const float (&q)[HDP], const float* kj, int i, int j,
                                           const float* tab, const int* rel, const float* maskw,
                                           const Dims& d) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < HDP; ++c) acc += q[c] * kj[c];
  float v = acc + tab[rel[i] - rel[NP + j]];
  if (maskw) v = v + maskw[i * d.n + j];
  return v;
}

template <int HDP>
__global__ void __launch_bounds__(F32_THREADS)
    winattn_fwd_f32(const float* __restrict__ qkv, const float* __restrict__ table,
                    const float* __restrict__ mask, float* __restrict__ out,
                    float* __restrict__ stats, Dims d) {
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;
  float* vs = ks + NP * HDP;
  float* ss = vs + NP * HDP;
  float* tab = ss + NP * SF;
  int* rel = reinterpret_cast<int*>(tab + MAX_TABLE);
  const int b = blockIdx.x, hh = blockIdx.y, i = threadIdx.x;
  const size_t stride = 3 * (size_t)d.h * d.hd, ostride = (size_t)d.h * d.hd;
  const float* src = qkv + (size_t)b * d.n * stride + (size_t)hh * d.hd;
  load_tile_f32(ks, src + ostride, stride, d, HDP, 1.f);
  load_tile_f32(vs, src + 2 * ostride, stride, d, HDP, 1.f);
  load_table(tab, table, d, hh, i, F32_THREADS);
  fill_rel(rel, d, i, F32_THREADS);
  cp_wait();
  __syncthreads();
  if (i >= d.n) return;
  const float* maskw = mask ? mask + (size_t)(b % d.nw) * d.n * d.n : nullptr;
  float q[HDP];
#pragma unroll
  for (int c = 0; c < HDP; ++c) q[c] = c < d.hd ? src[i * stride + c] * d.scale : 0.f;
  float* si = ss + i * SF;
  float mx = -INFINITY;
  for (int j = 0; j < d.n; ++j) {
    const float v = score_f32<HDP>(q, ks + j * HDP, i, j, tab, rel, maskw, d);
    si[j] = v;
    mx = fmaxf(mx, v);
  }
  float sum = 0.f;
  for (int j = 0; j < d.n; ++j) {
    const float x = expf(si[j] - mx);
    si[j] = x;
    sum += x;
  }
  float o[HDP];
#pragma unroll
  for (int c = 0; c < HDP; ++c) o[c] = 0.f;
  for (int j = 0; j < d.n; ++j) {
    const float pj = si[j] / sum;
#pragma unroll
    for (int c = 0; c < HDP; ++c) o[c] += pj * vs[j * HDP + c];
  }
  float* dst = out + ((size_t)b * d.n + i) * ostride + (size_t)hh * d.hd;
#pragma unroll
  for (int c = 0; c < HDP; ++c)
    if (c < d.hd) dst[c] = o[c];
  if (stats) {
    float* st = stats + (((size_t)b * d.h + hh) * d.n + i) * 2;
    st[0] = mx;
    st[1] = sum;
  }
}

template <int HDP>
__global__ void __launch_bounds__(F32_THREADS)
    winattn_bwd_f32(const float* __restrict__ qkv, const float* __restrict__ table,
                    const float* __restrict__ mask, const float* __restrict__ stats,
                    const float* __restrict__ dout, float* __restrict__ dqkv,
                    float* __restrict__ part, Dims d) {
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* ks = qs + NP * HDP;
  float* vs = ks + NP * HDP;
  float* os = vs + NP * HDP;
  float* ps = os + NP * HDP;  // p, [query][key]
  float* ds = ps + NP * SF;   // ds, [query][key]
  float* tab = ds + NP * SF;
  int* rel = reinterpret_cast<int*>(tab + MAX_TABLE);
  const int b = blockIdx.x, hh = blockIdx.y, i = threadIdx.x;
  const size_t stride = 3 * (size_t)d.h * d.hd, ostride = (size_t)d.h * d.hd;
  const float* src = qkv + (size_t)b * d.n * stride + (size_t)hh * d.hd;
  const float* dsrc = dout + (size_t)b * d.n * ostride + (size_t)hh * d.hd;
  load_tile_f32(qs, src, stride, d, HDP, d.scale);
  load_tile_f32(ks, src + ostride, stride, d, HDP, 1.f);
  load_tile_f32(vs, src + 2 * ostride, stride, d, HDP, 1.f);
  load_tile_f32(os, dsrc, ostride, d, HDP, 1.f);
  load_table(tab, table, d, hh, i, F32_THREADS);
  fill_rel(rel, d, i, F32_THREADS);
  cp_wait();
  __syncthreads();
  float* dst = dqkv + (size_t)b * d.n * stride + (size_t)hh * d.hd;
  if (i < d.n) {  // query row i: p, ds and dq
    const float* maskw = mask ? mask + (size_t)(b % d.nw) * d.n * d.n : nullptr;
    float q[HDP], g[HDP];
#pragma unroll
    for (int c = 0; c < HDP; ++c) {
      q[c] = c < d.hd ? src[i * stride + c] * d.scale : 0.f;
      g[c] = c < d.hd ? dsrc[i * ostride + c] : 0.f;
    }
    const float* st = stats + (((size_t)b * d.h + hh) * d.n + i) * 2;
    const float mx = st[0], sum = st[1];
    float rs = 0.f;
    for (int j = 0; j < d.n; ++j) {
      const float pj = expf(score_f32<HDP>(q, ks + j * HDP, i, j, tab, rel, maskw, d) - mx) / sum;
      float dpj = 0.f;
#pragma unroll
      for (int c = 0; c < HDP; ++c) dpj += g[c] * vs[j * HDP + c];
      const float gj = dpj * pj;
      ps[i * SF + j] = pj;
      ds[i * SF + j] = gj;
      rs += gj;
    }
    float dq[HDP];
#pragma unroll
    for (int c = 0; c < HDP; ++c) dq[c] = 0.f;
    for (int j = 0; j < d.n; ++j) {
      const float v = ds[i * SF + j] - ps[i * SF + j] * rs;
      ds[i * SF + j] = v;
#pragma unroll
      for (int c = 0; c < HDP; ++c) dq[c] += v * ks[j * HDP + c];
    }
#pragma unroll
    for (int c = 0; c < HDP; ++c)
      if (c < d.hd) dst[i * stride + c] = dq[c] * d.scale;
  }
  __syncthreads();
  if (i < d.n) {  // key row i: dk and dv
    float dk[HDP], dv[HDP];
#pragma unroll
    for (int c = 0; c < HDP; ++c) dk[c] = dv[c] = 0.f;
    for (int r = 0; r < d.n; ++r) {
      const float pr = ps[r * SF + i], dr = ds[r * SF + i];
#pragma unroll
      for (int c = 0; c < HDP; ++c) {
        dv[c] += pr * os[r * HDP + c];
        dk[c] += dr * qs[r * HDP + c];
      }
    }
#pragma unroll
    for (int c = 0; c < HDP; ++c) {
      if (c < d.hd) {
        dst[i * stride + ostride + c] = dk[c];
        dst[i * stride + 2 * ostride + c] = dv[c];
      }
    }
  }
  const int tw = 2 * d.w - 1;
  table_partials(part + ((size_t)b * d.h + hh) * tw * tw, ds, SF, d, i, F32_THREADS);
}

// The table gradient: a warp an entry (table row, head), the blocks'
// partials summed lane-strided and then by a fixed butterfly
__global__ void winattn_table_grad(const float* __restrict__ part, float* __restrict__ dtable,
                                   int bn, int h, int t) {
  const int o = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (o >= t * h) return;
  const int row = o / h, hh = o % h;
  float acc = 0.f;
  for (int b = lane; b < bn; b += 32) acc += part[((size_t)b * h + hh) * t + row];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dtable[o] = acc;
}

// ---------------------------------------------------------------- launch

constexpr int MAX_DEVICES = 64;

// Opt a kernel into more than the default 48 KB of dynamic shared memory,
// once a device, at the most any of its launches takes (the flags live in
// the calling template instance)
template <typename K>
cudaError_t allow_smem(K kernel, size_t most, bool (&done)[MAX_DEVICES], int dev) {
  if (most <= 48 * 1024 || (dev < MAX_DEVICES && done[dev])) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

template <int HDP>
cudaError_t fwd(const void* qkv, const float* table, const float* mask, void* out, float* stats,
                const Dims& d, bool f32, cudaStream_t stream) {
  static bool done_f32[MAX_DEVICES], done_bf16[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (f32) {
    const size_t smem = fwd_f32_smem<HDP>();
    e = allow_smem(winattn_fwd_f32<HDP>, smem, done_f32, dev);
    if (e != cudaSuccess) return e;
    winattn_fwd_f32<HDP><<<dim3(d.bn, d.h), F32_THREADS, smem, stream>>>(
        static_cast<const float*>(qkv), table, mask, static_cast<float*>(out), stats, d);
    return cudaGetLastError();
  }
  // two stages; as many blocks as the card holds at once, each looping.
  // Blocks an SM holds, by (masked, n), and the SMs: read once
  static int per_sm[2][NP + 1], sms;
  const bool masked = mask != nullptr;
  const size_t smem = 2 * fwd_stage_bytes<HDP>(masked, d.n);
  e = allow_smem(winattn_fwd_bf16<HDP>, 2 * fwd_stage_bytes<HDP>(true, NP), done_bf16, dev);
  if (e == cudaSuccess && !sms)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && !per_sm[masked][d.n])
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[masked][d.n],
                                                      winattn_fwd_bf16<HDP>, THREADS, smem);
  if (e != cudaSuccess) return e;
  const long long items = (long long)d.bn * d.h, most = (long long)per_sm[masked][d.n] * sms;
  const int blocks = (int)(items < most ? items : most);
  winattn_fwd_bf16<HDP><<<blocks > 0 ? blocks : 1, THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), table, mask, static_cast<bf16*>(out), stats, d);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t bwd(const void* qkv, const float* table, const float* mask, const float* stats,
                const void* dout, void* dqkv, float* part, const Dims& d, bool f32,
                cudaStream_t stream) {
  static bool done_f32[MAX_DEVICES], done_bf16[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const dim3 grid(d.bn, d.h);
  if (f32) {
    const size_t smem = bwd_f32_smem<HDP>();
    e = allow_smem(winattn_bwd_f32<HDP>, smem, done_f32, dev);
    if (e != cudaSuccess) return e;
    winattn_bwd_f32<HDP><<<grid, F32_THREADS, smem, stream>>>(
        static_cast<const float*>(qkv), table, mask, stats, static_cast<const float*>(dout),
        static_cast<float*>(dqkv), part, d);
  } else {
    const size_t smem = bwd_bf16_smem<HDP>();
    e = allow_smem(winattn_bwd_bf16<HDP>, smem, done_bf16, dev);
    if (e != cudaSuccess) return e;
    winattn_bwd_bf16<HDP><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), table, mask, stats, static_cast<const bf16*>(dout),
        static_cast<bf16*>(dqkv), part, d);
  }
  return cudaGetLastError();
}

bool valid(const Dims& d) {
  return d.bn >= 1 && d.w >= 1 && d.w <= 8 && d.n == d.w * d.w && d.h >= 1 && d.h <= 65535 &&
         d.hd >= 8 && d.hd <= 32 && d.hd % 8 == 0 && d.nw >= 1 && d.bn % d.nw == 0;
}

}  // namespace

extern "C" {

// qkv (bn, n, 3, h, hd) bf16 (f32 0) or f32 (1), 16-byte aligned; table
// ((2w-1)^2, h) f32; mask (nw, n, n) f32 or null (nw then 1); out
// (bn, n, h * hd) of qkv's type; stats (bn, h, n, 2) f32, or null to save
// nothing. n = w^2, w <= 8, hd in 8..32 a multiple of 8.
int cosa_window_attn_fwd(const void* qkv, const float* table, const float* mask, void* out,
                         float* stats, int bn, int w, int h, int hd, int nw, float scale,
                         int f32, cudaStream_t stream) {
  const Dims d{bn, w * w, w, h, hd, mask ? nw : 1, scale};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  return (int)(hd <= 16 ? fwd<16>(qkv, table, mask, out, stats, d, f32, stream)
                        : fwd<32>(qkv, table, mask, out, stats, d, f32, stream));
}

// The forward's arguments, its stats, dout (bn, n, h * hd) of qkv's type;
// writes dqkv (bn, n, 3, h, hd) and dtable ((2w-1)^2, h) f32 through part
// (bn, h, (2w-1)^2) f32 scratch.
int cosa_window_attn_bwd(const void* qkv, const float* table, const float* mask,
                         const float* stats, const void* dout, void* dqkv, float* part,
                         float* dtable, int bn, int w, int h, int hd, int nw, float scale,
                         int f32, cudaStream_t stream) {
  const Dims d{bn, w * w, w, h, hd, mask ? nw : 1, scale};
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      hd <= 16 ? bwd<16>(qkv, table, mask, stats, dout, dqkv, part, d, f32, stream)
               : bwd<32>(qkv, table, mask, stats, dout, dqkv, part, d, f32, stream);
  if (e != cudaSuccess) return (int)e;
  const int t = (2 * w - 1) * (2 * w - 1), warps = 8;
  winattn_table_grad<<<(t * h + warps - 1) / warps, 32 * warps, 0, stream>>>(part, dtable, bn, h,
                                                                              t);
  return (int)cudaGetLastError();
}

}  // extern "C"
