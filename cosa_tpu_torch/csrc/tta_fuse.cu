// The teacher TTA's multi-scale x flip fuse (K5), hand-written for Hopper
// (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package leaves this chain
// (objectives/pseudo.py::multi_scale_camseg) to XLA, which fuses it into its
// resize products. In PyTorch it is about 20 library launches a scale, each
// writing or reading a full-crop map in f32.
//
// What it computes, for S scales (at most 8), each with the CAM (2B, h, w, C)
// and the seg logits (2B, h, w, C + 1) of B images and their flips at its
// patch grid, and the last scale's aux CAM, at every output pixel (y, x) of
// the (H, W) crop: each map's bilinear value (torch's align_corners=False
// rule in f32, its products contracted into FMAs as torch's build of the
// CUDA kernel it would run contracts them), the flipped half read at the
// mirrored column W - 1 - x, then
//   cam     = sum_s relu(max(a_s, b_s)), every tap, value and partial sum
//             rounded to the CAM type (bf16 or f32) where the plain path
//             rounds: the taps (the model's f32 CAM is cast before the
//             resize), each interpolated value, each add;
//   seg     = sum_s (a_s + b_s) in f32;
//   cam_aux = relu(max(a, b)) of the last scale's aux CAM, on its own grid
//             (the last scale's with a ViT, twice as fine with Swin);
// and the CAMs min-max normalized per (image, channel) to f32 as
// minmax_norm rounds: round(round(x - mn) / round(round(mx - mn) + 1e-5)).
// On an H100 with torch 2.11 (CUDA 12.8) its outputs equal the plain path's
// bit for bit.
//
// What bounds it on the H100: its floor is the bytes of the full-crop
// outputs. At COCO's training shape (8 x 448 x 448, 80 CAM and 81 seg
// channels, 3 scales) the per-scale maps take about 42 MB and stay in the
// 50 MB L2, while the outputs are 1.5 GB of f32; with the bf16 sums written
// and read once between the two passes the kernels move about 2.6 GB, 0.8 ms
// at 3.35 TB/s. The library chain moves about 35 GB. The design writes each
// output once and keeps every intermediate of the chain in registers. What
// is left is arithmetic: each CAM value takes 8 bilinear samples of 6 FP
// operations plus the roundings, so the fuse pass is bound by its
// instructions (2.65 ms for the pair of passes at COCO, 18% of the 0.47 ms
// that the inputs and outputs alone take).
//  - the fuse pass: a block takes one output row segment of one image, its
//    threads laid out channels-fastest so that a warp's loads and stores run
//    over consecutive channels of consecutive pixels (NHWC), for any channel
//    count, odd ones too. The column taps of every scale, direct and
//    mirrored, are computed once per block into shared memory (and the aux
//    CAM's where its grid is not the last scale's), the row taps once per
//    thread. Each thread walks a run of consecutive pixels of one
//    channel, holding each map's four taps in registers while the run shares
//    them, summing every scale in registers (the scale loop is unrolled: S
//    is a template argument); it stores the CAM sum and aux CAM in the CAM
//    type and keeps their running min and max. The per-channel min and max are reduced
//    over the block, then merged across blocks by atomicMin/atomicMax on
//    the bit patterns, which order as the values do: every value is
//    non-negative (a ReLU sum) and the ReLU gives +0, never -0. The seg
//    logits are a second kernel of the same shape (another channel count);
//  - the normalize pass: 8 consecutive values a thread, read as 16-byte
//    vectors, written as f32 (in place for an f32 sum).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int MAX_SCALES = 8;
// a block's tap tables (two per scale and per aux grid of its own: the direct
// and the mirrored columns) plus its reduction scratch stay inside the 48 KB of shared memory a block
// takes without opting in
constexpr int TABLE_BYTES = 44 * 1024;
constexpr int VEC = 8;  // values a thread of the normalize pass
constexpr float EPS = 1e-5f;  // minmax_norm's eps, as torch casts it

// One axis's taps at an output index: the offsets (in elements) of the near
// and the far source index, and their weights; one 16-byte shared load
struct __align__(16) Tap {
  int o0, o1;
  float l0, l1;
};

struct Scales {
  const float* cam[MAX_SCALES];
  const float* seg[MAX_SCALES];
  int h[MAX_SCALES], w[MAX_SCALES];
  float rh[MAX_SCALES], rw[MAX_SCALES];  // in / out as torch computes it, in f32
  int ah, aw;  // the aux CAM's grid
  float rah, raw;
  int aux_own;  // 1 where that grid is not the last scale's: it takes tables of its own
};

// torch's upsample_bilinear2d (align_corners=False): the source index
// max(scale * (dst + 0.5) - 0.5, 0), its integer part, the far tap clamped
// at the edge, the weights 1 - lambda and lambda
__device__ __forceinline__ Tap make_tap(float scale, int dst, int in_size, int stride) {
  float src = __fmaf_rn(scale, __fadd_rn(dst, 0.5f), -0.5f);
  src = src < 0.f ? 0.f : src;
  const int i0 = static_cast<int>(src);
  const int p = i0 < in_size - 1 ? 1 : 0;
  Tap t;
  t.l1 = src - i0;
  t.l0 = 1.f - t.l1;
  t.o0 = i0 * stride;
  t.o1 = (i0 + p) * stride;
  return t;
}

template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float relu(float v) { return v > 0.f ? v : 0.f; }

// torch's upsample_bilinear2d on the card takes its channels-last kernel
// from this many channels on, its NCHW kernel below
constexpr int NHWC_MIN_CHANNELS = 16;

// h0 * (w0 * v00 + w1 * v01) + h1 * (w0 * v10 + w1 * v11) as torch's build
// of each of its two CUDA kernels contracts it into FMAs (read off their
// outputs bit for bit): the upper row's first product fused into its add in
// the NCHW kernel, its second in the channels-last kernel
template <bool NHWC>
__device__ __forceinline__ float bilerp(const Tap& r, const Tap& c, float v00, float v01,
                                        float v10, float v11) {
  const float up = NHWC ? __fmaf_rn(c.l1, v01, __fmul_rn(c.l0, v00))
                        : __fmaf_rn(c.l0, v00, __fmul_rn(c.l1, v01));
  const float down = __fmaf_rn(c.l0, v10, __fmul_rn(c.l1, v11));
  return __fmaf_rn(r.l0, up, __fmul_rn(r.l1, down));
}

// The four taps of one map around an output pixel's source position,
// rounded to T, and the column tap they were read at: a run of output pixels
// shares them (16 at the 1.0 scale of a 16-pixel patch grid), so a thread
// reads them again only when its column tap moves
struct Quad {
  int key;
  float v00, v01, v10, v11;
};

// The bilinear value at (row r, column c) of the map at p, the taps rounded
// to T first
template <typename T, bool NHWC>
__device__ __forceinline__ float sample(Quad& q, const float* __restrict__ p, const Tap& r,
                                        const Tap& c) {
  if (c.o0 != q.key) {
    q.key = c.o0;
    q.v00 = rnd<T>(__ldg(p + (r.o0 + c.o0)));
    q.v01 = rnd<T>(__ldg(p + (r.o0 + c.o1)));
    q.v10 = rnd<T>(__ldg(p + (r.o1 + c.o0)));
    q.v11 = rnd<T>(__ldg(p + (r.o1 + c.o1)));
  }
  return bilerp<NHWC>(r, c, q.v00, q.v01, q.v10, q.v11);
}

// The direct and mirrored column taps of a grid w wide at scale rw
__device__ __forceinline__ void column_taps(Tap* tab, float rw, int w, int W, int C, int x0,
                                            int nx, int xt) {
  for (int i = threadIdx.x; i < 2 * nx; i += THREADS) {
    const int m = i >= nx, xl = i - m * nx;
    const int x = m ? W - 1 - (x0 + xl) : x0 + xl;
    tab[m * xt + xl] = make_tap(rw, x, w, C);
  }
}

// The block's column taps, tab[(2 s + m) * xt + xl] for its pixels x0 + xl
// (m = 0) and their mirrors W - 1 - x0 - xl (m = 1), in elements of a map
// with C channels; then the thread's row taps. With AUX, the aux CAM's: its
// columns at s = S where its grid is its own, its row tap in `arow`, else
// the last scale's. Ends in a barrier.
template <int S, bool AUX>
__device__ __forceinline__ void tables(Tap* tab, Tap (&rows)[S], Tap& arow, const Scales& sc,
                                       int y, int W, int C, int x0, int nx, int xt) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    column_taps(tab + 2 * s * xt, sc.rw[s], sc.w[s], W, C, x0, nx, xt);
    rows[s] = make_tap(sc.rh[s], y, sc.h[s], sc.w[s] * C);
  }
  if (AUX) {
    if (sc.aux_own) {
      column_taps(tab + 2 * S * xt, sc.raw, sc.aw, W, C, x0, nx, xt);
      arow = make_tap(sc.rah, y, sc.ah, sc.aw * C);
    } else {
      arow = rows[S - 1];
    }
  }
  __syncthreads();
}

// A thread's channel and its run of the block's pixels: the threads walk
// the channels fastest, then the runs
struct Lane {
  int ct, cl, xb, xe;
  bool on;
};

__device__ __forceinline__ Lane lane(int C, int nx) {
  Lane l;
  l.ct = C < THREADS ? C : THREADS;
  const int lanes = THREADS / l.ct, px = threadIdx.x / l.ct;
  const int run = (nx + lanes - 1) / lanes;
  l.cl = threadIdx.x % l.ct;
  l.xb = px * run;
  l.xe = min(nx, l.xb + run);
  l.on = px < lanes;
  return l;
}

// CAM sum and aux CAM of one output row segment: grid (segments, H, B)
template <typename T, int S, bool NHWC>
__global__ void __launch_bounds__(THREADS)
    cam_fuse_kernel(Scales sc, const float* __restrict__ aux, int b, int H, int W, int C,
                    int xt, T* __restrict__ cam, T* __restrict__ cam_aux,
                    unsigned* __restrict__ stats) {
  extern __shared__ Tap tab[];
  __shared__ float red[4][THREADS];
  const int n = blockIdx.z, y = blockIdx.y, x0 = blockIdx.x * xt;
  const int nx = min(xt, W - x0);
  Tap rows[S], arow;
  tables<S, true>(tab, rows, arow, sc, y, W, C, x0, nx, xt);
  const Tap* atab = tab + 2 * (sc.aux_own ? S : S - 1) * xt;  // the aux CAM's columns
  const Lane ln = lane(C, nx);
  for (int cb = 0; cb < C; cb += ln.ct) {
    const int c = cb + ln.cl;
    float mn = INFINITY, mx = 0.f, amn = INFINITY, amx = 0.f;
    if (ln.on && c < C) {
      const float* pa[S];
      const float* pb[S];
      Quad qa[S], qb[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const size_t hw = (size_t)sc.h[s] * sc.w[s] * C;
        pa[s] = sc.cam[s] + n * hw + c;
        pb[s] = sc.cam[s] + (n + b) * hw + c;
        qa[s].key = qb[s].key = -1;
      }
      const size_t ahw = (size_t)sc.ah * sc.aw * C;
      const float* ra = aux + n * ahw + c;
      const float* rb = aux + (n + b) * ahw + c;
      Quad xa, xb;
      xa.key = xb.key = -1;
      const size_t row = (((size_t)n * H + y) * W + x0) * C + c;
      T* out = cam + row;
      T* aout = cam_aux + row;
      for (int xl = ln.xb; xl < ln.xe; ++xl) {
        float sum = 0.f, va, vb;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const Tap* t = tab + 2 * s * xt + xl;  // the pixel's column tap, then its mirror's
          va = rnd<T>(sample<T, NHWC>(qa[s], pa[s], rows[s], t[0]));
          vb = rnd<T>(sample<T, NHWC>(qb[s], pb[s], rows[s], t[xt]));
          sum = rnd<T>(sum + relu(fmaxf(va, vb)));
        }
        const Tap* t = atab + xl;
        va = rnd<T>(sample<T, NHWC>(xa, ra, arow, t[0]));
        vb = rnd<T>(sample<T, NHWC>(xb, rb, arow, t[xt]));
        const float av = relu(fmaxf(va, vb));
        put(out + (size_t)xl * C, sum);
        put(aout + (size_t)xl * C, av);
        mn = fminf(mn, sum);
        mx = fmaxf(mx, sum);
        amn = fminf(amn, av);
        amx = fmaxf(amx, av);
      }
    }
    red[0][threadIdx.x] = mn;
    red[1][threadIdx.x] = mx;
    red[2][threadIdx.x] = amn;
    red[3][threadIdx.x] = amx;
    __syncthreads();
    if (threadIdx.x < ln.ct && c < C) {
      for (int t = threadIdx.x + ln.ct; t < THREADS; t += ln.ct) {
        mn = fminf(mn, red[0][t]);
        mx = fmaxf(mx, red[1][t]);
        amn = fminf(amn, red[2][t]);
        amx = fmaxf(amx, red[3][t]);
      }
      // stats: the CAM's and the aux CAM's min, then their max, each (B, C)
      const int bc = b * C, i = n * C + c;
      atomicMin(stats + i, __float_as_uint(mn));
      atomicMin(stats + bc + i, __float_as_uint(amn));
      atomicMax(stats + 2 * bc + i, __float_as_uint(mx));
      atomicMax(stats + 3 * bc + i, __float_as_uint(amx));
    }
    __syncthreads();
  }
}

// The seg logits' f32 sum of one output row segment: grid (segments, H, B)
template <int S, bool NHWC>
__global__ void __launch_bounds__(THREADS)
    seg_fuse_kernel(Scales sc, int b, int H, int W, int C, int xt, float* __restrict__ seg) {
  extern __shared__ Tap tab[];
  const int n = blockIdx.z, y = blockIdx.y, x0 = blockIdx.x * xt;
  const int nx = min(xt, W - x0);
  Tap rows[S], arow;
  tables<S, false>(tab, rows, arow, sc, y, W, C, x0, nx, xt);
  const Lane ln = lane(C, nx);
  if (!ln.on) return;
  for (int c = ln.cl; c < C; c += ln.ct) {
    const float* pa[S];
    const float* pb[S];
    Quad qa[S], qb[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const size_t hw = (size_t)sc.h[s] * sc.w[s] * C;
      pa[s] = sc.seg[s] + n * hw + c;
      pb[s] = sc.seg[s] + (n + b) * hw + c;
      qa[s].key = qb[s].key = -1;
    }
    float* out = seg + (((size_t)n * H + y) * W + x0) * C + c;
    for (int xl = ln.xb; xl < ln.xe; ++xl) {
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const Tap* t = tab + 2 * s * xt + xl;
        sum = sum + (sample<float, NHWC>(qa[s], pa[s], rows[s], t[0]) +
                     sample<float, NHWC>(qb[s], pb[s], rows[s], t[xt]));
      }
      out[(size_t)xl * C] = sum;
    }
  }
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(e[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// f32 sums may be normalized in place, so no read-only path
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 c = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = c.x, v[5] = c.y, v[6] = c.z, v[7] = c.w;
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// The CAM (blockIdx.y 0) or aux CAM (1) sum in T -> f32 minmax_norm, VEC
// consecutive values a thread; the maps hold `total` values, `per_img` an image
template <typename T>
__global__ void __launch_bounds__(THREADS)
    norm_kernel(const T* cam, const T* aux, float* cam_out, float* aux_out,
                const unsigned* __restrict__ stats, int b, int C, int per_img, long long total) {
  const T* x = blockIdx.y ? aux : cam;
  float* out = blockIdx.y ? aux_out : cam_out;
  const unsigned* lo = stats + blockIdx.y * b * C;
  const unsigned* hi = stats + (2 + blockIdx.y) * b * C;
  const long long e = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (e >= total) return;
  int n = (int)(e / per_img);
  int r = (int)(e - (long long)n * per_img);
  int c = r % C;
  const int m = total - e < VEC ? (int)(total - e) : VEC;
  float v[VEC];
  if (m == VEC) {
    load8(x + e, v);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = j < m ? to_float(x[e + j]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const int i = min(n, b - 1) * C + c;  // past the last value: any slot
    const float mn = __uint_as_float(__ldg(lo + i));
    const float mx = __uint_as_float(__ldg(hi + i));
    const float den = rnd<T>(rnd<T>(mx - mn) + EPS);
    v[j] = rnd<T>(rnd<T>(v[j] - mn) / den);
    if (++c == C) c = 0;
    if (++r == per_img) r = 0, ++n;
  }
  if (m == VEC) {
    float4* o = reinterpret_cast<float4*>(out + e);
    o[0] = make_float4(v[0], v[1], v[2], v[3]);
    o[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (j < m) out[e + j] = v[j];
  }
}

struct Args {
  Scales sc;
  const float* aux;
  int b, H, W, c_cam, c_seg;
  void *cam_tmp, *aux_tmp, *seg_out, *cam_out, *aux_out;
  unsigned* stats;
};

// one row in segments of at most xt_max pixels, as even as they come, for
// `grids` tap tables
inline int segment(int W, int grids, int* nseg) {
  const int xt_max = TABLE_BYTES / (2 * grids * (int)sizeof(Tap));
  *nseg = (W + xt_max - 1) / xt_max;
  return (W + *nseg - 1) / *nseg;
}

template <typename T, int S>
int launch(const Args& a, cudaStream_t stream) {
  int nseg = 0;
  const int grids = S + a.sc.aux_own;
  const int xt = segment(a.W, grids, &nseg);
  const size_t smem = (size_t)2 * S * xt * sizeof(Tap);  // the seg kernel's
  const dim3 grid(nseg, a.H, a.b);
  auto cam_fuse = a.c_cam >= NHWC_MIN_CHANNELS ? cam_fuse_kernel<T, S, true>
                                               : cam_fuse_kernel<T, S, false>;
  cam_fuse<<<grid, THREADS, (size_t)2 * grids * xt * sizeof(Tap), stream>>>(a.sc, a.aux, a.b, a.H, a.W, a.c_cam, xt,
                                            static_cast<T*>(a.cam_tmp),
                                            static_cast<T*>(a.aux_tmp), a.stats);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  auto seg_fuse = a.c_seg >= NHWC_MIN_CHANNELS ? seg_fuse_kernel<S, true>
                                               : seg_fuse_kernel<S, false>;
  seg_fuse<<<grid, THREADS, smem, stream>>>(a.sc, a.b, a.H, a.W, a.c_seg, xt,
                                            static_cast<float*>(a.seg_out));
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  const int per_img = a.H * a.W * a.c_cam;
  const long long total = (long long)a.b * per_img;
  const long long groups = (total + VEC - 1) / VEC;
  const dim3 ngrid((unsigned)((groups + THREADS - 1) / THREADS), 2);
  norm_kernel<T><<<ngrid, THREADS, 0, stream>>>(
      static_cast<const T*>(a.cam_tmp), static_cast<const T*>(a.aux_tmp),
      static_cast<float*>(a.cam_out), static_cast<float*>(a.aux_out), a.stats, a.b, a.c_cam,
      per_img, total);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scales(int n, const Args& a, cudaStream_t stream) {
  switch (n) {
    case 1: return launch<T, 1>(a, stream);
    case 2: return launch<T, 2>(a, stream);
    case 3: return launch<T, 3>(a, stream);
    case 4: return launch<T, 4>(a, stream);
    case 5: return launch<T, 5>(a, stream);
    case 6: return launch<T, 6>(a, stream);
    case 7: return launch<T, 7>(a, stream);
    case 8: return launch<T, 8>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// cams[s], segs[s]: scale s's (2b, grid[2s], grid[2s+1], c_cam) CAM and
// (.., c_seg) seg logits, f32; aux the last scale's (2b, aux_h, aux_w, c_cam)
// aux CAM.
// Writes seg_out (b, H, W, c_seg) f32 and cam_out, aux_out (b, H, W, c_cam)
// f32, through the sums cam_tmp, aux_tmp (b, H, W, c_cam) in bf16 (cam_f32
// 0) or f32 (1; then cam_out, aux_out may be cam_tmp, aux_tmp), and stats
// (4, b, c_cam) 32-bit scratch, on the current device. Every output below
// 2^31 values; H, b at most 65535.
int cosa_tta_fuse(const void* const* cams, const void* const* segs, const int* grid,
                  int n_scales, const void* aux, int aux_h, int aux_w, int b, int H, int W,
                  int c_cam, int c_seg,
                  int cam_f32, void* cam_tmp, void* aux_tmp, void* seg_out, void* cam_out,
                  void* aux_out, void* stats, cudaStream_t stream) {
  if (n_scales < 1 || n_scales > MAX_SCALES || b < 1 || b > 65535 || H < 1 || H > 65535 ||
      W < 1 || c_cam < 1 || c_seg < 1 || aux_h < 1 || aux_w < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  for (int s = 0; s < n_scales; ++s) {
    const int h = grid[2 * s], w = grid[2 * s + 1];
    if (h < 1 || w < 1) return (int)cudaErrorInvalidValue;
    a.sc.cam[s] = static_cast<const float*>(cams[s]);
    a.sc.seg[s] = static_cast<const float*>(segs[s]);
    a.sc.h[s] = h;
    a.sc.w[s] = w;
    a.sc.rh[s] = static_cast<float>(h) / H;
    a.sc.rw[s] = static_cast<float>(w) / W;
  }
  a.sc.ah = aux_h;
  a.sc.aw = aux_w;
  a.sc.rah = static_cast<float>(aux_h) / H;
  a.sc.raw = static_cast<float>(aux_w) / W;
  a.sc.aux_own = aux_h != a.sc.h[n_scales - 1] || aux_w != a.sc.w[n_scales - 1];
  a.aux = static_cast<const float*>(aux);
  a.b = b, a.H = H, a.W = W, a.c_cam = c_cam, a.c_seg = c_seg;
  a.cam_tmp = cam_tmp, a.aux_tmp = aux_tmp, a.seg_out = seg_out;
  a.cam_out = cam_out, a.aux_out = aux_out;
  a.stats = static_cast<unsigned*>(stats);
  // min slots to all ones (above every non-negative f32's bits), max to 0
  const size_t half = (size_t)2 * b * c_cam * sizeof(unsigned);
  if (cudaError_t err = cudaMemsetAsync(stats, 0xFF, half, stream)) return (int)err;
  if (cudaError_t err = cudaMemsetAsync(static_cast<char*>(stats) + half, 0, half, stream))
    return (int)err;
  if (cam_f32) return launch_scales<float>(n_scales, a, stream);
  return launch_scales<bf16>(n_scales, a, stream);
}

}  // extern "C"
