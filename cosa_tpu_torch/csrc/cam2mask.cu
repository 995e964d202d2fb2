// CAM -> hard pseudo mask (K8, objectives/pseudo.py::cam2mask), hand-written
// for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the JAX package leaves this chain to XLA. In
// PyTorch it is about 20 library launches a call, and each of its two
// threshold passes writes and reads maps of all C channels in f32 at the
// full crop.
//
// What it computes, for B images of (H, W) CAMs with K = C - 1 classes and
// the two background thresholds (high, low), as the plain chain
// (kernels/cam2mask.py::plain_cam2mask) computes it:
//   logits  the background channel T(thr) before the K CAM channels, in the
//           CAM type T (bf16 or f32); bilinearly resized to (h, w) (torch's
//           align_corners=False rule in f32, its products contracted into
//           FMAs as torch's build of the CUDA kernel it would run contracts
//           them) and rounded to T; an absent class set to T(-1e5);
//   probs   their f32 softmax over the C channels, as torch's persistent
//           softmax sums it: lane l of ws = min(2^ceil(log2 C), 32) holds
//           the channels l + i ws and sums them in i's order, then the lanes
//           are summed by xor shuffles from ws / 2 down;
//   label   the first channel of the largest bilinear value of the probs at
//           the output pixel (f32, the same rule), for each threshold; then
//           high 0 -> ignore, both 0 -> 0, outside img_box -> ignore.
// With (h, w) = (H, W) neither resize runs. The two passes share the CAM
// reads and every resize tap; they differ only in the background channel.
//
// What bounds it on the H100: its floor is the bytes of the CAMs read once
// and the labels written once (8 x 448^2 x 80 f32 and int32 at COCO's
// training shape: 0.52 GB, 0.16 ms at 3.35 TB/s), but the labels need far
// less. An absent class's logit is the same constant T(-1e5), so every
// absent channel of a pixel has the same probability, and the argmax over
// all C channels equals the argmax over the background, the present classes
// and the first absent class, taken in channel order (ties keep the first).
// The kernel reads the present classes' CAMs alone (3.5 of 80 a COCO image)
// and interpolates those few channels at the full crop. The design:
//  - the fused pass (no refine step): a block owns a tile of up to 32 x 32
//    output pixels of one image. Warp 0 lists the image's channels that can
//    win (the background, the present classes, the first absent one). Each
//    warp then takes pixels of the low-res region under the tile (the
//    tile's taps and a one-pixel halo) and computes both softmaxes there
//    from the full-crop CAMs with the listed channels packed over its lanes
//    (one lane a channel: the loads, exps and divisions of the present
//    classes alone), keeping their probabilities in shared memory, 16
//    channels at a time. Each thread then takes up to 4 output pixels and
//    carries both thresholds' running argmaxes over the chunks; then the
//    merge, the box and one int32 store. No map of C channels is written at
//    any resolution;
//  - with a refine step (PAR), two launches: the first writes both
//    thresholds' low-res f32 probabilities of all C channels, the caller
//    refines them, the second interpolates them (all channels: the refine
//    step may set absent classes apart) and takes the argmaxes and the
//    merge, as the fused pass does.
// On an H100 with torch 2.11 (CUDA 12.8) its labels equal the plain chain's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <tuple>
#include <vector>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_C = 256;  // 32 lanes x 8 values a lane
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e5f;  // the logit of an absent class (seg_helper.py:565)
// torch's upsample_bilinear2d on the card takes its channels-last kernel
// from this many channels on, its NCHW kernel below
constexpr int NHWC_MIN_CHANNELS = 16;
// the most shared memory a block may take (the H100's opt-in limit)
constexpr int MAX_SMEM = 227 * 1024;
// listed channels a chunk of the label pass (kernels/cam2mask.py::CHUNK)
constexpr int CHUNK = 16;
// output pixels a thread of the label pass: a tile holds at most PX x THREADS
constexpr int PX = 4;

// One axis's taps at an output index: the near and the far source index
// and their weights
struct Tap {
  int i0, i1;
  float l0, l1;
};

// torch's upsample_bilinear2d (align_corners=False): the source index
// max(scale * (dst + 0.5) - 0.5, 0), its integer part, the far tap clamped
// at the edge, the weights 1 - lambda and lambda
__device__ __forceinline__ Tap make_tap(float scale, int dst, int in_size) {
  float src = __fmaf_rn(scale, __fadd_rn(dst, 0.5f), -0.5f);
  src = src < 0.f ? 0.f : src;
  Tap t;
  t.i0 = static_cast<int>(src);
  t.i1 = t.i0 + (t.i0 < in_size - 1 ? 1 : 0);
  t.l1 = src - t.i0;
  t.l0 = 1.f - t.l1;
  return t;
}

// h0 * (w0 * v00 + w1 * v01) + h1 * (w0 * v10 + w1 * v11) as torch's build
// of each of its two CUDA kernels contracts it into FMAs (csrc/tta_fuse.cu)
template <bool NHWC>
__device__ __forceinline__ float bilerp(const Tap& r, const Tap& c, float v00, float v01,
                                        float v10, float v11) {
  const float up = NHWC ? __fmaf_rn(c.l1, v01, __fmul_rn(c.l0, v00))
                        : __fmaf_rn(c.l0, v00, __fmul_rn(c.l1, v01));
  const float down = __fmaf_rn(c.l0, v10, __fmul_rn(c.l1, v11));
  return __fmaf_rn(r.l0, up, __fmul_rn(r.l1, down));
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

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(__ldg(p)); }

struct Params {
  const void* cams;        // (B, H, W, C - 1) of T
  const float* labels;     // (B, C - 1), 0 where a class is absent
  const void* box;         // (B, 4) [h0, h1, w0, w1], int32 (box64 0) or int64 (1)
  int box64;
  const float* thr_ptr[2];  // the high and the low threshold on the device, or null:
  float thr[2];             // then these
  const float* probs[2];    // the refined low-res probabilities (the label pass after PAR)
  float* probs_out[2];      // the low-res probabilities (the pass before PAR)
  int* out;                 // (B, H, W) int32 labels
  int B, H, W, C, h, w;
  float dsh, dsw, ush, usw;  // torch's scales of the resizes: H / h, W / w, h / H, w / W
  int resize;                // (h, w) != (H, W)
  int ws;                    // the softmax's lanes
  int ignore;
  int ty, tx, ry, rx;  // the output tile and the capacity of its low-res region
};

// The listed channels' probabilities under both thresholds (high, low) at
// low-res pixel (ly, lx) of image n, by one warp. Listed slot s = lane + 32 q
// (q < WI) holds channel act[s] (s < na); every unlisted channel is absent
// and has the listed first absent one's logit. The sum is torch's persistent
// softmax's: lane l < ws adds the exps of channels l + i ws in i's order
// (gathered from the slots by shuffles, an unlisted one's being the absent
// exp), then the lanes are summed by xor shuffles from ws / 2 down. Returns
// the probabilities in ph[q], pl[q] for s < na.
template <typename T, int WI, bool NHWC>
__device__ __forceinline__ void pixel_softmax(const Params& p, const int* act, const int* slot,
                                              int na, int n, int ly, int lx, float (&ph)[WI],
                                              float (&pl)[WI]) {
  const int lane = threadIdx.x & 31, K = p.C - 1;
  Tap r, c;
  if (p.resize) {
    r = make_tap(p.dsh, ly, p.H);
    c = make_tap(p.dsw, lx, p.W);
  }
  const T* cams = static_cast<const T*>(p.cams) + (size_t)n * p.H * p.W * K;
  const float* lab = p.labels + (size_t)n * K;
  const float neg = rnd<T>(NEG);
  float mh = -INFINITY, ml = -INFINITY;
#pragma unroll
  for (int q = 0; q < WI; ++q) {
    const int s = lane + 32 * q;
    float xh = -INFINITY, xl = -INFINITY;
    if (s < na) {
      const int ch = act[s];
      if (ch == 0) {
        // the background: T(thr), a constant map, resized like the others
        for (int k = 0; k < 2; ++k) {
          const float b = rnd<T>(p.thr_ptr[k] ? *p.thr_ptr[k] : p.thr[k]);
          const float x = p.resize ? rnd<T>(bilerp<NHWC>(r, c, b, b, b, b)) : b;
          (k ? xl : xh) = x;
        }
      } else if (__ldg(lab + ch - 1) == 0.f) {
        xh = xl = neg;
      } else {
        const T* a = cams + (ch - 1);
        xh = xl = p.resize ? rnd<T>(bilerp<NHWC>(r, c, ld(a + ((size_t)r.i0 * p.W + c.i0) * K),
                                                 ld(a + ((size_t)r.i0 * p.W + c.i1) * K),
                                                 ld(a + ((size_t)r.i1 * p.W + c.i0) * K),
                                                 ld(a + ((size_t)r.i1 * p.W + c.i1) * K)))
                           : ld(a + ((size_t)ly * p.W + lx) * K);
      }
    }
    ph[q] = xh;
    pl[q] = xl;
    mh = mh < xh ? xh : mh;
    ml = ml < xl ? xl : ml;
  }
  // the max over every channel is the max over the listed ones
  for (int off = 16; off > 0; off /= 2) {
    const float oh = __shfl_xor_sync(FULL, mh, off), ol = __shfl_xor_sync(FULL, ml, off);
    mh = mh < oh ? oh : mh;
    ml = ml < ol ? ol : ml;
  }
#pragma unroll
  for (int q = 0; q < WI; ++q) {
    ph[q] = expf(ph[q] - mh);
    pl[q] = expf(pl[q] - ml);
  }
  const float ah = expf(neg - mh), al = expf(neg - ml);  // an unlisted channel's
  float sh = 0.f, sl = 0.f;
#pragma unroll
  for (int i = 0; i < WI; ++i) {
    const int ch = lane + i * p.ws;
    const bool on = lane < p.ws && ch < p.C;
    const int at = on ? slot[ch] : -1;
    const int src = at < 0 ? 0 : (at & 31);
    float vh = ah, vl = al;
#pragma unroll
    for (int q = 0; q < WI; ++q) {
      if (32 * q < na) {  // the same for every lane
        const float th = __shfl_sync(FULL, ph[q], src), tl = __shfl_sync(FULL, pl[q], src);
        if (at >= 0 && (at >> 5) == q) vh = th, vl = tl;
      }
    }
    if (on) sh += vh, sl += vl;  // torch adds +0 past the last channel
  }
  for (int off = p.ws / 2; off > 0; off /= 2) {
    sh += __shfl_xor_sync(FULL, sh, off);
    sl += __shfl_xor_sync(FULL, sl, off);
  }
  sh = __shfl_sync(FULL, sh, 0);
  sl = __shfl_sync(FULL, sl, 0);
#pragma unroll
  for (int q = 0; q < WI; ++q) {
    if (32 * q < na) {
      ph[q] = ph[q] / sh;
      pl[q] = pl[q] / sl;
    }
  }
}

// Every channel listed, in order (the probabilities' pass, the label pass
// after a refine step); returns the count
__device__ __forceinline__ int list_all(int* act, int* slot, int C) {
  for (int ch = threadIdx.x; ch < C; ch += THREADS) act[ch] = slot[ch] = ch;
  return C;
}

// The channels of image n that can win, ascending, into act, and each
// channel's place there (or -1) into slot, by warp 0; returns the count
__device__ __forceinline__ int list_winners(const Params& p, int n, int* act, int* slot) {
  const int lane = threadIdx.x & 31;
  int count = 0;
  bool absent_seen = false;
  for (int base = 0; base < p.C; base += 32) {
    const int ch = base + lane;
    const bool on = ch < p.C;
    const bool absent = on && ch > 0 && __ldg(p.labels + (size_t)n * (p.C - 1) + ch - 1) == 0.f;
    const unsigned am = __ballot_sync(FULL, absent);
    bool first_absent = false;
    if (!absent_seen && am) {
      first_absent = lane == __ffs(am) - 1;
      absent_seen = true;
    }
    const bool listed = on && (!absent || first_absent);
    const unsigned lm = __ballot_sync(FULL, listed);
    const int s = count + __popc(lm & ((1u << lane) - 1));
    if (on) slot[ch] = listed ? s : -1;
    if (listed) act[s] = ch;
    count += __popc(lm);
  }
  return count;
}

// The pass before a refine step: both thresholds' low-res probabilities of
// every channel, (B, h, w, C) f32 each; a warp a low-res pixel, grid
// (pixel groups, B)
template <typename T, int WI, bool NHWC>
__global__ void __launch_bounds__(THREADS) probs_kernel(Params p) {
  __shared__ int act[MAX_C], slot[MAX_C];
  const int na = list_all(act, slot, p.C);
  __syncthreads();
  const int n = blockIdx.y, px = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (px >= p.h * p.w) return;  // a whole warp leaves
  const int lane = threadIdx.x & 31, ly = px / p.w, lx = px - ly * p.w;
  float ph[WI], pl[WI];
  pixel_softmax<T, WI, NHWC>(p, act, slot, na, n, ly, lx, ph, pl);
  const size_t at = ((size_t)n * p.h * p.w + px) * p.C;
#pragma unroll
  for (int q = 0; q < WI; ++q) {
    const int ch = lane + 32 * q;
    if (ch < p.C) {
      p.probs_out[0][at + ch] = ph[q];
      p.probs_out[1][at + ch] = pl[q];
    }
  }
}

// The label pass: one output tile of one image, grid (tiles across, tiles
// down, B). The listed channels go through shared memory CHUNK at a time:
// each chunk's low-res probabilities over the tile's region (FROM_PROBS:
// read from p.probs, every channel listed; else computed from the CAMs,
// the fused pass), then each thread's pixels' running argmaxes over them.
template <typename T, int WI, bool NHWC, bool FROM_PROBS>
__global__ void __launch_bounds__(THREADS) label_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ int act[MAX_C];   // the channels that can win, ascending
  __shared__ int slot[MAX_C];  // a channel's place in act, or -1
  __shared__ int n_act;
  const int n = blockIdx.z, y0 = blockIdx.y * p.ty, x0 = blockIdx.x * p.tx;
  const int y1 = min(y0 + p.ty, p.H) - 1, x1 = min(x0 + p.tx, p.W) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the low-res region under the tile: every tap of its pixels
  int ry0 = y0, ry1 = y1, rx0 = x0, rx1 = x1;
  if (p.resize) {
    ry0 = make_tap(p.ush, y0, p.h).i0;
    ry1 = make_tap(p.ush, y1, p.h).i1;
    rx0 = make_tap(p.usw, x0, p.w).i0;
    rx1 = make_tap(p.usw, x1, p.w).i1;
  }
  const int nry = ry1 - ry0 + 1, nrx = rx1 - rx0 + 1, npx = nry * nrx;
  if (nry > p.ry || nrx > p.rx) __trap();  // the wrapper's capacity is short

  if constexpr (FROM_PROBS) {
    if (threadIdx.x == 0) n_act = p.C;
    list_all(act, slot, p.C);
  } else if (warp == 0) {
    const int count = list_winners(p, n, act, slot);
    if (lane == 0) n_act = count;
  }
  __syncthreads();
  const int na = n_act, cs = min(na, CHUNK) | 1;  // odd: a warp's pixels on distinct banks
  float* sh = smem;                               // (region pixel, chunk slot), high threshold
  float* sl = smem + (size_t)p.ry * p.rx * cs;

  int best_h[PX], best_l[PX];
  float top_h[PX], top_l[PX];
  for (int base = 0; base < na; base += CHUNK) {
    const int nc = min(CHUNK, na - base);
    if (base) __syncthreads();  // the last chunk's readers are done
    if constexpr (FROM_PROBS) {
      for (int i = threadIdx.x; i < npx * nc; i += THREADS) {
        const int k = i / nc, j = i - k * nc;
        const int ly = ry0 + k / nrx, lx = rx0 + k % nrx;
        const size_t at = (((size_t)n * p.h + ly) * p.w + lx) * p.C + base + j;
        sh[k * cs + j] = __ldg(p.probs[0] + at);
        sl[k * cs + j] = __ldg(p.probs[1] + at);
      }
    } else {
      for (int k = warp; k < npx; k += WARPS) {
        float ph[WI], pl[WI];
        pixel_softmax<T, WI, NHWC>(p, act, slot, na, n, ry0 + k / nrx, rx0 + k % nrx, ph, pl);
#pragma unroll
        for (int q = 0; q < WI; ++q) {
          const int j = lane + 32 * q - base;
          if (j >= 0 && j < nc) {
            sh[k * cs + j] = ph[q];
            sl[k * cs + j] = pl[q];
          }
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PX; ++u) {
      const int q = threadIdx.x + u * THREADS;
      const int y = y0 + q / p.tx, x = x0 + q % p.tx;
      if (q >= p.ty * p.tx || y > y1 || x > x1) continue;
      float vh = top_h[u], vl = top_l[u];
      int bh = best_h[u], bl = best_l[u];
      if (p.resize) {
        const Tap r = make_tap(p.ush, y, p.h), c = make_tap(p.usw, x, p.w);
        const int k00 = (r.i0 - ry0) * nrx + (c.i0 - rx0), k01 = k00 + (c.i1 - c.i0);
        const int k10 = k00 + (r.i1 - r.i0) * nrx, k11 = k10 + (c.i1 - c.i0);
        for (int j = 0; j < nc; ++j) {
          const float a = bilerp<NHWC>(r, c, sh[k00 * cs + j], sh[k01 * cs + j],
                                       sh[k10 * cs + j], sh[k11 * cs + j]);
          const float d = bilerp<NHWC>(r, c, sl[k00 * cs + j], sl[k01 * cs + j],
                                       sl[k10 * cs + j], sl[k11 * cs + j]);
          // the first maximum: slot 0 (the background) starts each argmax
          if (base + j == 0 || a > vh) vh = a, bh = act[base + j];
          if (base + j == 0 || d > vl) vl = d, bl = act[base + j];
        }
      } else {
        const int k = (y - ry0) * nrx + (x - rx0);
        for (int j = 0; j < nc; ++j) {
          const float a = sh[k * cs + j], d = sl[k * cs + j];
          if (base + j == 0 || a > vh) vh = a, bh = act[base + j];
          if (base + j == 0 || d > vl) vl = d, bl = act[base + j];
        }
      }
      top_h[u] = vh, top_l[u] = vl, best_h[u] = bh, best_l[u] = bl;
    }
  }

  long long b[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    b[j] = p.box64 ? __ldg(static_cast<const long long*>(p.box) + 4 * n + j)
                   : (long long)__ldg(static_cast<const int*>(p.box) + 4 * n + j);
  const long long h0 = b[0] < 0 ? b[0] + p.H : b[0], h1 = b[1] < 0 ? b[1] + p.H : b[1];
  const long long w0 = b[2] < 0 ? b[2] + p.W : b[2], w1 = b[3] < 0 ? b[3] + p.W : b[3];
#pragma unroll
  for (int u = 0; u < PX; ++u) {
    const int q = threadIdx.x + u * THREADS;
    const int y = y0 + q / p.tx, x = x0 + q % p.tx;
    if (q >= p.ty * p.tx || y > y1 || x > x1) continue;
    int label = best_h[u] == 0 ? p.ignore : best_h[u];
    if (best_h[u] + best_l[u] == 0) label = 0;
    if (!(y >= h0 && y < h1 && x >= w0 && x < w1)) label = p.ignore;
    p.out[((size_t)n * p.H + y) * p.W + x] = label;
  }
}

// the label pass's shared memory: both thresholds' (region pixel, chunk
// slot) probabilities at the widest stride
inline size_t label_smem(const Params& p) {
  return (size_t)2 * p.ry * p.rx * ((p.C < CHUNK ? p.C : CHUNK) | 1) * sizeof(float);
}

// Lets `fn` take `bytes` of dynamic shared memory on the current device,
// once a kernel, device and size (so never inside a CUDA graph's capture
// after the first call)
cudaError_t allow_smem(const void* fn, size_t bytes) {
  static std::mutex mu;
  static std::vector<std::tuple<const void*, int, size_t>> done;
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& [f, d, b] : done)
    if (f == fn && d == dev && b >= bytes) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done.emplace_back(fn, dev, bytes);
  return err;
}

template <typename K>
int launch_label(K kernel, const Params& p, cudaStream_t stream) {
  const size_t smem = label_smem(p);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel), smem)) return (int)err;
  const dim3 grid((p.W + p.tx - 1) / p.tx, (p.H + p.ty - 1) / p.ty, p.B);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int WI, bool NHWC>
int launch_wi(const Params& p, bool probs_pass, cudaStream_t stream) {
  if (probs_pass) {
    const dim3 grid((p.h * p.w + WARPS - 1) / WARPS, p.B);
    probs_kernel<T, WI, NHWC><<<grid, THREADS, 0, stream>>>(p);
    return (int)cudaGetLastError();
  }
  return launch_label(label_kernel<T, WI, NHWC, false>, p, stream);
}

template <typename T, bool NHWC>
int launch_t(const Params& p, bool probs_pass, cudaStream_t stream) {
  switch ((p.C + 31) / 32) {
    case 1: return launch_wi<T, 1, NHWC>(p, probs_pass, stream);
    case 2: return launch_wi<T, 2, NHWC>(p, probs_pass, stream);
    case 3:
    case 4: return launch_wi<T, 4, NHWC>(p, probs_pass, stream);
    default: return launch_wi<T, 8, NHWC>(p, probs_pass, stream);
  }
}

int fill(Params& p, const void* cams, int cams_f32, const void* labels, const void* box,
         int box64, const void* thr_hi_ptr, const void* thr_lo_ptr, float thr_hi, float thr_lo,
         int B, int H, int W, int C, int h, int w, int ignore, int ty, int tx, int ry, int rx) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 2 || C > MAX_C || h < 1 || w < 1 ||
      h > H || w > W || ty < 1 || tx < 1 || ty * tx > PX * THREADS || ry < 1 || rx < 1 ||
      (H + ty - 1) / ty > 65535)
    return (int)cudaErrorInvalidValue;
  p.cams = cams;
  p.labels = static_cast<const float*>(labels);
  p.box = box;
  p.box64 = box64;
  p.thr_ptr[0] = static_cast<const float*>(thr_hi_ptr);
  p.thr_ptr[1] = static_cast<const float*>(thr_lo_ptr);
  p.thr[0] = thr_hi;
  p.thr[1] = thr_lo;
  p.probs[0] = p.probs[1] = nullptr;
  p.probs_out[0] = p.probs_out[1] = nullptr;
  p.out = nullptr;
  p.B = B, p.H = H, p.W = W, p.C = C, p.h = h, p.w = w;
  p.dsh = static_cast<float>(H) / h;
  p.dsw = static_cast<float>(W) / w;
  p.ush = static_cast<float>(h) / H;
  p.usw = static_cast<float>(w) / W;
  p.resize = h != H || w != W;
  int np2 = 1;
  while (np2 < C) np2 *= 2;
  p.ws = np2 < 32 ? np2 : 32;
  p.ignore = ignore;
  p.ty = ty, p.tx = tx, p.ry = ry, p.rx = rx;
  return 0;
}

}  // namespace

extern "C" {

// cams (B, H, W, C - 1) bf16 (cams_f32 0) or f32 (1); labels (B, C - 1) f32;
// box (B, 4) int32 (box64 0) or int64 (1); each threshold a device f32
// pointer or, where that is null, the float beside it; (h, w) the low-res
// grid; ty x tx the output tile a block, ry x rx the most low-res pixels
// under a tile (kernels/cam2mask.py::plan). Writes out (B, H, W) int32.
int cosa_cam2mask(const void* cams, int cams_f32, const void* labels, const void* box, int box64,
                  const void* thr_hi_ptr, const void* thr_lo_ptr, float thr_hi, float thr_lo,
                  int B, int H, int W, int C, int h, int w, int ignore, int ty, int tx, int ry,
                  int rx, void* out, cudaStream_t stream) {
  Params p;
  if (int err = fill(p, cams, cams_f32, labels, box, box64, thr_hi_ptr, thr_lo_ptr, thr_hi,
                     thr_lo, B, H, W, C, h, w, ignore, ty, tx, ry, rx))
    return err;
  p.out = static_cast<int*>(out);
  const bool nhwc = C >= NHWC_MIN_CHANNELS;
  if (cams_f32) return nhwc ? launch_t<float, true>(p, false, stream)
                            : launch_t<float, false>(p, false, stream);
  return nhwc ? launch_t<bf16, true>(p, false, stream) : launch_t<bf16, false>(p, false, stream);
}

// The pass before a refine step: writes probs_hi, probs_lo (B, h, w, C) f32
// from the arguments of cosa_cam2mask (the tile arguments unused)
int cosa_cam2mask_probs(const void* cams, int cams_f32, const void* labels,
                        const void* thr_hi_ptr, const void* thr_lo_ptr, float thr_hi,
                        float thr_lo, int B, int H, int W, int C, int h, int w, void* probs_hi,
                        void* probs_lo, cudaStream_t stream) {
  Params p;
  if (int err = fill(p, cams, cams_f32, labels, nullptr, 0, thr_hi_ptr, thr_lo_ptr, thr_hi,
                     thr_lo, B, H, W, C, h, w, 0, 1, 1, 1, 1))
    return err;
  p.probs_out[0] = static_cast<float*>(probs_hi);
  p.probs_out[1] = static_cast<float*>(probs_lo);
  const bool nhwc = C >= NHWC_MIN_CHANNELS;
  if (cams_f32) return nhwc ? launch_t<float, true>(p, true, stream)
                            : launch_t<float, false>(p, true, stream);
  return nhwc ? launch_t<bf16, true>(p, true, stream) : launch_t<bf16, false>(p, true, stream);
}

// The label pass after a refine step: probs_hi, probs_lo (B, h, w, C) f32,
// interpolated as torch's channels-last kernel does (nhwc 1: the refined
// maps were channels-last and C >= 16) or its NCHW kernel (0); the rest as
// cosa_cam2mask's. Writes out (B, H, W) int32
int cosa_cam2mask_from_probs(const void* probs_hi, const void* probs_lo, int nhwc,
                             const void* box, int box64, int B, int H, int W, int C, int h,
                             int w, int ignore, int ty, int tx, int ry, int rx, void* out,
                             cudaStream_t stream) {
  Params p;
  if (int err = fill(p, nullptr, 1, nullptr, box, box64, nullptr, nullptr, 0.f, 0.f, B, H, W,
                     C, h, w, ignore, ty, tx, ry, rx))
    return err;
  p.probs[0] = static_cast<const float*>(probs_hi);
  p.probs[1] = static_cast<const float*>(probs_lo);
  p.out = static_cast<int*>(out);
  if (nhwc) return launch_label(label_kernel<float, 1, true, true>, p, stream);
  return launch_label(label_kernel<float, 1, false, true>, p, stream);
}

}  // extern "C"
