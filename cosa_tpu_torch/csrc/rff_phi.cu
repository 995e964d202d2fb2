// Random-Fourier-feature embedding phi = scale * cos(f W + b) (K3),
// hand-written for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas kernel cosa_tpu/kernels/rff.py
// (_phi_kernel via rff_phi, called from ops/bilateral.py::rff_embed).
//
// What it computes: for every pixel row n and feature d,
//   phi[n, d] = scale * cos(b[d] + sum_i f[n, i] * W[i, d])   (i < 5)
// and stores it as bf16 (the mixed-precision path) or f32, as the Pallas
// kernel's dtype argument does. The projection is 5 true f32 FMAs in the
// order the TPU kernel adds them (no tensor core, no TF32): phases span
// tens of radians, and a reduced-precision product aliases them. The cosine
// is the TPU kernel's own (cosa_tpu/kernels/rff.py::_cos_poly): a range
// reduction r = p - 2 pi k with k = p / (2 pi) rounded half to even, then a
// degree-5 polynomial in u = r^2, fitted on [0, pi^2] (max error 1.9e-6 at
// |p| <= pi, 1.1e-5 at |p| <= 150 with the f32 reduction, before the
// scale: decades under the bf16 output's quantum). The caller passes the
// six coefficients with `scale` folded in (kernels/rff.py), so the cosine
// and the scale cost 1 FMUL, 1 FRND, 1 FFMA, 1 FMUL and 5 FFMA. Neither the
// accurate cosf (a slow path with local memory and a call for large
// arguments) nor __cosf (MUFU.COS, whose error grows with the argument) is
// used.
//
// What bounds it on the H100: the output. At the training shape
// (4 x 224^2 rows, 1024 features) it writes 411 MB in bf16 (822 MB in f32)
// and reads 4 MB: 0.124 ms at 3.35 TB/s. Per output it issues about 16
// instructions (5 FMAs of the phase, 9 of the cosine, half a packed bf16
// conversion, and the rows' loads, store and loop spread over 16 outputs:
// 258 in the loop's SASS), about 0.11 ms at 128 lanes per SM and clock, so
// the writes, not the ALUs, are the limit. The design only has to write at
// full rate: each thread owns 8 features (its W columns and b stay in
// registers for the whole grid-stride loop over rows) and stores them as
// one 16-byte vector, so a warp's store writes 512 contiguous bytes (in
// f32, two such stores of 4 features each, one in each half of the row).
// The grid is as many blocks as fit on the card at once, and each thread
// takes two rows per iteration. Stores are streaming (st.global.cs,
// evict-first): the output does not fit the 50 MB L2, and on an H100 SXM
// they wrote the bf16 output about 30% faster than plain stores (the f32
// output as fast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int DIM = 5;  // pixel features: x, y, r, g, b
// f32 roundings of 1 / (2 pi) and 2 pi, as the TPU kernel's constants
constexpr float INV2PI = (float)(0.5 / 3.14159265358979323846);
constexpr float TWOPI = (float)(2.0 * 3.14159265358979323846);

// scale * the polynomial's coefficients of u^5 .. u^0
struct CosPoly {
  float c[6];
};

// scale * cos(p), as the TPU kernel evaluates it (fmaf for p - 2 pi k)
__device__ __forceinline__ float cos_poly(float p, CosPoly cp) {
  const float k = rintf(p * INV2PI);
  const float r = fmaf(-TWOPI, k, p);
  const float u = r * r;
  float y = cp.c[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) y = fmaf(y, u, cp.c[i]);
  return y;
}

// Eight neighbouring outputs stored as one 16-byte vector (bf16) or two (f32).
__device__ __forceinline__ void store8(bf16* dst, const float* v, int) {
  uint4 pk;
  __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  __stcs(reinterpret_cast<uint4*>(dst), pk);
}

// f32: features 4 cg .. 4 cg + 3 and half + 4 cg .. half + 4 cg + 3 of a
// row of 2 * half, so that each of the two stores of a warp writes 512
// contiguous bytes
__device__ __forceinline__ void store8(float* dst, const float* v, int half) {
  __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(dst + half), make_float4(v[4], v[5], v[6], v[7]));
}

// The row's feature of a thread's output j (its 8 features, in cg's group)
template <typename T>
__device__ __forceinline__ int feature(int cg, int j, int n_feat) {
  if constexpr (sizeof(T) == 2) return cg * 8 + j;
  return (j < 4 ? 0 : n_feat / 2) + cg * 4 + (j & 3);
}

// One row's 8 outputs of this thread from the row's features fr
template <typename T>
__device__ __forceinline__ void phi8(const float* fr, T* op,
                                     const float (&wr)[DIM][8],
                                     const float (&br)[8], CosPoly cp,
                                     int half) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p = br[j];
#pragma unroll
    for (int i = 0; i < DIM; ++i) p = fmaf(fr[i], wr[i][j], p);
    v[j] = cos_poly(p, cp);
  }
  store8(op, v, half);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rff_phi_kernel(const float* __restrict__ f, const float* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int rows, int n_feat, CosPoly cp) {
  const int groups = n_feat / 8;  // threads per row
  const int rows_per_block = THREADS / groups;
  const int cg = threadIdx.x % groups, rsub = threadIdx.x / groups;
  if (rsub >= rows_per_block) return;
  float wr[DIM][8], br[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int d = feature<T>(cg, j, n_feat);
    br[j] = bias[d];
#pragma unroll
    for (int i = 0; i < DIM; ++i) wr[i][j] = w[i * n_feat + d];
  }
  // grid-stride over rows, two per iteration: both rows' feature loads are
  // in flight together, and the loop's own instructions count once
  const int step = gridDim.x * rows_per_block;
  int row = blockIdx.x * rows_per_block + rsub;
  const float* fp = f + (size_t)row * DIM;
  T* op = out + (size_t)row * n_feat + feature<T>(cg, 0, n_feat);
  const size_t fstep = (size_t)step * DIM, ostep = (size_t)step * n_feat;
  for (; row + step < rows;
       row += 2 * step, fp += 2 * fstep, op += 2 * ostep) {
    float fr[2][DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i) {
      fr[0][i] = __ldg(fp + i);
      fr[1][i] = __ldg(fp + fstep + i);
    }
    phi8(fr[0], op, wr, br, cp, n_feat / 2);
    phi8(fr[1], op + ostep, wr, br, cp, n_feat / 2);
  }
  if (row < rows) {  // an odd last row
    float fr[DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i) fr[i] = __ldg(fp + i);
    phi8(fr, op, wr, br, cp, n_feat / 2);
  }
}

constexpr int MAX_DEVICES = 64;

// Blocks of rff_phi_kernel<T> resident at once on the current device, in
// *blocks; cached per device
template <typename T>
int resident_blocks(int* blocks) {
  static std::atomic<int> cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int n = dev < MAX_DEVICES ? cache[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rff_phi_kernel<T>,
                                                          THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    n = sms * per_sm;
    if (dev < MAX_DEVICES) cache[dev].store(n, std::memory_order_relaxed);
  }
  *blocks = n;
  return 0;
}

template <typename T>
int launch(const void* f, const void* w, const void* bias, void* out,
           int rows, int n_feat, CosPoly cp, cudaStream_t stream) {
  // one wave: as many blocks as are resident on the card at once
  int resident = 0;
  if (int err = resident_blocks<T>(&resident)) return err;
  const int rows_per_block = THREADS / (n_feat / 8);
  int blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  rff_phi_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(f), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), rows, n_feat,
      cp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f (rows, 5) f32, w (5, n_feat) f32, bias (n_feat,) f32 -> out (rows,
// n_feat), bf16 if out_f32 is 0, else f32, on the current device. poly: the
// 6 coefficients of scale * cos's polynomial in r^2, highest degree first.
// n_feat must be a multiple of 8 with n_feat / 8 dividing 256; rows below
// 2^30 (the row counter is 32-bit).
int cosa_rff_phi(const void* f, const void* w, const void* bias, void* out,
                 long long rows, int n_feat, const float* poly, int out_f32,
                 cudaStream_t stream) {
  if (rows < 0 || rows >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int n = static_cast<int>(rows);
  CosPoly cp;
  for (int i = 0; i < 6; ++i) cp.c[i] = poly[i];
  if (out_f32) return launch<float>(f, w, bias, out, n, n_feat, cp, stream);
  return launch<bf16>(f, w, bias, out, n, n_feat, cp, stream);
}

}  // extern "C"
