// Random-Fourier-feature embedding phi = scale * cos(f W + b) (K3),
// hand-written for Hopper (sm_90a), plain C interface.
//
// Replaces the JAX package's Pallas kernel cosa_tpu/kernels/rff.py
// (_phi_kernel via rff_phi, called from ops/bilateral.py::rff_embed).
//
// What it computes: for every pixel row n and feature d,
//   phi[n, d] = scale * cos(b[d] + sum_i f[n, i] * W[i, d])   (i < 5)
// and stores it as bf16 (the mixed-precision path) or f32, as the Pallas
// kernel's dtype argument does. The projection is 5 true f32 FMAs in the order
// the TPU kernel adds them (no tensor core, no TF32): phases span tens of
// radians, and a reduced-precision product aliases them. cos is the
// accurate cosf (the build passes no --use_fast_math: __cosf's error grows
// with the argument and is far too large at such phases).
//
// What bounds it on the H100: the output. At the training shape
// (4 x 224^2 rows, 1024 features) it writes 411 MB in bf16 (822 MB in
// f32) and reads 4 MB; the 5
// FMAs and one cosf per output are well under the f32 instruction rate.
// So the design only has to write at full rate: each thread owns 8 neighbouring
// features (its W columns and b stay in registers for the whole grid-
// stride loop over rows) and stores them as one 16-byte vector (two in
// f32), so a warp writes 512 (1024) contiguous bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int DIM = 5;  // pixel features: x, y, r, g, b

// Eight neighbouring outputs stored as one 16-byte vector (bf16) or two (f32).
__device__ __forceinline__ void store8(bf16* dst, const float* v) {
  uint4 pk;
  bf16* e = reinterpret_cast<bf16*>(&pk);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(v[j]);
  *reinterpret_cast<uint4*>(dst) = pk;
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rff_phi_kernel(const float* __restrict__ f, const float* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ out,
                   long long rows, int n_feat, float scale) {
  const int groups = n_feat / 8;  // threads per row
  const int rows_per_block = THREADS / groups;
  const int cg = threadIdx.x % groups, rsub = threadIdx.x / groups;
  if (rsub >= rows_per_block) return;
  float wr[DIM][8], br[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    br[j] = bias[cg * 8 + j];
#pragma unroll
    for (int i = 0; i < DIM; ++i) wr[i][j] = w[i * n_feat + cg * 8 + j];
  }
  for (long long row = (long long)blockIdx.x * rows_per_block + rsub;
       row < rows; row += (long long)gridDim.x * rows_per_block) {
    float fr[DIM];
#pragma unroll
    for (int i = 0; i < DIM; ++i) fr[i] = f[row * DIM + i];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p = br[j];
#pragma unroll
      for (int i = 0; i < DIM; ++i) p = fmaf(fr[i], wr[i][j], p);
      v[j] = scale * cosf(p);
    }
    store8(out + row * n_feat + cg * 8, v);
  }
}

template <typename T>
int launch(const void* f, const void* w, const void* bias, void* out,
           long long rows, int n_feat, float scale, cudaStream_t stream) {
  const int rows_per_block = THREADS / (n_feat / 8);
  long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 per SM
  if (blocks < 1) blocks = 1;
  rff_phi_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(f), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), rows, n_feat,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// f (rows, 5) f32, w (5, n_feat) f32, bias (n_feat,) f32 -> out (rows,
// n_feat), bf16 if out_f32 is 0, else f32. n_feat must be a multiple of 8
// with n_feat / 8 dividing 256.
int cosa_rff_phi(const void* f, const void* w, const void* bias, void* out,
                 long long rows, int n_feat, float scale, int out_f32,
                 cudaStream_t stream) {
  if (out_f32)
    return launch<float>(f, w, bias, out, rows, n_feat, scale, stream);
  return launch<bf16>(f, w, bias, out, rows, n_feat, scale, stream);
}

}  // extern "C"
