// One-pass LayerNorm backward for Hopper (sm_90a).
//
// ln_backward replaces the Pallas kernel `_kernel`
// (paddle_tpu/ops/layernorm_kernel.py:43, called by ln_backward). Per row of
// x, dy [rows, d], with gamma f32 [d], in f32, the Pallas kernel's formula:
//
//   mean = sum(x) / d,  var = sum((x - mean)^2) / d     (two passes)
//   rstd = rsqrt(var + eps),  xhat = (x - mean) * rstd,  g = dy * gamma
//   dx   = rstd * (g - (sum(g) + xhat * sum(g * xhat)) / d)   rounded once
//
// and the column partials of dgamma = sum_rows dy * xhat and dbeta =
// sum_rows dy, one f32 row of each per block, summed outside the kernel
// (as the JAX package sums its per-tile partials outside).
//
// Design. One warp per row; lane l owns the columns 4l + 128j, so d must be
// a multiple of 128 (the gate's rule). The row statistics are recomputed
// from x, never stored: the passes over a row re-read x and dy from L1
// (2 KB a row at d = 512 bf16). A block of W warps takes rows_per_block
// consecutive rows, warp w the rows w, w + W, ...; each warp adds its
// rows' dy * xhat and dy into its own shared-memory row of column sums
// (lane-owned columns: no atomics), and at the end the block adds its W
// rows in a fixed order and writes its partial rows. Everything is
// deterministic.
//
// What bounds it on the H100: bytes. It reads x and dy once and writes dx
// once (201 MB at [65536, 512] bf16: 0.060 ms at 3.35 TB/s), about 20
// operations per element.

#include <math.h>

#include "rows.cuh"

namespace {

using rows::load4;
using rows::store4;
using rows::warp_sum;

template <typename T>
__global__ void ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                              const float* __restrict__ gamma,
                              T* __restrict__ dx, float* __restrict__ part_g,
                              float* __restrict__ part_b, int n_rows, int d,
                              float eps, int rows_per_block) {
  extern __shared__ float sums[];  // [W][2][d]: dgamma then dbeta sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* my_g = sums + (size_t)warp * 2 * d;
  float* my_b = my_g + d;
  for (int c = lane * 4; c < d; c += 128) {
#pragma unroll
    for (int e = 0; e < 4; ++e) my_g[c + e] = my_b[c + e] = 0.f;
  }
  const float inv_d = 1.f / (float)d;
  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(row0 + rows_per_block, n_rows);
  float a[4], b[4], gm[4];
  for (int r = row0 + warp; r < row_end; r += n_warps) {
    const T* xr = x + (size_t)r * d;
    const T* dyr = dy + (size_t)r * d;
    float s = 0.f;
    for (int c = lane * 4; c < d; c += 128) {
      load4(xr + c, a);
      s += (a[0] + a[1]) + (a[2] + a[3]);
    }
    const float mean = warp_sum(s) * inv_d;
    s = 0.f;
    for (int c = lane * 4; c < d; c += 128) {
      load4(xr + c, a);
#pragma unroll
      for (int e = 0; e < 4; ++e) s += (a[e] - mean) * (a[e] - mean);
    }
    const float rstd = rsqrtf(warp_sum(s) * inv_d + eps);
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane * 4; c < d; c += 128) {
      load4(xr + c, a);
      load4(dyr + c, b);
      load4(gamma + c, gm);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float g = b[e] * gm[e];
        s1 += g;
        s2 += g * ((a[e] - mean) * rstd);
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    for (int c = lane * 4; c < d; c += 128) {
      load4(xr + c, a);
      load4(dyr + c, b);
      load4(gamma + c, gm);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float xhat = (a[e] - mean) * rstd;
        const float g = b[e] * gm[e];
        my_g[c + e] += b[e] * xhat;
        my_b[c + e] += b[e];
        a[e] = rstd * (g - (s1 + xhat * s2) * inv_d);
      }
      store4(dx + (size_t)r * d + c, a);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float tg = 0.f, tb = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      tg += sums[(size_t)w * 2 * d + c];
      tb += sums[(size_t)w * 2 * d + d + c];
    }
    part_g[(size_t)blockIdx.x * d + c] = tg;
    part_b[(size_t)blockIdx.x * d + c] = tb;
  }
}

template <typename T>
int launch(const void* x, const void* dy, const float* gamma, void* dx,
           float* part_g, float* part_b, int n_rows, int d, float eps,
           int warps, int rows_per_block, cudaStream_t s) {
  const size_t smem = (size_t)warps * 2 * d * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  ln_bwd_kernel<T><<<blocks, warps * 32, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma,
      static_cast<T*>(dx), part_g, part_b, n_rows, d, eps, rows_per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dy, dx [rows, d] of one dtype (0 = float32, 1 = bfloat16), d a
// multiple of 128; gamma [d] float32; part_g, part_b [ceil(rows /
// rows_per_block), d] float32; warps per block 1..32 with warps * 2 * d
// floats of shared memory. Returns a cudaError_t value (0 = ok).
extern "C" int ln_backward(const void* x, const void* dy, const void* gamma,
                           void* dx, void* part_g, void* part_b, int n_rows,
                           int d, float eps, int warps, int rows_per_block,
                           int dtype, void* stream) {
  if (n_rows < 1 || d < 128 || d % 128 || warps < 1 || warps > 32 ||
      rows_per_block < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gm = static_cast<const float*>(gamma);
  float *pg = static_cast<float*>(part_g), *pb = static_cast<float*>(part_b);
  if (dtype == 0)
    return launch<float>(x, dy, gm, dx, pg, pb, n_rows, d, eps, warps,
                         rows_per_block, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dy, gm, dx, pg, pb, n_rows, d, eps, warps,
                                 rows_per_block, s);
  return (int)cudaErrorInvalidValue;
}
