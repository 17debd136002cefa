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
// and the column sums dgamma = sum_rows dy * xhat and dbeta = sum_rows dy.
//
// What bounds it on the H100: bytes. It must read x and dy once and write
// dx once (201 MB at [65536, 512] bf16: 0.060 ms at 3.35 TB/s), about 20
// operations per element.
//
// Design. One warp per row, the warps of the grid striding over the rows;
// the grid is as many blocks as the card holds at once (the occupancy
// calculator's count times the SMs), so every block lives for the whole
// launch. Up to d = 2048 in bf16 (1024 in f32) a lane keeps its share of
// the row of x and dy in registers, loaded once with 16-byte loads (8-byte
// ones in bf16 when d is an odd multiple of 128): lane l owns the VEC
// columns at VEC (32 j + l), j < J. The statistics, sum(g) and sum(g xhat)
// come from those registers, so x and dy are read from memory once. The
// dgamma and dbeta column partials stay in each lane's registers across the
// warp's rows. Past that width the kernel's general case streams each row
// four times from memory (L1 mostly) and keeps the column partials in
// shared memory, a row per warp. At the end each block adds its warps'
// partials in warp order and writes one partial row pair; the last block
// of each group of kGroup blocks (a device counter per group, after
// __threadfence) adds its group's rows in block order, and the last group
// to finish adds the group rows in group order into dgamma and dbeta and
// zeroes the counters for the next launch. Every sum runs in a fixed
// order, so the result is deterministic, and no second launch reduces the
// partials.

#include <math.h>

#include "rows.cuh"

namespace {

using rows::warp_sum;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;   // blocks whose partials one block adds

// VEC values of T at a 16-byte (VEC * sizeof(T)) aligned address, raw
template <typename T, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ float get(int e) const {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
// a bf16 is the high half of the f32 with the same bits: widening is exact
template <>
struct Vec<__nv_bfloat16, 4> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ float get(int e) const {
    const unsigned w = e < 2 ? v.x : v.y;
    return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(rows::pack_bf16(f[0], f[1]), rows::pack_bf16(f[2], f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16, 8> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ float get(int e) const {
    const unsigned w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
    return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(rows::pack_bf16(f[0], f[1]), rows::pack_bf16(f[2], f[3]),
                   rows::pack_bf16(f[4], f[5]), rows::pack_bf16(f[6], f[7]));
  }
};

// The block's partial row pair (2 d floats in sums) into part[blockIdx.x],
// then the cross-block sums: the last block of each group adds the group's
// rows in block order into gpart[group], the last group's adds those in
// group order into dg and db. counters: one per group, then one for the
// groups, all zero on entry and on exit.
__device__ void finish(const float* sums, float* part, float* gpart,
                       float* dg, float* db, unsigned* counters, int d) {
  const int tid = threadIdx.x, n2 = 2 * d;
  const int nb = gridDim.x, ng = (nb + kGroup - 1) / kGroup;
  const int grp = blockIdx.x / kGroup;
  const int b0 = grp * kGroup, bn = min(kGroup, nb - b0);
  __shared__ bool last;
  for (int c = tid; c < n2; c += blockDim.x)
    part[(size_t)blockIdx.x * n2 + c] = sums[c];
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&counters[grp], 1u) == (unsigned)bn - 1;
    if (last) counters[grp] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = tid; c < n2; c += blockDim.x) {
    float t = 0.f;
    for (int b = b0; b < b0 + bn; ++b)
      t += __ldcg(part + (size_t)b * n2 + c);
    gpart[(size_t)grp * n2 + c] = t;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(&counters[ng], 1u) == (unsigned)ng - 1;
    if (last) counters[ng] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int c = tid; c < n2; c += blockDim.x) {
    float t = 0.f;
    for (int g = 0; g < ng; ++g) t += __ldcg(gpart + (size_t)g * n2 + c);
    if (c < d)
      dg[c] = t;
    else
      db[c - d] = t;
  }
}

// d = 32 VEC J: the rows of x and dy in registers. Shared: gamma [d], then
// the block's partial row pair [2][d].
template <typename T, int VEC, int J>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ gamma, T* __restrict__ dx,
                  float* __restrict__ part, float* __restrict__ gpart,
                  float* __restrict__ dg, float* __restrict__ db,
                  unsigned* __restrict__ counters, int n_rows, float eps) {
  constexpr int d = 32 * VEC * J;
  constexpr float inv_d = 1.f / (float)d;
  extern __shared__ float smem[];
  float* gm_s = smem;
  float* sums = smem + d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < d; c += kThreads) gm_s[c] = gamma[c];
  __syncthreads();
  float pg[J][VEC], pb[J][VEC];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) pg[j][e] = pb[j][e] = 0.f;

  for (int r = blockIdx.x * kWarps + warp; r < n_rows;
       r += gridDim.x * kWarps) {
    const size_t row = (size_t)r * d;
    Vec<T, VEC> xv[J], dv[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      xv[j].load(x + row + (32 * j + lane) * VEC);
      dv[j].load(dy + row + (32 * j + lane) * VEC);
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += xv[j].get(e);
    const float mean = warp_sum(s) * inv_d;
    s = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float c = xv[j].get(e) - mean;
        s += c * c;
      }
    const float rstd = rsqrtf(warp_sum(s) * inv_d + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float g = dv[j].get(e) * gm_s[(32 * j + lane) * VEC + e];
        s1 += g;
        s2 += g * ((xv[j].get(e) - mean) * rstd);
      }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float out[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xhat = (xv[j].get(e) - mean) * rstd;
        const float dyv = dv[j].get(e);
        const float g = dyv * gm_s[(32 * j + lane) * VEC + e];
        pg[j][e] += dyv * xhat;
        pb[j][e] += dyv;
        out[e] = rstd * (g - (s1 + xhat * s2) * inv_d);
      }
      Vec<T, VEC>::store(dx + row + (32 * j + lane) * VEC, out);
    }
  }
  // the block's partials: the warps' in warp order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int c = (32 * j + lane) * VEC + e;
          sums[c] = w ? sums[c] + pg[j][e] : pg[j][e];
          sums[d + c] = w ? sums[d + c] + pb[j][e] : pb[j][e];
        }
    }
    __syncthreads();
  }
  finish(sums, part, gpart, dg, db, counters, d);
}

// The general case (wider rows): each row streamed four times (mean, var,
// the two sums, dx), the column partials in shared memory, a row pair per
// warp, then summed in warp order into warp 0's pair. lane l owns the
// columns 4l + 128j, so d must be a multiple of 128 (the gate's rule).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel_wide(const T* __restrict__ x, const T* __restrict__ dy,
                       const float* __restrict__ gamma, T* __restrict__ dx,
                       float* __restrict__ part, float* __restrict__ gpart,
                       float* __restrict__ dg, float* __restrict__ db,
                       unsigned* __restrict__ counters, int n_rows, int d,
                       float eps) {
  using rows::load4;
  using rows::store4;
  extern __shared__ float smem[];  // [W][2][d]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* my_g = smem + (size_t)warp * 2 * d;
  float* my_b = my_g + d;
  for (int c = lane * 4; c < d; c += 128) {
#pragma unroll
    for (int e = 0; e < 4; ++e) my_g[c + e] = my_b[c + e] = 0.f;
  }
  const float inv_d = 1.f / (float)d;
  float a[4], b[4], gm[4];
  for (int r = blockIdx.x * n_warps + warp; r < n_rows;
       r += gridDim.x * n_warps) {
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
      tg += smem[(size_t)w * 2 * d + c];
      tb += smem[(size_t)w * 2 * d + d + c];
    }
    smem[c] = tg;      // only this thread reads or writes column c here
    smem[d + c] = tb;
  }
  __syncthreads();
  finish(smem, part, gpart, dg, db, counters, d);
}

// the grid: as many blocks of `threads` as the card holds at once, no more
// than the rows need (a warp a row) nor than max_blocks
template <typename K>
int grid_for(K kernel, int threads, size_t smem, int n_rows, int max_blocks,
             int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int warps = threads / 32;
  *blocks = min(min(per_sm * sms, max_blocks), (n_rows + warps - 1) / warps);
  return 0;
}

struct Args {
  const void* x;
  const void* dy;
  const float* gamma;
  void* dx;
  float* part;
  float* gpart;
  float* dg;
  float* db;
  unsigned* counters;
  int n_rows, d;
  float eps;
  int max_blocks;
  cudaStream_t stream;
};

template <typename T, int VEC, int J>
int launch_rows(const Args& a) {
  constexpr int d = 32 * VEC * J;
  const size_t smem = sizeof(float) * 3 * d;
  auto kernel = ln_bwd_kernel<T, VEC, J>;
  int blocks = 0;
  const int err = grid_for(kernel, kThreads, smem, a.n_rows, a.max_blocks,
                           &blocks);
  if (err) return err;
  kernel<<<blocks, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), a.gamma,
      static_cast<T*>(a.dx), a.part, a.gpart, a.dg, a.db, a.counters,
      a.n_rows, a.eps);
  return (int)cudaGetLastError();
}

// each warp's partial row pair in shared memory: as many warps (up to 8)
// as 200 KB holds
template <typename T>
int launch_wide(const Args& a) {
  const int warps = min(kWarps, 200 * 1024 / (8 * a.d));
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)warps * 2 * a.d;
  auto kernel = ln_bwd_kernel_wide<T>;
  int blocks = 0;
  const int err = grid_for(kernel, warps * 32, smem, a.n_rows, a.max_blocks,
                           &blocks);
  if (err) return err;
  kernel<<<blocks, warps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), a.gamma,
      static_cast<T*>(a.dx), a.part, a.gpart, a.dg, a.db, a.counters,
      a.n_rows, a.d, a.eps);
  return (int)cudaGetLastError();
}

// the register kernel for d = 32 VEC J, J = J0, J0 + kStep, ... <= kMaxJ,
// or the wide one
template <typename T, int VEC, int kMaxJ, int kStep, int J>
int launch_by_width(const Args& a) {
  if constexpr (J > kMaxJ) {
    return launch_wide<T>(a);
  } else {
    if (a.d == 32 * VEC * J) return launch_rows<T, VEC, J>(a);
    return launch_by_width<T, VEC, kMaxJ, kStep, J + kStep>(a);
  }
}

}  // namespace

// x, dy, dx [rows, d] of one dtype (0 = float32, 1 = bfloat16), d a
// multiple of 128; gamma [d] float32; dgamma, dbeta [d] float32 outputs.
// Scratch the caller allocates for a grid of at most max_blocks blocks
// (8 a SM always suffices: no kernel here holds more): part [max_blocks][2][d]
// and gpart [ceil(max_blocks / 16)][2][d] float32, and counters,
// ceil(max_blocks / 16) + 1 unsigned ints that are zero (the kernel leaves
// them zero). Returns a cudaError_t value (0 = ok).
extern "C" int ln_backward(const void* x, const void* dy, const void* gamma,
                           void* dx, void* dgamma, void* dbeta, void* part,
                           void* gpart, void* counters, int n_rows, int d,
                           float eps, int max_blocks, int dtype,
                           void* stream) {
  if (n_rows < 1 || d < 128 || d % 128 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Args a = {x, dy, static_cast<const float*>(gamma), dx,
                  static_cast<float*>(part), static_cast<float*>(gpart),
                  static_cast<float*>(dgamma), static_cast<float*>(dbeta),
                  static_cast<unsigned*>(counters), n_rows, d, eps,
                  max_blocks, static_cast<cudaStream_t>(stream)};
  using bf16 = __nv_bfloat16;
  // registers up to d = 1024 in f32 and 2048 in bf16, 8-value (16-byte)
  // vectors where d % 256 == 0 and 4-value ones at odd multiples of 128
  if (dtype == 0) return launch_by_width<float, 4, 8, 1, 1>(a);
  if (dtype == 1 && d % 256 == 0)
    return launch_by_width<bf16, 8, 8, 1, 1>(a);
  if (dtype == 1) return launch_by_width<bf16, 4, 15, 2, 1>(a);
  return (int)cudaErrorInvalidValue;
}
