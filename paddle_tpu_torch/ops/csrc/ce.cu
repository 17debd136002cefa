// Softmax cross-entropy over [T, V] logits for Hopper (sm_90a), forward and
// backward.
//
// ce_forward replaces the Pallas kernel `_fwd_kernel`
// (paddle_tpu/ops/ce_kernel.py:60, called by ce_forward). Per token row,
// with the Pallas kernel's rounding points:
//
//   m    = max_j l[j]                       f32
//   lse  = m + log(sum_j exp(l[j] - m))     f32
//   loss = lse - l[label], 0 where label == ignore, < 0 or >= V
//
// One block per row. Pass 1 takes the row max, pass 2 the sum of exp (the
// row, 16 KB at V = 8192 bf16, is read again from L1/L2). Each thread reads
// 4 values at a time, neighbouring threads neighbouring addresses, and the
// partials meet by warp shuffles and then shared memory. The label logit is
// read directly (the Pallas kernel's iota-compare picks the same value). A
// masked row writes loss 0 and its true lse.
//
// ce_backward replaces `_bwd_kernel` (paddle_tpu/ops/ce_kernel.py:72,
// called by ce_backward). Per element:
//
//   dlogits = (exp(l - lse) - [j == label]) * g,   g = 0 on masked rows
//
// computed in f32 and rounded once to the logits dtype; no f32 [T, V]
// tensor exists. A grid-stride loop, one thread per 4 values.
//
// What bounds them on the H100: bytes. The forward reads the logits once
// (1.07 GB at [65536, 8192] bf16: 0.32 ms at 3.35 TB/s) and does a handful
// of operations per element; the backward reads them once and writes
// dlogits once (0.64 ms).

#include <math.h>

#include "rows.cuh"

namespace {

using rows::load4;
using rows::store4;
using rows::to_f;

constexpr int kThreads = 256;

// block-wide max or sum of one value per thread; every thread gets it
template <bool kMax>
__device__ float block_reduce(float x, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = kMax ? rows::warp_max(x) : rows::warp_sum(x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < kThreads / 32; ++w)
    r = kMax ? fmaxf(r, scratch[w]) : r + scratch[w];
  __syncthreads();  // scratch is reused by the next reduction
  return r;
}

__device__ __forceinline__ bool masked_label(long long lab, int v,
                                             long long ignore) {
  return lab == ignore || lab < 0 || lab >= v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* __restrict__ logits,
                  const long long* __restrict__ label, float* __restrict__ loss,
                  float* __restrict__ lse, int v, long long ignore) {
  __shared__ float scratch[kThreads / 32];
  const size_t row = blockIdx.x;
  const T* l = logits + row * (size_t)v;
  float x[4];
  float m = -INFINITY;
  for (int c = threadIdx.x * 4; c < v; c += kThreads * 4) {
    load4(l + c, x);
    m = fmaxf(fmaxf(m, fmaxf(x[0], x[1])), fmaxf(x[2], x[3]));
  }
  m = block_reduce<true>(m, scratch);
  float s = 0.f;
  for (int c = threadIdx.x * 4; c < v; c += kThreads * 4) {
    load4(l + c, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) s += expf(x[e] - m);
  }
  s = block_reduce<false>(s, scratch);
  if (threadIdx.x == 0) {
    const float r = m + logf(s);
    const long long lab = label[row];
    loss[row] = masked_label(lab, v, ignore) ? 0.f : r - to_f(l[lab]);
    lse[row] = r;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(const T* __restrict__ logits,
                  const long long* __restrict__ label,
                  const float* __restrict__ lse,
                  const float* __restrict__ dloss, T* __restrict__ dlogits,
                  long long n_vec, int vec_per_row, int v, long long ignore) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n_vec; i += (long long)gridDim.x * kThreads) {
    const long long row = i / vec_per_row;
    const int c0 = (int)(i - row * vec_per_row) * 4;
    const long long lab = label[row];
    const float g = masked_label(lab, v, ignore) ? 0.f : dloss[row];
    const float r = lse[row];
    const size_t off = (size_t)row * v + c0;
    float x[4];
    load4(logits + off, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = expf(x[e] - r);
      if (c0 + e == lab) p -= 1.f;
      x[e] = p * g;
    }
    store4(dlogits + off, x);
  }
}

template <typename T>
int launch_fwd(const void* logits, const long long* label, float* loss,
               float* lse, int t, int v, long long ignore, cudaStream_t s) {
  ce_fwd_kernel<T><<<t, kThreads, 0, s>>>(static_cast<const T*>(logits),
                                          label, loss, lse, v, ignore);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* logits, const long long* label, const float* lse,
               const float* dloss, void* dlogits, int t, int v,
               long long ignore, cudaStream_t s) {
  const long long n_vec = (long long)t * (v / 4);
  // enough blocks to fill the 132 SMs many times over; the loop strides
  const long long want = (n_vec + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  ce_bwd_kernel<T><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(logits), label, lse, dloss,
      static_cast<T*>(dlogits), n_vec, v / 4, v, ignore);
  return (int)cudaGetLastError();
}

}  // namespace

// logits [t, v] (dtype: 0 = float32, 1 = bfloat16), v a multiple of 128,
// rows 16-byte aligned; label [t] int64; loss, lse [t] float32. Returns a
// cudaError_t value (0 = ok).
extern "C" int ce_forward(const void* logits, const void* label, void* loss,
                          void* lse, int t, int v, int ignore, int dtype,
                          void* stream) {
  if (t < 1 || v < 128 || v % 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* lab = static_cast<const long long*>(label);
  float *lo = static_cast<float*>(loss), *ls = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_fwd<float>(logits, lab, lo, ls, t, v, ignore, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(logits, lab, lo, ls, t, v, ignore, s);
  return (int)cudaErrorInvalidValue;
}

// logits, dlogits [t, v] of one dtype; label [t] int64; lse, dloss [t]
// float32.
extern "C" int ce_backward(const void* logits, const void* label,
                           const void* lse, const void* dloss, void* dlogits,
                           int t, int v, int ignore, int dtype, void* stream) {
  if (t < 1 || v < 128 || v % 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* lab = static_cast<const long long*>(label);
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(dloss);
  if (dtype == 0)
    return launch_bwd<float>(logits, lab, ls, dl, dlogits, t, v, ignore, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(logits, lab, ls, dl, dlogits, t, v,
                                     ignore, s);
  return (int)cudaErrorInvalidValue;
}
