// Dense embedding gradient (lookup_table_grad) for Hopper (sm_90a): dW
// [vocab, dim] = the sum of dout's rows by id. Two variants, as in the JAX
// package.
//
// emb_grad_scatter replaces the Pallas kernel `_scatter_kernel`
// (paddle_tpu/ops/emb_grad_kernel.py:96, called by emb_grad_scatter), which
// keeps dW resident in VMEM and adds each id's dout row into it in the
// TABLE dtype. Here dW is zeroed, then one thread per (id, column pair) adds
// the pair with one atomic: atomicAdd on __nv_bfloat162 for a bf16 table
// (each add rounds to bf16, as the Pallas kernel's read-modify-write does),
// on float for an f32 table. The order of the adds is not fixed, so a sum
// of more than two values may round differently from run to run; with
// integer-valued douts below 256 in magnitude every order is exact.
//
// emb_grad_segsum replaces `_segsum_kernel`
// (paddle_tpu/ops/emb_grad_kernel.py:147, called by emb_grad_segsum). The
// ids are argsorted (stably) outside the kernel and starts[r] is the first
// sorted position with id >= r, as the JAX package buckets them outside.
// One warp per (vocab row, 128 columns): it walks the row's run of sorted
// positions, reads dout[order[p]] directly (no gathered copy), sums in f32
// in sorted order and rounds once. An empty row writes 0. Deterministic.
//
// Both skip an id outside [0, vocab): the lowering wraps negative ids
// first, so such an id is out of range in the JAX lowering too, where it
// contributes nothing.
//
// What bounds them on the H100: bytes. Both read dout once and write dW
// once (67 MB + 8 MB at 65,536 ids into [8192, 512] bf16: 0.023 ms at
// 3.35 TB/s); the scatter's atomics and the segsum's sorted gather read
// dout rows in random order.

#include "rows.cuh"

namespace {

using rows::load4;
using rows::store4;

constexpr int kThreads = 256;

__device__ __forceinline__ void add_pair(float* dst, const float* src) {
  atomicAdd(dst, src[0]);
  atomicAdd(dst + 1, src[1]);
}

__device__ __forceinline__ void add_pair(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src) {
  atomicAdd(reinterpret_cast<__nv_bfloat162*>(dst),
            *reinterpret_cast<const __nv_bfloat162*>(src));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const long long* __restrict__ ids,
                   const T* __restrict__ dout, T* __restrict__ dw,
                   long long n_pairs, int pairs_per_row, int vocab, int dim) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
       i < n_pairs; i += (long long)gridDim.x * kThreads) {
    const long long j = i / pairs_per_row;
    const int c = (int)(i - j * pairs_per_row) * 2;
    const long long id = ids[j];
    if (id < 0 || id >= vocab) continue;
    add_pair(dw + id * dim + c, dout + j * dim + c);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    segsum_kernel(const long long* __restrict__ order,
                  const long long* __restrict__ starts,
                  const T* __restrict__ dout, T* __restrict__ dw, int vocab,
                  int dim) {
  const int lane = threadIdx.x & 31;
  const int chunks = dim / 128;
  const long long item =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (item >= (long long)vocab * chunks) return;
  const int r = (int)(item / chunks);
  const int c = (int)(item - (long long)r * chunks) * 128 + lane * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float v[4];
  const long long end = starts[r + 1];
  for (long long p = starts[r]; p < end; ++p) {
    load4(dout + order[p] * dim + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += v[e];
  }
  store4(dw + (long long)r * dim + c, acc);
}

int grid_for(long long work) {
  const long long want = (work + kThreads - 1) / kThreads;
  return (int)(want < 132 * 64 ? want : 132 * 64);
}

template <typename T>
int scatter(const long long* ids, const void* dout, void* dw, int n, int vocab,
            int dim, cudaStream_t s) {
  cudaError_t err =
      cudaMemsetAsync(dw, 0, (size_t)vocab * dim * sizeof(T), s);
  if (err != cudaSuccess) return (int)err;
  const long long n_pairs = (long long)n * (dim / 2);
  scatter_kernel<T><<<grid_for(n_pairs), kThreads, 0, s>>>(
      ids, static_cast<const T*>(dout), static_cast<T*>(dw), n_pairs, dim / 2,
      vocab, dim);
  return (int)cudaGetLastError();
}

template <typename T>
int segsum(const long long* order, const long long* starts, const void* dout,
           void* dw, int vocab, int dim, cudaStream_t s) {
  const long long items = (long long)vocab * (dim / 128);
  const long long blocks = (items + kThreads / 32 - 1) / (kThreads / 32);
  segsum_kernel<T><<<(unsigned int)blocks, kThreads, 0, s>>>(
      order, starts, static_cast<const T*>(dout), static_cast<T*>(dw), vocab,
      dim);
  return (int)cudaGetLastError();
}

}  // namespace

// ids [n] int64; dout [n, dim] and dw [vocab, dim] of one dtype (0 =
// float32, 1 = bfloat16), dim a multiple of 128. Returns a cudaError_t
// value (0 = ok).
extern "C" int emb_grad_scatter(const void* ids, const void* dout, void* dw,
                                int n, int vocab, int dim, int dtype,
                                void* stream) {
  if (n < 1 || vocab < 1 || dim < 128 || dim % 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* id = static_cast<const long long*>(ids);
  if (dtype == 0) return scatter<float>(id, dout, dw, n, vocab, dim, s);
  if (dtype == 1) return scatter<__nv_bfloat16>(id, dout, dw, n, vocab, dim, s);
  return (int)cudaErrorInvalidValue;
}

// order [n] int64 (a stable argsort of the ids), starts [vocab + 1] int64
// (starts[r] = the first sorted position with id >= r); dout, dw as above.
extern "C" int emb_grad_segsum(const void* order, const void* starts,
                               const void* dout, void* dw, int n, int vocab,
                               int dim, int dtype, void* stream) {
  if (n < 1 || vocab < 1 || dim < 128 || dim % 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* o = static_cast<const long long*>(order);
  const long long* st = static_cast<const long long*>(starts);
  if (dtype == 0) return segsum<float>(o, st, dout, dw, vocab, dim, s);
  if (dtype == 1) return segsum<__nv_bfloat16>(o, st, dout, dw, vocab, dim, s);
  return (int)cudaErrorInvalidValue;
}
