// Tile helpers shared by the attention kernels (attention.cu, forward;
// attention_bwd.cu, backward): dtype conversion, warp reductions, tile loads
// from the [B, T, H, D] layout into shared f32 tiles, and the 4 x 4 / 4 x
// (kDC/16) register micro-tile products of a 256-thread (16 x 16) block.
//
// The CUDA-core kernels take any D that is a multiple of 8. Their shared
// tiles are at most kDC + 1 floats wide and a thread holds kDC / 16 output
// columns in registers, so past kDC the output columns split into chunks of
// kDC, one block per chunk (the chunk folds into blockIdx.x), and the sums
// over all of D (S = Q K^T, dP = dO V^T) stream through the same tiles in
// kDC-column pieces (score_stream), recomputed by every chunk's block. At D
// <= kDC there is one chunk and one piece, and the tiles load once as they
// always did.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <type_traits>

namespace attn {

constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kBQ = 64;                // query rows per block
constexpr int kBK = 64;                // key rows per tile
// head-dim columns per chunk of the CUDA-core kernels (see above); the
// bfloat16 tensor-core kernels pad D to 64, 128 or 256 and take D up to
// kMaxDWgmma, the CUDA-core kernels (instantiated for bf16 too) the rest
constexpr int kDC = 128;
constexpr int kMaxDWgmma = 256;
constexpr int kMaxJ = kDC / 16;        // output columns per thread
constexpr int kOnepassMaxTk = 512;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// x rounded to T and held as f32 (P cast to V's dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// columns [c0, c0 + w) of rows [row0, row0 + nrows) of head h of a
// [B, T, H, D] tensor into a shared f32 tile with row stride ld; rows at or
// past T read as zero
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int b, int row0,
                          int nrows, int t_len, int H, int h, int D, int c0,
                          int w) {
  for (int idx = threadIdx.x; idx < nrows * w; idx += kThreads) {
    const int r = idx / w, c = idx - r * w;
    const int t = row0 + r;
    float val = 0.f;
    if (t < t_len)
      val = to_f(src[(((size_t)b * t_len + t) * H + h) * D + c0 + c]);
    dst[r * ld + c] = val;
  }
}

__device__ __forceinline__ void zero_tile(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += q row (ty*4+i) . k row (tx+16j), summed over d < D in order
__device__ __forceinline__ void score_add(float acc[4][4], const float* q_s,
                                          const float* k_s, int ld, int D,
                                          int ty, int tx) {
  for (int d = 0; d < D; ++d) {
    float a[4], bk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = q_s[(ty * 4 + i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bk[j] = k_s[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bk[j], acc[i][j]);
  }
}

// acc[i][j] = q row (ty*4+i) . k row (tx+16j), summed over d in order
__device__ __forceinline__ void score_tile(float acc[4][4], const float* q_s,
                                           const float* k_s, int ld, int D,
                                           int ty, int tx) {
  zero_tile(acc);
  score_add(acc, q_s, k_s, ld, D, ty, tx);
}

// D > kDC: acc[i][j] = a row (a0 + ty*4+i) . b row (b0 + tx+16j) of head h,
// summed over all D columns in order, streamed through the shared tiles a_s
// and b_s in kDC-column pieces (the same order of sums as one tile). Starts
// with a barrier, so the caller may still have been reading a_s and b_s.
template <typename T>
__device__ void score_stream(float acc[4][4], float* a_s, float* b_s, int ld,
                             const T* a, int a0, int a_len, const T* bsrc,
                             int b0, int b_len, int b, int H, int h, int D,
                             int ty, int tx) {
  zero_tile(acc);
  for (int c0 = 0; c0 < D; c0 += kDC) {
    const int w = min(kDC, D - c0);
    __syncthreads();
    load_tile(a_s, ld, a, b, a0, kBQ, a_len, H, h, D, c0, w);
    load_tile(b_s, ld, bsrc, b, b0, kBK, b_len, H, h, D, c0, w);
    __syncthreads();
    score_add(acc, a_s, b_s, ld, w, ty, tx);
  }
}

// the output-column chunk of a CUDA-core block: blockIdx.x = tile * chunks
// + chunk; columns [c0, c0 + w) of D
struct Chunk {
  int tile, c0, w, first;
  __device__ Chunk(int D) {
    const int n = (D + kDC - 1) / kDC;
    tile = blockIdx.x / n;
    const int c = blockIdx.x - tile * n;
    c0 = c * kDC;
    w = min(kDC, D - c0);
    first = c == 0;
  }
};

// o[i][j] += sum_kk p[row ty*4+i][kk] * v[kk][tx+16j] over kn rows of v_s
// and its D columns
__device__ __forceinline__ void pv_tile(float o[4][kMaxJ], const float* p_s,
                                        int pld, const float* v_s, int ld,
                                        int kn, int D, int ty, int tx) {
  for (int kk = 0; kk < kn; ++kk) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = p_s[(ty * 4 + i) * pld + kk];
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        const float vv = v_s[kk * ld + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(p[i], vv, o[i][j]);
      }
    }
  }
}

// o's columns [0, w) into columns [c0, c0 + w) of rows q0 + ty*4+i of head h
// of a [B, Tq, H, D] tensor, divided by div[row] where div is given
template <typename T>
__device__ void store_out(T* out, float o[4][kMaxJ], const float* div,
                          int b, int q0, int Tq, int H, int h, int D, int c0,
                          int w, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, t = q0 + r;
    if (t >= Tq) continue;
    const float l = div ? div[r] : 1.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int c = tx + 16 * j;
      if (c < w)
        out[(((size_t)b * Tq + t) * H + h) * D + c0 + c] =
            from_f<T>(div ? o[i][j] / l : o[i][j]);
    }
  }
}

// dtype: 0 = float32, 1 = bfloat16
// f(std::integral_constant<int, DP>()) at the DP (64, 128 or 256) that pads
// D for the bf16 tensor-core kernels
template <typename F>
int by_dp(int D, F f) {
  if (D <= 64) return f(std::integral_constant<int, 64>());
  if (D <= 128) return f(std::integral_constant<int, 128>());
  return f(std::integral_constant<int, 256>());
}

inline bool bad_shape(int B, int Tq, int Tk, int H, int D) {
  return B < 1 || B > 65535 || H < 1 || H > 65535 || Tq < 1 || Tk < 1 ||
         D < 8 || D % 8 != 0;
}

// the row stride of the CUDA-core kernels' f32 tiles
inline int tile_ld(int D) { return (D < kDC ? D : kDC) + 1; }

// blocks along x of a CUDA-core kernel: row tiles times column chunks
inline int chunked_blocks(int rows, int tile_rows, int D) {
  return ((rows + tile_rows - 1) / tile_rows) * ((D + kDC - 1) / kDC);
}

}  // namespace attn
