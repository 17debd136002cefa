// Tile helpers shared by the attention kernels (attention.cu, forward;
// attention_bwd.cu, backward): dtype conversion, warp reductions, tile loads
// from the [B, T, H, D] layout into shared f32 tiles, and the 4 x 4 / 4 x
// (D/16) register micro-tile products of a 256-thread (16 x 16) block.
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
// head dims: the float32 kernels hold D / 16 output columns a thread in
// registers and (D + 1)-wide f32 tiles in shared memory, which stop fitting
// past 128; the bfloat16 tensor-core kernels pad D to 64, 128 or 256
constexpr int kMaxD = 128;
constexpr int kMaxDBf16 = 256;
constexpr int kMaxJ = kMaxD / 16;      // output columns per thread
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

// rows [row0, row0 + nrows) of head h of a [B, T, H, D] tensor into a
// shared f32 tile with row stride ld; rows at or past T read as zero
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int b, int row0,
                          int nrows, int t_len, int H, int h, int D) {
  for (int idx = threadIdx.x; idx < nrows * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int t = row0 + r;
    float val = 0.f;
    if (t < t_len) val = to_f(src[(((size_t)b * t_len + t) * H + h) * D + c]);
    dst[r * ld + c] = val;
  }
}

// acc[i][j] = q row (ty*4+i) . k row (tx+16j), summed over d in order
__device__ __forceinline__ void score_tile(float acc[4][4], const float* q_s,
                                           const float* k_s, int ld, int D,
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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

// o[i][j] += sum_kk p[row ty*4+i][kk] * v[kk][tx+16j] over kn rows of v_s
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

template <typename T>
__device__ void store_out(T* out, float o[4][kMaxJ], const float* div,
                          int b, int q0, int Tq, int H, int h, int D, int ty,
                          int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, t = q0 + r;
    if (t >= Tq) continue;
    const float l = div ? div[r] : 1.f;
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D)
        out[(((size_t)b * Tq + t) * H + h) * D + c] =
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

inline bool bad_shape(int B, int Tq, int Tk, int H, int D, int dtype) {
  return B < 1 || B > 65535 || H < 1 || H > 65535 || Tq < 1 || Tk < 1 ||
         D < 8 || D > (dtype == 1 ? kMaxDBf16 : kMaxD) || D % 8 != 0;
}

}  // namespace attn
