// Helpers shared by the row-wise kernels (ce.cu, layernorm.cu, emb_grad.cu):
// dtype conversion, 4-value vector loads and stores (8 bytes of bf16, 16 of
// f32), and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rows {

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

// p[0..3] as f32; p is aligned to 4 values
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// a bf16 is the high half of the f32 with the same bits: widening is exact
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  out[0] = __uint_as_float(v.x << 16);
  out[1] = __uint_as_float(v.x & 0xffff0000u);
  out[2] = __uint_as_float(v.y << 16);
  out[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ unsigned int pack_bf16(float lo, float hi) {
  return (unsigned int)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned int)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// each value rounded to nearest even, once
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* in) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(in[0], in[1]), pack_bf16(in[2], in[3]));
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

}  // namespace rows
