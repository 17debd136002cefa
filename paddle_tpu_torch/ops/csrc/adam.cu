// Fused dense-Adam update for Hopper (sm_90a).
//
// adam_update replaces the Pallas kernel `_kernel`
// (paddle_tpu/ops/adam_kernel.py:53, called by adam_update). Per element,
// in place on p, m1 and m2 (the Pallas kernel aliases them the same way):
//
//   m1' = b1*m1 + (1-b1)*g                 f32
//   m2' = b2*m2 + (1-b2)*g*g               f32
//   step = lr_t*m1' / (sqrt(m2') + eps)    f32, rounded to p's dtype
//   p'   = p - step                        in f32, rounded to p's dtype once
//
// lr_t (= lr*sqrt(1-b2^t)/(1-b1^t), computed outside on the device) is read
// from device memory, so the caller never syncs with the host.
//
// What bounds it on the H100: bytes. Each element reads p, g, m1, m2 and
// writes p, m1, m2: 22 bytes for a bf16 p and g, 28 for f32, and does about
// a dozen operations, far under the card's ~295 operations per byte. The
// design streams each array once, one element per thread, loads and stores
// next to each other across a warp. Every arithmetic step is an explicitly
// rounded intrinsic (__fmul_rn, __fadd_rn, ...), so the compiler contracts
// nothing into an FMA and the result equals the plain PyTorch version's,
// which rounds after every operation, bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename P, typename G>
__global__ void __launch_bounds__(256)
    adam_kernel(P* __restrict__ p, const G* __restrict__ g,
                float* __restrict__ m1, float* __restrict__ m2,
                const float* __restrict__ lr_t, int n, float b1,
                float one_minus_b1, float b2, float one_minus_b2, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float gf = to_f(g[i]);
  const float a = __fadd_rn(__fmul_rn(b1, m1[i]), __fmul_rn(one_minus_b1, gf));
  const float s = __fadd_rn(__fmul_rn(b2, m2[i]),
                            __fmul_rn(__fmul_rn(one_minus_b2, gf), gf));
  const float step = __fdiv_rn(__fmul_rn(*lr_t, a),
                               __fadd_rn(__fsqrt_rn(s), eps));
  m1[i] = a;
  m2[i] = s;
  p[i] = from_f<P>(__fsub_rn(to_f(p[i]), to_f(from_f<P>(step))));
}

template <typename P, typename G>
int launch(void* p, const void* g, float* m1, float* m2, const float* lr_t,
           int n, float b1, float omb1, float b2, float omb2, float eps,
           cudaStream_t stream) {
  const int blocks = (n + 255) / 256;
  adam_kernel<P, G><<<blocks, 256, 0, stream>>>(
      static_cast<P*>(p), static_cast<const G*>(g), m1, m2, lr_t, n, b1, omb1,
      b2, omb2, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// p_dtype, g_dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value
// (0 = ok).
extern "C" int adam_update(void* p, const void* g, void* m1, void* m2,
                           const void* lr_t, int n, float b1, float omb1,
                           float b2, float omb2, float eps, int p_dtype,
                           int g_dtype, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *a = static_cast<float*>(m1), *b = static_cast<float*>(m2);
  const float* lr = static_cast<const float*>(lr_t);
  if (p_dtype == 0 && g_dtype == 0)
    return launch<float, float>(p, g, a, b, lr, n, b1, omb1, b2, omb2, eps, s);
  if (p_dtype == 1 && g_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, g, a, b, lr, n, b1, omb1,
                                                b2, omb2, eps, s);
  if (p_dtype == 1 && g_dtype == 0)
    return launch<__nv_bfloat16, float>(p, g, a, b, lr, n, b1, omb1, b2, omb2,
                                        eps, s);
  if (p_dtype == 0 && g_dtype == 1)
    return launch<float, __nv_bfloat16>(p, g, a, b, lr, n, b1, omb1, b2, omb2,
                                        eps, s);
  return (int)cudaErrorInvalidValue;
}
