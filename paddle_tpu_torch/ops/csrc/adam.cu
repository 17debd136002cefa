// Fused dense-Adam update for Hopper (sm_90a), over many parameters at once.
//
// adam_update_multi replaces the Pallas kernel `_kernel`
// (paddle_tpu/ops/adam_kernel.py:53, called by adam_update), which the JAX
// package launches once per parameter. Per element, in place on p, m1 and m2
// (the Pallas kernel aliases them the same way):
//
//   m1' = b1*m1 + (1-b1)*g                 f32
//   m2' = b2*m2 + (1-b2)*g*g               f32
//   step = lr_t*m1' / (sqrt(m2') + eps)    f32, rounded to p's dtype
//   p'   = p - step                        in f32, rounded to p's dtype once
//
// lr_t (= lr*sqrt(1-b2^t)/(1-b1^t), computed outside on the device, one per
// parameter) is read from device memory, so the caller never syncs with the
// host.
//
// What bounds it on the H100: bytes. Each element reads p, g, m1, m2 and
// writes p, m1, m2: 22 bytes for a bf16 p and g, 28 for f32, and does about
// a dozen operations, far under the card's ~295 operations per byte. What
// holds a per-parameter kernel back is not the card but the host: a
// training step makes one update per parameter, each a few tens of
// microseconds of Python and a launch, while the card needs a few
// microseconds for most of them.
//
// The design. One launch updates a whole table of parameters. The table (a
// descriptor per parameter: the p, g, m1, m2 and lr_t pointers, the element
// count, p's and g's dtypes, and the parameter's first chunk) is a kernel
// parameter passed by value (__grid_constant__, read in place from the
// parameter space): at most kMaxTensors descriptors fit the 4 KB that every
// CUDA 12 toolkit and driver take, and the wrapper splits a longer list into
// several launches. The grid walks the table's elements in chunks of
// kChunk, one block each; a block finds its parameter by a binary search
// over the descriptors' first chunks (uniform across the block, so the
// parameter space broadcasts). Each thread takes kVec = 8 consecutive
// elements with 16-byte loads and stores (one for 8 bf16 values, two for 8
// f32 ones), and the ragged end of a parameter element by element. Every
// arithmetic step is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// ...), so the compiler contracts nothing into an FMA and the result equals
// the plain PyTorch version's, which rounds after every operation, bit for
// bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                   // elements a thread
constexpr int kChunk = kThreads * kVec;   // elements a block
constexpr int kMaxTensors = 72;

struct AdamTensor {
  void* p;
  const void* g;
  float* m1;
  float* m2;
  const float* lr_t;
  int n;        // elements
  int chunk0;   // the parameter's first chunk in the launch's grid
  int p_bf16;   // dtypes: 0 = float32, 1 = bfloat16
  int g_bf16;
};

struct AdamTable {
  int count;
  float b1, omb1, b2, omb2, eps;
  AdamTensor t[kMaxTensors];
};
static_assert(sizeof(AdamTable) <= 4096,
              "the table must fit the 4 KB of kernel parameters");

struct Consts {
  float b1, omb1, b2, omb2, eps, lr;
};

// one element: m1, m2 and p in place, every step rounded
template <bool kPBf16>
__device__ __forceinline__ void update(float& p, float g, float& m1, float& m2,
                                       const Consts& c) {
  const float a = __fadd_rn(__fmul_rn(c.b1, m1), __fmul_rn(c.omb1, g));
  const float s = __fadd_rn(__fmul_rn(c.b2, m2),
                            __fmul_rn(__fmul_rn(c.omb2, g), g));
  float step = __fdiv_rn(__fmul_rn(c.lr, a), __fadd_rn(__fsqrt_rn(s), c.eps));
  if (kPBf16) step = __bfloat162float(__float2bfloat16(step));
  m1 = a;
  m2 = s;
  p = __fsub_rn(p, step);  // the caller rounds p to its dtype once
}

// 8 values at a 16-byte aligned address, as f32 (a bf16 widens exactly: it
// is the high half of the f32 with the same bits)
__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* v) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ float load1(const float* src) { return *src; }
__device__ __forceinline__ float load1(const __nv_bfloat16* src) {
  return __bfloat162float(*src);
}
__device__ __forceinline__ void store1(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);
}

// elements [i, i + kVec) of one parameter, or its ragged end
template <typename P, typename G>
__device__ __forceinline__ void update_run(const AdamTensor& t, int i,
                                           const Consts& c) {
  constexpr bool kPBf16 = sizeof(P) == 2;
  P* p = static_cast<P*>(t.p) + i;
  const G* g = static_cast<const G*>(t.g) + i;
  float* m1 = t.m1 + i;
  float* m2 = t.m2 + i;
  if (i + kVec <= t.n) {
    float pv[kVec], gv[kVec], av[kVec], bv[kVec];
    load8(p, pv);
    load8(g, gv);
    load8(m1, av);
    load8(m2, bv);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      update<kPBf16>(pv[e], gv[e], av[e], bv[e], c);
    store8(m1, av);
    store8(m2, bv);
    store8(p, pv);
  } else {
    for (int e = 0; e < t.n - i; ++e) {
      float pv = load1(p + e), av = m1[e], bv = m2[e];
      update<kPBf16>(pv, load1(g + e), av, bv, c);
      m1[e] = av;
      m2[e] = bv;
      store1(p + e, pv);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    adam_multi_kernel(const __grid_constant__ AdamTable tab) {
  // the parameter of this block's chunk: the last whose chunk0 <= blockIdx.x
  const int chunk = blockIdx.x;
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.t[mid].chunk0 <= chunk)
      lo = mid;
    else
      hi = mid - 1;
  }
  const AdamTensor& t = tab.t[lo];
  const int i = (chunk - t.chunk0) * kChunk + threadIdx.x * kVec;
  if (i >= t.n) return;
  const Consts c = {tab.b1, tab.omb1, tab.b2, tab.omb2, tab.eps, *t.lr_t};
  using bf16 = __nv_bfloat16;
  if (t.p_bf16) {
    if (t.g_bf16)
      update_run<bf16, bf16>(t, i, c);
    else
      update_run<bf16, float>(t, i, c);
  } else {
    if (t.g_bf16)
      update_run<float, bf16>(t, i, c);
    else
      update_run<float, float>(t, i, c);
  }
}

}  // namespace

// desc: count (1 .. kMaxTensors) rows of 8 int64 values, one parameter
// each: p, g, m1, m2 and lr_t (device pointers; p, g, m1, m2 16-byte
// aligned), the element count (1 .. 2^31 - 1), p's dtype and g's dtype (0 =
// float32, 1 = bfloat16); m1, m2 and lr_t are float32. One launch. Returns a
// cudaError_t value (0 = ok); a bad row launches nothing.
extern "C" int adam_update_multi(const int64_t* desc, int count, float b1,
                                 float omb1, float b2, float omb2, float eps,
                                 void* stream) {
  if (count < 1 || count > kMaxTensors) return (int)cudaErrorInvalidValue;
  AdamTable tab;
  tab.count = count;
  tab.b1 = b1, tab.omb1 = omb1, tab.b2 = b2, tab.omb2 = omb2, tab.eps = eps;
  int chunks = 0;  // at most kMaxTensors * 2^20: no overflow
  for (int r = 0; r < count; ++r) {
    const int64_t* d = desc + 8 * r;
    if ((d[0] | d[1] | d[2] | d[3]) % 16 || d[4] % 4)
      return (int)cudaErrorMisalignedAddress;
    if (d[5] < 1 || d[5] > 0x7fffffff || (d[6] | d[7]) & ~int64_t(1))
      return (int)cudaErrorInvalidValue;
    AdamTensor& t = tab.t[r];
    t.p = reinterpret_cast<void*>(d[0]);
    t.g = reinterpret_cast<const void*>(d[1]);
    t.m1 = reinterpret_cast<float*>(d[2]);
    t.m2 = reinterpret_cast<float*>(d[3]);
    t.lr_t = reinterpret_cast<const float*>(d[4]);
    t.n = (int)d[5];
    t.chunk0 = chunks;
    t.p_bf16 = (int)d[6];
    t.g_bf16 = (int)d[7];
    chunks += (int)((d[5] + kChunk - 1) / kChunk);
  }
  adam_multi_kernel<<<chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tab);
  return (int)cudaGetLastError();
}
