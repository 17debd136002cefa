// Attention forward kernels for Hopper (sm_90a) on the [B, T, H, D] layout.
//
// onepass_fwd_kernel replaces the Pallas kernel `_onepass_fwd_kernel`
// (paddle_tpu/ops/attention.py:123, called by onepass_attention_fwd_bthd).
// flash_fwd_kernel replaces the Pallas kernel `_fwd_kernel`
// (paddle_tpu/ops/attention.py:272, called by flash_attention_fwd_bthd).
//
// What bounds them on the H100. Per (batch, head) both kernels read Q, K and
// V once and write O once, and do 4*D operations per unmasked (row, col)
// pair: T/2 operations per bf16 byte at T_q = T_k = T (half that when
// causal), so 128 at the one-pass serving shape T = 256 and 2048 at the
// flash shape T = 4096. Against the card's ~295 bf16 operations per byte,
// the short kernel is bound by its bytes and the long one by its
// operations. Neither is near either bound in this version: the
// products run on the CUDA cores in f32 from shared memory (no wgmma, no TMA
// yet), so their time is set by shared-memory reads and FMAs.
//
// What the design does about it. The [T, T] score matrix never reaches
// device memory: the one-pass kernel keeps a 64 x T_k f32 score tile in
// shared memory (up to 128 KB at T_k = 512, opted in above the 48 KB
// default), the flash kernel keeps only a 64 x 64 tile and runs the online
// softmax over k-tiles. Each block owns one (batch, head, 64-row q-tile) and
// loops over k-tiles itself, since blocks carry nothing across the grid.
// Each thread holds a 4 x 4 score micro-tile and a 4 x (D/16) output
// micro-tile in registers; shared tiles are padded to D + 1 floats a row so
// that the strided reads do not collide on banks. Ragged edges (T not a
// multiple of 64) are masked here, not by choosing a divisor tile.
//
// Rounding points follow the Pallas kernels: scores in f32, causal mask to
// -1e30 (bottom-right aligned: col <= row + T_k - T_q), P cast to V's dtype
// before P.V, P.V accumulated in f32, output rounded once to q's dtype.
// The one-pass kernel normalises P in f32 before the cast; the flash kernel
// casts the unnormalised P and divides the accumulator by l at the end.

#include "attention_common.cuh"

namespace {

using namespace attn;

// One block per (64-row q-tile, head, batch). Shared: Q tile, one K/V tile,
// and the full 64 x T_k f32 score/probability tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    onepass_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Tq,
                       int Tk, int H, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;
  float* kv_s = q_s + kBQ * ld;
  float* s_s = kv_s + kBK * ld;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int offset = Tk - Tq;

  load_tile(q_s, ld, q, b, q0, kBQ, Tq, H, h, D);
  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    __syncthreads();
    load_tile(kv_s, ld, k, b, k0, kBK, Tk, H, h, D);
    __syncthreads();
    float acc[4][4];
    score_tile(acc, q_s, kv_s, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c < Tk) {
          float s = acc[i][j] * scale;
          if (causal && c > q0 + r + offset) s = kNegInf;
          s_s[r * Tk + c] = s;
        }
      }
    }
  }
  __syncthreads();

  // exact softmax of each row, normalised in f32, then rounded to V's dtype
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    float* row = s_s + r * Tk;
    float m = -INFINITY;
    for (int c = lane; c < Tk; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < Tk; c += 32) {
      const float p = expf(row[c] - m);
      row[c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < Tk; c += 32) row[c] = round_to<T>(row[c] / sum);
  }

  float o[4][kMaxJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) o[i][j] = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    __syncthreads();
    load_tile(kv_s, ld, v, b, k0, kBK, Tk, H, h, D);
    __syncthreads();
    pv_tile(o, s_s + k0, Tk, kv_s, ld, min(kBK, Tk - k0), D, ty, tx);
  }
  store_out(out, o, nullptr, b, q0, Tq, H, h, D, ty, tx);
}

// One block per (64-row q-tile, head, batch), looping over 64-row k-tiles
// with the online softmax; running m, l and the rescale factor per row in
// shared memory, the output accumulator in registers.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Tq, int Tk, int H, int D,
                     float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1, pld = kBK + 1;
  float* q_s = smem;
  float* k_s = q_s + kBQ * ld;
  float* v_s = k_s + kBK * ld;
  float* p_s = v_s + kBK * ld;
  float* m_s = p_s + kBQ * pld;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int offset = Tk - Tq;

  load_tile(q_s, ld, q, b, q0, kBQ, Tq, H, h, D);
  for (int r = tid; r < kBQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  int last = (Tk + kBK - 1) / kBK - 1;
  // causal: skip k-tiles strictly above the diagonal. A q-tile holding a
  // row with no key at all (T_q > T_k) visits every tile, so that row's
  // softmax runs over all keys at -1e30, as on the dense path and in the
  // one-pass kernel. This departs from the Pallas kernel on purpose: there
  // such a row gets 0/0 or a softmax over whichever tiles its q-tile visits.
  if (causal && q0 + offset >= 0) {
    const int qlast = min(q0 + kBQ, Tq) - 1;
    last = min(last, (qlast + offset) / kBK);
  }

  float o[4][kMaxJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) o[i][j] = 0.f;

  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile(k_s, ld, k, b, k0, kBK, Tk, H, h, D);
    load_tile(v_s, ld, v, b, k0, kBK, Tk, H, h, D);
    __syncthreads();
    float acc[4][4];
    score_tile(acc, q_s, k_s, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        float s;
        if (c >= Tk) {
          s = -INFINITY;  // past the ragged edge: no key, p = 0
        } else {
          s = acc[i][j] * scale;
          if (causal && c > q0 + r + offset) s = kNegInf;
        }
        p_s[r * pld + tx + 16 * j] = s;
      }
    }
    __syncthreads();

    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const float s0 = p_s[r * pld + lane], s1 = p_s[r * pld + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      // l sums the unrounded P; P.V uses P rounded to V's dtype
      p_s[r * pld + lane] = round_to<T>(p0);
      p_s[r * pld + lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) o[i][j] *= alpha;
    }
    pv_tile(o, p_s, pld, v_s, ld, kBK, D, ty, tx);
  }

  store_out(out, o, l_s, b, q0, Tq, H, h, D, ty, tx);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, t = q0 + r;
      if (t < Tq) lse[((size_t)b * Tq + t) * H + h] = m_s[r] + logf(l_s[r]);
    }
  }
}

template <typename T>
int launch_onepass(const void* q, const void* k, const void* v, void* out,
                   int B, int Tq, int Tk, int H, int D, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * (D + 1) +
                                       (size_t)kBQ * Tk);
  cudaError_t err = cudaFuncSetAttribute(
      onepass_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  onepass_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tq, Tk, H, D, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int Tq, int Tk, int H, int D, float scale,
                 int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 1) +
                       (size_t)kBQ * (kBK + 1) + 3 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Tq, Tk, H, D,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
extern "C" int onepass_attention_fwd(const void* q, const void* k,
                                     const void* v, void* out, int B, int Tq,
                                     int Tk, int H, int D, float scale,
                                     int causal, int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, D) || Tk > kOnepassMaxTk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_onepass<float>(q, k, v, out, B, Tq, Tk, H, D, scale, causal,
                                 s);
  if (dtype == 1)
    return launch_onepass<__nv_bfloat16>(q, k, v, out, B, Tq, Tk, H, D, scale,
                                         causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int B, int Tq, int Tk,
                                   int H, int D, float scale, int causal,
                                   int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_flash<float>(q, k, v, out, l, B, Tq, Tk, H, D, scale, causal,
                               s);
  if (dtype == 1)
    return launch_flash<__nv_bfloat16>(q, k, v, out, l, B, Tq, Tk, H, D, scale,
                                       causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
