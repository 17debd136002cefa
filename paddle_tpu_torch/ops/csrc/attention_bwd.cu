// Attention backward kernels for Hopper (sm_90a) on the [B, T, H, D] layout.
//
// onepass_attention_bwd replaces the Pallas kernel `_onepass_bwd_kernel`
// (paddle_tpu/ops/attention.py:146, called by onepass_attention_bwd_bthd).
// flash_attention_bwd_dq replaces `_bwd_dq_kernel` (attention.py:400) and
// flash_attention_bwd_dkv replaces `_bwd_dkv_kernel` (attention.py:447),
// both called by flash_attention_bwd_bthd.
//
// What bounds them on the H100. Per (batch, head) the one-pass backward
// does about 10*D operations per unmasked (row, col) pair (S, dP, dQ, dK,
// dV), the flash dq kernel 6*D (S, dP, dQ) and the dkv kernel 8*D (S, dP,
// dK, dV), against 4 inputs of T*D values read once and 3 (or 1, or 2)
// outputs written once. At T = 256 that is about 150 operations per bf16
// byte, under the card's ~295, so the one-pass backward is bound by its
// bytes; at T = 4096 the flash kernels are bound by their operations.
// Neither is near either bound in this version: as in the forward kernels
// the products run on the CUDA cores in f32 from shared memory (no wgmma, no
// TMA yet).
//
// What the design does about it. No [T, T] matrix reaches device memory.
// Blocks carry nothing across the grid, so the sums the Pallas kernels carry
// in VMEM scratch across sequential grid steps become loops inside a block:
//
// - one-pass, two launches. (a) One block per (64-row q-tile, head, batch)
//   holds the tile's whole 64 x T_k f32 score row block in shared memory
//   (128 KB at T_k = 512), takes the exact row max m and sum l as the
//   forward does, normalises P in f32, computes delta = rowsum(dP o P) from
//   P and dP (not from O, as at attention.py:164), then dS = P o (dP -
//   delta) * scale rounded to the input dtype and dQ = dS K, and writes m,
//   l and delta ([B, T_q, H] f32 each). (b) One block per (64-row k-tile,
//   head, batch) loops over q-tiles, rebuilds the same P = exp(S - m) / l
//   bit for bit (the same score arithmetic), and accumulates dV = P^T dO (P
//   rounded first) and dK = dS^T Q in f32 registers, rounding once.
// - flash: dq, one block per q-tile looping over k-tiles; dkv, one block per
//   k-tile looping over q-tiles (kernel (b) again, with P = exp(S - lse)).
//   delta = rowsum(dO o O) comes from outside (attention.py:524).
//
// Causal masks are bottom-right aligned (col <= row + T_k - T_q) and whole
// tiles above the diagonal are skipped, as the Pallas predicates skip them
// (attention.py:436, :492). A row with no key at all (causal, T_q > T_k)
// has the dense path's uniform P = 1/T_k over all keys and dS = 0 (its
// scores are constants), so it adds P^T dO to dV and nothing else; a
// q-tile holding such a row visits every k-tile in kernel (b).
//
// Rounding points follow the Pallas kernels: S and dP in f32, P in f32,
// dS = P o (dP - delta) * scale rounded to the input dtype, P rounded to
// the input dtype before P^T dO, all products accumulated in f32 and each
// output rounded once.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kPld = kBK + 1;   // row stride of the 64 x 64 P and dS tiles

// (a) One block per (64-row q-tile, head, batch) of the one-pass backward.
// Shared: Q, dO and one K/V tile, the 64 x T_k f32 score/probability tile,
// and delta per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    onepass_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          T* __restrict__ dq, float* __restrict__ row_m,
                          float* __restrict__ row_l,
                          float* __restrict__ row_delta, int Tq, int Tk,
                          int H, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;
  float* do_s = q_s + kBQ * ld;
  float* kv_s = do_s + kBQ * ld;
  float* s_s = kv_s + kBK * ld;
  float* delta_s = s_s + kBQ * Tk;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int offset = Tk - Tq;
  const int nk = (Tk + kBK - 1) / kBK;

  load_tile(q_s, ld, q, b, q0, kBQ, Tq, H, h, D);
  load_tile(do_s, ld, dout, b, q0, kBQ, Tq, H, h, D);
  // S = Q K^T * scale, masked, for the whole row block (as the forward)
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

  // exact softmax of each row, P normalised and kept in f32
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
    for (int c = lane; c < Tk; c += 32) row[c] = row[c] / sum;
    if (lane == 0 && q0 + r < Tq) {
      const size_t at = ((size_t)b * Tq + q0 + r) * H + h;
      row_m[at] = m;
      row_l[at] = sum;
    }
  }

  // k-tiles wholly above the diagonal hold P = 0 and dS = 0 for every row
  // of this q-tile (a keyless row has dS = 0 everywhere): skip them
  int kend = nk;
  if (causal) {
    const int lim = min(q0 + kBQ, Tq) - 1 + offset;
    kend = lim < 0 ? 0 : min(nk, lim / kBK + 1);
  }

  // delta = rowsum(dP o P), dP = dO V^T
  float part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile(kv_s, ld, v, b, k0, kBK, Tk, H, h, D);
    __syncthreads();
    float dp[4][4];
    score_tile(dp, do_s, kv_s, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c < Tk) part[i] += dp[i][j] * s_s[r * Tk + c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x = part[i];
    for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (tx == 0) {
      const int r = ty * 4 + i;
      delta_s[r] = x;
      if (q0 + r < Tq) row_delta[((size_t)b * Tq + q0 + r) * H + h] = x;
    }
  }
  __syncthreads();

  // dS = P o (dP - delta) * scale, rounded; dQ = dS K
  float o[4][kMaxJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) o[i][j] = 0.f;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile(kv_s, ld, v, b, k0, kBK, Tk, H, h, D);
    __syncthreads();
    float dp[4][4];
    score_tile(dp, do_s, kv_s, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c < Tk) {
          float ds = 0.f;
          if (!(causal && c > q0 + r + offset))
            ds = round_to<T>(s_s[r * Tk + c] * (dp[i][j] - delta_s[r]) *
                             scale);
          s_s[r * Tk + c] = ds;
        }
      }
    }
    __syncthreads();
    load_tile(kv_s, ld, k, b, k0, kBK, Tk, H, h, D);
    __syncthreads();
    pv_tile(o, s_s + k0, Tk, kv_s, ld, min(kBK, Tk - k0), D, ty, tx);
  }
  store_out(dq, o, nullptr, b, q0, Tq, H, h, D, ty, tx);
}

// (b) One block per (64-row k-tile, head, batch), looping over q-tiles:
// dV = sum_q P^T dO (P rounded), dK = sum_q dS^T Q. kNormalized: P =
// exp(S - m) / l from the one-pass kernel (a)'s row statistics; otherwise
// P = exp(S - lse) from the flash forward's lse.
template <typename T, bool kNormalized>
__global__ void __launch_bounds__(kThreads)
    bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ stat0,
                   const float* __restrict__ stat1,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, int Tq, int Tk, int H, int D,
                   float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* k_s = smem;
  float* v_s = k_s + kBK * ld;
  float* q_s = v_s + kBK * ld;
  float* do_s = q_s + kBQ * ld;
  float* pb_s = do_s + kBQ * ld;
  float* ds_s = pb_s + kBQ * kPld;
  float* st0_s = ds_s + kBQ * kPld;
  float* st1_s = st0_s + kBQ;
  float* dl_s = st1_s + kBQ;
  const int k0 = blockIdx.x * kBK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int offset = Tk - Tq;
  const float uniform = 1.f / (float)Tk;

  load_tile(k_s, ld, k, b, k0, kBK, Tk, H, h, D);
  load_tile(v_s, ld, v, b, k0, kBK, Tk, H, h, D);
  float dk_acc[4][kMaxJ], dv_acc[4][kMaxJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < Tq; q0 += kBQ) {
    // skip a q-tile whose every row sees none of this k-tile, unless it
    // holds a keyless row (uniform P over all keys)
    if (causal && q0 + offset >= 0 && min(q0 + kBQ, Tq) - 1 + offset < k0)
      continue;
    __syncthreads();
    load_tile(q_s, ld, q, b, q0, kBQ, Tq, H, h, D);
    load_tile(do_s, ld, dout, b, q0, kBQ, Tq, H, h, D);
    for (int r = tid; r < kBQ; r += kThreads) {
      const int t = q0 + r;
      const size_t at = ((size_t)b * Tq + t) * H + h;
      st0_s[r] = t < Tq ? stat0[at] : 0.f;
      st1_s[r] = (kNormalized && t < Tq) ? stat1[at] : 1.f;
      dl_s[r] = t < Tq ? delta[at] : 0.f;
    }
    __syncthreads();
    float acc[4][4], dp[4][4];
    score_tile(acc, q_s, k_s, ld, D, ty, tx);
    score_tile(dp, do_s, v_s, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, t = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tx + 16 * j, c = k0 + cc;
        float p = 0.f, ds = 0.f;
        if (t < Tq && c < Tk) {
          const bool masked = causal && c > t + offset;
          if (!kNormalized && causal && t + offset < 0) {
            p = uniform;                        // keyless row
          } else {
            const float s = masked ? kNegInf : acc[i][j] * scale;
            p = kNormalized ? expf(s - st0_s[r]) / st1_s[r]
                            : expf(s - st0_s[r]);
          }
          if (!masked) ds = round_to<T>(p * (dp[i][j] - dl_s[r]) * scale);
        }
        pb_s[r * kPld + cc] = round_to<T>(p);
        ds_s[r * kPld + cc] = ds;
      }
    }
    __syncthreads();
    for (int r = 0; r < kBQ; ++r) {
      float ap[4], ad[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ap[i] = pb_s[r * kPld + ty * 4 + i];
        ad[i] = ds_s[r * kPld + ty * 4 + i];
      }
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        const int col = tx + 16 * j;
        if (col < D) {
          const float dov = do_s[r * ld + col], qv = q_s[r * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][j] = fmaf(ap[i], dov, dv_acc[i][j]);
            dk_acc[i][j] = fmaf(ad[i], qv, dk_acc[i][j]);
          }
        }
      }
    }
  }
  store_out(dk, dk_acc, nullptr, b, k0, Tk, H, h, D, ty, tx);
  store_out(dv, dv_acc, nullptr, b, k0, Tk, H, h, D, ty, tx);
}

// Flash dq: one block per (64-row q-tile, head, batch), looping over the
// k-tiles the causal predicate keeps; dQ = sum_k dS K in f32 registers.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Tq, int Tk, int H, int D, float scale,
                        int causal) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* q_s = smem;
  float* do_s = q_s + kBQ * ld;
  float* k_s = do_s + kBQ * ld;
  float* v_s = k_s + kBK * ld;
  float* ds_s = v_s + kBK * ld;
  float* lse_s = ds_s + kBQ * kPld;
  float* dl_s = lse_s + kBQ;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int offset = Tk - Tq;

  load_tile(q_s, ld, q, b, q0, kBQ, Tq, H, h, D);
  load_tile(do_s, ld, dout, b, q0, kBQ, Tq, H, h, D);
  for (int r = tid; r < kBQ; r += kThreads) {
    const int t = q0 + r;
    const size_t at = ((size_t)b * Tq + t) * H + h;
    lse_s[r] = t < Tq ? lse[at] : 0.f;
    dl_s[r] = t < Tq ? delta[at] : 0.f;
  }
  int last = (Tk + kBK - 1) / kBK - 1;
  if (causal) {
    const int lim = min(q0 + kBQ, Tq) - 1 + offset;
    last = lim < 0 ? -1 : min(last, lim / kBK);
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
    float acc[4][4], dp[4][4];
    score_tile(acc, q_s, k_s, ld, D, ty, tx);
    score_tile(dp, do_s, v_s, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, t = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tx + 16 * j, c = k0 + cc;
        float ds = 0.f;
        if (t < Tq && c < Tk && !(causal && c > t + offset)) {
          const float p = expf(acc[i][j] * scale - lse_s[r]);
          ds = round_to<T>(p * (dp[i][j] - dl_s[r]) * scale);
        }
        ds_s[r * kPld + cc] = ds;
      }
    }
    __syncthreads();
    pv_tile(o, ds_s, kPld, k_s, ld, kBK, D, ty, tx);
  }
  store_out(dq, o, nullptr, b, q0, Tq, H, h, D, ty, tx);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t dkv_smem(int D) {
  return sizeof(float) * ((size_t)(2 * kBK + 2 * kBQ) * (D + 1) +
                          (size_t)2 * kBQ * kPld + 3 * kBQ);
}

template <typename T, bool kNormalized>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* st0, const float* st1, const float* delta,
               void* dk, void* dv, int B, int Tq, int Tk, int H, int D,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = dkv_smem(D);
  cudaError_t err = set_smem(bwd_dkv_kernel<T, kNormalized>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + kBK - 1) / kBK, H, B);
  bwd_dkv_kernel<T, kNormalized><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), st0, st1, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), Tq, Tk, H, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_onepass_bwd(const void* q, const void* k, const void* v,
                       const void* dout, void* dq, void* dk, void* dv,
                       float* row_m, float* row_l, float* row_delta, int B,
                       int Tq, int Tk, int H, int D, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(2 * kBQ + kBK) * (D + 1) +
                                       (size_t)kBQ * Tk + kBQ);
  cudaError_t err = set_smem(onepass_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  onepass_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), row_m, row_l, row_delta, Tq, Tk, H, D, scale,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_dkv<T, true>(q, k, v, dout, row_m, row_l, row_delta, dk, dv,
                             B, Tq, Tk, H, D, scale, causal, stream);
}

template <typename T>
int launch_flash_dq(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, int B, int Tq, int Tk, int H, int D,
                    float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) * (D + 1) +
                                       (size_t)kBQ * kPld + 2 * kBQ);
  cudaError_t err = set_smem(flash_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Tq, Tk, H, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t value (0 =
// ok). row_m, row_l and row_delta are [B, T_q, H] f32 scratch the caller
// allocates; lse and delta are [B, T_q, H] f32 inputs.
extern "C" int onepass_attention_bwd(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     void* dq, void* dk, void* dv,
                                     void* row_m, void* row_l,
                                     void* row_delta, int B, int Tq, int Tk,
                                     int H, int D, float scale, int causal,
                                     int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, D) || Tk > kOnepassMaxTk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *m = static_cast<float*>(row_m), *l = static_cast<float*>(row_l),
        *dl = static_cast<float*>(row_delta);
  if (dtype == 0)
    return launch_onepass_bwd<float>(q, k, v, dout, dq, dk, dv, m, l, dl, B,
                                     Tq, Tk, H, D, scale, causal, s);
  if (dtype == 1)
    return launch_onepass_bwd<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, m, l,
                                             dl, B, Tq, Tk, H, D, scale,
                                             causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int Tq, int Tk, int H,
                                      int D, float scale, int causal,
                                      int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return launch_flash_dq<float>(q, k, v, dout, l, dl, dq, B, Tq, Tk, H, D,
                                  scale, causal, s);
  if (dtype == 1)
    return launch_flash_dq<__nv_bfloat16>(q, k, v, dout, l, dl, dq, B, Tq, Tk,
                                          H, D, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int Tq,
                                       int Tk, int H, int D, float scale,
                                       int causal, int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return launch_dkv<float, false>(q, k, v, dout, l, nullptr, dl, dk, dv, B,
                                    Tq, Tk, H, D, scale, causal, s);
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16, false>(q, k, v, dout, l, nullptr, dl, dk,
                                            dv, B, Tq, Tk, H, D, scale,
                                            causal, s);
  return (int)cudaErrorInvalidValue;
}
