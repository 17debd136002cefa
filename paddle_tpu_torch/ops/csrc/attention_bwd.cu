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
//
// What the design does about it. No [T, T] matrix reaches device memory.
// Blocks carry nothing across the grid, so the sums the Pallas kernels carry
// in VMEM scratch across sequential grid steps become loops inside a block:
// dq, one block per q-tile looping over k-tiles; dk and dv, one block per
// k-tile looping over q-tiles. The entry points pick the code by dtype.
//
// - bfloat16 (flash_bwd_{dq,dkv}_kernel_wgmma<DP>,
//   onepass_bwd_{dq,dkv}_kernel_wgmma<DP>): every product runs on the tensor
//   cores (wgmma, f32 accumulate), which the flash kernels' operations bound
//   asks for and which keeps the one-pass kernel's products off its byte
//   bound's way. bf16 tiles in hopper.cuh's layout are filled by 16-byte
//   cp.async copies through a ring; S and dP (dkv: their transposes, so that
//   keys lie on wgmma's M) come out as accumulator fragments in registers,
//   P and dS form there and, rounded to bf16, become the register A operands
//   of the gradient products: no P or dS tile goes to shared memory. D is
//   padded with zero columns to DP = 64, 128 or 256; at DP = 256 the dq
//   kernel steps 32 keys through a 3-deep ring and the dkv kernel's two
//   warpgroups split D's output columns (see the constants below), to fit
//   the 227 KB of shared memory and the 255 registers a thread. The forward
//   kernels' pipeline (attention.cu) carries over: the next step's scores
//   are issued before this step's gradient products, so the exponentials
//   run while the tensor cores work. The one-pass backward is two launches
//   of the same machinery. (a) dq with the row statistics: per 128-row
//   q-tile, pass 1 runs S and dP over the <= 8 k-tiles and keeps each row's
//   max m and sum l online, and delta online as sum dP 2^(S' - m), rescaled
//   as m grows and divided by l at the end; pass 2 is the flash dq body
//   with P = 2^(S' - m) / l; it writes m (base 2), l and delta. (b) the
//   flash dkv body with P = 2^(S' - m) / l.
// - float32: the first version's CUDA-core kernels, products in f32 from
//   shared memory (the tensor cores take f32 only as TF32). One-pass, two
//   launches. (a) One block per (64-row q-tile, head, batch) holds the
//   tile's whole 64 x T_k f32 score row block in shared memory (128 KB at
//   T_k = 512), takes the exact row max m and sum l as the forward does,
//   normalises P in f32, computes delta = rowsum(dP o P) from P and dP (not
//   from O, as at attention.py:164), then dS = P o (dP - delta) * scale and
//   dQ = dS K, and writes m, l and delta ([B, T_q, H] f32 each). (b) One
//   block per (64-row k-tile, head, batch) loops over q-tiles, rebuilds the
//   same P = exp(S - m) / l bit for bit (the same score arithmetic), and
//   accumulates dV = P^T dO and dK = dS^T Q in f32 registers. The flash dkv
//   kernel is kernel (b) with P = exp(S - lse). They take any D % 8 == 0:
//   past 128 the output columns (dQ; dK and dV) split into 128-column
//   chunks, one block each, and S and dP stream through the same 129-wide
//   tiles in 128-column pieces, recomputed by every chunk's block
//   (attention_common.cuh): the score products cost ceil(D / 128) times
//   over, the tiles and registers stay those of D = 128.
//
// delta = rowsum(dO o O) for the flash kernels comes from outside
// (attention.py:524).
//
// Causal masks are bottom-right aligned (col <= row + T_k - T_q) and whole
// tiles above the diagonal are skipped, as the Pallas predicates skip them
// (attention.py:436, :492). A row with no key at all (causal, T_q > T_k)
// has the dense path's uniform P = 1/T_k over all keys and dS = 0 (its
// scores are constants), so it adds P^T dO to dV and nothing else; a
// q-tile holding such a row visits every k-tile in the dk/dv kernels.
//
// Rounding points follow the Pallas kernels: S and dP in f32, P in f32,
// dS = P o (dP - delta) * scale rounded to the input dtype, P rounded to
// the input dtype before P^T dO, all products accumulated in f32 and each
// output rounded once. The bf16 kernels take P in base 2 (scale and log2 e
// folded into one multiply-add with lse or m, the exponential on the
// special-function unit), as the forward kernels do. The tensor cores sum S
// and dP (and the one-pass kernel l and delta) in another order than the
// plain version, so single bf16 roundings of P and dS can flip
// (chip_smoke.py's backward rounding bounds say by how much); P from expf
// with the plain version's roundings flips the same terms, measured on the
// card, for 7-12% more time.

#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;

constexpr int kPld = kBK + 1;   // row stride of the 64 x 64 P and dS tiles

// (a) One block per (64-row q-tile and kDC-column dq chunk, head, batch) of
// the one-pass backward. Shared: Q, dO and one K/V tile, the 64 x T_k f32
// score/probability tile, and delta per row. Past kDC every chunk's block
// computes the same S, P and delta (S and dP streamed through the Q, dO
// and K/V tiles in pieces); the first chunk's writes m, l and delta.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    onepass_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          T* __restrict__ dq, float* __restrict__ row_m,
                          float* __restrict__ row_l,
                          float* __restrict__ row_delta, int Tq, int Tk,
                          int H, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = min(D, kDC) + 1;
  float* q_s = smem;
  float* do_s = q_s + kBQ * ld;
  float* kv_s = do_s + kBQ * ld;
  float* s_s = kv_s + kBK * ld;
  float* delta_s = s_s + kBQ * Tk;
  const Chunk ch(D);
  const bool whole = D <= kDC;
  const int q0 = ch.tile * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int offset = Tk - Tq;
  const int nk = (Tk + kBK - 1) / kBK;
  // dP = dO V^T of k-tile k0 (D > kDC: streamed, starting with a barrier)
  auto dp_tile = [&](float dp[4][4], int k0) {
    if (whole) {
      __syncthreads();
      load_tile(kv_s, ld, v, b, k0, kBK, Tk, H, h, D, 0, D);
      __syncthreads();
      score_tile(dp, do_s, kv_s, ld, D, ty, tx);
    } else {
      score_stream(dp, do_s, kv_s, ld, dout, q0, Tq, v, k0, Tk, b, H, h, D,
                   ty, tx);
    }
  };

  if (whole) {
    load_tile(q_s, ld, q, b, q0, kBQ, Tq, H, h, D, 0, D);
    load_tile(do_s, ld, dout, b, q0, kBQ, Tq, H, h, D, 0, D);
  }
  // S = Q K^T * scale, masked, for the whole row block (as the forward)
  for (int k0 = 0; k0 < Tk; k0 += kBK) {
    float acc[4][4];
    if (whole) {
      __syncthreads();
      load_tile(kv_s, ld, k, b, k0, kBK, Tk, H, h, D, 0, D);
      __syncthreads();
      score_tile(acc, q_s, kv_s, ld, D, ty, tx);
    } else {
      score_stream(acc, q_s, kv_s, ld, q, q0, Tq, k, k0, Tk, b, H, h, D, ty,
                   tx);
    }
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
    if (lane == 0 && q0 + r < Tq && ch.first) {
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
    float dp[4][4];
    dp_tile(dp, k0);
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
      if (q0 + r < Tq && ch.first)
        row_delta[((size_t)b * Tq + q0 + r) * H + h] = x;
    }
  }
  __syncthreads();

  // dS = P o (dP - delta) * scale, rounded; dQ = dS K (this chunk's columns)
  float o[4][kMaxJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxJ; ++j) o[i][j] = 0.f;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * kBK;
    float dp[4][4];
    dp_tile(dp, k0);
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
    load_tile(kv_s, ld, k, b, k0, kBK, Tk, H, h, D, ch.c0, ch.w);
    __syncthreads();
    pv_tile(o, s_s + k0, Tk, kv_s, ld, min(kBK, Tk - k0), ch.w, ty, tx);
  }
  store_out(dq, o, nullptr, b, q0, Tq, H, h, D, ch.c0, ch.w, ty, tx);
}

// (b) One block per (64-row k-tile and kDC-column dk/dv chunk, head, batch),
// looping over q-tiles: dV = sum_q P^T dO (P rounded), dK = sum_q dS^T Q.
// kNormalized: P = exp(S - m) / l from the one-pass kernel (a)'s row
// statistics; otherwise P = exp(S - lse) from the flash forward's lse. Past
// kDC every chunk's block computes the same S and dP, streamed through the
// K, Q, V and dO tiles in pieces, then loads Q's and dO's chunk columns.
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
  const int ld = min(D, kDC) + 1;
  float* k_s = smem;
  float* v_s = k_s + kBK * ld;
  float* q_s = v_s + kBK * ld;
  float* do_s = q_s + kBQ * ld;
  float* pb_s = do_s + kBQ * ld;
  float* ds_s = pb_s + kBQ * kPld;
  float* st0_s = ds_s + kBQ * kPld;
  float* st1_s = st0_s + kBQ;
  float* dl_s = st1_s + kBQ;
  const Chunk ch(D);
  const bool whole = D <= kDC;
  const int k0 = ch.tile * kBK, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int offset = Tk - Tq;
  const float uniform = 1.f / (float)Tk;

  if (whole) {
    load_tile(k_s, ld, k, b, k0, kBK, Tk, H, h, D, 0, D);
    load_tile(v_s, ld, v, b, k0, kBK, Tk, H, h, D, 0, D);
  }
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
    float acc[4][4], dp[4][4];
    if (!whole) {
      score_stream(acc, q_s, k_s, ld, q, q0, Tq, k, k0, Tk, b, H, h, D, ty,
                   tx);
      score_stream(dp, do_s, v_s, ld, dout, q0, Tq, v, k0, Tk, b, H, h, D,
                   ty, tx);
    }
    __syncthreads();
    load_tile(q_s, ld, q, b, q0, kBQ, Tq, H, h, D, ch.c0, ch.w);
    load_tile(do_s, ld, dout, b, q0, kBQ, Tq, H, h, D, ch.c0, ch.w);
    for (int r = tid; r < kBQ; r += kThreads) {
      const int t = q0 + r;
      const size_t at = ((size_t)b * Tq + t) * H + h;
      st0_s[r] = t < Tq ? stat0[at] : 0.f;
      st1_s[r] = (kNormalized && t < Tq) ? stat1[at] : 1.f;
      dl_s[r] = t < Tq ? delta[at] : 0.f;
    }
    __syncthreads();
    if (whole) {
      score_tile(acc, q_s, k_s, ld, D, ty, tx);
      score_tile(dp, do_s, v_s, ld, D, ty, tx);
    }
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
        if (col < ch.w) {
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
  store_out(dk, dk_acc, nullptr, b, k0, Tk, H, h, D, ch.c0, ch.w, ty, tx);
  store_out(dv, dv_acc, nullptr, b, k0, Tk, H, h, D, ch.c0, ch.w, ty, tx);
}

// Flash dq: one block per (64-row q-tile and kDC-column dq chunk, head,
// batch), looping over the k-tiles the causal predicate keeps; dQ = sum_k
// dS K in f32 registers. Past kDC every chunk's block computes the same S
// and dP, streamed through the Q, K, dO and V tiles in pieces, then loads
// K's chunk columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Tq, int Tk, int H, int D, float scale,
                        int causal) {
  extern __shared__ float smem[];
  const int ld = min(D, kDC) + 1;
  float* q_s = smem;
  float* do_s = q_s + kBQ * ld;
  float* k_s = do_s + kBQ * ld;
  float* v_s = k_s + kBK * ld;
  float* ds_s = v_s + kBK * ld;
  float* lse_s = ds_s + kBQ * kPld;
  float* dl_s = lse_s + kBQ;
  const Chunk ch(D);
  const bool whole = D <= kDC;
  const int q0 = ch.tile * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int offset = Tk - Tq;

  if (whole) {
    load_tile(q_s, ld, q, b, q0, kBQ, Tq, H, h, D, 0, D);
    load_tile(do_s, ld, dout, b, q0, kBQ, Tq, H, h, D, 0, D);
  }
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
    float acc[4][4], dp[4][4];
    if (whole) {
      __syncthreads();
      load_tile(k_s, ld, k, b, k0, kBK, Tk, H, h, D, 0, D);
      load_tile(v_s, ld, v, b, k0, kBK, Tk, H, h, D, 0, D);
      __syncthreads();
      score_tile(acc, q_s, k_s, ld, D, ty, tx);
      score_tile(dp, do_s, v_s, ld, D, ty, tx);
    } else {
      score_stream(acc, q_s, k_s, ld, q, q0, Tq, k, k0, Tk, b, H, h, D, ty,
                   tx);
      score_stream(dp, do_s, v_s, ld, dout, q0, Tq, v, k0, Tk, b, H, h, D,
                   ty, tx);
      // the second stream's barriers end every read of k_s
      load_tile(k_s, ld, k, b, k0, kBK, Tk, H, h, D, ch.c0, ch.w);
    }
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
    pv_tile(o, ds_s, kPld, k_s, ld, kBK, ch.w, ty, tx);
  }
  store_out(dq, o, nullptr, b, q0, Tq, H, h, D, ch.c0, ch.w, ty, tx);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t dkv_smem(int D) {
  return sizeof(float) * ((size_t)(2 * kBK + 2 * kBQ) * tile_ld(D) +
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
  const dim3 grid(chunked_blocks(Tk, kBK, D), H, B);
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
  const size_t smem = sizeof(float) * ((size_t)(2 * kBQ + kBK) * tile_ld(D) +
                                       (size_t)kBQ * Tk + kBQ);
  cudaError_t err = set_smem(onepass_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(chunked_blocks(Tq, kBQ, D), H, B);
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
  const size_t smem = sizeof(float) * ((size_t)(2 * kBQ + 2 * kBK) *
                                       tile_ld(D) +
                                       (size_t)kBQ * kPld + 2 * kBQ);
  cudaError_t err = set_smem(flash_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(chunked_blocks(Tq, kBQ, D), H, B);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), Tq, Tk, H, D, scale, causal);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// bfloat16: tensor cores
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;        // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;
// the masked score in base 2 (the softmax runs on S scale log2 e)
constexpr float kNegInf2 = kNegInf * kLog2e;
// dq (flash and one-pass): 128 query rows a block (64 a warpgroup); k-tiles
// of 64 keys through a 4-deep ring, or at DP = 256, where Q and dO take 128
// KB of shared memory and the dQ accumulator 128 registers a thread, of 32
// keys through a 3-deep ring (96 KB; S, dP and dS halve)
constexpr int kDqRows = 128;
template <int DP>
constexpr int kDqKeys = DP == 256 ? 32 : 64;
template <int DP>
constexpr int kDqStages = DP == 256 ? 3 : 4;
// dkv: a 4-deep ring of q-tiles of 64 rows (DP = 64) or 32 (so that dK and
// dV fit the registers beside S^T and dP^T). At DP = 64 and 128 each
// warpgroup owns 64 keys of a 128-key block. At DP = 256 dK and dV would
// take 256 registers a thread: the two warpgroups share a block's 64 keys,
// each owns half of D's output columns and computes S^T and dP^T over all
// of D for itself (1.5x the products, no exchange of P^T and dS^T).
constexpr int kDkvStages = 4;
template <int DP>
constexpr bool kDkvSplit = DP == 256;
template <int DP>
constexpr int kDkvKeys = kDkvSplit<DP> ? 64 : 128;
template <int DP>
constexpr int kDkvRows = DP == 64 ? 64 : 32;
template <int DP>
constexpr int kDpIndex = DP == 64 ? 0 : (DP == 128 ? 1 : 2);

// The pipeline every tensor-core backward kernel shares. A block walks
// steps; step j's streamed tiles sit in ring buffer j % NST, copied NST - 1
// steps ahead, one cp.async group a step, and one barrier a step makes step
// j + 1's tiles visible and frees step j - 1's buffer for the next copy. In
// step j each warpgroup issues the scores of step j + 1 (two products, one
// commit group), then the gradient products of step j (register A
// operands); it forms step j + 1's operands from the scores while the
// gradient products run on the tensor cores, and packs them once those are
// done. With kPass1, the first n_p1 steps (the one-pass dq kernel's first
// pass) take scores only. Every branch around a wgmma is uniform over the
// block (the loops are split by what their steps hold, and both warpgroups
// take every step), so the compiler keeps the wgmma asynchronous.
template <int NST, bool kPass1, typename Issue, typename Scores,
          typename Grads, typename Form, typename Pack, typename FenceS,
          typename FenceG>
__device__ __forceinline__ void run_steps(int n_p1, int n_steps, Issue issue,
                                          Scores scores, Grads grads,
                                          Form form, Pack pack,
                                          FenceS fence_scores,
                                          FenceG fence_grads) {
  for (int j = 0; j < NST - 1; ++j) issue(j);
  sm90::cp_async_wait<NST - 2>();                  // step 0 (and the tiles
  sm90::fence_async_shared();                      // loaded once)
  __syncthreads();
  sm90::wgmma_fence();
  scores(0);
  sm90::wgmma_wait<0>();
  fence_scores();
  form(0);
  pack();
  auto step = [&](int j, auto has_next, auto has_grads) {
    constexpr bool kNext = decltype(has_next)::value;
    constexpr bool kGrads = decltype(has_grads)::value;
    if (kNext) {
      sm90::cp_async_wait<NST - 3>();
      sm90::fence_async_shared();
    }
    __syncthreads();
    issue(j + NST - 1);
    sm90::wgmma_fence();
    if constexpr (kNext) scores(j + 1);
    if constexpr (kGrads) grads(j);
    if constexpr (kNext) {
      if constexpr (kGrads)
        sm90::wgmma_wait<1>();                     // the scores; grads run on
      else
        sm90::wgmma_wait<0>();
      fence_scores();
      form(j + 1);
    }
    if constexpr (kGrads) {
      sm90::wgmma_wait<0>();
      fence_grads();                               // A operands stay put
    }
    if constexpr (kNext) pack();                   // until here
  };
  using yes = std::true_type;
  using no = std::false_type;
  if constexpr (kPass1)
    for (int j = 0; j < n_p1; ++j) step(j, yes(), no());
  for (int j = kPass1 ? n_p1 : 0; j < n_steps - 1; ++j) step(j, yes(), yes());
  step(n_steps - 1, no(), yes());
}

// dq: one block per (128-row q-tile, head, batch). Q and dO load once; K
// and V stream through the ring a k-tile of KT keys a step. Per step, with
// this thread's rows ra and ra + 8 and S, dP in accumulator fragments: S =
// Q K^T, dP = dO V^T (K-major operands over D), P = 2^(S scale log2 e -
// l2), dS = P (dP - delta) scale, rounded to bf16 in registers as the A
// operand of dQ += dS K (K read MN-major). k-tiles above the diagonal of
// every row hold dS = 0 and are skipped (a keyless row's dS is 0
// everywhere); causal blocks with the most k-tiles launch first.
//
// Flash: l2 = lse log2 e and delta come from outside. One-pass (kOnepass):
// pass 1 walks the k-tiles once more before, with S and dP only, and keeps
// each row's running max m (base 2), sum l = sum 2^(S' - m) and
// sum dP 2^(S' - m), both rescaled as m grows (S' = S scale log2 e, masked
// as the forward masks it); then l2 = m, P = 2^(S' - m) / l in f32 and
// delta = (sum dP 2^(S' - m)) / l = rowsum(dP o P), from P and not from O.
// The launch writes m (base 2), l and delta, [B, T_q, H] f32 each, for the
// dk/dv launch.
template <int DP, bool kOnepass>
__device__ __forceinline__ void wgmma_dq(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, float* __restrict__ row_m,
    float* __restrict__ row_l, float* __restrict__ row_delta, int Tq, int Tk,
    int H, int D, float scale, int causal) {
  constexpr int C = DP / 8, KT = kDqKeys<DP>, NS = KT / 2;
  constexpr int NST = kDqStages<DP>;
  constexpr int kQ = kDqRows * DP * 2, kKV = KT * DP * 2;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t s_q = sm90::smem_addr(smem_tc), s_do = s_q + kQ;
  const uint32_t s_kv = s_do + kQ;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kDqRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int offset = Tk - Tq;
  int n_tiles = (Tk + KT - 1) / KT;
  if (causal) {
    const int lim = min(q0 + kDqRows, Tq) - 1 + offset;
    n_tiles = lim < 0 ? 0 : min(n_tiles, lim / KT + 1);
  }
  // steps: the one-pass pass 1 (a k-tile each), then a k-tile a step
  const int n_p1 = kOnepass ? n_tiles : 0;
  const int n_steps = n_p1 + n_tiles;
  auto tile_of = [&](int j) { return j < n_p1 ? j : j - n_p1; };
  // this warpgroup's first row, this thread's rows ra and ra + 8, the
  // first of its two columns in each 8-column block
  const int r0 = q0 + 64 * wg;
  const int ra = r0 + 16 * w + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  // per row: P's exponent's subtrahend (base 2), 1 / l (one-pass), delta;
  // the one-pass pass 1's running max, sum and sum of dP 2^(S' - m)
  float l2[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f}, dl[2] = {0.f, 0.f};
  float m2[2] = {kNegInf2, kNegInf2}, lsum[2] = {0.f, 0.f};
  float dsum[2] = {0.f, 0.f};
  if constexpr (!kOnepass) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = ra + 8 * i;
      const size_t at = ((size_t)b * Tq + t) * H + h;
      l2[i] = t < Tq ? lse[at] * kLog2e : 0.f;
      dl[i] = t < Tq ? delta[at] : 0.f;
    }
  }
  const float scale2 = scale * kLog2e;

  const sm90::TileCopy<KT, C, kTcThreads> k_copy(k, b, Tk, H, h, D);
  const sm90::TileCopy<KT, C, kTcThreads> v_copy(v, b, Tk, H, h, D);
  auto buf = [&](int j) { return (uint32_t)(j % NST) * 2 * kKV; };
  auto issue = [&](int j) {
    if (j < n_steps) {
      const int k0 = tile_of(j) * KT;
      k_copy.load(s_kv + buf(j), k0, Tk);
      v_copy.load(s_kv + buf(j) + kKV, k0, Tk);
    }
    sm90::cp_async_commit();
  };

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float s[NS], dp[NS];
  uint32_t ds[NS / 2];
  const uint64_t d_q = sm90::kmajor(s_q + wg * 64 * 16, kDqRows);
  const uint64_t d_do = sm90::kmajor(s_do + wg * 64 * 16, kDqRows);
  const uint64_t d_k = sm90::kmajor(s_kv, KT);
  const uint64_t d_v = sm90::kmajor(s_kv + kKV, KT);
  const uint64_t d_kn = sm90::mnmajor(s_kv, KT);
  auto scores = [&](int j) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t a = kk * 2 * kDqRows * 16 >> 4;
      const uint32_t bb = (buf(j) + kk * 2 * KT * 16) >> 4;
      sm90::wgmma_ss<KT>(s, d_q + a, d_k + bb, kk > 0);
      sm90::wgmma_ss<KT>(dp, d_do + a, d_v + bb, kk > 0);
    }
    sm90::wgmma_commit();
  };
  auto grads = [&](int j) {
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      sm90::wgmma_rs<DP, KT>(acc, ds[4 * kk], ds[4 * kk + 1],
                             ds[4 * kk + 2], ds[4 * kk + 3],
                             d_kn + ((buf(j) + kk * 256) >> 4));
    sm90::wgmma_commit();
  };
  // whether the k-tile at k0 holds columns past T_k or above the diagonal
  // of this warpgroup's rows
  auto ragged = [&](int k0) {
    return k0 + KT > Tk || (causal && k0 + KT - 1 > r0 + offset);
  };
  // one-pass pass 1 on the k-tile at k0: scores scaled (base 2) and masked
  // as the forward masks them (past T_k: -inf; above the diagonal: -1e30
  // log2 e, so a keyless row's P is uniform), then the running statistics
  auto stats = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] *= scale2;
    if (ragged(k0)) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = k0 + 8 * (i >> 2) + c0 + (i & 1);
        const int row = ra + ((i & 2) ? 8 : 0);
        const bool above = causal && col > row + offset;
        s[i] = col >= Tk ? -INFINITY : (above ? kNegInf2 : s[i]);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      mx[r] = fmaxf(mx[r], s[i]);
    }
    float mn[2], al[2], ps[2] = {0.f, 0.f}, pd[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mn[r] = fmaxf(m2[r], sm90::quad_max(mx[r]));
      al[r] = sm90::ex2(m2[r] - mn[r]);
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      const float p = sm90::ex2(s[i] - mn[r]);
      ps[r] += p;
      pd[r] = fmaf(p, dp[i], pd[r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] = al[r] * lsum[r] + sm90::quad_sum(ps[r]);
      dsum[r] = al[r] * dsum[r] + sm90::quad_sum(pd[r]);
      m2[r] = mn[r];
    }
  };
  // dS of the k-tile at k0 in s (f32): 0 past T_k and above the diagonal
  auto ds_form = [&](int k0) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int r = (i >> 1) & 1;
      float p = sm90::ex2(fmaf(s[i], scale2, -l2[r]));
      if constexpr (kOnepass) p *= inv[r];
      s[i] = p * (dp[i] - dl[r]) * scale;
    }
    if (ragged(k0)) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = k0 + 8 * (i >> 2) + c0 + (i & 1);
        const int row = ra + ((i & 2) ? 8 : 0);
        if (col >= Tk || (causal && col > row + offset)) s[i] = 0.f;
      }
    }
  };
  auto form = [&](int j) {
    if constexpr (kOnepass) {
      if (j < n_p1) {
        stats(j * KT);
        return;
      }
      if (j == n_p1) {                             // the final statistics
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l2[r] = m2[r];
          inv[r] = 1.f / lsum[r];
          dl[r] = dsum[r] / lsum[r];
        }
      }
    }
    ds_form(tile_of(j) * KT);
  };
  if (n_tiles > 0) {
    const sm90::TileCopy<kDqRows, C, kTcThreads> q_copy(q, b, Tq, H, h, D);
    const sm90::TileCopy<kDqRows, C, kTcThreads> do_copy(dout, b, Tq, H, h,
                                                         D);
    q_copy.load(s_q, q0, Tq);                      // join step 0's group
    do_copy.load(s_do, q0, Tq);
    run_steps<NST, kOnepass>(
        n_p1, n_steps, issue, scores, grads, form,
        [&]() { sm90::pack_tile<NS>(ds, s); },
        [&]() {
          sm90::fence_regs(s);
          sm90::fence_regs(dp);
        },
        [&]() {
          sm90::fence_regs(acc);
          sm90::fence_regs(ds);
        });
  }
  if (kOnepass && (lane & 3) == 0) {
    // a q-tile with no key at all (n_tiles = 0) writes m = -1e30 log2 e
    // and l = 0: the dk/dv launch gives its rows the uniform P itself
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = ra + 8 * r;
      if (t < Tq) {
        const size_t at = ((size_t)b * Tq + t) * H + h;
        row_m[at] = m2[r];
        row_l[at] = lsum[r];
        row_delta[at] = dl[r];
      }
    }
  }

  // dQ as bf16 into this warpgroup's rows of the Q tile (read only by its
  // own, finished products), then out by 16-byte stores
  sm90::stage_out<DP>(smem_tc, kDqRows, acc, 64 * wg + 16 * w + (lane >> 2),
                      lane);
  __syncthreads();
  sm90::store_tile<kDqRows, C, kTcThreads>(dq, smem_tc, b, q0, Tq, H, h, D);
}

// dk, dv: one block per (kDkvKeys<DP>-key k-tile, head, batch). K and V
// load once; Q, dO and the row vectors stream through the ring a q-tile of
// QB rows a step. The scores are taken transposed, so that keys lie on
// wgmma's M and dK, dV accumulate in registers: S^T = K Q^T, dP^T = V dO^T
// (K-major over D); P^T and dS^T form on the accumulator fragments (each
// thread's QB / 4 q columns read the row vectors from the ring) and,
// rounded to bf16, become the register A operands of dV += P^T dO and dK
// += dS^T Q (dO and Q read MN-major). No P or dS tile goes to shared
// memory. kNormalized (one-pass): P = 2^(S' - m) / l from the one-pass dq
// launch's row statistics (stat0 = m in base 2, stat1 = l); otherwise P =
// exp(S - lse) (stat0 = lse). Causal: q-tiles whose rows all precede the
// block's first key are skipped, except those holding a keyless row
// (uniform P = 1 / T_k over all keys, dS = 0); the first k-tiles, which
// see the most q-tiles, launch first.
template <int DP, bool kNormalized>
__device__ __forceinline__ void wgmma_dkv(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ stat0, const float* __restrict__ stat1,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Tq, int Tk, int H, int D, float scale,
    int causal) {
  constexpr int C = DP / 8;
  constexpr bool kSplit = kDkvSplit<DP>;
  constexpr int KB = kDkvKeys<DP>;                 // keys a block
  constexpr int DO = kSplit ? DP / 2 : DP;         // output columns a wg
  constexpr int QB = kDkvRows<DP>;                 // q rows a step
  constexpr int NS = QB / 2;                       // S^T registers a thread
  constexpr int kKV = KB * DP * 2, kQ = QB * DP * 2;
  constexpr int kVecs = kNormalized ? 3 : 2;       // lse or (m, l); delta
  constexpr int kStage = 2 * kQ + kVecs * QB * 4;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t s_k = sm90::smem_addr(smem_tc), s_v = s_k + kKV;
  const uint32_t s_ring = s_v + kKV;
  const int k0 = blockIdx.x * KB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int offset = Tk - Tq;
  // this warpgroup's first key row in the K and V tiles and its first key,
  // this thread's keys ka and ka + 8, the first of its two q columns in
  // each 8-column block; split: the byte offset of this warpgroup's output
  // chunk columns in an MN-major Q or dO tile
  const int wrow = kSplit ? 0 : 64 * wg;
  const int kw = k0 + wrow;
  const int ka = kw + 16 * w + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const uint32_t half = kSplit ? wg * (DO / 8) * QB * 16 : 0;

  // steps: q-tiles [0, n_kl) (keyless rows), then [first, nq)
  const int nq = (Tq + QB - 1) / QB;
  int n_kl = 0, first = 0;
  if (causal) {
    n_kl = offset < 0 ? min(nq, (-offset + QB - 1) / QB) : 0;
    first = max(n_kl, max(0, k0 - offset) / QB);
  }
  const int n_steps = n_kl + nq - first;
  auto row0 = [&](int j) { return (j < n_kl ? j : first + j - n_kl) * QB; };
  auto stage = [&](int j) { return (uint32_t)(j % kDkvStages) * kStage; };

  const sm90::TileCopy<QB, C, kTcThreads> q_copy(q, b, Tq, H, h, D);
  const sm90::TileCopy<QB, C, kTcThreads> do_copy(dout, b, Tq, H, h, D);
  // thread t < kVecs * QB copies row t % QB of vector t / QB
  const int vec = tid / QB, vrow = tid % QB;
  const float* vsrc = vec == 0 ? stat0 : (kNormalized && vec == 1 ? stat1
                                                                  : delta);
  auto issue = [&](int j) {
    if (j < n_steps) {
      const int q0 = row0(j);
      const uint32_t st = s_ring + stage(j);
      q_copy.load(st, q0, Tq);
      do_copy.load(st + kQ, q0, Tq);
      if (vec < kVecs) {
        const int t = q0 + vrow;
        const bool ok = t < Tq;
        sm90::cp_async4(st + 2 * kQ + (vec * QB + vrow) * 4,
                        ok ? vsrc + ((size_t)b * Tq + t) * H + h : vsrc, ok);
      }
    }
    sm90::cp_async_commit();
  };

  float dk_acc[DO / 2], dv_acc[DO / 2];
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float st_[NS], dpt[NS];
  uint32_t pa[NS / 2], dsa[NS / 2];
  const uint64_t d_k = sm90::kmajor(s_k + wrow * 16, KB);
  const uint64_t d_v = sm90::kmajor(s_v + wrow * 16, KB);
  const uint64_t d_q = sm90::kmajor(s_ring, QB);
  const uint64_t d_do = sm90::kmajor(s_ring + kQ, QB);
  const uint64_t d_qn = sm90::mnmajor(s_ring + half, QB);
  const uint64_t d_don = sm90::mnmajor(s_ring + kQ + half, QB);
  auto scores = [&](int j) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t a = kk * 2 * KB * 16 >> 4;
      const uint32_t bb = (stage(j) + kk * 2 * QB * 16) >> 4;
      sm90::wgmma_ss<QB>(st_, d_k + a, d_q + bb, kk > 0);
      sm90::wgmma_ss<QB>(dpt, d_v + a, d_do + bb, kk > 0);
    }
    sm90::wgmma_commit();
  };
  auto grads = [&](int j) {
#pragma unroll
    for (int kk = 0; kk < QB / 16; ++kk) {
      const uint32_t bb = (stage(j) + kk * 256) >> 4;
      sm90::wgmma_rs<DO, QB>(dv_acc, pa[4 * kk], pa[4 * kk + 1],
                             pa[4 * kk + 2], pa[4 * kk + 3], d_don + bb);
      sm90::wgmma_rs<DO, QB>(dk_acc, dsa[4 * kk], dsa[4 * kk + 1],
                             dsa[4 * kk + 2], dsa[4 * kk + 3], d_qn + bb);
    }
    sm90::wgmma_commit();
  };
  const float scale2 = scale * kLog2e, uniform = 1.f / (float)Tk;
  // P^T in st_ and dS^T in dpt (f32) of step j
  auto form = [&](int j) {
    const int q0 = row0(j);
    const float* vecs =
        reinterpret_cast<const float*>(smem_tc + 2 * kKV + stage(j) + 2 * kQ);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int cc = 8 * (i >> 2) + c0 + (i & 1);  // q column in the tile
      const float sub = kNormalized ? vecs[cc] : vecs[cc] * kLog2e;
      float p = sm90::ex2(fmaf(st_[i], scale2, -sub));
      if constexpr (kNormalized)          // rows past T_q read l = 0
        p = vecs[QB + cc] > 0.f ? p / vecs[QB + cc] : 0.f;
      st_[i] = p;
      dpt[i] = p * (dpt[i] - vecs[(kVecs - 1) * QB + cc]) * scale;
    }
    if (causal && (q0 + offset < 0 || kw + 63 > q0 + offset)) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int row = q0 + 8 * (i >> 2) + c0 + (i & 1);
        const int key = ka + ((i & 2) ? 8 : 0);
        if (row + offset < 0) {                    // keyless row
          st_[i] = uniform;
          dpt[i] = 0.f;
        } else if (key > row + offset) {
          st_[i] = 0.f;
          dpt[i] = 0.f;
        }
      }
    }
  };
  const sm90::TileCopy<KB, C, kTcThreads> k_copy(k, b, Tk, H, h, D);
  const sm90::TileCopy<KB, C, kTcThreads> v_copy(v, b, Tk, H, h, D);
  k_copy.load(s_k, k0, Tk);                        // join step 0's group
  v_copy.load(s_v, k0, Tk);
  run_steps<kDkvStages, false>(
      0, n_steps, issue, scores, grads, form,
      [&]() {
        sm90::pack_tile<NS>(pa, st_);
        sm90::pack_tile<NS>(dsa, dpt);
      },
      [&]() {
        sm90::fence_regs(st_);
        sm90::fence_regs(dpt);
      },
      [&]() {
        sm90::fence_regs(dk_acc);
        sm90::fence_regs(dv_acc);
        sm90::fence_regs(pa);
        sm90::fence_regs(dsa);
      });

  // dK and dV as bf16 into the K and V tiles (each warpgroup its rows, or
  // split, its chunk columns), then out by 16-byte stores. Split, both
  // warpgroups read every K and V row: all finish their products first.
  if constexpr (kSplit) __syncthreads();
  const int rl = wrow + 16 * w + (lane >> 2);
  const int col = kSplit ? wg * (DO / 8) * KB * 16 : 0;
  sm90::stage_out<DO>(smem_tc + col, KB, dk_acc, rl, lane);
  sm90::stage_out<DO>(smem_tc + kKV + col, KB, dv_acc, rl, lane);
  __syncthreads();
  sm90::store_tile<KB, C, kTcThreads>(dk, smem_tc, b, k0, Tk, H, h, D);
  sm90::store_tile<KB, C, kTcThreads>(dv, smem_tc + kKV, b, k0, Tk, H, h, D);
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_kernel_wgmma(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dq, int Tq, int Tk, int H,
                              int D, float scale, int causal) {
  wgmma_dq<DP, false>(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                      nullptr, Tq, Tk, H, D, scale, causal);
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_kernel_wgmma(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int Tq, int Tk, int H, int D, float scale,
                               int causal) {
  wgmma_dkv<DP, false>(q, k, v, dout, lse, nullptr, delta, dk, dv, Tq, Tk, H,
                       D, scale, causal);
}

// the one-pass backward's two launches: dq with the row statistics, then
// dk and dv from them
template <int DP>
__global__ void __launch_bounds__(kTcThreads)
    onepass_bwd_dq_kernel_wgmma(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const bf16* __restrict__ dout,
                                bf16* __restrict__ dq,
                                float* __restrict__ row_m,
                                float* __restrict__ row_l,
                                float* __restrict__ row_delta, int Tq, int Tk,
                                int H, int D, float scale, int causal) {
  wgmma_dq<DP, true>(q, k, v, dout, nullptr, nullptr, dq, row_m, row_l,
                     row_delta, Tq, Tk, H, D, scale, causal);
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads)
    onepass_bwd_dkv_kernel_wgmma(const bf16* __restrict__ q,
                                 const bf16* __restrict__ k,
                                 const bf16* __restrict__ v,
                                 const bf16* __restrict__ dout,
                                 const float* __restrict__ row_m,
                                 const float* __restrict__ row_l,
                                 const float* __restrict__ row_delta,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                                 int Tq, int Tk, int H, int D, float scale,
                                 int causal) {
  wgmma_dkv<DP, true>(q, k, v, dout, row_m, row_l, row_delta, dk, dv, Tq, Tk,
                      H, D, scale, causal);
}

template <int DP>
constexpr int dq_smem() {
  return 2 * kDqRows * DP * 2 + kDqStages<DP> * 2 * kDqKeys<DP> * DP * 2;
}
// kVecs row vectors a stage: lse and delta (flash), m, l and delta
// (one-pass)
template <int DP, int kVecs>
constexpr int dkv_smem() {
  return 2 * kDkvKeys<DP> * DP * 2 +
         kDkvStages * (2 * kDkvRows<DP> * DP * 2 + kVecs * kDkvRows<DP> * 4);
}
static_assert(dq_smem<256>() <= 232448 && dkv_smem<256, 3>() <= 232448,
              "a block's shared memory fits the 227 KB of an H100");

inline bool misaligned(std::initializer_list<const void*> ptrs) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return any % 16 != 0;
}

// a tensor-core kernel with its dynamic shared memory, launched
template <typename Kernel, typename... Args>
int launch_tc(Kernel kernel, int smem, dim3 grid, cudaStream_t stream,
              Args... args) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kTcThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// the bf16 kernels for D <= DP, launched; each records its name in *name
template <int DP>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, int B, int Tq, int Tk, int H, int D,
                    float scale, int causal, cudaStream_t stream,
                    const char** name) {
  static const char* const names[3] = {"flash_bwd_dq_kernel_wgmma<64>",
                                       "flash_bwd_dq_kernel_wgmma<128>",
                                       "flash_bwd_dq_kernel_wgmma<256>"};
  *name = names[kDpIndex<DP>];
  // 16-byte copies need 16-byte aligned rows (D % 8 == 0 gives the rest)
  if (misaligned({q, k, v, dout, dq})) return (int)cudaErrorMisalignedAddress;
  return launch_tc(flash_bwd_dq_kernel_wgmma<DP>, dq_smem<DP>(),
                   dim3((Tq + kDqRows - 1) / kDqRows, H, B), stream,
                   static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                   lse, delta, static_cast<bf16*>(dq), Tq, Tk, H, D, scale,
                   causal);
}

template <int DP>
int launch_dkv_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int B, int Tq, int Tk, int H, int D,
                     float scale, int causal, cudaStream_t stream,
                     const char** name) {
  static const char* const names[3] = {"flash_bwd_dkv_kernel_wgmma<64>",
                                       "flash_bwd_dkv_kernel_wgmma<128>",
                                       "flash_bwd_dkv_kernel_wgmma<256>"};
  *name = names[kDpIndex<DP>];
  if (misaligned({q, k, v, dout, dk, dv}))
    return (int)cudaErrorMisalignedAddress;
  return launch_tc(flash_bwd_dkv_kernel_wgmma<DP>, dkv_smem<DP, 2>(),
                   dim3((Tk + kDkvKeys<DP> - 1) / kDkvKeys<DP>, H, B),
                   stream, static_cast<const bf16*>(q),
                   static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                   static_cast<const bf16*>(dout), lse, delta,
                   static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, H,
                   D, scale, causal);
}

template <int DP>
int launch_onepass_bwd_wgmma(const void* q_, const void* k_,
                             const void* v_, const void* dout_, void* dq,
                             void* dk, void* dv, float* row_m, float* row_l,
                             float* row_delta,
                             int B, int Tq, int Tk, int H, int D, float scale,
                             int causal, cudaStream_t stream,
                             const char** name) {
  static const char* const names[3] = {
      "onepass_bwd_dq_kernel_wgmma<64> + onepass_bwd_dkv_kernel_wgmma<64>",
      "onepass_bwd_dq_kernel_wgmma<128> + onepass_bwd_dkv_kernel_wgmma<128>",
      "onepass_bwd_dq_kernel_wgmma<256> + onepass_bwd_dkv_kernel_wgmma<256>"};
  *name = names[kDpIndex<DP>];
  if (misaligned({q_, k_, v_, dout_, dq, dk, dv}))
    return (int)cudaErrorMisalignedAddress;
  const bf16 *q = static_cast<const bf16*>(q_),
             *k = static_cast<const bf16*>(k_),
             *v = static_cast<const bf16*>(v_),
             *dout = static_cast<const bf16*>(dout_);
  const int err = launch_tc(onepass_bwd_dq_kernel_wgmma<DP>, dq_smem<DP>(),
                            dim3((Tq + kDqRows - 1) / kDqRows, H, B), stream,
                            q, k, v, dout, static_cast<bf16*>(dq), row_m,
                            row_l, row_delta, Tq, Tk, H, D, scale, causal);
  if (err != 0) return err;
  return launch_tc(onepass_bwd_dkv_kernel_wgmma<DP>, dkv_smem<DP, 3>(),
                   dim3((Tk + kDkvKeys<DP> - 1) / kDkvKeys<DP>, H, B),
                   stream, q, k, v, dout, (const float*)row_m,
                   (const float*)row_l, (const float*)row_delta,
                   static_cast<bf16*>(dk), static_cast<bf16*>(dv), Tq, Tk, H,
                   D, scale, causal);
}

}  // namespace

// name of the kernel instantiation(s) the last entry-point call launched
// (the one-pass backward: both launches, "dq + dkv")
static const char* g_last_kernel = "";

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t value (0 =
// ok). row_m, row_l and row_delta are [B, T_q, H] f32 scratch the caller
// allocates; lse and delta are [B, T_q, H] f32 inputs. bfloat16 runs on the
// tensor cores (*_wgmma<DP>, DP = D padded to 64, 128 or 256) up to D =
// 256 and on the CUDA cores (*<__nv_bfloat16>) past it, float32 on the CUDA
// cores at every D.
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
  if (dtype == 0) {
    g_last_kernel =
        "onepass_bwd_dq_kernel<float> + bwd_dkv_kernel<float, true>";
    return launch_onepass_bwd<float>(q, k, v, dout, dq, dk, dv, m, l, dl, B,
                                     Tq, Tk, H, D, scale, causal, s);
  }
  if (dtype == 1 && D > kMaxDWgmma) {
    g_last_kernel =
        "onepass_bwd_dq_kernel<__nv_bfloat16> + "
        "bwd_dkv_kernel<__nv_bfloat16, true>";
    return launch_onepass_bwd<bf16>(q, k, v, dout, dq, dk, dv, m, l, dl, B,
                                    Tq, Tk, H, D, scale, causal, s);
  }
  if (dtype == 1)
    return by_dp(D, [&](auto dp) {
      constexpr int DP = decltype(dp)::value;
      return launch_onepass_bwd_wgmma<DP>(q, k, v, dout, dq, dk, dv, m, l, dl,
                                          B, Tq, Tk, H, D, scale, causal, s,
                                          &g_last_kernel);
    });
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
  if (dtype == 0) {
    g_last_kernel = "flash_bwd_dq_kernel<float>";
    return launch_flash_dq<float>(q, k, v, dout, l, dl, dq, B, Tq, Tk, H, D,
                                  scale, causal, s);
  }
  if (dtype == 1 && D > kMaxDWgmma) {
    g_last_kernel = "flash_bwd_dq_kernel<__nv_bfloat16>";
    return launch_flash_dq<bf16>(q, k, v, dout, l, dl, dq, B, Tq, Tk, H, D,
                                 scale, causal, s);
  }
  if (dtype == 1)
    return by_dp(D, [&](auto dp) {
      constexpr int DP = decltype(dp)::value;
      return launch_dq_wgmma<DP>(q, k, v, dout, l, dl, dq, B, Tq, Tk, H, D,
                                 scale, causal, s, &g_last_kernel);
    });
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
  if (dtype == 0) {
    g_last_kernel = "bwd_dkv_kernel<float, false>";
    return launch_dkv<float, false>(q, k, v, dout, l, nullptr, dl, dk, dv, B,
                                    Tq, Tk, H, D, scale, causal, s);
  }
  if (dtype == 1 && D > kMaxDWgmma) {
    g_last_kernel = "bwd_dkv_kernel<__nv_bfloat16, false>";
    return launch_dkv<bf16, false>(q, k, v, dout, l, nullptr, dl, dk, dv, B,
                                   Tq, Tk, H, D, scale, causal, s);
  }
  if (dtype == 1)
    return by_dp(D, [&](auto dp) {
      constexpr int DP = decltype(dp)::value;
      return launch_dkv_wgmma<DP>(q, k, v, dout, l, dl, dk, dv, B, Tq, Tk, H,
                                  D, scale, causal, s, &g_last_kernel);
    });
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* attention_bwd_last_kernel() { return g_last_kernel; }
