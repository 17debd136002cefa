// Attention forward kernels for Hopper (sm_90a) on the [B, T, H, D] layout.
//
// onepass_fwd_kernel_* replaces the Pallas kernel `_onepass_fwd_kernel`
// (paddle_tpu/ops/attention.py:123, called by onepass_attention_fwd_bthd).
// flash_fwd_kernel_* replaces the Pallas kernel `_fwd_kernel`
// (paddle_tpu/ops/attention.py:272, called by flash_attention_fwd_bthd).
// The entry points pick the code by dtype: bfloat16 runs the tensor-core
// kernels (*_wgmma<DP>) up to D = 256 and the CUDA-core kernels
// (*<__nv_bfloat16>) past it, float32 the CUDA-core kernels (*<float>),
// since the tensor cores take f32 only as TF32 (about three decimal digits).
//
// What bounds them on the H100. Per (batch, head) both kernels read Q, K and
// V once and write O once, and do 4*D operations per unmasked (row, col)
// pair: T/2 operations per bf16 byte at T_q = T_k = T (half that when
// causal), so 128 at the one-pass path shape T = 256 and 2048 at the flash
// shape T = 4096. Against the card's ~295 bf16 operations per byte, the
// one-pass kernel is bound by its bytes and the flash kernel by its
// operations; the flash kernel's exp of every score is a second ceiling
// (16 a cycle per SM on the special-function units), about as low as the
// tensor cores' at D = 64.
//
// What the bf16 design does about it. Both products run on the tensor cores
// (wgmma, f32 accumulate): the flash kernel's bound is operations, and wgmma
// is the only way to the card's full rate. Q, K and V stay bf16 all the way:
// 16-byte cp.async copies fill shared tiles laid out as wgmma reads them
// (hopper.cuh), through a ring of four K/V buffers, so that the copies of
// the next two tiles overlap this tile's products and one barrier a tile
// suffices. A block holds two warpgroups, each owning 64 rows of a 128-row
// q-tile and sharing the K/V tiles; S and O live in registers, the softmax
// runs on the accumulator fragments (row max and sum by quad shuffles,
// exponentials in base 2 on the special-function unit), and P becomes the
// bf16 register A operand of P.V, with V as the MN-major B operand. Each
// warpgroup issues the next tile's S before this tile's P.V and runs the
// softmax while P.V is on the tensor cores. The one-pass kernel normalises
// P before its cast, which needs each row's final max and sum before any
// P.V: pass 1 runs S over the k-tiles for m and l, pass 2 recomputes S,
// forms P = exp(S - m) / l in f32, rounds it and multiplies by V (1.5x the
// operations, still under the byte bound at T = 256, and no 64 x T_k f32
// score buffer). D is padded in shared memory with zero columns to DP = 64,
// 128 or 256, so the contraction of QK^T and the N of P.V are whole wgmma
// shapes (N = 256 as two n128 halves). At DP = 256 a block holds one
// warpgroup and a 3-deep ring, to fit the 227 KB of shared memory. Ragged
// edges are masked here (columns past T_k to -inf, p = 0; rows past T read
// as zero, never the next batch's rows). Causal: k-tiles
// strictly above the diagonal of the q-tile are skipped, and the q-tiles
// with the most k-tiles launch first.
//
// The float32 kernels keep the first version's design: a 16 x 16 thread
// block with 4 x 4 register micro-tiles on the CUDA cores, f32 tiles in
// shared memory padded to D + 1, and (one-pass) a 64 x T_k f32 score tile.
// They take any D % 8 == 0: past 128 columns the output splits into
// 128-column chunks, one block each, and S streams through the same
// 129-wide tiles in 128-column pieces, recomputed by every chunk's block
// (attention_common.cuh), so the tiles and registers stay those of D = 128
// and the score products cost ceil(D / 128) times over. bfloat16 past
// D = 256 (the widest the tensor-core kernels pad to) runs them too,
// instantiated for __nv_bfloat16.
//
// Rounding points follow the Pallas kernels: scores in f32 with the scale
// applied after the product (the bf16 kernels fold log2(e) into that one
// multiply and run the softmax in base 2), causal mask to -1e30
// (bottom-right aligned: col <= row + T_k - T_q), P cast to V's dtype
// before P.V, P.V accumulated in f32, output rounded once to q's dtype.
// The one-pass kernel normalises P in f32 before the cast; the flash
// kernel casts the unnormalised P per k-tile, divides the accumulator by l
// at the end, and writes lse = m + log l. A causal row with no key at all
// (T_q > T_k) gets the uniform softmax over all keys: its q-tile visits
// every k-tile.

#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;

// --------------------------------------------------------------------------
// bfloat16: tensor cores
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTK = 64;                // keys per k-tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the softmax runs in base 2: scores times log2(e), so the causal mask
// value is -1e30 * log2(e)
constexpr float kNegInf2 = kNegInf * kLog2e;

// Per DP: warpgroups a block (64 q rows each) and K/V buffers in the ring
// (a step's copy is issued kStages - 1 steps ahead). At DP = 256 a 128-row
// Q tile and four 64-key K/V pairs would take 320 KB of the 227 KB a block
// may use: one warpgroup (32 KB of Q) and a 3-deep ring (192 KB) fit.
template <int DP>
constexpr int kWG = DP == 256 ? 1 : 2;
template <int DP>
constexpr int kStages = DP == 256 ? 3 : 4;
template <int DP>
constexpr int kTQ = 64 * kWG<DP>;      // query rows per block
template <int DP>
constexpr int kTcThreads = 128 * kWG<DP>;

// shared memory of one block: the Q tile, then kStages (K, V) tile pairs
template <int DP>
struct WgSmem {
  static constexpr int kQ = kTQ<DP> * DP * 2;
  static constexpr int kKV = kTK * DP * 2;
  static constexpr int kBytes = kQ + kStages<DP> * 2 * kKV;
};

// Softmax pieces on one k-tile of base-2 scores s in accumulator layout:
// s[4t + 2r + {0, 1}] is row r's (a: 0, b: 1) pair of columns in 8-column
// block t of this thread. Maxes and sums are taken as trees, to keep the
// chains of dependent instructions short.

// max over this thread's columns of rows a and b, folded into mx_*
__device__ __forceinline__ void tile_max(const float (&s)[32], float& mx_a,
                                         float& mx_b) {
  float x[8], y[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    x[t] = fmaxf(s[4 * t], s[4 * t + 1]);
    y[t] = fmaxf(s[4 * t + 2], s[4 * t + 3]);
  }
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int t = 0; t < w; ++t) {
      x[t] = fmaxf(x[t], x[t + w]);
      y[t] = fmaxf(y[t], y[t + w]);
    }
  mx_a = fmaxf(mx_a, x[0]);
  mx_b = fmaxf(mx_b, y[0]);
}

// s becomes 2^(s - m) for its row's m; the sums over this thread's columns
// are added to sum_*. s - m first: at s = m = -1e30 log2(e) (a row with no
// key) it is 0.
__device__ __forceinline__ void exp_sum(float (&s)[32], float m_a, float m_b,
                                        float& sum_a, float& sum_b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = sm90::ex2(s[i] - ((i & 2) ? m_b : m_a));
  float x[8], y[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    x[t] = s[4 * t] + s[4 * t + 1];
    y[t] = s[4 * t + 2] + s[4 * t + 3];
  }
#pragma unroll
  for (int w = 4; w > 0; w >>= 1)
#pragma unroll
    for (int t = 0; t < w; ++t) {
      x[t] += x[t + w];
      y[t] += y[t + w];
    }
  sum_a += x[0];
  sum_b += y[0];
}

// One block per (q-tile of kTQ<DP> rows: 128, or 64 at DP = 256, head,
// batch); warpgroup wg owns q rows [64 wg, 64 wg + 64) of the tile and walks
// 64-key k-tiles in steps. The
// flash kernel takes one step a k-tile with the online softmax. The
// one-pass kernel takes two passes, a step a k-tile: pass 1 (S only: the
// rows' m and l), then pass 2 (S again, P = exp(S - m) / l, P.V).
//
// Pipeline. Step j's K and V tiles (pass 1: K only) sit in ring buffer
// j % kStages, copied kStages - 1 steps ahead, one cp.async group a step;
// one barrier a step makes step j + 1's tiles visible and frees step
// j - 1's buffer for the next copy. In step j a warpgroup issues
// S(j + 1) = Q K(j + 1)^T, then P(j).V(j); it runs the softmax of S(j + 1)
// while P.V is still on the tensor cores, and rescales O and packs
// P(j + 1) once P.V is done. Every
// branch around a wgmma is uniform over the block (the loops are split by
// what their steps hold, and both warpgroups take every step of the block),
// so the compiler keeps the wgmma asynchronous.
template <int DP, bool kOnepass>
__device__ __forceinline__ void wgmma_fwd(const bf16* __restrict__ q,
                                          const bf16* __restrict__ k,
                                          const bf16* __restrict__ v,
                                          bf16* __restrict__ out,
                                          float* __restrict__ lse, int Tq,
                                          int Tk, int H, int D, float scale,
                                          int causal) {
  using Sm = WgSmem<DP>;
  constexpr int C = DP / 8;
  // q rows, ring buffers and threads of a block
  constexpr int QR = kTQ<DP>, NS = kStages<DP>, NT = kTcThreads<DP>;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t s_q = sm90::smem_addr(wg_smem);
  const uint32_t s_kv = s_q + Sm::kQ;
  // causal: the q-tiles with the most k-tiles launch first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * QR, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7, w = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int offset = Tk - Tq;

  // causal: skip k-tiles strictly above the diagonal; a q-tile holding a
  // row with no key visits them all
  int last = (Tk + kTK - 1) / kTK - 1;
  if (causal && q0 + offset >= 0)
    last = min(last, (min(q0 + QR, Tq) - 1 + offset) / kTK);
  const int n_tiles = last + 1;
  // steps: the one-pass kernel's pass 1 (one a k-tile), then a k-tile a
  // step with P.V
  const int n_p1 = kOnepass ? n_tiles : 0;
  const int n_steps = n_p1 + n_tiles;
  auto pass1 = [&](int step) { return step < n_p1; };
  auto tile_of = [&](int step) { return pass1(step) ? step : step - n_p1; };

  // this warpgroup's first row, this thread's accumulator rows ra and
  // ra + 8, and the first of its two columns in each 8-column block
  const int r0 = q0 + 64 * wg;
  const int ra = r0 + 16 * w + (lane >> 2);
  const int c0 = 2 * (lane & 3);

  const sm90::TileCopy<kTK, C, NT> k_copy(k, b, Tk, H, h, D);
  const sm90::TileCopy<kTK, C, NT> v_copy(v, b, Tk, H, h, D);
  // byte offset of a step's K buffer from the first; V follows at + kKV
  auto buf = [&](int step) {
    return (uint32_t)(step % NS) * 2 * Sm::kKV;
  };
  auto issue = [&](int step) {
    if (step < n_steps) {
      const int k0 = tile_of(step) * kTK;
      k_copy.load(s_kv + buf(step), k0, Tk);
      if (!pass1(step)) v_copy.load(s_kv + buf(step) + Sm::kKV, k0, Tk);
    }
    sm90::cp_async_commit();
  };

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  // running max (base 2) and sum of this thread's rows
  float m_a = kNegInf2, m_b = kNegInf2, l_a = 0.f, l_b = 0.f;
  float inv_a = 0.f, inv_b = 0.f, al_a = 1.f, al_b = 1.f;
  const float scale2 = scale * kLog2e;
  float s[32];
  uint32_t p[16];

  // wgmma descriptors of this warpgroup's Q rows and of the first K and V
  // buffers; a step and a k16 slice add their byte offset / 16
  const uint64_t d_q = sm90::kmajor(s_q + wg * 64 * 16, QR);
  const uint64_t d_k = sm90::kmajor(s_kv, kTK);
  const uint64_t d_v = sm90::mnmajor(s_kv + Sm::kKV, kTK);
  // S(step) = Q K^T into s (issued, not waited for)
  auto scores = [&](int step) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      sm90::wgmma_ss_n64(s, d_q + (kk * 2 * QR * 16 >> 4),
                         d_k + ((buf(step) + kk * 2 * kTK * 16) >> 4),
                         kk > 0);
    sm90::wgmma_commit();
  };
  // O += P(step) V(step) (issued, not waited for)
  auto pv = [&](int step) {
#pragma unroll
    for (int kk = 0; kk < kTK / 16; ++kk)
      sm90::wgmma_rs<DP, kTK>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                         p[4 * kk + 3],
                         d_v + ((buf(step) + kk * 16 * 16) >> 4));
    sm90::wgmma_commit();
  };
  // scores of the k-tile at k0 scaled (base 2) and masked: columns past T_k
  // to -inf, above the diagonal to -1e30 log2(e)
  auto scale_mask = [&](float (&x)[32], int k0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] *= scale2;
    if (k0 + kTK > Tk || (causal && k0 + kTK - 1 > r0 + offset)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + 8 * (i >> 2) + c0 + (i & 1);
        const int row = ra + ((i & 2) ? 8 : 0);
        const bool above = causal && col > row + offset;
        x[i] = col >= Tk ? -INFINITY : (above ? kNegInf2 : x[i]);
      }
    }
  };
  // the online softmax (flash; one-pass pass 1) or P = 2^(S - m) / l with
  // the final m and l (one-pass pass 2)
  auto softmax = [&](int step) {
    const int k0 = tile_of(step) * kTK;
    scale_mask(s, k0);
    if (kOnepass && !pass1(step)) {
      if (k0 == 0) {
        inv_a = 1.f / l_a;
        inv_b = 1.f / l_b;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = sm90::ex2(s[i] - ((i & 2) ? m_b : m_a)) *
               ((i & 2) ? inv_b : inv_a);
      return;
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
    tile_max(s, mx_a, mx_b);
    const float mn_a = fmaxf(m_a, sm90::quad_max(mx_a));
    const float mn_b = fmaxf(m_b, sm90::quad_max(mx_b));
    al_a = sm90::ex2(m_a - mn_a);
    al_b = sm90::ex2(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
    exp_sum(s, mn_a, mn_b, sum_a, sum_b);
    l_a = al_a * l_a + sm90::quad_sum(sum_a);
    l_b = al_b * l_b + sm90::quad_sum(sum_b);
    m_a = mn_a;
    m_b = mn_b;
  };
  // once P.V(step - 1) is done: O rescaled (flash), P(step) packed to bf16
  // (l summed the unrounded P)
  auto to_p = [&]() {
    if (!kOnepass) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= (i & 2) ? al_b : al_a;
    }
    sm90::pack_tile<32>(p, s);
  };
  // step j: wait for step j + 1's tiles, refill step j - 1's buffer, then
  // S(j + 1) and P(j).V(j) as the step holds them
  auto step = [&](int j, auto has_next, auto has_pv) {
    constexpr bool kNext = decltype(has_next)::value;
    constexpr bool kPv = decltype(has_pv)::value;
    if (kNext) {
      sm90::cp_async_wait<NS - 3>();
      sm90::fence_async_shared();
    }
    __syncthreads();
    issue(j + NS - 1);
    sm90::wgmma_fence();
    if constexpr (kNext) scores(j + 1);
    if constexpr (kPv) pv(j);
    if constexpr (kNext) {
      if constexpr (kPv)
        sm90::wgmma_wait<1>();                   // S(j + 1); P.V runs on
      else
        sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      softmax(j + 1);
    }
    if constexpr (kPv) {
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(p);                       // P stays put until here
    }
    if (kNext && !pass1(j + 1)) to_p();
  };
  using yes = std::true_type;
  using no = std::false_type;

  const sm90::TileCopy<QR, C, NT> q_copy(q, b, Tq, H, h, D);
  q_copy.load(s_q, q0, Tq);                      // joins step 0's group
  for (int j = 0; j < NS - 1; ++j) issue(j);
  sm90::cp_async_wait<NS - 2>();            // Q and step 0
  sm90::fence_async_shared();
  __syncthreads();
  sm90::wgmma_fence();
  scores(0);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  softmax(0);
  if (!pass1(0)) to_p();
  for (int j = 0; j < n_p1; ++j) step(j, yes(), no());
  for (int j = n_p1; j < n_steps - 1; ++j) step(j, yes(), yes());
  step(n_steps - 1, no(), yes());

  // O (divided by l for flash) as bf16 into this warpgroup's rows of the Q
  // tile (read only by its own, finished products), then out by 16-byte
  // stores; rows past T_q are dropped
  sm90::stage_out<DP>(wg_smem, QR, o, 64 * wg + 16 * w + (lane >> 2), lane,
                      kOnepass ? 1.f : l_a, kOnepass ? 1.f : l_b);
  if (!kOnepass && (lane & 3) == 0) {
    if (ra < Tq)
      lse[((size_t)b * Tq + ra) * H + h] = m_a * kLn2 + logf(l_a);
    if (ra + 8 < Tq)
      lse[((size_t)b * Tq + ra + 8) * H + h] = m_b * kLn2 + logf(l_b);
  }
  __syncthreads();
  sm90::store_tile<QR, C, NT>(out, wg_smem, b, q0, Tq, H, h, D);
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads<DP>)
    onepass_fwd_kernel_wgmma(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             bf16* __restrict__ out, float* __restrict__ lse,
                             int Tq, int Tk, int H, int D, float scale,
                             int causal) {
  wgmma_fwd<DP, true>(q, k, v, out, lse, Tq, Tk, H, D, scale, causal);
}

template <int DP>
__global__ void __launch_bounds__(kTcThreads<DP>)
    flash_fwd_kernel_wgmma(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, int Tq, int Tk, int H,
                           int D, float scale, int causal) {
  wgmma_fwd<DP, false>(q, k, v, out, lse, Tq, Tk, H, D, scale, causal);
}

// the bf16 kernel for D <= DP, launched; records its name in *name
template <int DP>
int launch_wgmma(bool onepass, const void* q, const void* k, const void* v,
                 void* out, float* lse, int B, int Tq, int Tk, int H, int D,
                 float scale, int causal, cudaStream_t stream,
                 const char** name) {
  auto kernel = onepass ? onepass_fwd_kernel_wgmma<DP>
                        : flash_fwd_kernel_wgmma<DP>;
  static const char* const names[2][3] = {
      {"flash_fwd_kernel_wgmma<64>", "flash_fwd_kernel_wgmma<128>",
       "flash_fwd_kernel_wgmma<256>"},
      {"onepass_fwd_kernel_wgmma<64>", "onepass_fwd_kernel_wgmma<128>",
       "onepass_fwd_kernel_wgmma<256>"}};
  *name = names[onepass][DP == 64 ? 0 : (DP == 128 ? 1 : 2)];
  // 16-byte copies need 16-byte aligned rows (D % 8 == 0 gives the rest)
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return (int)cudaErrorMisalignedAddress;
  const int smem = WgSmem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kTQ<DP> - 1) / kTQ<DP>, H, B);
  kernel<<<grid, kTcThreads<DP>, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Tq, Tk, H, D,
      scale, causal);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------------------
// float32 (and bfloat16 past kMaxDWgmma): CUDA cores
// --------------------------------------------------------------------------

// One block per (64-row q-tile and kDC-column output chunk, head, batch).
// Shared: Q tile, one K/V tile, and the full 64 x T_k f32 score/probability
// tile. Past kDC every chunk's block computes the same S, streamed through
// the Q and K tiles in pieces.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    onepass_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Tq,
                       int Tk, int H, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = min(D, kDC) + 1;
  float* q_s = smem;
  float* kv_s = q_s + kBQ * ld;
  float* s_s = kv_s + kBK * ld;
  const Chunk ch(D);
  const bool whole = D <= kDC;
  const int q0 = ch.tile * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int offset = Tk - Tq;

  if (whole) load_tile(q_s, ld, q, b, q0, kBQ, Tq, H, h, D, 0, D);
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
    load_tile(kv_s, ld, v, b, k0, kBK, Tk, H, h, D, ch.c0, ch.w);
    __syncthreads();
    pv_tile(o, s_s + k0, Tk, kv_s, ld, min(kBK, Tk - k0), ch.w, ty, tx);
  }
  store_out(out, o, nullptr, b, q0, Tq, H, h, D, ch.c0, ch.w, ty, tx);
}

// One block per (64-row q-tile and kDC-column output chunk, head, batch),
// looping over 64-row k-tiles with the online softmax; running m, l and the
// rescale factor per row in shared memory, the output accumulator in
// registers. Past kDC every chunk's block computes the same S, m and l; the
// first chunk's writes lse.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Tq, int Tk, int H, int D,
                     float scale, int causal) {
  extern __shared__ float smem[];
  const int ld = min(D, kDC) + 1, pld = kBK + 1;
  float* q_s = smem;
  float* k_s = q_s + kBQ * ld;
  float* v_s = k_s + kBK * ld;
  float* p_s = v_s + kBK * ld;
  float* m_s = p_s + kBQ * pld;
  float* l_s = m_s + kBQ;
  float* a_s = l_s + kBQ;
  const Chunk ch(D);
  const bool whole = D <= kDC;
  const int q0 = ch.tile * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const int offset = Tk - Tq;

  if (whole) load_tile(q_s, ld, q, b, q0, kBQ, Tq, H, h, D, 0, D);
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
    float acc[4][4];
    if (whole) {
      __syncthreads();
      load_tile(k_s, ld, k, b, k0, kBK, Tk, H, h, D, 0, D);
      load_tile(v_s, ld, v, b, k0, kBK, Tk, H, h, D, 0, D);
      __syncthreads();
      score_tile(acc, q_s, k_s, ld, D, ty, tx);
    } else {
      // the barrier score_stream starts with ends the last tile's P.V
      score_stream(acc, q_s, k_s, ld, q, q0, Tq, k, k0, Tk, b, H, h, D, ty,
                   tx);
      load_tile(v_s, ld, v, b, k0, kBK, Tk, H, h, D, ch.c0, ch.w);
    }
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
    pv_tile(o, p_s, pld, v_s, ld, kBK, ch.w, ty, tx);
  }

  store_out(out, o, l_s, b, q0, Tq, H, h, D, ch.c0, ch.w, ty, tx);
  if (tx == 0 && ch.first) {
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
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * tile_ld(D) +
                                       (size_t)kBQ * Tk);
  cudaError_t err = cudaFuncSetAttribute(
      onepass_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(chunked_blocks(Tq, kBQ, D), H, B);
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
      sizeof(float) * ((size_t)(kBQ + 2 * kBK) * tile_ld(D) +
                       (size_t)kBQ * (kBK + 1) + 3 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(chunked_blocks(Tq, kBQ, D), H, B);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Tq, Tk, H, D,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// name of the kernel instantiation the last entry-point call launched
static const char* g_last_kernel = "";

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores up to D =
// kMaxDWgmma, CUDA cores past it). Returns a cudaError_t value (0 = ok).
extern "C" int onepass_attention_fwd(const void* q, const void* k,
                                     const void* v, void* out, int B, int Tq,
                                     int Tk, int H, int D, float scale,
                                     int causal, int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, D) || Tk > kOnepassMaxTk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    g_last_kernel = "onepass_fwd_kernel<float>";
    return launch_onepass<float>(q, k, v, out, B, Tq, Tk, H, D, scale, causal,
                                 s);
  }
  if (dtype == 1 && D > kMaxDWgmma) {
    g_last_kernel = "onepass_fwd_kernel<__nv_bfloat16>";
    return launch_onepass<bf16>(q, k, v, out, B, Tq, Tk, H, D, scale, causal,
                                s);
  }
  if (dtype == 1)
    return by_dp(D, [&](auto dp) {
      constexpr int DP = decltype(dp)::value;
      return launch_wgmma<DP>(true, q, k, v, out, nullptr, B, Tq, Tk, H, D,
                              scale, causal, s, &g_last_kernel);
    });
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int B, int Tq, int Tk,
                                   int H, int D, float scale, int causal,
                                   int dtype, void* stream) {
  if (bad_shape(B, Tq, Tk, H, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) {
    g_last_kernel = "flash_fwd_kernel<float>";
    return launch_flash<float>(q, k, v, out, l, B, Tq, Tk, H, D, scale, causal,
                               s);
  }
  if (dtype == 1 && D > kMaxDWgmma) {
    g_last_kernel = "flash_fwd_kernel<__nv_bfloat16>";
    return launch_flash<bf16>(q, k, v, out, l, B, Tq, Tk, H, D, scale, causal,
                              s);
  }
  if (dtype == 1)
    return by_dp(D, [&](auto dp) {
      constexpr int DP = decltype(dp)::value;
      return launch_wgmma<DP>(false, q, k, v, out, l, B, Tq, Tk, H, D, scale,
                              causal, s, &g_last_kernel);
    });
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* attention_last_kernel() { return g_last_kernel; }

extern "C" const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
