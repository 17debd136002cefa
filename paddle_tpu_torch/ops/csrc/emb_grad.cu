// Dense embedding gradient (lookup_table_grad) for Hopper (sm_90a): dW
// [vocab, dim] = the sum of dout's rows by id. Two variants, as in the JAX
// package, served by one kernel template (band<T, kSegsum>, entered as
// scatter_kernel<T> and segsum_kernel<T>):
//
// emb_grad_scatter replaces the Pallas kernel `_scatter_kernel`
// (paddle_tpu/ops/emb_grad_kernel.py:96, called by emb_grad_scatter), which
// keeps dW resident in VMEM and adds each id's dout row into it in the
// TABLE dtype, in id order. Here the accumulator is in the table dtype too,
// and each add rounds to it (to nearest even, as the f32 add then the
// rounding of the plain version do).
//
// emb_grad_segsum replaces `_segsum_kernel`
// (paddle_tpu/ops/emb_grad_kernel.py:147, called by emb_grad_segsum), which
// argsorts the ids outside the kernel only to find each vocab tile's rows.
// Here the accumulator is f32 and each row is rounded once, when it is
// written out. Nothing is sorted: a block finds its rows' ids by filtering.
//
// What bounds them on the H100: bytes. Both must read dout once and write
// dW once (67 MB + 8 MB at 65,536 ids into [8192, 512] bf16: 0.023 ms at
// 3.35 TB/s). dout's rows come in id order, which is random in the table.
// Every block must also see every id: 512 KB a block from L2, as much as
// its share of dout.
//
// The design keeps dW out of device memory until it is final, as the
// Pallas scatter keeps it in VMEM: one SM's shared memory is 227 KB, but
// the 132 SMs together hold about 30 MB.
//
// - Ownership. Block (cls, c) owns the rows r with r % R == cls (R a power
//   of two, rows dealt round robin so that the hot rows of a skewed id
//   distribution, the first ones under Zipf's law, land in different
//   blocks) and the c-th 256-byte column slice of each of them. C =
//   dim * sizeof(T) / 256 slices; R * C <= the SM count. Its accumulator
//   for those rows sits in dynamic shared memory (T for the scatter, f32
//   for the segsum): H rows of 256 (or, f32 for a bf16 table, 512) bytes.
// - Passes. If a block's rows do not fit in shared memory beside the fixed
//   buffers (kFixedBytes), it takes them H at a time and scans the ids
//   again for each pass; that begins where ceil(vocab / R) rows of the
//   accumulator pass 227 KB - kFixedBytes (555 rows of 256 bytes, 277 of
//   512), e.g. a [32768, 1024] bf16 segsum (8 passes). The scatter's gate
//   (dW <= 11 MB) gives one pass on 132 SMs.
// - Finding a block's ids in order. The block streams the int64 ids in
//   windows of kWindow by 16-byte cp.async into a ring (from L2 after the
//   first block has read them). Each thread takes kIds ids of a window and
//   keeps those of the block's rows (an id outside [0, vocab) matches
//   none); warp ballots give each kept id its rank in the warp and a block
//   prefix over the warps' counts its place in a queue of (position, local
//   row) in shared memory, in the ids' order. The queue is drained (below)
//   when a window's ids would overflow it.
// - Adding. The queue's dout slices stream by 16-byte cp.async through a
//   ring of kDoutStages stages of kEntries entries, all threads copying.
//   Warp w owns the local rows with (row % 16) == w and walks the staged
//   entries in queue order, a lane on 8 bytes of the slice: each (row,
//   column) sum is taken in id order (rows are independent, so only each
//   row's own entries keep their order). Where kDense or more of a
//   round's 32 entries are the warp's and of one row (a hot row), that
//   row's sum stays in registers and its entries are a chain of adds
//   without a branch, fed from shared memory at fixed offsets; every other
//   entry is added to its row's sum in shared memory, the next entry's row
//   and value loaded before the add. 8-byte lanes halve the entries (and
//   the shared-memory instructions, which bound the adds) that 4-byte
//   lanes would give a block.
// - Write-out. After a block barrier the block's rows are stored in 16-byte
//   pieces, a row that got no id as 0: nothing else zeroes dW. One launch a
//   call: no memset, no sort, no atomics.
//
// So each (row, column) is summed in id order, the order of a stable sort
// by id that both plain versions define (emb_grad_kernel.py `_sum_runs`):
// both variants equal their plain versions bit for bit. An id outside
// [0, vocab) is skipped: the lowering wraps negative ids first, so such an
// id is out of range in the JAX lowering too, where it contributes nothing.

#include <stdint.h>

#include "hopper.cuh"

namespace {

using sm90::cp_async16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::smem_addr;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// a block's column slice of a row: 32 lanes of 8 bytes, 16 16-byte chunks
constexpr int kSliceBytes = 256;
constexpr int kChunks = kSliceBytes / 16;
// ids a window (kIds a thread), windows in the ring; dout entries a
// stage, stages
constexpr int kIds = 4;
constexpr int kWindow = kIds * kThreads;
constexpr int kIdStages = 4;
constexpr int kEntries = 64;
constexpr int kDoutStages = 4;
// a row with this many of a round's 32 entries is added in registers
constexpr int kDense = 12;
// the two rings share one buffer: the scan and the adds take turns
constexpr int kBufBytes = kIdStages * kWindow * 8;
static_assert(kDoutStages * kEntries * kSliceBytes == kBufBytes, "rings");
// queue: int32 positions and uint16 local rows
constexpr int kQueue = 4096;
constexpr int kFixedBytes = kBufBytes + kQueue * 6 + 2 * kWarps * 4;

// d = a + b on two bf16 each, one rounding to nearest even of the exact
// sum: the same bf16 as rounding the f32 sum (the f32 sum of two bf16 is
// exact unless their exponents differ by more than 15, and then both
// round to the larger)
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// A lane's 8 bytes of a row slice (four bf16 or two f32, `uint2`) and its
// running sum: in the table dtype for the scatter (each add rounds), in
// f32 for the segsum. kBytes of accumulator a lane in shared memory; out()
// gives 16 bytes of dW from two lanes' accumulators.
template <typename T, bool kSegsum>
struct Lane;

template <bool kSegsum>
struct Lane<float, kSegsum> {
  using Reg = float2;
  static constexpr int kBytes = 8;
  __device__ static Reg load(const unsigned char* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static void store(unsigned char* p, Reg v) {
    *reinterpret_cast<float2*>(p) = v;
  }
  __device__ static Reg add(Reg acc, uint2 x) {
    return make_float2(acc.x + __uint_as_float(x.x),
                       acc.y + __uint_as_float(x.y));
  }
  __device__ static uint4 out(const unsigned char* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
};

template <>
struct Lane<__nv_bfloat16, false> {
  using Reg = uint2;   // four bf16
  static constexpr int kBytes = 8;
  __device__ static Reg load(const unsigned char* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ static void store(unsigned char* p, Reg v) {
    *reinterpret_cast<uint2*>(p) = v;
  }
  __device__ static Reg add(Reg acc, uint2 x) {
    return make_uint2(add_bf16x2(acc.x, x.x), add_bf16x2(acc.y, x.y));
  }
  __device__ static uint4 out(const unsigned char* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
};

template <>
struct Lane<__nv_bfloat16, true> {
  using Reg = float4;  // four f32 sums
  static constexpr int kBytes = 16;
  __device__ static Reg load(const unsigned char* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void store(unsigned char* p, Reg v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  // a bf16 is the high half of the f32 with the same bits
  __device__ static Reg add(Reg acc, uint2 x) {
    return make_float4(acc.x + __uint_as_float(x.x << 16),
                       acc.y + __uint_as_float(x.x & 0xffff0000u),
                       acc.z + __uint_as_float(x.y << 16),
                       acc.w + __uint_as_float(x.y & 0xffff0000u));
  }
  __device__ static uint4 out(const unsigned char* p) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    return make_uint4(sm90::pack_bf16(a.x, a.y), sm90::pack_bf16(a.z, a.w),
                      sm90::pack_bf16(b.x, b.y), sm90::pack_bf16(b.z, b.w));
  }
};

// One block: the rows r % R == cls, column slice c, in `passes` passes of
// at most H rows. Shared memory: the accumulator [H][32 lanes], the ring
// buffer, the queue, the warps' counts (two windows').
template <typename T, bool kSegsum>
__device__ __forceinline__ void band(const long long* __restrict__ ids,
                                     const T* __restrict__ dout,
                                     T* __restrict__ dw, int n, int vocab,
                                     int dim, int log_r, int H, int passes) {
  using L = Lane<T, kSegsum>;
  using Reg = typename L::Reg;
  constexpr int kRow = 32 * L::kBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_slices = dim * (int)sizeof(T) / kSliceBytes;
  const int cls = blockIdx.x / n_slices;
  const int col0 = (blockIdx.x - cls * n_slices) * (kSliceBytes / sizeof(T));
  const int R = 1 << log_r;
  const int my_rows = (vocab - 1 - cls) / R + 1;   // R <= vocab
  unsigned char* acc = smem;
  unsigned char* buf = smem + (size_t)H * kRow;
  int* qpos = reinterpret_cast<int*>(buf + kBufBytes);
  uint16_t* qrow = reinterpret_cast<uint16_t*>(qpos + kQueue);
  int* wtot = reinterpret_cast<int*>(qrow + kQueue);
  unsigned char* my_acc = acc + lane * L::kBytes;
  const unsigned below = (1u << lane) - 1;
  const int windows = (n + kWindow - 1) / kWindow;
  int w = 0;   // this pass's next window

  // a thread copies, and later reads, only its own kIds ids of a window:
  // the id ring needs no block barrier
  auto issue_ids = [&](int win) {
    if (win < windows) {
      long long* slot = reinterpret_cast<long long*>(buf) +
                        (win % kIdStages) * kWindow + kIds * tid;
      const long long at = (long long)win * kWindow + kIds * tid;
#pragma unroll
      for (int j = 0; j < kIds; j += 2)
        cp_async16(smem_addr(slot + j), at + j < n ? ids + at + j : ids,
                   at + j < n);
    }
    cp_async_commit();
  };

  // every queued entry's dout slice added to its row, in queue order; the
  // id windows loaded ahead are loaded again after
  auto drain = [&](int count) {
    cp_async_wait<0>();
    __syncthreads();   // the queue written, the id ring read by all
    const int stages = (count + kEntries - 1) / kEntries;
    auto issue_dout = [&](int s) {
      if (s < stages) {
#pragma unroll
        for (int j = 0; j < kEntries * kChunks / kThreads; ++j) {
          const int i = j * kThreads + tid;
          const int e = s * kEntries + i / kChunks, ch = i % kChunks;
          if (e < count)
            cp_async16(smem_addr(buf + ((s % kDoutStages) * kEntries *
                                            kChunks + i) * 16),
                       dout + (long long)qpos[e] * dim + col0 +
                           ch * (16 / (int)sizeof(T)),
                       true);
        }
      }
      cp_async_commit();
    };
    for (int j = 0; j < kDoutStages - 1; ++j) issue_dout(j);
    for (int s = 0; s < stages; ++s) {
      cp_async_wait<kDoutStages - 2>();
      __syncthreads();   // stage s landed; stage s - 1 read by all
      issue_dout(s + kDoutStages - 1);
      const unsigned char* stage =
          buf + (s % kDoutStages) * kEntries * kSliceBytes + lane * 8;
      const int e = s * kEntries + lane;
      // both rounds' rows first: their loads overlap
      const int ra = e < count ? (int)qrow[e] : -1;
      const int rb = e + 32 < count ? (int)qrow[e + 32] : -1;
#pragma unroll
      for (int i = 0; i < kEntries; i += 32) {
        const int r = i ? rb : ra;
        unsigned own = __ballot_sync(0xffffffffu,
                                     r >= 0 && (r & (kWarps - 1)) == warp);
        if (!own) continue;
        const unsigned char* xs = stage + i * kSliceBytes;
        if (__popc(own) >= kDense) {
          // one row may take most of the round (a hot row): the row of
          // the warp's last entry and its entries
          const int hot = __shfl_sync(0xffffffffu, r, 31 - __clz(own));
          const unsigned mine =
              __ballot_sync(0xffffffffu, (own >> lane & 1) && r == hot);
          if (__popc(mine) >= kDense) {
            // its sum in registers, the values loaded at fixed offsets 16
            // at a time before their adds, entries not of this row added
            // as +0 (the sum is never -0, so that changes nothing): a
            // chain of adds without a branch. The round's other rows
            // follow.
            unsigned char* a = my_acc + hot * kRow;
            Reg sum = L::load(a);
#pragma unroll
            for (int h = 0; h < 32; h += 16) {
              uint2 x[16];
#pragma unroll
              for (int j = 0; j < 16; ++j)
                x[j] = mine >> (h + j) & 1
                           ? *reinterpret_cast<const uint2*>(
                                 xs + (h + j) * kSliceBytes)
                           : make_uint2(0u, 0u);
#pragma unroll
              for (int j = 0; j < 16; ++j) sum = L::add(sum, x[j]);
            }
            L::store(a, sum);
            own &= ~mine;
            if (!own) continue;
          }
        }
        // the other entries: each added to its row's sum in shared
        // memory, the next one's row and value loaded before the add
        int at = __ffs(own) - 1;
        own &= own - 1;
        int row = __shfl_sync(0xffffffffu, r, at);
        uint2 x = *reinterpret_cast<const uint2*>(xs + at * kSliceBytes);
        while (true) {
          const bool more = own != 0;
          at = more ? __ffs(own) - 1 : 0;
          own &= own - 1;
          const int row2 = __shfl_sync(0xffffffffu, r, at);
          const uint2 x2 =
              *reinterpret_cast<const uint2*>(xs + at * kSliceBytes);
          unsigned char* a = my_acc + row * kRow;
          L::store(a, L::add(L::load(a), x));
          if (!more) break;
          row = row2;
          x = x2;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the adds done before the ring is reused
    for (int j = 0; j < kIdStages - 1; ++j) issue_ids(w + j);
  };

  for (int pass = 0; pass < passes; ++pass) {
    const int row0 = pass * H;
    if (row0 >= my_rows) break;
    const int rows = min(H, my_rows - row0);
    for (int i = tid; i < rows * kRow / 16; i += kThreads)
      reinterpret_cast<uint4*>(acc)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();   // the acc zeroed, the buffer free
    int count = 0;
    for (w = 0; w < kIdStages - 1; ++w) issue_ids(w);
    for (w = 0; w < windows;) {
      cp_async_wait<kIdStages - 2>();   // this thread's ids of window w
      issue_ids(w + kIdStages - 1);
      // ---- a window: the class's ids, in order, into the queue
      const longlong2* mine_at = reinterpret_cast<const longlong2*>(buf) +
                                 (w % kIdStages) * (kWindow / 2) +
                                 kIds / 2 * tid;
      const int first = kIds * tid, valid = n - w * kWindow;
      int local[kIds], mine = 0;
#pragma unroll
      for (int j2 = 0; j2 < kIds / 2; ++j2) {
        const longlong2 two = mine_at[j2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * j2 + h;
          const long long id = h ? two.y : two.x;
          const int lo = (int)id;
          local[j] = (lo >> log_r) - row0;
          if (first + j < valid && (id >> 32) == 0 && (unsigned)lo < vocab &&
              (lo & (R - 1)) == cls && (unsigned)local[j] < (unsigned)rows)
            mine |= 1 << j;
        }
      }
      // ranks from ballots (thread t's ids precede thread t + 1's: its
      // rank is the sum over c of the lanes below with c or more kept ids;
      // rarely does a lane keep two) and a prefix over the warps' counts
      // (double-buffered: one barrier)
      const int kept = __popc(mine);
      unsigned b = __ballot_sync(0xffffffffu, kept > 0);
      int q = __popc(b & below), in_warp = __popc(b);
      if (__any_sync(0xffffffffu, kept > 1)) {
#pragma unroll
        for (int c = 2; c <= kIds; ++c) {
          b = __ballot_sync(0xffffffffu, kept >= c);
          q += __popc(b & below);
          in_warp += __popc(b);
        }
      }
      int* counts = wtot + (w & 1) * kWarps;
      if (lane == 0) counts[warp] = in_warp;
      __syncthreads();
      int incl = lane < kWarps ? counts[lane] : 0;
#pragma unroll
      for (int o = 1; o < kWarps; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      const int total = __shfl_sync(0xffffffffu, incl, kWarps - 1);
      q += __shfl_sync(0xffffffffu, incl, warp) - in_warp;
      const int at0 = w++ * kWindow + first;
      if (count + total > kQueue) {   // drained first: the ids are at hand
        drain(count);
        count = 0;
      }
      q += count;
#pragma unroll
      for (int j = 0; j < kIds; ++j) {
        if (mine >> j & 1) {
          qpos[q] = at0 + j;
          qrow[q] = (uint16_t)local[j];
          ++q;
        }
      }
      count += total;
    }
    if (count) drain(count);
    cp_async_wait<0>();

    // ---- write-out: every row of the pass, 16 bytes a thread
    __syncthreads();
    for (int i = tid; i < rows * kChunks; i += kThreads) {
      const int lr = i / kChunks, ch = i % kChunks;
      const long long r = ((long long)(row0 + lr) << log_r) + cls;
      *reinterpret_cast<uint4*>(dw + r * dim + col0 +
                                ch * (16 / (int)sizeof(T))) =
          L::out(acc + lr * kRow + ch * 2 * L::kBytes);
    }
    __syncthreads();   // the acc read before the next pass zeroes it
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    scatter_kernel(const long long* __restrict__ ids,
                   const T* __restrict__ dout, T* __restrict__ dw, int n,
                   int vocab, int dim, int log_r, int H, int passes) {
  band<T, false>(ids, dout, dw, n, vocab, dim, log_r, H, passes);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    segsum_kernel(const long long* __restrict__ ids,
                  const T* __restrict__ dout, T* __restrict__ dw, int n,
                  int vocab, int dim, int log_r, int H, int passes) {
  band<T, true>(ids, dout, dw, n, vocab, dim, log_r, H, passes);
}

// The plan (row classes R = 2^log_r, rows a pass H, passes) and the launch.
template <typename T, bool kSegsum>
int launch(const void* ids, const void* dout, void* dw, int n, int vocab,
           int dim, cudaStream_t s) {
  if (n < 2 || n % 2 || vocab < 1 || dim < 128 || dim % 128)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(ids) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dw)) % 16)
    return (int)cudaErrorMisalignedAddress;
  int dev = 0, sms = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  constexpr int kRow = 32 * Lane<T, kSegsum>::kBytes;
  const int slices = dim * (int)sizeof(T) / kSliceBytes;
  int log_r = 0;
  while ((2 << log_r) * slices <= sms && (2 << log_r) <= vocab) ++log_r;
  const int per_class = (vocab + (1 << log_r) - 1) >> log_r;
  const int fit = (max_smem - kFixedBytes) / kRow;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  const int H = min(per_class, fit);
  const int passes = (per_class + H - 1) / H;
  const int smem = H * kRow + kFixedBytes;
  auto kernel = kSegsum ? segsum_kernel<T> : scatter_kernel<T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<slices << log_r, kThreads, smem, s>>>(
      static_cast<const long long*>(ids), static_cast<const T*>(dout),
      static_cast<T*>(dw), n, vocab, dim, log_r, H, passes);
  return (int)cudaGetLastError();
}

template <bool kSegsum>
int dispatch(const void* ids, const void* dout, void* dw, int n, int vocab,
             int dim, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, kSegsum>(ids, dout, dw, n, vocab, dim, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, kSegsum>(ids, dout, dw, n, vocab, dim, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ids [n] int64, n even; dout [n, dim] and dw [vocab, dim] of one dtype (0
// = float32, 1 = bfloat16), dim a multiple of 128, all 16-byte aligned. One
// kernel launch; dW is written whole. Returns a cudaError_t value (0 = ok).
extern "C" int emb_grad_scatter(const void* ids, const void* dout, void* dw,
                                int n, int vocab, int dim, int dtype,
                                void* stream) {
  return dispatch<false>(ids, dout, dw, n, vocab, dim, dtype, stream);
}

extern "C" int emb_grad_segsum(const void* ids, const void* dout, void* dw,
                               int n, int vocab, int dim, int dtype,
                               void* stream) {
  return dispatch<true>(ids, dout, dw, n, vocab, dim, dtype, stream);
}
