// Hopper (sm_90a) building blocks for bf16 tiles on the tensor cores:
// 16-byte asynchronous copies (cp.async) into the layout wgmma reads,
// wgmma matrix descriptors, the m64nNk16 bf16 wgmma instructions with f32
// accumulate (A from shared memory or from registers), and the packing and
// stores of their accumulator tiles.
//
// Tile layout ("core matrices", no swizzle). A tile of R rows by C chunks,
// a chunk being 8 bf16 (16 bytes) of one row, keeps chunk c of row r at
// byte c * R * 16 + r * 16. So each 8-row by 16-byte core matrix that wgmma
// reads is 128 contiguous bytes (conflict-free), 8-row groups sit 128 bytes
// apart and chunk columns R * 16 bytes apart. The same bytes serve as a
// K-major operand (rows along M or N, chunks along the contraction: Q and K
// in S = QK^T) and as an MN-major one (rows along the contraction, chunks
// along N: V in P.V).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid (no
// global read then; src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes (one f32 of a strided row vector) from global to shared memory,
// or 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor, no swizzle: start address, leading byte offset
// (between core matrices along the contraction) and stride byte offset
// (between core matrices along M or N)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// descriptors of an R-row tile in the layout above: read K-major (rows along
// M or N, chunks along the contraction), core matrices step R * 16 bytes
// along the contraction (leading) and 128 along the rows (stride); read
// MN-major (rows along the contraction), 128 along the rows (leading) and
// R * 16 along the columns (stride)
__device__ __forceinline__ uint64_t kmajor(uint32_t addr, int rows) {
  return desc(addr, rows * 16, 128);
}
__device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int rows) {
  return desc(addr, 128, rows * 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous instruction and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// 2^x on the special-function unit (one instruction); results below the
// smallest normal f32 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the four threads of a quad (the four that hold one
// accumulator row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// two f32 as one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the bf16 register A operand of products over 16-column slices, from an
// f32 accumulator tile of N columns (s[4t + 2r + {0, 1}] is row r's pair of
// columns in 8-column block t: the A fragment's order)
template <int N>
__device__ __forceinline__ void pack_tile(uint32_t (&a)[N / 2],
                                          const float (&s)[N]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) a[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
}

// a warpgroup's f32 accumulator tile of 64 rows by N columns, its rows
// divided by div_a (this thread's first row) and div_b (8 below), as bf16
// into rows rl and rl + 8 of a shared tile of R rows in the layout above
template <int N>
__device__ __forceinline__ void stage_out(unsigned char* tile, int rows,
                                          const float (&o)[N / 2], int rl,
                                          int lane, float div_a = 1.f,
                                          float div_b = 1.f) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    unsigned char* at = tile + j * rows * 16 + rl * 16 + (lane & 3) * 4;
    *reinterpret_cast<uint32_t*>(at) =
        pack_bf16(o[4 * j] / div_a, o[4 * j + 1] / div_a);
    *reinterpret_cast<uint32_t*>(at + 8 * 16) =
        pack_bf16(o[4 * j + 2] / div_b, o[4 * j + 3] / div_b);
  }
}

// rows [row0, row0 + R) of a shared tile of R rows by C chunks to head h of
// a [B, T, H, D] bf16 tensor by 16-byte stores from all NT threads; rows at
// or past T and columns at or past D are dropped
template <int R, int C, int NT>
__device__ __forceinline__ void store_tile(__nv_bfloat16* out,
                                           const unsigned char* tile, int b,
                                           int row0, int t_len, int H, int h,
                                           int D) {
#pragma unroll
  for (int i = 0; i < R * C / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = (idx & 7) | ((idx / (8 * C)) << 3);
    const int c = (idx >> 3) % C;
    const int t = row0 + r;
    if (t < t_len && c * 8 < D)
      *reinterpret_cast<uint4*>(out + (((size_t)b * t_len + t) * H + h) * D +
                                c * 8) =
          *reinterpret_cast<const uint4*>(tile + c * R * 16 + r * 16);
  }
}

// Copies of R-row tiles of one head of a [B, T, H, D] bf16 tensor into
// shared tiles of R rows by C chunks (C * 8 >= D), by cp.async from all NT
// threads of the block. Each thread's chunks, and so its offsets, are the
// same for every tile: they are computed once. Rows at or past T and
// columns at or past D are zero-filled and never read. Eight neighbouring
// threads fill one core matrix (128 contiguous bytes) and read 16 bytes
// each of eight rows.
template <int R, int C, int NT>
struct TileCopy {
  static_assert((R * C) % NT == 0, "whole chunks per thread");
  static constexpr int kN = R * C / NT;
  uintptr_t base;             // row 0 of this head
  size_t ld;                  // bytes between rows (H * D * 2)
  int row[kN];                // the thread's rows in a tile
  uint32_t src[kN], dst[kN];  // byte offsets in a global and a shared tile
  bool col_ok[kN];

  __device__ __forceinline__ TileCopy(const __nv_bfloat16* x, int b,
                                      int t_len, int H, int h, int D)
      : base(reinterpret_cast<uintptr_t>(x + ((size_t)b * t_len * H + h) *
                                                 D)),
        ld((size_t)H * D * 2) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int r = (idx & 7) | ((idx / (8 * C)) << 3);
      const int c = (idx >> 3) % C;
      row[i] = r;
      src[i] = (uint32_t)r * H * D * 2 + c * 16;
      dst[i] = c * R * 16 + r * 16;
      col_ok[i] = c * 8 < D;
    }
  }

  // rows [row0, row0 + R) into the shared tile at tile; the tile's global
  // address is one multiply for all the thread's chunks
  __device__ __forceinline__ void load(uint32_t tile, int row0,
                                       int t_len) const {
    const uintptr_t g = base + (uintptr_t)row0 * ld;
    const int left = t_len - row0;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const uintptr_t at = g + src[i];
      const bool ok = col_ok[i] && row[i] < left;
      cp_async16(tile + dst[i], reinterpret_cast<const void*>(ok ? at : base),
                 ok);
    }
  }
};

// d (64 x 64) = A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32) = A (64 x 16, shared, K-major) * B (16 x 32, shared,
// K-major) + (accumulate ? d : 0)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d (64 x 128) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// S or dP of N columns: d (64 x N) = A (64 x 16) * B (16 x N), both shared
// and K-major, + (accumulate ? d : 0); N = 32 or 64
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (N == 32)
    wgmma_ss_n32(d, a, b, accumulate);
  else
    wgmma_ss_n64(d, a, b, accumulate);
}

// an output tile of N = 64, 128 or 256 columns: d (64 x N) += A (64 x 16,
// registers) * B (16 x N, shared, MN-major, a tile of R rows). N = 256 runs
// as two n128 halves: the accumulator's 8-column blocks 16-31 are its
// registers 64-127, and B's chunk columns 16-31 start 16 * R * 16 bytes on
template <int N, int R>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t b) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a0, a1, a2, a3, b);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a0, a1, a2, a3, b);
  } else {
    static_assert(N == 256, "N = 64, 128 or 256");
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a0, a1, a2, a3, b);
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a0, a1, a2, a3,
                  b + ((16 * R * 16) >> 4));
  }
}

}  // namespace sm90
