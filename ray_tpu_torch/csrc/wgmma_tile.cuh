// Tile machinery of the tensor-core attention kernels (the bf16 kernels of
// flash_fwd.cu and flash_bwd.cu) for Hopper, sm_90a: the shared-memory
// layout that wgmma reads, its matrix descriptors, the cp.async loaders
// that fill it, thin wrappers of wgmma.mma_async, and the conversion of an
// fp32 accumulator into the bf16 register operand of the next product.
//
// Layout. A [R, 128] bf16 tile (R positions of one head, D = 128) is two
// column halves of [R, 64], each R * 128 bytes. Within a half, row r is
// 128 bytes whose 16-byte chunks are permuted, chunk c stored at c ^ (r % 8)
// (the 128-byte swizzle). Tiles start at 1024-byte boundaries, so every
// group of 8 rows is one swizzle atom and the descriptors' base offset is 0.
// The same bytes serve as either operand form, chosen by the descriptor:
//
//   K-major  (rows are M or N, columns are K, as q and k in q . k^T):
//            start = half base + 32 * (16-column step within the half),
//            SBO = 1024 (the next 8 rows), LBO unused.
//   MN-major (rows are K, columns are N, as v in p . v): start = base +
//            2048 * (16-row step), SBO = 1024 (the next 8 rows along K),
//            LBO = R * 128 (the next 64-column half along N).
//
// Fragments of one warpgroup (128 threads; warp w, lane l, g = l / 4,
// t = l % 4):
//   accumulator of an m64nN product: d[4 j + 2 h + e] holds row
//   16 w + g + 8 h, column 8 j + 2 t + e (j < N / 8; h, e in {0, 1});
//   A operand of an m64k16 product from registers: four 32-bit words of
//   bf16 pairs; word 2 c + h holds row 16 w + g + 8 h, columns
//   8 c + 2 t + {0, 1} (low half first). So the accumulator's columns
//   16 k .. 16 k + 15 are the A operand of the k-th 16-deep step of the
//   next product: word i = (d[8 k + 2 i], d[8 k + 2 i + 1]) (acc_to_a).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace rtt {
namespace tile {

constexpr int kRowBytes = 128;   // one swizzled row of a column half
constexpr int kAtomBytes = 1024; // 8 rows: one swizzle atom

// Bytes of a [rows, 128] bf16 tile.
constexpr int tile_bytes(int rows) { return rows * 2 * kRowBytes; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk c (0..15, 8 columns each) of row r in
// a [rows, 128] tile.
__device__ __forceinline__ uint32_t chunk_offset(int rows, int r, int c) {
  return (c >> 3) * rows * kRowBytes + r * kRowBytes +
         (((c & 7) ^ (r & 7)) << 4);
}

// Matrix descriptor: 128-byte swizzle, base offset 0.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t addr = smem_u32(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: rows [row0, row0 + 64 or N) of a [rows, 128] tile,
// columns 16 k .. 16 k + 15 (k < 8).
__device__ __forceinline__ uint64_t desc_k_major(const uint8_t* tile,
                                                 int rows, int row0, int k) {
  return make_desc(tile + (k >> 2) * rows * kRowBytes + row0 * kRowBytes +
                       (k & 3) * 32,
                   16, kAtomBytes);
}

// MN-major operand: rows 16 k .. 16 k + 15 of a [rows, 128] tile (K), all
// its columns from `half` on (N = 64 from one half, 128 from both).
__device__ __forceinline__ uint64_t desc_mn_major(const uint8_t* tile,
                                                  int rows, int half, int k) {
  return make_desc(tile + half * rows * kRowBytes + k * 16 * kRowBytes,
                   rows * kRowBytes, kAtomBytes);
}

// --- cp.async ----------------------------------------------------------
// 16 bytes, or zeros when `valid` is false (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// Orders this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) before later async-proxy reads (wgmma); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows s0 .. s0 + R - 1 of one head into a [R, 128] tile; `src` points at
// the head's first element of position 0 and `row` is the stride between
// positions (elements). Rows at or past `seq` are zero-filled. Sixteen
// consecutive threads copy one 256-byte row.
template <int R, int kThreads>
__device__ __forceinline__ void load_tile(uint8_t* dst,
                                          const __nv_bfloat16* src,
                                          size_t row, int s0, int seq,
                                          int tid) {
  static_assert(R * 16 % kThreads == 0, "whole rows per pass");
#pragma unroll
  for (int j = 0; j < R * 16 / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i >> 4, c = i & 15;
    const int s = s0 + r;
    const bool in = s < seq;
    cp_async16(dst + chunk_offset(R, r, c),
               src + (size_t)(in ? s : 0) * row + c * 8, in);
  }
}

// n fp32 values src[s0 .. s0 + n - 1] (zeros at or past seq), one per
// thread of 0 <= tid < n.
__device__ __forceinline__ void load_row_f32(float* dst, const float* src,
                                             int s0, int seq, int n,
                                             int tid) {
  if (tid >= 0 && tid < n) {
    const int s = s0 + tid;
    cp_async4(dst + tid, src + (s < seq ? s : 0), s < seq);
  }
}

// --- wgmma -------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// Keeps the compiler from moving accumulator registers across the
// asynchronous products (started before, read after a wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for register A operands: keeps their registers live, unchanged,
// until after the wait of the products that read them.
template <int K>
__device__ __forceinline__ void fence_words(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// D[64, 64] (+)= A[64, 16] . B[16, 64], A and B in shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// D[64, 128] (+)= A[64, 16] . B[16, 128], A and B in shared memory.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// D[64, 128] (+)= A[64, 16] . B[16, 128], A from registers (four words of
// bf16 pairs, see acc_to_a), B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d), "n"(kTransB));
}

// *p += (a, b, c, d) in device memory, one 16-byte reduction (sm_90),
// with no value returned; p is 16-byte aligned.
__device__ __forceinline__ void red_add_v4(float* p, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// Two fp32 values as one word of bf16 (round to nearest even), the first
// in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of an m64nN product (N / 2 floats) as the bf16 A operand
// of the N / 16 16-deep steps of the next product.
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[k][i] = pack_bf16(d[8 * k + 2 * i], d[8 * k + 2 * i + 1]);
}

// Dynamic shared memory rounded up to the next 1024-byte boundary (the
// launch asks for kAtomBytes more than the kernel uses).
__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + ((kAtomBytes - (a & (kAtomBytes - 1))) & (kAtomBytes - 1));
}

}  // namespace tile
}  // namespace rtt
