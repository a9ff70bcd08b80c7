// Hopper (sm_90a) primitives shared by the port's tensor-core kernels: the
// bf16 flash prefill (flash_attention.cu) and its backward
// (flash_attention_bwd.cu), and the bf16 SSD scan (ssd_scan.cu, whose
// d_state-16 state contribution is an m64n16 product) and its backward
// (ssd_scan_bwd.cu, which reads transposed operands MN-major).
//
//   * cp.async copies from global to shared memory (16 bytes, or 4 bytes for
//     scattered fp32 scalars), zero-filled when their predicate is false, in
//     commit groups;
//   * the proxy fence that makes generic shared-memory stores visible to
//     wgmma's reads;
//   * wgmma's fence / commit / wait and a register pin for accumulators;
//   * the shared-memory matrix descriptor and the m64nNk16 bf16 products the
//     kernels run, with fp32 accumulators;
//   * the attention kernels' 64-row head tile (``WgTile``).
//
// Tiles live in shared memory under the 128-byte swizzle: a tile of R rows
// is cut into column blocks of 128 bytes (64 bf16); block c holds every
// row's bytes [128 c, 128 (c + 1)), rows 128 bytes apart, and the 16-byte
// chunk index within a row is XORed with the row's low three bits
// (``sw128``). A tile's base must be 1024-byte aligned (the swizzle period).
// A K-major operand (K contiguous) is addressed by its 8-row stride (1024
// bytes); an MN-major operand of one 64-element column block reads 8-row
// groups of K at 1024 bytes, which both descriptor offsets name, so the
// descriptor holds whichever the hardware reads. Every product here is at
// most one column block wide in its MN-major operand.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk ``ch`` of row ``r`` in a 128-byte-swizzled
// tile of ``rows`` rows
__device__ __forceinline__ uint32_t sw128(int r, int ch, int rows) {
  const uint32_t off = (ch >> 3) * (rows * 128) + r * 128 + (ch & 7) * 16;
  return off ^ ((off >> 3) & 0x70u);
}

// 16 bytes from global to shared memory; zeros when ``pred`` is false
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
// 4 bytes from global to shared memory; zero when ``pred`` is false
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// make generic-proxy writes to shared memory visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pin an accumulator's registers in place across the asynchronous wgmma, so
// the compiler neither reads them before the wait nor moves them meanwhile
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode in bits 62-63 (1: 128-byte).
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo,
                                            uint64_t layout) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// D[64 x 64] (+)= A . B in shared memory. A K-major (A[64 x 16], TRANS_A =
// 0) or MN-major (A^T stored [16 x 64], one column block, TRANS_A = 1); B
// K-major (B[64 x 16]^T, TRANS_B = 0) or MN-major (B[16 x 64], one column
// block, TRANS_B = 1)
template <int TRANS_B = 0, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B), "n"(TRANS_A));
}

// D[64 x 32] (+)= A[64 x 16] . B[32 x 16]^T, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] (+)= A . B in shared memory, A K-major (A[64 x 16], TRANS_A =
// 0) or MN-major (A^T stored [16 x 64], TRANS_A = 1), B K-major (B[16 x
// 16]^T: 16 rows of K, two 8-row groups at the stride byte offset)
template <int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The m64nN accumulator fragment: a thread's element j sits at row
// (warp * 16 + lane / 4 + 8 * ((j / 2) % 2)) and column (8 * (j / 4) +
// 2 * (lane % 4) + j % 2). The register A fragment of the k-step that
// covers columns 16 kk .. 16 kk + 15 is the bf16 pairs of elements
// 8 kk .. 8 kk + 7 of such an accumulator (the rows and columns line up).
__device__ __forceinline__ int frag_row(int j, int warp, int lane) {
  return warp * 16 + (lane >> 2) + 8 * ((j >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int j, int lane) {
  return 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
}

// A [64 x HD] bf16 tile of the attention kernels in shared memory: HD * 2
// bytes a row, cut into column blocks of RB bytes (128, or 64 at hd 32);
// block c holds every row's bytes [c * RB, (c + 1) * RB), rows RB apart,
// under the RB-byte swizzle (the 16-byte chunk index XORed with address
// bits 7.., as wgmma reads it). Read K-major, it is the A or B operand of a
// product over HD; read MN-major (one column block of PVN columns at a
// time), the B operand of a product whose N is HD.
constexpr int WG_TILE_ROWS = 64;
template <int HD>
struct WgTile {
  static constexpr int RB = HD * 2 >= 128 ? 128 : HD * 2;
  static constexpr int BYTES = WG_TILE_ROWS * HD * 2;
  static constexpr int CHUNKS = WG_TILE_ROWS * HD / 8;  // 16-byte chunks in a tile
  static constexpr uint32_t SWZ = RB == 128 ? 0x70u : 0x30u;
  static constexpr uint64_t LAYOUT = RB == 128 ? 1ull : 2ull;  // SW128 / SW64
  static constexpr int PVN = RB / 2;                // wgmma N of one MN-major product
  static constexpr int NPV = HD / PVN;              // such products per k-step
  static_assert(HD * 2 % RB == 0, "whole column blocks");

  // byte offset of 16-byte chunk ``ch`` of row ``r`` inside the tile
  __device__ static __forceinline__ uint32_t offset(int r, int ch) {
    const int cpr = RB / 16;  // chunks per row of a column block
    const uint32_t off = (ch / cpr) * (WG_TILE_ROWS * RB) + r * RB + (ch % cpr) * 16;
    return off ^ ((off >> 3) & SWZ);
  }
};
