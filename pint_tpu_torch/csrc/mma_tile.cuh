// Tiles of 16 problems on the s8 tensor cores (K2, K2p and K7 to 256 lanes;
// past 256 their wide forms run csrc/wide_gemm.cuh's tiles of 64 problems).
//
// A product across the batch, (16 problems x W) int8 times a W x W int8
// matrix shared by every problem, runs as mma.sync m16n8k32 s8 -> s32: a
// block owns a tile of 16 problems, each warp the output columns of NG
// groups of 8.  Thread (warp w, gq = lane >> 2, tq = lane & 3) holds, for
// column group n, the accumulator elements e of rows gq + 8 (e >> 1),
// columns 8n + 2tq + (e & 1).  Each iteration rebuilds the A operand, the
// problems' int8 vectors, through a 16 x W byte tile in shared memory: every
// thread writes its elements (store_pairs) and, after a barrier, reads the
// A fragments of each 32-byte k-chunk (load_a).  Rows are padded by 16
// bytes, so the fragment loads are free of bank conflicts.
#pragma once

#include <stdint.h>

namespace pint {

// d += a . b, one m16n8k32 tile: a the 16 x 32 int8 A fragment (row), b the
// 32 x 8 int8 B fragment (col), d the 16 x 8 int32 accumulator.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of k-chunk kc of the 16 x W byte tile `t` (row stride RS):
// rows (g, g+8) x bytes kc*32 + 4tq (+16).
template <int RS>
__device__ __forceinline__ void load_a(const unsigned char* t, int gq, int tq, int kc,
                                       uint32_t (&a)[4]) {
  const unsigned char* p = t + gq * RS + kc * 32 + tq * 4;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * RS);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * RS + 16);
}

// The low bytes of v[0], v[1] (row g) and v[2], v[3] (row g+8) at columns
// col, col + 1 of the byte tile `t`.
template <int RS>
__device__ __forceinline__ void store_pairs(unsigned char* t, int gq, int col,
                                            const int (&v)[4]) {
  *reinterpret_cast<uint16_t*>(t + gq * RS + col) =
      (uint16_t)__byte_perm(v[0], v[1], 0x0040);
  *reinterpret_cast<uint16_t*>(t + (gq + 8) * RS + col) =
      (uint16_t)__byte_perm(v[2], v[3], 0x0040);
}

// A tile's shape at width W (32, 64, 128 or 256) with NG column groups of 8
// a warp: KC k-chunks of 32 bytes, the tile's row stride RS and NW warps a
// block.
template <int W, int NG_>
struct MmaTile {
  static_assert(W == 32 || W == 64 || W == 128 || W == 256, "W: 32, 64, 128 or 256");
  static constexpr int KC = W / 32;
  static constexpr int RS = W + 16;
  static constexpr int NG = NG_;
  static constexpr int NW = W / 8 / NG;
};

}  // namespace pint
