// K2 and K2p: box-QP projected gradient descent with one shared int8 Hessian.
//
// K2 replaces pint_tpu/mpc/fused.py:119 (FusedPGD._kernel, iteration body
// _body at :91, pallas_call at :256); K2p replaces pint_tpu/mpc/fused.py:136
// (FusedPGD._kernel_packed, pallas_call at :215), the same loop with packed
// words in and out and no momentum.  Each iteration, per problem b:
//   acc   = y . Hq^T                            (int8 x int8 -> int32)
//   pre   = (acc * hs_num) >> hs_den
//   delta = clip((-(pre + g) + half) >> g_shift, -128, 127)
//   x     = clip(y + delta, -127, 127)
// where y = x, or with momentum the extrapolation
//   y = clip(x + ((beta_num * (x - x_prev)) >> beta_den), -127, 127).
// Products and sums wrap as XLA's do (common.cuh's helpers); >> of a
// negative int is arithmetic, as XLA's.  |acc| <= 128 * 127 * 256 < 2^31, so
// the int32 sum is exact in any order and the kernels are bit-identical to
// fused_pgd_plain and fused_pgd_packed_plain.
//
// Bound at the main-path shape (B = 8192, Tp = 64, 15 iterations;
// utils/profiling.kernel_cost("fused_pgd")): K2 moves 6.3 MB, 0.0019 ms at
// 3.35 TB/s, and does 1.0 G int8 operations, 0.0005 ms at 1,979 TOP/s.
// The first design gave each problem a warp and each lane Tp/32 Hessian
// rows, recomputing each output as a chain of 16 __dp4a whose operands both
// came from shared memory by 4-byte loads (rows 68 bytes apart: no 16-byte
// loads), about 64 warp-wide loads a warp an iteration: 0.0422 ms (K2p
// 0.0423) queued on one H100 80GB HBM3 at 700 W, bound by shared-memory
// load issue.
//
// Here, as in K7 (csrc/alm.cu), the Hessian is one matrix for every
// problem, so the product runs across the batch on the tensor cores
// (csrc/mma_tile.cuh): a block owns a tile of 16 problems for the whole
// loop, its warps the output columns of two groups of 8 (one at W = 32)
// of (16 x W) int8 times Hq^T, by mma.sync m16n8k32 s8 -> s32, Tp padded to
// W = 32, 64, 128 or 256.  Hq's B fragments are built once a block from
// global memory, zero past Tp (so Tp = 20 or 52 stays exact), and held in
// registers, or at W = 256 in shared memory in register order (64 KB).  The
// state (x, x_prev with momentum, and half - g, which wraps to the same
// step) lives in registers in the accumulator's layout.  Each iteration
// writes y into one of two 16 x W byte tiles and reads its A fragments
// back after one barrier; the two tiles alternate, so no second barrier
// guards the next write.  K2 reads its int32 lanes and g by 16-byte loads
// that the quad of threads sharing a row exchanges by shuffles, and writes
// its lanes by 8-byte stores.  K2p's (B, Tp/4) words are the (B, Tp) int8
// lanes in memory: a tile's 16 x Tp bytes are the A tile itself, copied in
// and out by 16-byte loads and stores.  A data pointer that is not 16-byte
// aligned takes 4-byte loads and stores instead.  Problems past B are zero
// rows that are never stored; a padded lane has g = 0 and zero Hq row and
// column, so its delta is half >> g_shift = 0 and it stays 0.  0.0086 ms
// queued at the main-path shape on the same card (K2p 0.0087), 0.0038 of it
// staging and write-back, and each iteration adds 0.0003 ms.  The measured
// alternative, one warp a tile rebuilding A by shuffles within each quad (no
// barrier, ~4 warps an SM), took 0.0176 ms.
//
// Past Tp 256 Hq no longer fits beside the tile: the wide form below
// (fused_pgd_wide_kernel, to Tp 4096) runs each iteration as one product
// across the whole batch in tiles of 64 problems (csrc/wide_gemm.cuh).
//
// Input lanes must lie in [-128, 127] (unpacked int8 control lanes).
#include "common.cuh"
#include "mma_tile.cuh"
#include "wide_gemm.cuh"

namespace {

using pint::clampi;
using pint::wrap_mul;
using pint::wrap_sub;

// K2's tile at W: two column groups a warp (one at W = 32), so each warp
// reads the A tile for two products; the B fragments in shared memory at W =
// 256.
template <int W>
struct PgdShape : pint::MmaTile<W, (W > 32 ? 2 : 1)> {
  static constexpr bool SMEM_B = W > 128;
  static constexpr size_t tile = 16 * (W + 16);
  static constexpr size_t bytes = 2 * tile + (SMEM_B ? (size_t)W * W : 0);
};

// v[i][e] = m[row0 + gq + 8 (e >> 1)][c[i] + (e & 1)] of the row-major
// (B, Tp) int32 matrix m, 0 outside it; c[i] = 8 grp(i) + 2tq.  vec: m is
// 16-byte aligned, and thread tq of each quad loads the 4 columns 8 grp(i) +
// 4 (tq & 1) of row gq + 8 (tq >> 1) at once, which the quad exchanges.
template <int NG>
__device__ __forceinline__ void load_lanes(const int* m, int row0, int B, int Tp,
                                           const int (&c)[NG], int lane, bool vec,
                                           int (&v)[NG][4]) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    if (vec) {
      const int r = row0 + gq + 8 * (tq >> 1);
      const int c4 = c[i] - 2 * tq + 4 * (tq & 1);
      int4 w = make_int4(0, 0, 0, 0);
      if (r < B && c4 < Tp) w = *reinterpret_cast<const int4*>(m + (size_t)r * Tp + c4);
      const int lo = (lane & ~3) | (tq >> 1), hi = lo | 2;
      const int l0 = __shfl_sync(0xffffffffu, w.x, lo), l1 = __shfl_sync(0xffffffffu, w.y, lo);
      const int l2 = __shfl_sync(0xffffffffu, w.z, lo), l3 = __shfl_sync(0xffffffffu, w.w, lo);
      const int h0 = __shfl_sync(0xffffffffu, w.x, hi), h1 = __shfl_sync(0xffffffffu, w.y, hi);
      const int h2 = __shfl_sync(0xffffffffu, w.z, hi), h3 = __shfl_sync(0xffffffffu, w.w, hi);
      const bool odd = tq & 1;
      v[i][0] = odd ? l2 : l0;
      v[i][1] = odd ? l3 : l1;
      v[i][2] = odd ? h2 : h0;
      v[i][3] = odd ? h3 : h1;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + gq + 8 * (e >> 1), col = c[i] + (e & 1);
        v[i][e] = r < B && col < Tp ? m[(size_t)r * Tp + col] : 0;
      }
    }
  }
}

// Copy the tile's rows of the (B, Tp) int8 lanes at `src` (16 x Tp bytes
// from row row0, contiguous) into the byte tile t, or (out) back; rows past
// B are zeros in, and are not written out.  By 16-byte units of the
// contiguous bytes when vec (src 16-byte aligned), else by 4-byte words.
template <int RS, bool OUT>
__device__ __forceinline__ void copy_tile(unsigned char* t, unsigned char* src, int row0,
                                          int B, int Tp, bool vec) {
  const int valid = min(16, B - row0) * Tp;  // bytes of the tile's problems
  unsigned char* base = src + (size_t)row0 * Tp;
  for (int u = threadIdx.x; u < Tp; u += blockDim.x) {
    const int off = 16 * u;
    uint32_t w[4];
    int r[4], c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      r[q] = (off + 4 * q) / Tp;
      c[q] = off + 4 * q - r[q] * Tp;
    }
    if constexpr (OUT) {
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = *reinterpret_cast<const uint32_t*>(t + r[q] * RS + c[q]);
      if (vec && off + 16 <= valid) {
        *reinterpret_cast<uint4*>(base + off) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (off + 4 * q < valid) *reinterpret_cast<uint32_t*>(base + off + 4 * q) = w[q];
      }
    } else {
      if (vec && off + 16 <= valid) {
        const uint4 v = *reinterpret_cast<const uint4*>(base + off);
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = off + 4 * q < valid ? *reinterpret_cast<const uint32_t*>(base + off + 4 * q)
                                     : 0u;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) *reinterpret_cast<uint32_t*>(t + r[q] * RS + c[q]) = w[q];
    }
  }
}

// One block: tiles of 16 problems with a grid stride.  L is the lane I/O
// type: int (K2, (B, Tp) int32 lanes) or int8_t (K2p, (B, Tp/4) words).
template <int W, bool MOM, typename L>
__global__ void __launch_bounds__(PgdShape<W>::NW * 32)
fused_pgd_kernel(const L* __restrict__ lanes, const int* __restrict__ g,
                 const int8_t* __restrict__ hq, L* __restrict__ out, int B, int Tp,
                 int iters, int hs_num, int hs_den, int g_shift, int beta_num,
                 int beta_den) {
  using S = PgdShape<W>;
  constexpr int KC = S::KC, RS = S::RS, NG = S::NG, NW = S::NW;
  constexpr int KU = S::SMEM_B ? 1 : KC;  // k-chunks unrolled in the product
  constexpr bool PACKED = sizeof(L) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_b = reinterpret_cast<uint32_t*>(smem + 2 * S::tile);  // SMEM_B
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int half = 1 << (g_shift - 1);
  const bool vec = ((reinterpret_cast<uintptr_t>(lanes) | reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  int col[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) col[i] = 8 * (warp + NW * i) + 2 * tq;

  // B fragments for output column n = 8 (w + NW i) + gq: bytes k0..k0+3 of
  // row n of Hq (one word: Tp % 4 == 0), in registers or in shared memory at
  // word ((column group) * KC + kc) * 64 + h * 32 + lane
  const bool hq4 = (reinterpret_cast<uintptr_t>(hq) & 3) == 0;
  uint32_t breg[NG][S::SMEM_B ? 1 : KC][2];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int grp = warp + NW * i;
    const int n = 8 * grp + gq;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k0 = kc * 32 + h * 16 + tq * 4;
        uint32_t w = 0;
        if (n < Tp && k0 < Tp) {
          if (hq4) {
            w = *reinterpret_cast<const uint32_t*>(hq + n * Tp + k0);
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b) w |= (uint32_t)(uint8_t)hq[n * Tp + k0 + b] << (8 * b);
          }
        }
        if constexpr (S::SMEM_B)
          s_b[(grp * KC + kc) * 64 + h * 32 + lane] = w;
        else
          breg[i][kc][h] = w;
      }
    }
  }
  auto bw = [&](int i, int kc, int h) -> uint32_t {
    if constexpr (S::SMEM_B)
      return s_b[((warp + NW * i) * KC + kc) * 64 + h * 32 + lane];
    else
      return breg[i][kc][h];
  };

  const int ntiles = (B + 15) / 16;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * 16;
    int x[NG][4], hg[NG][4], xp[MOM ? NG : 1][4];
    __syncthreads();  // the B fragments are staged; the last tile's reads are done
    if constexpr (PACKED) {
      unsigned char* t = smem + S::tile;  // tile 1: iteration 0 writes tile 0
      copy_tile<RS, false>(t, (unsigned char*)lanes, row0, B, Tp, vec);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = gq + 8 * (e >> 1), c = col[i] + (e & 1);
          x[i][e] = row0 + r < B && c < Tp ? (int)(int8_t)t[r * RS + c] : 0;
        }
    } else {
      load_lanes<NG>(reinterpret_cast<const int*>(lanes), row0, B, Tp, col, lane, vec, x);
    }
    load_lanes<NG>(g, row0, B, Tp, col, lane, vec, hg);
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hg[i][e] = wrap_sub(half, hg[i][e]);
        if constexpr (MOM) xp[i][e] = x[i][e];
      }

    // unrolled by two, the tiles' addresses are constants
#pragma unroll 2
    for (int it = 0; it < iters; ++it) {
      unsigned char* t = smem + (it & 1) * S::tile;
      int y[NG][4];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (MOM)
            y[i][e] = clampi(
                x[i][e] + (wrap_mul(beta_num, x[i][e] - xp[i][e]) >> beta_den), -127, 127);
          else
            y[i][e] = x[i][e];
        }
        pint::store_pairs<RS>(t, gq, col[i], y[i]);
      }
      __syncthreads();  // t holds y; every read of the other tile is done
      int acc[NG][4] = {};
#pragma unroll(KU)
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        pint::load_a<RS>(t, gq, tq, kc, a);
#pragma unroll
        for (int i = 0; i < NG; ++i) pint::mma_s8(acc[i], a, bw(i, kc, 0), bw(i, kc, 1));
      }
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pre = wrap_mul(acc[i][e], hs_num) >> hs_den;
          const int delta = clampi(wrap_sub(hg[i][e], pre) >> g_shift, -128, 127);
          if constexpr (MOM) xp[i][e] = x[i][e];
          x[i][e] = clampi(y[i][e] + delta, -127, 127);
        }
    }

    if constexpr (PACKED) {
      // the last iteration read tile (iters - 1) & 1; the other is free
      unsigned char* t = smem + (iters & 1) * S::tile;
#pragma unroll
      for (int i = 0; i < NG; ++i) pint::store_pairs<RS>(t, gq, col[i], x[i]);
      __syncthreads();
      copy_tile<RS, true>(t, (unsigned char*)out, row0, B, Tp, vec);
    } else {
      int* o = reinterpret_cast<int*>(out);
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row0 + gq + 8 * h;
          if (r >= B || col[i] >= Tp) continue;
          int* p = o + (size_t)r * Tp + col[i];
          if (vec) {
            *reinterpret_cast<int2*>(p) = make_int2(x[i][2 * h], x[i][2 * h + 1]);
          } else {
            p[0] = x[i][2 * h];
            p[1] = x[i][2 * h + 1];
          }
        }
    }
  }
}

// -- K2 and K2p past Tp 256: the batch product (csrc/wide_gemm.cuh) ----------
//
// The same TPU kernels (pint_tpu/mpc/fused.py:119 -> :256, :136 -> :215)
// past 256 lanes.  Bound at phase 18's shapes (B = 4096, 15 iterations;
// utils/profiling.kernel_cost): the products, 2 B Tp^2 int8 operations an
// iteration, 0.0042 / 0.0163 / 0.2604 ms at Tp 260 / 512 / 2048 at 1,979
// TOP/s; each iteration also re-reads g (B Tp 4 bytes: 32 MiB at 2048).
// The first design gave a block one tile of 16 problems for the whole loop
// and read Hq's B fragments from L2 a 4-byte word at a time every
// iteration, so each byte of Hq fed 16 problems and the word loads set the
// pace (~1.9 TB/s of them): 0.1468 / 0.5560 / 8.2354 ms queued on one H100
// 80GB HBM3 at 700 W.  Here an iteration is the batch product y (B x Tp) .
// Hq^T over output tiles of 64 problems x 128 lanes on wgmma, the operands
// bulk-copied into the shared-memory ring, the PGD step the epilogue; a
// grid barrier separates the iterations (one cooperative launch a call).
// At Tp 260 and 512 an iteration is one round of tiles, so what bounds it
// is one tile's chain: the barrier, the chunks' copies and products, then
// the epilogue, which runs on 8 warps an SM and so is bound by its
// instructions' latency.  An epilogue that stepped each thread's wgmma
// fragment pairs where they lie (2-byte loads and stores, an address a
// pair) took 0.148 / 0.174 / 1.154 ms, with momentum 0.219 / 0.275 / 1.59,
// slower than the first design at Tp 260 with momentum (0.154).  So the
// epilogue goes through shared memory (wide_iterate) and steps 4 lanes a
// load (times in PERF.md; at 2048 the products' L2 traffic
// bounds it).  The state lives in the scratch (pint_fused_pgd_scratch): Hq
// and two buffers of y as int8 in the tiled layout (iteration it reads one
// and writes the other) and, with momentum, x as int8 (B x Tp).  Each
// element of the epilogue reads its y, g (and x) and writes its next y;
// the last iteration writes the lanes (K2: int32; K2p: the output words'
// bytes).  Pass 0 writes the padded copies: Hq, y0 from the lanes (clipped
// with momentum) and x.  |acc| <= 128 * 128 * 4096 < 2^31: exact in int32
// in any order, so the tiling cannot move a bit.
struct WideArgs {
  const void* lanes;  // K2: (B, Tp) int32 lanes; K2p: (B, Tp/4) words
  const int* g;
  const int8_t* hq;
  void* out;
  int8_t* scratch;
  int B, Tp, iters, hs_num, hs_den, g_shift, beta_num, beta_den;
  int vec;  // bit 0: g 16-byte aligned; bit 1: hq 4-byte; bit 2: lanes, out 16-byte
};

// The scratch: Hq padded to np x kp, y0 and y1 (bp x kp), all three in the
// tiled layout (wide_gemm.cuh: 8 KB blocks of 128 rows x 64 bytes), then x
// (momentum, B x Tp row-major).
struct WidePlan {
  int np, kp, nkc, bp;
  size_t y0, y1, x, bytes;
};

__host__ __device__ inline WidePlan wide_plan(int B, int Tp, bool mom) {
  using namespace pint::wide;
  WidePlan p;
  p.np = round_up(Tp, kTileN);
  p.kp = round_up(Tp, kTileK);
  p.nkc = p.kp / kTileK;
  p.bp = round_up(B, 128);  // whole row blocks of the tiled layout
  p.y0 = (size_t)p.np * p.kp;
  p.y1 = p.y0 + (size_t)p.bp * p.kp;
  p.x = p.y1 + (size_t)p.bp * p.kp;
  p.bytes = p.x + (mom ? round16((size_t)B * Tp) : 0);
  return p;
}

// pass 0: the padded copies, or with no iteration the output itself
template <bool MOM, bool PACKED>
__device__ void wide_stage(const WideArgs& a, const WidePlan& pl) {
  using pint::wide::bytes4;
  using pint::wide::grid_copy;
  using pint::wide::ld_lanes4;
  const int B = a.B, Tp = a.Tp, kw = pl.kp / 4, tw = Tp / 4;
  const bool vec16 = a.vec & 4;
  if (a.iters == 0) {  // the lanes as they came
    if constexpr (PACKED) {
      const uint32_t* src = static_cast<const uint32_t*>(a.lanes);
      uint32_t* dst = static_cast<uint32_t*>(a.out);
      grid_copy<4, uint32_t>((long)B * tw, [&](long u) { return __ldg(src + u); },
                             [&](long u, uint32_t v) { dst[u] = v; });
    } else {
      const int* src = static_cast<const int*>(a.lanes);
      int4* dst = static_cast<int4*>(a.out);
      grid_copy<4, int4>(
          (long)B * tw, [&](long u) { return ld_lanes4(src + 4 * u, vec16); },
          [&](long u, int4 v) {
            if (vec16) {
              dst[u] = v;
            } else {
              int* d = reinterpret_cast<int*>(dst) + 4 * u;
              d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
            }
          });
    }
    return;
  }
  const bool hq4 = a.vec & 2;
  grid_copy<4, uint32_t>(
      (long)pl.np * kw,
      [&](long u) {
        const int n = (int)(u / kw), k = (int)(u - (long)n * kw) * 4;
        return n < Tp && k < Tp ? pint::wide::ld4(a.hq + (size_t)n * Tp + k, hq4) : 0u;
      },
      [&](long u, uint32_t w) {
        const int n = (int)(u / kw), k = (int)(u - (long)n * kw) * 4;
        *reinterpret_cast<uint32_t*>(a.scratch + pint::wide::tiled(n, k, pl.nkc)) = w;
      });
  // y0 (and x) from the lanes; the padding of y0's rows is zeros
  grid_copy<4, int4>(
      (long)B * kw,
      [&](long u) {
        const int b = (int)(u / kw), k = (int)(u - (long)b * kw) * 4;
        if (k >= Tp) return make_int4(0, 0, 0, 0);
        if constexpr (PACKED)
          return make_int4((int)__ldg(static_cast<const uint32_t*>(a.lanes) + (size_t)b * tw + k / 4),
                           0, 0, 0);
        else
          return ld_lanes4(static_cast<const int*>(a.lanes) + (size_t)b * Tp + k, vec16);
      },
      [&](long u, int4 v) {
        const int b = (int)(u / kw), k = (int)(u - (long)b * kw) * 4;
        uint32_t* y0 = reinterpret_cast<uint32_t*>(a.scratch + pl.y0 + pint::wide::tiled(b, k, pl.nkc));
        if constexpr (PACKED) {
          *y0 = (uint32_t)v.x;
        } else {
          if constexpr (MOM) {
            if (k < Tp) *reinterpret_cast<uint32_t*>(a.scratch + pl.x + (size_t)b * Tp + k) = bytes4(v);
            v = make_int4(clampi(v.x, -127, 127), clampi(v.y, -127, 127), clampi(v.z, -127, 127),
                          clampi(v.w, -127, 127));
          }
          *y0 = bytes4(v);
        }
      });
}

// iteration `it`: y_next = step(y . Hq^T) over the tiles this block takes;
// the epilogue in groups of 4 lanes (wide_gemm.cuh), 16 a thread
template <bool MOM, bool PACKED>
__device__ void wide_iterate(const WideArgs& a, const WidePlan& pl, int it,
                             pint::wide::Ring& ring, int* accs) {
  using namespace pint::wide;
  const int B = a.B, Tp = a.Tp, nkc = pl.nkc;
  const int8_t* cur = a.scratch + ((it & 1) ? pl.y1 : pl.y0);
  int8_t* nxt = a.scratch + ((it & 1) ? pl.y0 : pl.y1);
  int8_t* xs = a.scratch + pl.x;
  const bool last = it == a.iters - 1, g16 = a.vec & 1, out16 = a.vec & 4;
  const int half = 1 << (a.g_shift - 1);
  const int nt = pl.np / kTileN;
  auto tile = [&](int t) {  // 64 problems: half mt & 1 of row block mt / 2
    const int mt = t / nt;
    return Tile{cur + (size_t)(mt >> 1) * nkc * kChunk + (mt & 1) * kHalf, nullptr,
                a.scratch + (size_t)(t % nt) * nkc * kChunk, nkc};
  };
  auto epilogue = [&](int t, int (&acc)[64]) {
    const int m0 = (t / nt) * kTileM, n0 = (t % nt) * kTileN;
    acc_to_smem(acc, accs);
    // group q: row rows8() + 8 (q / 2), lanes lanes4() + 64 (q % 2)
    int4 gv[16];
    uint32_t yv[16], xo[16];
    bool ok[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int r = m0 + rows8() + 8 * (q >> 1), c = n0 + 64 * (q & 1) + lanes4();
      ok[q] = r < B && c < Tp;  // Tp % 4 == 0: a group is all in or all out
      if (!ok[q]) continue;
      const size_t e = (size_t)r * Tp + c;
      gv[q] = ld_lanes4(a.g + e, g16);
      yv[q] = ld8x4(cur + tiled(r, c, nkc));
      if constexpr (MOM) xo[q] = ld8x4(xs + e);
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      if (!ok[q]) continue;
      const int rr = rows8() + 8 * (q >> 1), cc = 64 * (q & 1) + lanes4();
      const int r = m0 + rr, c = n0 + cc;
      const size_t e = (size_t)r * Tp + c;
      int4 av = *reinterpret_cast<const int4*>(accs + rr * kAccRow + cc), x, yn;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int pre = wrap_mul(lane(av, k), a.hs_num) >> a.hs_den;
        const int delta =
            clampi(wrap_sub(wrap_sub(half, lane(gv[q], k)), pre) >> a.g_shift, -128, 127);
        lane(x, k) = clampi(lane8(yv[q], k) + delta, -127, 127);
        lane(yn, k) = lane(x, k);
        if constexpr (MOM)
          lane(yn, k) = clampi(
              lane(x, k) + (wrap_mul(a.beta_num, lane(x, k) - lane8(xo[q], k)) >> a.beta_den),
              -127, 127);
      }
      if (last) {
        if constexpr (PACKED)
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.out) + e) = bytes4(x);
        else
          st4(static_cast<int*>(a.out) + e, out16, x);
      } else {
        if constexpr (MOM) *reinterpret_cast<uint32_t*>(xs + e) = bytes4(x);
        *reinterpret_cast<uint32_t*>(nxt + tiled(r, c, nkc)) = bytes4(yn);
      }
    }
    __syncthreads();  // every read of accs is done before the next tile's copy
  };
  for_tiles(((B + kTileM - 1) / kTileM) * nt, tile, epilogue, ring);
}

template <bool MOM, bool PACKED>
__global__ void __launch_bounds__(pint::wide::kThreads, pint::wide::kBlocksPerSm)
fused_pgd_wide_kernel(const WideArgs a) {
  extern __shared__ __align__(1024) unsigned char wide_smem[];
  const WidePlan pl = wide_plan(a.B, a.Tp, MOM);
  pint::wide::Ring ring(wide_smem);
  int* accs = reinterpret_cast<int*>(wide_smem + pint::wide::kSmem);
  wide_stage<MOM, PACKED>(a, pl);
  for (int it = 0; it < a.iters; ++it) {
    pint::wide::grid_sync();
    wide_iterate<MOM, PACKED>(a, pl, it, ring, accs);
  }
}

template <bool MOM, typename L>
cudaError_t launch_wide(const L* lanes, const int* g, const int8_t* hq, L* out, void* scratch,
                        int B, int Tp, int iters, int hs_num, int hs_den, int g_shift,
                        int beta_num, int beta_den, cudaStream_t stream, int extra_blocks = 0) {
  constexpr bool PACKED = sizeof(L) == 1;
  if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16) return cudaErrorInvalidValue;
  const bool g16 = (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const bool hq4 = (reinterpret_cast<uintptr_t>(hq) & 3) == 0;
  const bool vec16 = ((reinterpret_cast<uintptr_t>(lanes) | reinterpret_cast<uintptr_t>(out)) &
                      15) == 0;
  const WideArgs a{lanes, g, hq, out, static_cast<int8_t*>(scratch), B, Tp, iters, hs_num,
                   hs_den, g_shift, beta_num, beta_den,
                   (g16 ? 1 : 0) | (hq4 ? 2 : 0) | (vec16 ? 4 : 0)};
  return pint::wide::launch(fused_pgd_wide_kernel<MOM, PACKED>, a, pint::wide::kSmemAcc,
                            stream, extra_blocks);
}

template <int W, bool MOM, typename L>
cudaError_t launch(const L* lanes, const int* g, const int8_t* hq, L* out, int B, int Tp,
                   int iters, int hs_num, int hs_den, int g_shift, int beta_num,
                   int beta_den, cudaStream_t stream) {
  using S = PgdShape<W>;
  auto kernel = fused_pgd_kernel<W, MOM, L>;
  constexpr int threads = S::NW * 32;
  cudaError_t err = pint_allow_smem(kernel, S::bytes);
  int grid = 0;
  if (err == cudaSuccess)
    err = pint_persistent_grid(kernel, threads, S::bytes, (B + 15) / 16, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, S::bytes, stream>>>(lanes, g, hq, out, B, Tp, iters, hs_num,
                                              hs_den, g_shift, beta_num, beta_den);
  return cudaGetLastError();
}


// The widest Tp the wide form takes (Hq 16 MB).
constexpr int kMaxTp = 4096;

template <bool MOM, typename L>
int dispatch(const void* lanes, const void* g, const void* hq, void* out, void* scratch, int B,
             int Tp, int iters, int hs_num, int hs_den, int g_shift, int beta_num, int beta_den,
             void* stream) {
  if (B <= 0 || Tp <= 0 || Tp % 4 || Tp > kMaxTp || iters < 0 || g_shift < 1 ||
      g_shift > 30 || hs_den < 0 || hs_den > 31 || beta_den < 0 || beta_den > 30)
    return (int)cudaErrorInvalidValue;
  const L* l = static_cast<const L*>(lanes);
  const int* gg = static_cast<const int*>(g);
  const int8_t* h = static_cast<const int8_t*>(hq);
  L* o = static_cast<L*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Tp <= 32)
    err = launch<32, MOM, L>(l, gg, h, o, B, Tp, iters, hs_num, hs_den, g_shift, beta_num,
                             beta_den, s);
  else if (Tp <= 64)
    err = launch<64, MOM, L>(l, gg, h, o, B, Tp, iters, hs_num, hs_den, g_shift, beta_num,
                             beta_den, s);
  else if (Tp <= 128)
    err = launch<128, MOM, L>(l, gg, h, o, B, Tp, iters, hs_num, hs_den, g_shift, beta_num,
                              beta_den, s);
  else if (Tp <= 256)
    err = launch<256, MOM, L>(l, gg, h, o, B, Tp, iters, hs_num, hs_den, g_shift, beta_num,
                              beta_den, s);
  else
    err = launch_wide<MOM, L>(l, gg, h, o, scratch, B, Tp, iters, hs_num, hs_den, g_shift,
                              beta_num, beta_den, s);
  return (int)err;
}

}  // namespace

// The scratch K2 and K2p need at (B, Tp): none to 256, past it the wide
// form's padded Hq, two y buffers and (momentum) x.
extern "C" long long pint_fused_pgd_scratch(int B, int Tp, int momentum) {
  if (B <= 0 || Tp <= 256 || Tp > kMaxTp) return 0;
  return (long long)wide_plan(B, Tp, momentum != 0).bytes;
}

// For the card tests alone, not a solver's entry: K2's wide form (momentum
// off) on a cooperative grid extra_blocks larger than the card holds at
// once; returns the runtime's refusal (cudaErrorCooperativeLaunchTooLarge).
extern "C" int pint_fused_pgd_wide_oversized(const void* lanes, const void* g, const void* hq,
                                             void* out, void* scratch, int B, int Tp,
                                             int iters, int extra_blocks, void* stream) {
  if (B <= 0 || Tp <= 256 || Tp % 4 || Tp > kMaxTp || iters < 0 || extra_blocks < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch_wide<false, int>(
      static_cast<const int*>(lanes), static_cast<const int*>(g), static_cast<const int8_t*>(hq),
      static_cast<int*>(out), scratch, B, Tp, iters, 1, 0, 12, 0, 0,
      static_cast<cudaStream_t>(stream), extra_blocks);
}

// scratch: pint_fused_pgd_scratch(B, Tp, momentum) bytes, 16-byte aligned
// (null to Tp 256)
extern "C" int pint_fused_pgd(const void* lanes, const void* g, const void* hq,
                              void* out, void* scratch, int B, int Tp, int iters,
                              int hs_num, int hs_den, int g_shift, int momentum,
                              int beta_num, int beta_den, void* stream) {
  return momentum ? dispatch<true, int>(lanes, g, hq, out, scratch, B, Tp, iters, hs_num,
                                        hs_den, g_shift, beta_num, beta_den, stream)
                  : dispatch<false, int>(lanes, g, hq, out, scratch, B, Tp, iters, hs_num,
                                         hs_den, g_shift, beta_num, beta_den, stream);
}

// words, out: (B, Tp/4) packed control words, the (B, Tp) int8 lanes in
// memory; scratch: pint_fused_pgd_scratch(B, Tp, 0) bytes
extern "C" int pint_fused_pgd_packed(const void* words, const void* g,
                                     const void* hq, void* out, void* scratch, int B,
                                     int Tp, int iters, int hs_num, int hs_den,
                                     int g_shift, void* stream) {
  return dispatch<false, int8_t>(words, g, hq, out, scratch, B, Tp, iters, hs_num, hs_den,
                                 g_shift, 0, 0, stream);
}

extern "C" const char* pint_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
