// K5 and K7: the augmented-Lagrangian (ALM) inner of the state-constrained
// tier, the whole outer x inners loop in one launch; and K4 past 64 lanes.
//
// K5 replaces pint_tpu/mpc/fused_alm.py:335 (_kernel_factory, pallas_call
// at :674 in _alm_fused_core): per-problem int8 Hessian, constraint rows and
// rationals (DeviceConstrainedSQP).  K7 replaces pint_tpu/mpc/fused_alm.py:176
// (_shared_kernel_factory, pallas_call at :312 in alm_shared_fused_words):
// one Hessian and one constraint matrix for every problem (the LTI
// ConstrainedPGD), rationals as scalars.  Per problem b, each of `inners`
// iterations:
//   pre   = (Hq u * hs_num) >> hs_den
//   t     = ((Sq u * cs_num) >> cs_den) + c_off + lam
//   y     = t - clip(t, lo, hi) + ey
//   y14   = clip((y + y_half) >> y_shift, -8191, 8191)
//   ey    = y - (y14 << y_shift);  y_hi = y14 >> 7;  y_lo = y14 - (y_hi << 7)
//   extra = ((Sq^T y_hi * eh_num) >> eh_den) + ((Sq^T y_lo * el_num) >> el_den)
//   step  = -(pre + g + extra) + carry
//   delta = clip((step + half) >> g_shift, -128, 127)
//   carry = step - (delta << g_shift);  u = clip(u + delta, -127, 127)
// and after each `inners` block the multiplier update
//   lam = clip(t - clip(t, lo, hi), -2^22, 2^22)   (t from the final u).
// With no constraint rows and extra = 0 this is K4's PGD step
// (csrc/pgd_hqt.cu), which alm_wide_kernel runs for K4 past 64 lanes.
// Integer products and sums that XLA lets wrap go through common.cuh's
// uint32_t helpers; >> of a negative int is arithmetic, as XLA's.  The
// elementwise steps are one set of device functions (constraint_step,
// objective_step, lam_update) shared by every design below, and each int8
// product is exact in int32 (|acc| <= 127 * 128 * 4096 < 2^31), so the order
// of its sum cannot change a bit.
//
// K7 (alm_mma_kernel, Tp and Cp <= 256; past them alm_mma_wide_kernel, to
// 4096, below).  Bound at the main-path shape (B =
// 4096, Tp = Cp = 64, 12 x 60): 97 G int8 operations, 0.049 ms at the tensor
// cores' 1,979 TOP/s.  The first design (one warp a problem, each of the four
// matvecs of an iteration a row of __dp4a whose two operands were both read
// from shared memory by 4-byte loads: ~224 a lane an iteration) took 3.34 ms
// on one H100 80GB HBM3, bound by shared-memory load issue (~5.0M warp-wide
// loads an SM), and spilled.  Here the operands are shared by every problem,
// so each of the four matvecs is a product across the batch, (16 problems x
// Tp) int8 times a Tp x Tp or Cp x Tp matrix, run on the tensor cores by
// mma.sync m16n8k32 s8 -> s32.  Tp and Cp pad to W = 32, 64, 128 or 256; a
// block owns a tile of 16 problems for the whole loop and each of its warps
// the output columns of one (two at W = 256) group of 8 of every product.
// The B fragments of Hq, Sq and Sq^T (zero past Tp and Cp, so Tp = 20 or 52
// stays exact) are built once a block from global memory and held in
// registers, or at W = 256 in shared memory in register order (3 x 64 KB,
// read by conflict-free 4-byte loads); the state (lanes, g, carry, c_off,
// lam, ey) lives in registers in the accumulator's layout.  Each iteration
// rebuilds the A operand (u, then y_hi and y_lo) through a 16 x W byte tile
// in shared memory (rows padded by 16 bytes: the fragment loads are free of
// bank conflicts), one 32-byte k-chunk at a time, with 2 barriers an
// iteration.  Problems past B are zero rows that are never stored.  0.454 ms
// at the main-path shape on the same card; what is left is the elementwise
// integer work of the loop.
//
// K5 (alm_reg_kernel, Tp and Cp <= 64).  Bound at the main-path shape (B =
// 4096, Tp = Cp = 64, 3 x 30): each problem's hqt, one orientation of Sq
// (sqc), lanes, g, offsets, bounds, multipliers and rationals read once and
// its lanes and multipliers written once, 42 MB, 0.0126 ms at 3.35 TB/s.
// The first design (0.807 ms on the same card) staged 16 problems a block
// with 1-byte loads out of the batch-last layout, never overlapped with
// compute, then issued the same ~224 shared loads a lane an iteration as
// K7's.  Here (K4's design, csrc/pgd_hqt.cu) a persistent grid walks groups
// of 8 problems, one warp each; a group's hqt and sqc rows land by 8-byte
// cp.async (8 problems' bytes of one row kj) into one landing buffer, which
// the next group's copies refill while this group iterates; __byte_perm
// gathers turn the landed bytes into each problem's Hq rows, Sq rows by c
// and Sq rows by j, held in registers (96 words a lane at Tp = Cp = 64).  An
// iteration then issues 128 __dp4a from registers and reads only the
// broadcast vectors u, y_hi and y_lo from shared memory, 16 bytes a load (~12
// a lane).  A batch that is not a multiple of 8 stages the same layout with
// byte loads.  sqj is not read.  0.221 ms on the same card.
//
// K5 and K4 past 64 (alm_wide_kernel; the long-horizon path runs it at Tp =
// 256, Cp = 128 for K5, and at Tp = 256 and 288 for K4): one problem a
// cluster of NC = 1, 2, 4 or 8 blocks, the fewest whose shared memory holds
// the problem's rows.  Block r of the cluster holds slice r of the rows j of
// Hq and of Sq by j (from sqj) and slice r of the rows c of Sq by c, one row
// a thread, and the whole broadcast vectors u (two buffers) and y_hi, y_lo.
// An iteration reads its rows by 16-byte loads (rows padded to an odd
// number of 16 bytes: free of bank conflicts) against the broadcast vectors
// (both y halves in one pass over a row of Sq by j), and each thread writes
// its y and then its new u into every block of the cluster through
// distributed shared memory, with a cluster barrier after each (one for
// K4).  This reaches the reference's own fits (pgd_viable Tp <= 632,
// alm_viable), where one problem's rows outgrow one block.
// Staging: each slab comes batch-last or problem-major (the solvers hand it
// problem-major past 64 lanes or rows).  Problem-major, a block's rows of a
// slab are one contiguous run, copied by 16-byte (else 4-byte) cp.async from
// every thread, so every sector is read once and whole, and L2 prefetches
// the cluster's next problem (one bulk prefetch a slab) while this one
// iterates, so the copies come from L2.  A block holds one problem: where
// its rows fit, several blocks share an SM (three at Tp 256, two at 288),
// and one block's copies overlap another's iterations.  A second buffer a
// block (the next problem landing while this one runs) took as long or
// longer on one H100 80GB HBM3 (PERF.md), since it halves the blocks an SM;
// so did the products on the s8 tensor cores (mma.sync with the vector as
// one column of B) in place of __dp4a.  Batch-last, the rows are gathered a
// byte at a time (one sector a byte, neighbouring clusters on neighbouring
// problems of it): the first design, which took 10.73 ms for K5 at 256 x
// 128, 3 x 30, B 4096, 5.63 of it with no iteration, on the same card.
//
// Input lanes must lie in [-128, 127] (unpacked int8 control lanes).
#include <cooperative_groups.h>

#include "common.cuh"
#include "mma_tile.cuh"
#include "wide_gemm.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kLamCap = 1 << 22;
constexpr int kYCap = (1 << 13) - 1;
constexpr int kGroup = 8;  // K5 problems a group, one warp each: 8 bytes a row kj

struct Rationals {
  int hs_num, hs_den, cs_num, cs_den, eh_num, eh_den, el_num, el_den;
};

__device__ __forceinline__ int shr_mul(int acc, int num, int den) {
  return pint::wrap_mul(acc, num) >> den;
}

// The constraint side of an iteration from acc = (Sq u)[c]: returns the
// 14-bit violation y14 and updates eyh, which carries ey + y_half (ey the
// error feedback), so the rounding offset costs no add an iteration:
//   yy = t - clip(t, lo, hi) + ey + y_half,  y14 = clip(yy >> y_shift),
//   eyh' = yy - (y14 << y_shift) = ey' + y_half.
// negys = -(1 << y_shift): the shift-and-subtract is one multiply-add.
__device__ __forceinline__ int constraint_step(int acc, int co, int lam, int lo,
                                               int hi, int& eyh, const Rationals& r,
                                               int negys, int y_shift) {
  const int t =
      pint::wrap_add(pint::wrap_add(shr_mul(acc, r.cs_num, r.cs_den), co), lam);
  const int yy = pint::wrap_add(pint::wrap_sub(t, pint::clampi(t, lo, hi)), eyh);
  const int y14 = pint::clampi(yy >> y_shift, -kYCap, kYCap);
  eyh = pint::wrap_add(yy, pint::wrap_mul(y14, negys));
  return y14;
}

// The objective side and the update of one lane from acc = (Hq u)[j] and
// the two halves of the penalty gradient eh, el = (Sq^T y_hi/lo)[j].  ch
// carries carry + half, so step + half is four subtractions:
//   sh = ch - pre - g - eh' - el',  delta = clip(sh >> g_shift),
//   ch' = sh - (delta << g_shift) = carry' + half.
// negg = -(1 << g_shift).  Every sum wraps, so the order is free.
__device__ __forceinline__ void objective_step(int acc, int eh, int el, int gj,
                                               int& ch, int& x, const Rationals& r,
                                               int negg, int g_shift) {
  int sh = pint::wrap_sub(pint::wrap_sub(ch, shr_mul(acc, r.hs_num, r.hs_den)), gj);
  sh = pint::wrap_sub(pint::wrap_sub(sh, shr_mul(eh, r.eh_num, r.eh_den)),
                      shr_mul(el, r.el_num, r.el_den));
  const int delta = pint::clampi(sh >> g_shift, -128, 127);
  ch = pint::wrap_add(sh, pint::wrap_mul(delta, negg));
  x = pint::clampi(x + delta, -127, 127);
}

// The multiplier update from acc = (Sq u)[c] at the inner solution.
__device__ __forceinline__ int lam_update(int acc, int co, int lam, int lo, int hi,
                                          const Rationals& r) {
  const int t =
      pint::wrap_add(pint::wrap_add(shr_mul(acc, r.cs_num, r.cs_den), co), lam);
  return pint::clampi(pint::wrap_sub(t, pint::clampi(t, lo, hi)), -kLamCap, kLamCap);
}

// -- K7: the four matvecs on the tensor cores (Tp, Cp <= 256) ----------------

using pint::load_a;
using pint::mma_s8;
using pint::store_pairs;

// K7's shape at W (csrc/mma_tile.cuh's tile) and whether the B fragments
// live in shared memory (at W = 256 three sets of 48 registers a thread
// would not fit beside the state).  At W = 256 a warp owns two column
// groups (16 warps of up to 128 registers), and the k-chunk loops stay
// rolled, so the fragment loads of all chunks are not hoisted into
// registers at once.
template <int W>
struct MmaShape : pint::MmaTile<W, (W > 128 ? 2 : 1)> {
  static constexpr bool SMEM_B = W > 128;
  static constexpr size_t tiles = 3 * 16 * (W + 16);  // u, y_hi, y_lo
  static constexpr size_t bytes = tiles + (SMEM_B ? (size_t)3 * W * W : 0);
};

// A block (MmaShape<W>::NW warps) runs tiles of 16 problems with a grid
// stride; thread (warp w, group gq, tq) holds, for each of its column groups
// n = w + NW * i, the elements e of rows gq + 8 (e >> 1), columns 8n + 2tq +
// (e & 1) of every product, which are its lanes j and its constraint rows c.
// The padding runs the same steps with no branch: a lane j >= Tp has zero Hq
// and Sq columns and g = 0, so it stays 0; a row c >= Cp has zero Sq row,
// offset, bounds and multiplier, so its y and lam stay 0.  Only the stores
// mask.
template <int W>
__global__ void __launch_bounds__(MmaShape<W>::NW * 32)
alm_mma_kernel(const int* __restrict__ lanes, const int* __restrict__ g,
               const int* __restrict__ coff, const int* __restrict__ lam0,
               const int8_t* __restrict__ hq, const int8_t* __restrict__ sq,
               const int* __restrict__ lo, const int* __restrict__ hi,
               int* __restrict__ out_lanes, int* __restrict__ out_lam, int B,
               int Tp, int Cp, int outer, int inners, int g_shift, int y_shift,
               Rationals r) {
  using S = MmaShape<W>;
  constexpr int KC = S::KC, RS = S::RS, NG = S::NG, NW = S::NW;
  constexpr int KU = S::SMEM_B ? 1 : KC;  // k-chunks unrolled in the products
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s_u = smem;
  unsigned char* s_yh = s_u + 16 * RS;
  unsigned char* s_yl = s_yh + 16 * RS;
  uint32_t* s_b = reinterpret_cast<uint32_t*>(smem + S::tiles);  // SMEM_B
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int half = 1 << (g_shift - 1);
  const int y_half = (1 << y_shift) >> 1;
  const int negg = -(1 << g_shift), negys = -(1 << y_shift);
  int col[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) col[i] = 8 * (warp + NW * i) + 2 * tq;

  // B fragments (m = 0 Hq, 1 Sq, 2 Sq^T) for output column n = 8(w + NW i)
  // + gq: bytes k0..k0+3 of column n, in registers or in shared memory at
  // word ((m * W/8 + column group) * KC + kc) * 64 + h * 32 + lane
  uint32_t breg[S::SMEM_B ? 1 : 3][NG][S::SMEM_B ? 1 : KC][2];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int grp = warp + NW * i;
    const int n = 8 * grp + gq;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k0 = kc * 32 + h * 16 + tq * 4;
        uint32_t w[3] = {0, 0, 0};
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = k0 + b;
          const uint32_t vh = n < Tp && k < Tp ? (uint8_t)hq[n * Tp + k] : 0;  // Hq[j][k]
          const uint32_t vs = n < Cp && k < Tp ? (uint8_t)sq[n * Tp + k] : 0;  // Sq[c][j]
          const uint32_t vj = n < Tp && k < Cp ? (uint8_t)sq[k * Tp + n] : 0;  // Sq[c][j]
          w[0] |= vh << (8 * b);
          w[1] |= vs << (8 * b);
          w[2] |= vj << (8 * b);
        }
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          if constexpr (S::SMEM_B)
            s_b[((m * (W / 8) + grp) * KC + kc) * 64 + h * 32 + lane] = w[m];
          else
            breg[m][i][kc][h] = w[m];
        }
      }
    }
  }
  // the B fragment (word h) of matrix m, column group i, k-chunk kc
  auto bw = [&](int m, int i, int kc, int h) -> uint32_t {
    if constexpr (S::SMEM_B)
      return s_b[((m * (W / 8) + warp + NW * i) * KC + kc) * 64 + h * 32 + lane];
    else
      return breg[m][i][kc][h];
  };
  int clo[NG][2], chi[NG][2];
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      clo[i][e] = col[i] + e < Cp ? lo[col[i] + e] : 0;
      chi[i][e] = col[i] + e < Cp ? hi[col[i] + e] : 0;
    }

  const int ntiles = (B + 15) / 16;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    // ch: carry + half; eyh: ey + y_half
    int x[NG][4], gj[NG][4], ch[NG][4], co[NG][4], lam[NG][4], eyh[NG][4];
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = tile * 16 + gq + 8 * (e >> 1);
        const int c = col[i] + (e & 1);
        const bool jb = b < B && c < Tp, cb = b < B && c < Cp;
        x[i][e] = jb ? lanes[(size_t)b * Tp + c] : 0;
        gj[i][e] = jb ? g[(size_t)b * Tp + c] : 0;
        co[i][e] = cb ? coff[(size_t)b * Cp + c] : 0;
        lam[i][e] = cb ? lam0[(size_t)b * Cp + c] : 0;
        ch[i][e] = half;
        eyh[i][e] = y_half;
      }
    __syncthreads();  // the B fragments are staged; the last tile's readers are done
#pragma unroll
    for (int i = 0; i < NG; ++i) store_pairs<RS>(s_u, gq, col[i], x[i]);
    for (int o = 0; o < outer; ++o) {
      for (int it = 0; it < inners; ++it) {
        __syncthreads();  // s_u holds u; every read of s_yh, s_yl is done
        int ds[NG][4] = {}, dh[NG][4] = {};
#pragma unroll(KU)
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t a[4];
          load_a<RS>(s_u, gq, tq, kc, a);
#pragma unroll
          for (int i = 0; i < NG; ++i) {
            mma_s8(ds[i], a, bw(1, i, kc, 0), bw(1, i, kc, 1));  // (Sq u)[c]
            mma_s8(dh[i], a, bw(0, i, kc, 0), bw(0, i, kc, 1));  // (Hq u)[j]
          }
        }
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          int yh[4], yl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int y14 = constraint_step(ds[i][e], co[i][e], lam[i][e], clo[i][e & 1],
                                            chi[i][e & 1], eyh[i][e], r, negys, y_shift);
            yh[e] = y14 >> 7;
            yl[e] = y14 & 0x7F;
          }
          store_pairs<RS>(s_yh, gq, col[i], yh);
          store_pairs<RS>(s_yl, gq, col[i], yl);
        }
        __syncthreads();  // s_yh, s_yl complete; every read of s_u is done
        int de[NG][4] = {}, dl[NG][4] = {};
#pragma unroll(KU)
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t a[4];
          load_a<RS>(s_yh, gq, tq, kc, a);
#pragma unroll
          for (int i = 0; i < NG; ++i)
            mma_s8(de[i], a, bw(2, i, kc, 0), bw(2, i, kc, 1));  // (Sq^T y_hi)[j]
          load_a<RS>(s_yl, gq, tq, kc, a);
#pragma unroll
          for (int i = 0; i < NG; ++i)
            mma_s8(dl[i], a, bw(2, i, kc, 0), bw(2, i, kc, 1));  // (Sq^T y_lo)[j]
        }
#pragma unroll
        for (int i = 0; i < NG; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            objective_step(dh[i][e], de[i][e], dl[i][e], gj[i][e], ch[i][e], x[i][e], r,
                           negg, g_shift);
          store_pairs<RS>(s_u, gq, col[i], x[i]);
        }
      }
      // multiplier update from the exact int32 violation at the inner solution
      __syncthreads();
      int ds[NG][4] = {};
#pragma unroll(KU)
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t a[4];
        load_a<RS>(s_u, gq, tq, kc, a);
#pragma unroll
        for (int i = 0; i < NG; ++i) mma_s8(ds[i], a, bw(1, i, kc, 0), bw(1, i, kc, 1));
      }
#pragma unroll
      for (int i = 0; i < NG; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lam[i][e] = lam_update(ds[i][e], co[i][e], lam[i][e], clo[i][e & 1],
                                 chi[i][e & 1], r);
    }
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = tile * 16 + gq + 8 * (e >> 1);
        const int c = col[i] + (e & 1);
        if (b < B && c < Tp) out_lanes[(size_t)b * Tp + c] = x[i][e];
        if (b < B && c < Cp) out_lam[(size_t)b * Cp + c] = lam[i][e];
      }
  }
}

// -- K7 past 256: the batch products (csrc/wide_gemm.cuh) ---------------------
//
// The same TPU kernel (pint_tpu/mpc/fused_alm.py:176 -> :312) past 256
// lanes or rows.  Bound at phase 18's shapes (B = 4096, 3 x 10;
// kernel_cost "operations"): 0.0344 / 0.0830 / 0.1335 / 2.136 ms at (Tp,
// Cp) = 260² / 512 x 256 / 512² / 2048².  Past 256 the int32 state (carry,
// multipliers, error feedback: 12 bytes a lane or row and problem) fits on
// chip nowhere at B 4096, so each pass also moves it through L2 and HBM:
// about 290 MiB an inner iteration at 2048², ~2.6 ms over 30 inners, which
// kernel_cost does not count.  The first design gave a block one tile of 16
// problems for the whole loop and read the B fragments of Hq, Sq and Sq^T
// from L2 a 4-byte word at a time every pass (each byte fed 16 problems;
// ~1.8 TB/s of word loads set the pace): 1.453 / 2.630 / 4.144 / 52.98 ms
// queued on one H100 80GB HBM3 at 700 W.  Here each pass is one product
// across the batch on wgmma, tiles of 64 problems bulk-copied through the
// shared-memory ring, the elementwise step its epilogue (4 lanes a load
// through shared memory, wide_gemm.cuh) and a grid barrier after it.  At
// the narrow shapes each pass is one or two rounds of tiles and their
// chains of latencies (61 barriers at 3 x 10) bound it; at 2048² the
// products and the state traffic:
//   pass 1: u (B x Tp) . [Hq; Sq]^T, one product with Tp + Cp columns in
//     tiles of 64 x 128 (Hq's rows padded to 128, so a tile is all objective
//     or all constraint):
//     objective columns fold -pre into the stored carry, constraint columns
//     run constraint_step and write y_hi and y_lo;
//   pass 2: [y_hi; y_lo] (the same 64 problems of each) . (Sq^T)^T in tiles
//     of 64 x 64 (ceil(Tp / 64) of them across), one B tile for both
//     halves, so the epilogue finds (Sq^T y_hi)[j] and (Sq^T y_lo)[j] of the
//     same problem and lane side by side:
//     objective_step, the new u (the last pass 2 writes the lanes over the
//     carries);
//   the multiplier update: (Sq u)[c] at the inner solution is the first
//     pass 1 of the next outer iteration's product, so that pass 1 applies
//     lam_update before its constraint step (exact: u has not changed); the
//     last outer's update is a pass of the Sq columns alone (with no inner
//     iteration, `outer` such passes on u as staged).
// The scratch (pint_alm_shared_scratch) holds [Hq; Sq] padded ((nh + nc) x
// kj), Sq^T padded (nh x kc, written by pass 0 from Sq), u (bp x kj), y_hi,
// y_lo (bp x kc) as int8 in the tiled layout, and ey + y_half (B x Cp
// int32); the carry + half
// lives in out_lanes and the multipliers in out_lam.  Padded columns meet
// zero B rows; padded rows and columns are never stored.  Exact in int32:
// |acc| <= 128 * 128 * max(Tp, Cp) < 2^31 below 131,072.  Tp, Cp <= 4096.
constexpr int kMmaMaxW = 4096;

struct MmaWideArgs {
  const int *lanes, *g, *coff, *lam0;
  const int8_t *hq, *sq;
  const int *lo, *hi;
  int *out_lanes, *out_lam;  // the carry + half, then the lanes; the multipliers
  int8_t* scratch;
  int B, Tp, Cp, outer, inners, g_shift, y_shift;
  int vec;  // bit 0: the int32 arrays 16-byte aligned; bit 1: hq, bit 2: sq 4-byte aligned
  Rationals r;
};

// The scratch: [Hq; Sq] at 0, then Sq^T, u, y_hi, y_lo in the tiled layout
// (wide_gemm.cuh: 8 KB blocks of 128 rows x 64 bytes), then ey + y_half
// (B x Cp int32).
struct MmaWidePlan {
  int nh, nc, kj, kc;  // Hq's and Sq's rows padded; k of u (Tp) and of y (Cp) padded
  int nkj, nkc, bp;    // their chunks; the batch padded to 128
  size_t sqt, u, yh, yl, eyh, bytes;
};

__host__ __device__ inline MmaWidePlan mma_wide_plan(int B, int Tp, int Cp) {
  using namespace pint::wide;
  MmaWidePlan p;
  p.nh = round_up(Tp, kTileN);
  p.nc = round_up(Cp, kTileN);
  p.kj = round_up(Tp, kTileK);
  p.kc = round_up(Cp, kTileK);
  p.nkj = p.kj / kTileK;
  p.nkc = p.kc / kTileK;
  p.bp = round_up(B, 128);  // whole row blocks of the tiled layout
  p.sqt = (size_t)(p.nh + p.nc) * p.kj;
  p.u = p.sqt + (size_t)p.nh * p.kc;
  p.yh = p.u + (size_t)p.bp * p.kj;
  p.yl = p.yh + (size_t)p.bp * p.kc;
  p.eyh = p.yl + (size_t)p.bp * p.kc;
  p.bytes = p.eyh + (size_t)4 * B * Cp;
  return p;
}

// passes of a call: staging, two a step of the outer x inners loop, and the
// last multiplier update (with no inner step, `outer` updates on u as staged)
__host__ __device__ inline int mma_wide_passes(int outer, int inners) {
  return 1 + 2 * outer * inners + (inners > 0 ? (outer > 0 ? 1 : 0) : outer);
}

__device__ void mma_wide_stage(const MmaWideArgs& a, const MmaWidePlan& pl) {
  using pint::wide::grid_copy;
  const int B = a.B, Tp = a.Tp, Cp = a.Cp;
  const bool hq4 = a.vec & 2, sq4 = a.vec & 4, steps = a.outer * a.inners > 0;
  int8_t* s = a.scratch;
  const int kjw = pl.kj / 4, kcw = pl.kc / 4;
  grid_copy<4, uint32_t>(
      (long)(pl.nh + pl.nc) * kjw,
      [&](long u) {
        const int n = (int)(u / kjw), k = (int)(u - (long)n * kjw) * 4;
        if (k < Tp && n < Tp) return pint::wide::ld4(a.hq + (size_t)n * Tp + k, hq4);
        if (k < Tp && n >= pl.nh && n - pl.nh < Cp)
          return pint::wide::ld4(a.sq + (size_t)(n - pl.nh) * Tp + k, sq4);
        return 0u;
      },
      [&](long u, uint32_t w) {
        const int n = (int)(u / kjw), k = (int)(u - (long)n * kjw) * 4;
        *reinterpret_cast<uint32_t*>(s + pint::wide::tiled(n, k, pl.nkj)) = w;
      });
  grid_copy<4, uint32_t>(  // Sq^T[j][c] = Sq[c][j]
      (long)pl.nh * kcw,
      [&](long u) {
        const int j = (int)(u / kcw), c = (int)(u - (long)j * kcw) * 4;
        uint32_t w = 0;
        if (j < Tp)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (c + q < Cp)
              w |= (uint32_t)(uint8_t)__ldg(a.sq + (size_t)(c + q) * Tp + j) << (8 * q);
        return w;
      },
      [&](long u, uint32_t w) {
        const int j = (int)(u / kcw), c = (int)(u - (long)j * kcw) * 4;
        *reinterpret_cast<uint32_t*>(s + pl.sqt + pint::wide::tiled(j, c, pl.nkc)) = w;
      });
  const int half = 1 << (a.g_shift - 1);
  grid_copy<4, int4>(  // u from the lanes; the carries (or, with no step, the lanes)
      (long)B * kjw,
      [&](long u) {
        const int b = (int)(u / kjw), k = (int)(u - (long)b * kjw) * 4;
        return k < Tp ? pint::wide::ld_lanes4(a.lanes + (size_t)b * Tp + k, false)
                      : make_int4(0, 0, 0, 0);
      },
      [&](long u, int4 v) {
        const int b = (int)(u / kjw), k = (int)(u - (long)b * kjw) * 4;
        *reinterpret_cast<uint32_t*>(s + pl.u + pint::wide::tiled(b, k, pl.nkj)) =
            pint::wide::bytes4(v);
        if (k < Tp) {
          int* o = a.out_lanes + (size_t)b * Tp + k;
          if (steps)
            o[0] = o[1] = o[2] = o[3] = half;
          else
            o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
        }
      });
  int* eyh = reinterpret_cast<int*>(s + pl.eyh);
  const int y_half = (1 << a.y_shift) >> 1;
  grid_copy<4, int>((long)B * Cp, [&](long u) { return __ldg(a.lam0 + u); },
                    [&](long u, int v) {
                      a.out_lam[u] = v;
                      eyh[u] = y_half;
                    });
}

// Pass 1 of a step (update: lam_update first, in the first step of an
// outer iteration past the first), or with constraint_step_too false a
// multiplier update alone (the Sq columns only).
__device__ void mma_wide_pass1(const MmaWideArgs& a, const MmaWidePlan& pl,
                               bool constraint_step_too, bool update, pint::wide::Ring& ring,
                               int* accs) {
  using namespace pint::wide;
  const int B = a.B, Tp = a.Tp, Cp = a.Cp, nkj = pl.nkj;
  const int8_t* u = a.scratch + pl.u;
  int8_t* yh = a.scratch + pl.yh;
  int8_t* yl = a.scratch + pl.yl;
  int* eyh = reinterpret_cast<int*>(a.scratch + pl.eyh);
  const bool v16 = a.vec & 1;
  const Rationals& r = a.r;
  const int negys = -(1 << a.y_shift);
  const int nfirst = constraint_step_too ? 0 : pl.nh / kTileN;
  const int nt = (pl.nh + pl.nc) / kTileN - nfirst;
  auto tile = [&](int t) {  // 64 problems: half mt & 1 of row block mt / 2
    const int mt = t / nt;
    return Tile{u + (size_t)(mt >> 1) * nkj * kChunk + (mt & 1) * kHalf, nullptr,
                a.scratch + (size_t)(nfirst + t % nt) * nkj * kChunk, nkj};
  };
  auto epilogue = [&](int t, int (&acc)[64]) {
    const int m0 = (t / nt) * kTileM, n0 = (nfirst + t % nt) * kTileN;
    acc_to_smem(acc, accs);
    // a thread's groups: rows rows8() + 8 k, lanes lanes4() + 64 m (k < 8, m < 2)
    if (n0 < pl.nh) {  // objective columns: the carry takes -pre, two rounds of 8
#pragma unroll
      for (int rd = 0; rd < 2; ++rd) {
        int4 ch[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int row = m0 + rows8() + 8 * (4 * rd + (q >> 1)), c = n0 + 64 * (q & 1) + lanes4();
          if (row < B && c < Tp) ch[q] = ld4cg(a.out_lanes + (size_t)row * Tp + c, v16);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int rr = rows8() + 8 * (4 * rd + (q >> 1)), cc = 64 * (q & 1) + lanes4();
          const int row = m0 + rr, c = n0 + cc;
          if (row >= B || c >= Tp) continue;
          int4 av = *reinterpret_cast<const int4*>(accs + rr * kAccRow + cc);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            lane(ch[q], k) =
                pint::wrap_sub(lane(ch[q], k), shr_mul(lane(av, k), r.hs_num, r.hs_den));
          st4(a.out_lanes + (size_t)row * Tp + c, v16, ch[q]);
        }
      }
    } else {  // constraint columns: four rounds of 4 groups, loads first (no spill)
      const int cb = n0 - pl.nh;
      int4 lo[2], hi[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int c = cb + 64 * m + lanes4();
        if (c < Cp) lo[m] = ld_lanes4(a.lo + c, v16), hi[m] = ld_lanes4(a.hi + c, v16);
      }
#pragma unroll
      for (int rd = 0; rd < 4; ++rd) {
        int4 co[4], lam[4], ey[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = m0 + rows8() + 8 * (2 * rd + (q >> 1)), c = cb + 64 * (q & 1) + lanes4();
          if (row >= B || c >= Cp) continue;
          const size_t e = (size_t)row * Cp + c;
          co[q] = ld_lanes4(a.coff + e, v16);
          lam[q] = ld4cg(a.out_lam + e, v16);
          if (constraint_step_too) ey[q] = ld4cg(eyh + e, true);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rr = rows8() + 8 * (2 * rd + (q >> 1)), cc = 64 * (q & 1) + lanes4();
          const int row = m0 + rr, c = cb + cc;
          if (row >= B || c >= Cp) continue;
          const size_t e = (size_t)row * Cp + c;
          int4 av = *reinterpret_cast<const int4*>(accs + rr * kAccRow + cc), y14;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int v = lane(av, k);
            if (update)
              lane(lam[q], k) = lam_update(v, lane(co[q], k), lane(lam[q], k),
                                           lane(lo[q & 1], k), lane(hi[q & 1], k), r);
            if (constraint_step_too)
              lane(y14, k) = constraint_step(v, lane(co[q], k), lane(lam[q], k),
                                             lane(lo[q & 1], k), lane(hi[q & 1], k),
                                             lane(ey[q], k), r, negys, a.y_shift);
          }
          if (update) st4(a.out_lam + e, v16, lam[q]);
          if (constraint_step_too) {
            st4(eyh + e, true, ey[q]);
            *reinterpret_cast<uint32_t*>(yh + tiled(row, c, pl.nkc)) = bytes4(make_int4(
                y14.x >> 7, y14.y >> 7, y14.z >> 7, y14.w >> 7));
            *reinterpret_cast<uint32_t*>(yl + tiled(row, c, pl.nkc)) = bytes4(make_int4(
                y14.x & 0x7F, y14.y & 0x7F, y14.z & 0x7F, y14.w & 0x7F));
          }
        }
      }
    }
    __syncthreads();  // every read of accs is done before the next tile's copy
  };
  for_tiles(((B + kTileM - 1) / kTileM) * nt, tile, epilogue, ring);
}

// Pass 2: the penalty gradient of both y halves, the step and the new u.
__device__ void mma_wide_pass2(const MmaWideArgs& a, const MmaWidePlan& pl, bool last,
                               pint::wide::Ring& ring, int* accs) {
  using namespace pint::wide;
  const int B = a.B, Tp = a.Tp, nkc = pl.nkc;
  int8_t* u = a.scratch + pl.u;
  const int8_t* yh = a.scratch + pl.yh;
  const int8_t* yl = a.scratch + pl.yl;
  const bool v16 = a.vec & 1;
  const int negg = -(1 << a.g_shift);
  const int nt = (Tp + 63) / 64;  // tiles of 64 problems x 64 lanes
  auto tile = [&](int t) {  // halves mt & 1 and nn & 1 of row blocks mt / 2 and nn / 2
    const int mt = t / nt, nn = t % nt;
    const size_t off = (size_t)(mt >> 1) * nkc * kChunk + (mt & 1) * kHalf;
    return Tile{yh + off, yl + off,
                a.scratch + pl.sqt + (size_t)(nn >> 1) * nkc * kChunk + (nn & 1) * kHalf, nkc};
  };
  auto epilogue = [&](int t, int (&acc)[64]) {
    const int m0 = (t / nt) * 64, n0 = (t % nt) * 64;
    // columns 0-63 of accs: (Sq^T y_hi)[j], 64-127: (Sq^T y_lo)[j] of the
    // same problem and lane; round rd's group q: row rows8() + 8 (4 rd + q)
    acc_to_smem(acc, accs);
#pragma unroll
    for (int rd = 0; rd < 2; ++rd) {  // two rounds of 4 groups, loads first
      int4 ch[4], gj[4];
      uint32_t uv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + rows8() + 8 * (4 * rd + q), c = n0 + lanes4();
        if (row >= B || c >= Tp) continue;
        const size_t e = (size_t)row * Tp + c;
        ch[q] = ld4cg(a.out_lanes + e, v16);
        gj[q] = ld_lanes4(a.g + e, v16);
        uv[q] = ld8x4(u + tiled(row, c, pl.nkj));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int rr = rows8() + 8 * (4 * rd + q), row = m0 + rr, c = n0 + lanes4();
        if (row >= B || c >= Tp) continue;
        const size_t e = (size_t)row * Tp + c;
        int4 eh = *reinterpret_cast<const int4*>(accs + rr * kAccRow + lanes4());
        int4 el = *reinterpret_cast<const int4*>(accs + rr * kAccRow + 64 + lanes4()), x;
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // pre is already in the carry: acc = 0
          lane(x, k) = lane8(uv[q], k);
          objective_step(0, lane(eh, k), lane(el, k), lane(gj[q], k), lane(ch[q], k), lane(x, k),
                         a.r, negg, a.g_shift);
        }
        *reinterpret_cast<uint32_t*>(u + tiled(row, c, pl.nkj)) = bytes4(x);
        st4(a.out_lanes + e, v16, last ? x : ch[q]);
      }
    }
    __syncthreads();  // every read of accs is done before the next tile's copy
  };
  for_tiles<true>(((B + 63) / 64) * nt, tile, epilogue, ring);
}

__global__ void __launch_bounds__(pint::wide::kThreads, pint::wide::kBlocksPerSm)
alm_mma_wide_kernel(const MmaWideArgs a) {
  extern __shared__ __align__(1024) unsigned char wide_smem[];
  const MmaWidePlan pl = mma_wide_plan(a.B, a.Tp, a.Cp);
  pint::wide::Ring ring(wide_smem);
  int* accs = reinterpret_cast<int*>(wide_smem + pint::wide::kSmem);
  const int steps = a.outer * a.inners;
  const int passes = mma_wide_passes(a.outer, a.inners);
  for (int ph = 0; ph < passes; ++ph) {
    if (ph > 0) pint::wide::grid_sync();
    if (ph == 0) {
      mma_wide_stage(a, pl);
    } else if (ph <= 2 * steps) {
      const int s = (ph - 1) / 2;
      if ((ph - 1) % 2 == 0)  // the first pass 1 of an outer > 0 updates lam first
        mma_wide_pass1(a, pl, true, s % a.inners == 0 && s > 0, ring, accs);
      else
        mma_wide_pass2(a, pl, s == steps - 1, ring, accs);
    } else {
      mma_wide_pass1(a, pl, false, true, ring, accs);
    }
  }
}

// -- K5: each problem's rows in registers (Tp, Cp <= 64) ---------------------

// Byte p of the 8-byte landed rows r0, r0 + st, r0 + 2 st, r0 + 3 st of
// `land`, as one word (the first row in the low byte).
__device__ __forceinline__ uint32_t gather4(const unsigned char* land, int r0, int st,
                                            int p) {
  const int sel = (p & 3) | ((p & 3) + 4) << 4;
  const unsigned char* b = land + (p & 4);
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(b + (size_t)r0 * 8);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(b + (size_t)(r0 + st) * 8);
  const uint32_t w2 = *reinterpret_cast<const uint32_t*>(b + (size_t)(r0 + 2 * st) * 8);
  const uint32_t w3 = *reinterpret_cast<const uint32_t*>(b + (size_t)(r0 + 3 * st) * 8);
  return __byte_perm(__byte_perm(w0, w1, sel), __byte_perm(w2, w3, sel), 0x5410);
}

// sum of __dp4a over the words of one row held in registers against a
// broadcast vector of 16-byte chunks (two partial sums: shorter chains;
// the int32 sum is exact)
template <int NW>
__device__ __forceinline__ int dot_regs(const uint32_t (&row)[NW],
                                        const uint4 (&v)[NW / 4]) {
  int a = 0, b = 0;
#pragma unroll
  for (int ch = 0; ch < NW / 4; ++ch) {
    int& s = ch & 1 ? b : a;
    s = __dp4a((int)row[4 * ch], (int)v[ch].x, s);
    s = __dp4a((int)row[4 * ch + 1], (int)v[ch].y, s);
    s = __dp4a((int)row[4 * ch + 2], (int)v[ch].z, s);
    s = __dp4a((int)row[4 * ch + 3], (int)v[ch].w, s);
  }
  return a + b;
}

template <int NC>
__device__ __forceinline__ void load_vec(const int8_t* v, int n, uint4 (&out)[NC]) {
#pragma unroll
  for (int ch = 0; ch < NC; ++ch)
    out[ch] = 16 * ch < n ? *reinterpret_cast<const uint4*>(v + 16 * ch)
                          : make_uint4(0, 0, 0, 0);
}

// Shared-memory layout of alm_reg_kernel: the landing buffer of one group,
// hqt as [k][j][8] and sqc as [c][j][8] with rows of Tp + 1 (so a warp's
// gathers down a column meet at most 2-way bank conflicts), then each
// warp's broadcast vectors u, y_hi, y_lo (each rounded up to 16 bytes).
struct RegLayout {
  int ss;        // sqc landing row stride, in 8-byte units
  size_t land_s; // offset of the sqc landing
  size_t vec;    // offset of the broadcast vectors
  int tp16, cp16;
  size_t bytes;
};

__host__ __device__ inline RegLayout reg_layout(int Tp, int Cp) {
  RegLayout l;
  l.ss = Tp + 1;
  l.land_s = (size_t)Tp * Tp * 8;
  l.vec = l.land_s + (((size_t)Cp * l.ss * 8 + 15) & ~(size_t)15);
  l.tp16 = (Tp + 15) & ~15;
  l.cp16 = (Cp + 15) & ~15;
  l.bytes = l.vec + (size_t)kGroup * (l.tp16 + 2 * l.cp16);
  return l;
}

// NJ = 1 (Tp, Cp <= 32) or 2 (<= 64): lane l holds rows l + 32q, q < NJ.
template <int NJ>
__global__ void __launch_bounds__(kGroup * 32, 1)
alm_reg_kernel(const int* __restrict__ lanes, const int* __restrict__ g,
               const int8_t* __restrict__ hqt, const int8_t* __restrict__ sqc,
               const int* __restrict__ coff, const int* __restrict__ lo,
               const int* __restrict__ hi, const int* __restrict__ lam0,
               const int* __restrict__ sc, int* __restrict__ out_lanes,
               int* __restrict__ out_lam, int B, int Tp, int Cp, int outer,
               int inners, int g_shift, int y_shift, int async) {
  constexpr int NW = 8 * NJ;  // words a row, at most
  constexpr int NC = 2 * NJ;  // 16-byte chunks a vector, at most
  extern __shared__ __align__(16) unsigned char smem[];
  const RegLayout lay = reg_layout(Tp, Cp);
  unsigned char* land_h = smem;
  unsigned char* land_s = smem + lay.land_s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int8_t* s_lane = reinterpret_cast<int8_t*>(smem + lay.vec) +
                   warp * (lay.tp16 + 2 * lay.cp16);
  int8_t* s_yhi = s_lane + lay.tp16;
  int8_t* s_ylo = s_yhi + lay.cp16;
  const int tw = Tp >> 2, cw = Cp >> 2;
  const int half = 1 << (g_shift - 1);
  const int y_half = (1 << y_shift) >> 1;
  const int negg = -(1 << g_shift), negys = -(1 << y_shift);
  const int ngroups = (B + kGroup - 1) / kGroup;

  // the vectors' pad bytes stay zero: nothing below writes them
  for (size_t i = lay.vec + threadIdx.x * 16; i < lay.bytes; i += blockDim.x * 16)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);

  auto issue = [&](int t) {  // group t of this block -> the landing buffer
    const int grp = blockIdx.x + t * gridDim.x;
    if (grp < ngroups) {
      const size_t b0 = (size_t)grp * kGroup;
      for (int kj = threadIdx.x; kj < Tp * Tp; kj += blockDim.x)
        pint::cp_async8(land_h + (size_t)kj * 8, hqt + (size_t)kj * B + b0);
      for (int cj = threadIdx.x; cj < Cp * Tp; cj += blockDim.x) {
        const int c = cj / Tp;
        pint::cp_async8(land_s + ((size_t)c * lay.ss + cj - c * Tp) * 8,
                        sqc + (size_t)cj * B + b0);
      }
    }
    pint::cp_async_commit();
  };
  if (async) issue(0);

  for (int t = 0;; ++t) {
    const int grp = blockIdx.x + t * gridDim.x;
    if (grp >= ngroups) break;
    const int b0 = grp * kGroup;
    const int nb = min(kGroup, B - b0);
    if (async) {
      pint::cp_async_wait<0>();
    } else {
      // the same layout from byte loads, zero past the batch
      for (int i = threadIdx.x; i < Tp * Tp * kGroup; i += blockDim.x) {
        const int p = i % kGroup, kj = i / kGroup;
        land_h[i] = p < nb ? (unsigned char)hqt[(size_t)kj * B + b0 + p] : 0;
      }
      for (int i = threadIdx.x; i < Cp * Tp * kGroup; i += blockDim.x) {
        const int p = i % kGroup, cj = i / kGroup, c = cj / Tp;
        land_s[((size_t)c * lay.ss + cj - c * Tp) * 8 + p] =
            p < nb ? (unsigned char)sqc[(size_t)cj * B + b0 + p] : 0;
      }
    }
    __syncthreads();

    // this warp's problem: Hq rows j, Sq rows by c and by j, into registers
    uint32_t hr[NJ][NW], sr[NJ][NW], jr[NJ][NW];
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int rw = lane + 32 * q;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        hr[q][w] = rw < Tp && w < tw ? gather4(land_h, 4 * w * Tp + rw, Tp, warp) : 0;
        sr[q][w] = rw < Cp && w < tw ? gather4(land_s, rw * lay.ss + 4 * w, 1, warp) : 0;
        jr[q][w] = rw < Tp && w < cw ? gather4(land_s, 4 * w * lay.ss + rw, lay.ss, warp)
                                     : 0;
      }
    }
    __syncthreads();  // the landing buffer is free
    if (async) issue(t + 1);

    if (warp < nb) {
      const int b = b0 + warp;
      const Rationals r{sc[b],         sc[B + b],     sc[2 * B + b],
                        sc[3 * B + b], sc[4 * B + b], sc[5 * B + b],
                        sc[6 * B + b], sc[7 * B + b]};
      const size_t bt = (size_t)b * Tp, bc = (size_t)b * Cp;
      int x[NJ], gj[NJ], ch[NJ], co[NJ], clo[NJ], chi[NJ], lam[NJ], eyh[NJ];
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
        x[q] = j < Tp ? lanes[bt + j] : 0;
        gj[q] = j < Tp ? g[bt + j] : 0;
        co[q] = j < Cp ? coff[bc + j] : 0;
        clo[q] = j < Cp ? lo[bc + j] : 0;
        chi[q] = j < Cp ? hi[bc + j] : 0;
        lam[q] = j < Cp ? lam0[bc + j] : 0;
        ch[q] = half;    // carry + half
        eyh[q] = y_half; // ey + y_half
      }
      for (int o = 0; o < outer; ++o) {
        for (int it = 0; it < inners; ++it) {
          __syncwarp();
#pragma unroll
          for (int q = 0; q < NJ; ++q)
            if (lane + 32 * q < Tp) s_lane[lane + 32 * q] = (int8_t)x[q];
          __syncwarp();
          uint4 lv[NC];
          load_vec<NC>(s_lane, Tp, lv);
#pragma unroll
          for (int q = 0; q < NJ; ++q) {
            const int c = lane + 32 * q;
            if (c < Cp) {
              const int y14 = constraint_step(dot_regs<NW>(sr[q], lv), co[q], lam[q],
                                              clo[q], chi[q], eyh[q], r, negys, y_shift);
              s_yhi[c] = (int8_t)(y14 >> 7);
              s_ylo[c] = (int8_t)(y14 & 0x7F);
            }
          }
          __syncwarp();
          uint4 yh[NC], yl[NC];
          load_vec<NC>(s_yhi, Cp, yh);
          load_vec<NC>(s_ylo, Cp, yl);
#pragma unroll
          for (int q = 0; q < NJ; ++q)
            if (lane + 32 * q < Tp)
              objective_step(dot_regs<NW>(hr[q], lv), dot_regs<NW>(jr[q], yh),
                             dot_regs<NW>(jr[q], yl), gj[q], ch[q], x[q], r,
                             negg, g_shift);
        }
        __syncwarp();
#pragma unroll
        for (int q = 0; q < NJ; ++q)
          if (lane + 32 * q < Tp) s_lane[lane + 32 * q] = (int8_t)x[q];
        __syncwarp();
        uint4 lv[NC];
        load_vec<NC>(s_lane, Tp, lv);
#pragma unroll
        for (int q = 0; q < NJ; ++q)
          if (lane + 32 * q < Cp)
            lam[q] = lam_update(dot_regs<NW>(sr[q], lv), co[q], lam[q], clo[q],
                                chi[q], r);
      }
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
        if (j < Tp) out_lanes[bt + j] = x[q];
        if (j < Cp) out_lam[bc + j] = lam[q];
      }
    }
  }
  pint::cp_async_wait<0>();
}

// -- K5 and K4 past 64: one problem a cluster of blocks ----------------------

// n rounded up to an odd number of 16 bytes (n > 0): a row stride whose
// 16-byte loads by consecutive threads meet no bank conflict
__host__ __device__ inline int odd16(int n) {
  const int n16 = (n + 15) & ~15;
  return (n16 / 16) % 2 ? n16 : n16 + 16;
}

// Shared memory of one block of alm_wide_kernel, a cluster of nc blocks:
// rj rows of Hq and of Sq by j, rc rows of Sq by c, the two u buffers and
// y_hi, y_lo (each rounded up to 16 bytes).
struct WideLayout {
  int rj, rc, hs, js, tp16, cp16, threads;
  size_t sc, sj, u, y, bytes;
};

__host__ __device__ inline WideLayout wide_layout(int Tp, int Cp, int nc) {
  WideLayout l;
  l.rj = (Tp + nc - 1) / nc;
  l.rc = (Cp + nc - 1) / nc;
  l.hs = odd16(Tp);
  l.js = Cp ? odd16(Cp) : 0;
  l.tp16 = (Tp + 15) & ~15;
  l.cp16 = (Cp + 15) & ~15;
  l.threads = ((l.rj > l.rc ? l.rj : l.rc) + 31) & ~31;
  l.sc = (size_t)l.rj * l.hs;
  l.sj = l.sc + (size_t)l.rc * l.hs;
  l.u = l.sj + (size_t)l.rj * l.js;
  l.y = l.u + 2 * (size_t)l.tp16;
  l.bytes = l.y + 2 * (size_t)l.cp16;
  return l;
}

constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kWideThreads = 512;  // a row a thread, 128 registers a thread

// The fewest blocks a cluster (1, 2, 4 or 8) whose rows fit; 0 if none.
int wide_cluster(int Tp, int Cp) {
  for (int nc = 1; nc <= kMaxCluster; nc *= 2) {
    const WideLayout l = wide_layout(Tp, Cp, nc);
    if (l.bytes <= kPintMaxSmem && l.threads <= kWideThreads) return nc;
  }
  return 0;
}

__device__ __forceinline__ void dp4a16(const uint4 r, const uint4 x, int& s) {
  s = __dp4a((int)r.x, (int)x.x, s);
  s = __dp4a((int)r.y, (int)x.y, s);
  s = __dp4a((int)r.z, (int)x.z, s);
  s = __dp4a((int)r.w, (int)x.w, s);
}

__device__ __forceinline__ uint4 ld16(const int8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// int8 dot of a row and a broadcast vector, `chunks` 16-byte chunks each
// (two partial sums: shorter chains; the int32 sum is exact, so its order
// cannot change a bit).  Pairs of chunks go unguarded, so the loads of U
// pairs are in flight at once.
template <int U>
__device__ __forceinline__ int dot16(const int8_t* row, const int8_t* v, int chunks) {
  int a = 0, b = 0, ch = 0;
#pragma unroll(U)
  for (; ch + 1 < chunks; ch += 2) {
    const uint4 r = ld16(row + 16 * ch), r2 = ld16(row + 16 * ch + 16);
    dp4a16(r, ld16(v + 16 * ch), a);
    dp4a16(r2, ld16(v + 16 * ch + 16), b);
  }
  if (ch < chunks) dp4a16(ld16(row + 16 * ch), ld16(v + 16 * ch), a);
  return a + b;
}

// The dots of one row with two broadcast vectors (y_hi and y_lo), reading
// the row once, U chunks in flight.
template <int U>
__device__ __forceinline__ void dot16x2(const int8_t* row, const int8_t* v1,
                                        const int8_t* v2, int chunks, int& s1, int& s2) {
  int a = 0, b = 0;
#pragma unroll(U)
  for (int ch = 0; ch < chunks; ++ch) {
    const uint4 r = ld16(row + 16 * ch);
    dp4a16(r, ld16(v1 + 16 * ch), a);
    dp4a16(r, ld16(v2 + 16 * ch), b);
  }
  s1 = a, s2 = b;
}

// Stage n bytes out of a batch-last slab: byte i from src[from(i)] (no byte
// where from(i) < 0) to dst[to(i)], the block's threads each keeping
// kStageLoads loads in flight (each gather is one sector a byte).
constexpr int kStageLoads = 8;

template <typename From, typename To>
__device__ __forceinline__ void stage_bytes(int8_t* dst, const int8_t* __restrict__ src,
                                            int n, From from, To to) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kStageLoads * blockDim.x) {
    long long at[kStageLoads];
    int8_t v[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = i0 + u * blockDim.x;
      at[u] = i < n ? from(i) : -1;
      v[u] = at[u] >= 0 ? src[at[u]] : 0;
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u)
      if (at[u] >= 0) dst[to(i0 + u * blockDim.x)] = v[u];
  }
}

// Copy `rows` contiguous rows of `len` bytes (a problem-major slab's run)
// into shared-memory rows of stride `stride`: 16-byte or 4-byte cp.async
// from every thread (cw 16 or 4: len and src aligned to cw), else bytes.
__device__ __forceinline__ void copy_rows(int8_t* dst, const int8_t* src, int rows,
                                          int len, int stride, int cw) {
  if (cw == 1) {
    for (int i = threadIdx.x; i < rows * len; i += blockDim.x) {
      const int r = i / len;
      dst[r * stride + i - r * len] = src[i];
    }
    return;
  }
  const int per = len / cw;
  for (int i = threadIdx.x; i < rows * per; i += blockDim.x) {
    const int r = i / per, o = (i - r * per) * cw;
    if (cw == 16)
      pint::cp_async16(dst + r * stride + o, src + (size_t)r * len + o, true);
    else
      pint::cp_async4(dst + r * stride + o, src + (size_t)r * len + o, true);
  }
}

// The operands of alm_wide_kernel.  K5: sc the (8, B) rationals, Cp > 0.
// K4: Cp = 0, sqc = sqj = sc = nullptr, rationals hs_num, hs_den (B,), one
// outer block of `inners` = iters steps.  orders: bits 0, 1, 2 set when hqt,
// sqc, sqj are problem-major (hqt[b Tp^2 + j Tp + k], sqc[b Cp Tp + c Tp +
// j], sqj[b Tp Cp + j Cp + c]), else batch-last; cw their copy widths (16,
// 4 or 1 bytes), a byte each (hqt in the lowest); prefetch: bits of the
// problem-major slabs that L2 may prefetch whole (16-byte aligned).
template <typename L>
struct WideArgs {
  const L* lanes;
  const int* g;
  const int8_t *hqt, *sqc, *sqj;
  const int *coff, *lo, *hi, *lam0, *sc, *hs_num, *hs_den;
  L* out_lanes;
  int* out_lam;
  int B, Tp, Cp, outer, inners, g_shift, y_shift;
  int orders, prefetch, cw;
};

// L: int (lanes) or int8_t (K4's packed words, read and written as bytes).
// U: pairs of 16-byte chunks a dot keeps in flight: 4 for K5, which reads
// three row stacks an iteration with one block an SM at 256 x 128; 2 for
// K4, whose fewer registers leave room for more blocks an SM (on one H100
// 80GB HBM3 K4 took 0.51 ms at Tp 256 with 4, 0.48 with 2; PERF.md).  Up to
// 128 registers a thread: at 64 both spill.
template <typename L, int U>
__global__ void __launch_bounds__(kWideThreads, 1) alm_wide_kernel(const WideArgs<L> a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nc = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int Tp = a.Tp, Cp = a.Cp, B = a.B;
  const WideLayout lay = wide_layout(Tp, Cp, nc);
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* const sm = reinterpret_cast<int8_t*>(smem);
  int8_t* H = sm;               // [rj][hs]: Hq rows j
  int8_t* Sc = sm + lay.sc;     // [rc][hs]: Sq rows c
  int8_t* Sj = sm + lay.sj;     // [rj][js]: Sq rows j
  int8_t* ubuf = sm + lay.u;    // 2 x [tp16]
  int8_t* yh = sm + lay.y;      // [cp16]
  int8_t* yl = yh + lay.cp16;   // [cp16]
  const int tid = threadIdx.x;
  const int j = rank * lay.rj + tid, c = rank * lay.rc + tid;
  const bool jv = tid < lay.rj && j < Tp, cv = tid < lay.rc && c < Cp;
  const int tch = lay.tp16 / 16, cch = lay.cp16 / 16;
  const int half = 1 << (a.g_shift - 1);
  const int y_half = (1 << a.y_shift) >> 1;
  const int negg = -(1 << a.g_shift), negys = -(1 << a.y_shift);
  // this block's rows of each slab
  const int nj = max(0, min(lay.rj, Tp - rank * lay.rj));
  const int nrc = max(0, min(lay.rc, Cp - rank * lay.rc));
  const size_t hh = (size_t)Tp * Tp, ss = (size_t)Cp * Tp;

  // pad bytes stay zero: the staging writes only real rows and columns
  for (size_t i = (size_t)tid * 16; i < lay.bytes; i += (size_t)blockDim.x * 16)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);
  cluster.sync();  // every block has started and zeroed before remote writes

  // a barrier over the cluster, and a byte of a broadcast vector written
  // into every block of it (a block barrier and a local store for one block)
  auto sync = [&] {
    if (nc == 1)
      __syncthreads();
    else
      cluster.sync();
  };
  auto put = [&](int8_t* buf, int i, int8_t v) {
    if (nc == 1)
      buf[i] = v;
    else
      for (int q = 0; q < nc; ++q) cluster.map_shared_rank(buf, q)[i] = v;
  };

  const int nclusters = gridDim.x / nc;
  for (int b = blockIdx.x / nc; b < B; b += nclusters) {
    __syncthreads();  // the last problem's readers are done
    // the problem-major slabs: this block's rows, one contiguous run each,
    // by cp.async; L2 fetches the cluster's next problem meanwhile
    if (a.orders & 1)
      copy_rows(H, a.hqt + b * hh + (size_t)rank * lay.rj * Tp, nj, Tp, lay.hs,
                a.cw & 0xff);
    if (a.orders & 2)
      copy_rows(Sc, a.sqc + b * ss + (size_t)rank * lay.rc * Tp, nrc, Tp, lay.hs,
                a.cw >> 8 & 0xff);
    if (a.orders & 4)
      copy_rows(Sj, a.sqj + b * ss + (size_t)rank * lay.rj * Cp, nj, Cp, lay.js,
                a.cw >> 16);
    pint::cp_async_commit();
    const int bn = b + nclusters;
    if (bn < B && rank == 0 && tid == 0) {
      if (a.prefetch & 1) pint::prefetch_l2(a.hqt + bn * hh, (uint32_t)hh);
      if (a.prefetch & 2) pint::prefetch_l2(a.sqc + bn * ss, (uint32_t)ss);
      if (a.prefetch & 4) pint::prefetch_l2(a.sqj + bn * ss, (uint32_t)ss);
    }
    // the batch-last slabs, gathered a byte at a time
    if (!(a.orders & 1))
      stage_bytes(
          H, a.hqt, lay.rj * Tp,
          [&](int i) -> long long {
            const int jl = i / Tp, k = i - jl * Tp, jj = rank * lay.rj + jl;
            return jj < Tp ? ((long long)k * Tp + jj) * B + b : -1;
          },
          [&](int i) { return (i / Tp) * lay.hs + i % Tp; });
    if (Cp && !(a.orders & 2))
      stage_bytes(
          Sc, a.sqc, lay.rc * Tp,
          [&](int i) -> long long {
            const int cc = rank * lay.rc + i / Tp;
            return cc < Cp ? ((long long)cc * Tp + i % Tp) * B + b : -1;
          },
          [&](int i) { return (i / Tp) * lay.hs + i % Tp; });
    if (Cp && !(a.orders & 4))
      stage_bytes(
          Sj, a.sqj, lay.rj * Cp,
          [&](int i) -> long long {
            const int jj = rank * lay.rj + i / Cp;
            return jj < Tp ? ((long long)jj * Cp + i % Cp) * B + b : -1;
          },
          [&](int i) { return (i / Cp) * lay.js + i % Cp; });
    const size_t bt = (size_t)b * Tp, bc = (size_t)b * Cp;
    for (int i = tid; i < Tp; i += blockDim.x) ubuf[i] = (int8_t)a.lanes[bt + i];
    const Rationals r =
        a.sc ? Rationals{a.sc[b],         a.sc[B + b],     a.sc[2 * B + b],
                         a.sc[3 * B + b], a.sc[4 * B + b], a.sc[5 * B + b],
                         a.sc[6 * B + b], a.sc[7 * B + b]}
             : Rationals{a.hs_num[b], a.hs_den[b], 0, 0, 0, 0, 0, 0};
    int x = jv ? (int)a.lanes[bt + j] : 0, gj = jv ? a.g[bt + j] : 0, ch = half;
    int co = 0, clo = 0, chi = 0, lam = 0, eyh = y_half;
    if (cv) co = a.coff[bc + c], clo = a.lo[bc + c], chi = a.hi[bc + c], lam = a.lam0[bc + c];
    pint::cp_async_wait<0>();
    __syncthreads();

    int p = 0;  // the u buffer this iteration reads
    for (int o = 0; o < a.outer; ++o) {
      for (int it = 0; it < a.inners; ++it) {
        const int8_t* u = ubuf + p * lay.tp16;
        const int acc = jv ? dot16<U>(H + tid * lay.hs, u, tch) : 0;
        int eh = 0, el = 0;
        if (Cp) {
          if (cv) {
            const int y14 = constraint_step(dot16<U>(Sc + tid * lay.hs, u, tch), co, lam, clo,
                                            chi, eyh, r, negys, a.y_shift);
            put(yh, c, (int8_t)(y14 >> 7));
            put(yl, c, (int8_t)(y14 & 0x7F));
          }
          sync();  // y complete in every block
          if (jv) dot16x2<U>(Sj + tid * lay.js, yh, yl, cch, eh, el);
        }
        if (jv) {
          objective_step(acc, eh, el, gj, ch, x, r, negg, a.g_shift);
          put(ubuf, (p ^ 1) * lay.tp16 + j, (int8_t)x);
        }
        p ^= 1;
        sync();  // the new u complete in every block; y read
      }
      // multiplier update from the exact int32 violation at the inner solution
      if (cv)
        lam = lam_update(dot16<U>(Sc + tid * lay.hs, ubuf + p * lay.tp16, tch), co, lam, clo,
                         chi, r);
    }
    if (jv) a.out_lanes[bt + j] = (L)x;
    if (cv) a.out_lam[bc + c] = lam;
  }
  cluster.sync();  // no block leaves while another may still write to it
}

// Copy width of a problem-major slab whose rows are `len` bytes: 16 or 4
// when its rows start so aligned, else 1.
int copy_width(const void* p, int len) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  return len % 16 == 0 && at % 16 == 0 ? 16 : len % 4 == 0 && at % 4 == 0 ? 4 : 1;
}

template <typename L>
cudaError_t launch_wide(WideArgs<L> args, cudaStream_t stream) {
  const int Tp = args.Tp, Cp = args.Cp;
  const int nc = wide_cluster(Tp, Cp);
  if (nc == 0) return cudaErrorInvalidValue;
  const void* slab[3] = {args.hqt, args.sqc, args.sqj};
  const int len[3] = {Tp, Tp, Cp};
  args.prefetch = 0;
  args.cw = 0;
  for (int i = 0; i < 3; ++i) {
    args.cw |= copy_width(slab[i], len[i]) << (8 * i);
    if ((args.orders >> i & 1) && reinterpret_cast<uintptr_t>(slab[i]) % 16 == 0)
      args.prefetch |= 1 << i;
  }
  const WideLayout lay = wide_layout(Tp, Cp, nc);
  auto kernel = Cp ? alm_wide_kernel<L, 4> : alm_wide_kernel<L, 2>;
  cudaError_t err = pint_allow_smem(kernel, lay.bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(lay.threads);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // as many clusters as may be resident at once (several blocks an SM where
  // their rows fit, so that one block's copies overlap another's
  // iterations), and no more than problems
  cfg.gridDim = dim3(nc * sms);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;
  const int clusters = args.B < active ? args.B : active;
  cfg.gridDim = dim3(nc * clusters);
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// -- launches -----------------------------------------------------------------

template <int NJ>
cudaError_t launch_alm_reg(const int* lanes, const int* g, const int8_t* hqt,
                           const int8_t* sqc, const int* coff, const int* lo,
                           const int* hi, const int* lam, const int* sc,
                           int* out_lanes, int* out_lam, int B, int Tp, int Cp,
                           int outer, int inners, int g_shift, int y_shift,
                           cudaStream_t stream) {
  const RegLayout lay = reg_layout(Tp, Cp);
  const bool async = B % kGroup == 0 && reinterpret_cast<uintptr_t>(hqt) % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(sqc) % 8 == 0;
  auto kernel = alm_reg_kernel<NJ>;
  cudaError_t err = pint_allow_smem(kernel, lay.bytes);
  int grid = 0;
  if (err == cudaSuccess)
    err = pint_persistent_grid(kernel, kGroup * 32, lay.bytes,
                               (B + kGroup - 1) / kGroup, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kGroup * 32, lay.bytes, stream>>>(
      lanes, g, hqt, sqc, coff, lo, hi, lam, sc, out_lanes, out_lam, B, Tp, Cp,
      outer, inners, g_shift, y_shift, (int)async);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_mma(const int* lanes, const int* g, const int* coff,
                       const int* lam, const int8_t* hq, const int8_t* sq,
                       const int* lo, const int* hi, int* out_lanes, int* out_lam,
                       int B, int Tp, int Cp, int outer, int inners, int g_shift,
                       int y_shift, Rationals r, cudaStream_t stream) {
  using S = MmaShape<W>;
  auto kernel = alm_mma_kernel<W>;
  constexpr int threads = S::NW * 32;
  cudaError_t err = pint_allow_smem(kernel, S::bytes);
  int grid = 0;
  if (err == cudaSuccess)
    err = pint_persistent_grid(kernel, threads, S::bytes, (B + 15) / 16, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, S::bytes, stream>>>(lanes, g, coff, lam, hq, sq, lo, hi,
                                              out_lanes, out_lam, B, Tp, Cp, outer,
                                              inners, g_shift, y_shift, r);
  return cudaGetLastError();
}

cudaError_t launch_mma_wide(MmaWideArgs a, cudaStream_t stream) {
  if (a.scratch == nullptr || reinterpret_cast<uintptr_t>(a.scratch) % 16 ||
      (reinterpret_cast<uintptr_t>(a.out_lanes) | reinterpret_cast<uintptr_t>(a.out_lam)) % 8)
    return cudaErrorInvalidValue;
  return pint::wide::launch(alm_mma_wide_kernel, a, pint::wide::kSmemAcc, stream);
}

bool bad_loop(int B, int outer, int inners, int g_shift, int y_shift) {
  return B <= 0 || outer < 0 || inners < 0 || g_shift < 1 || g_shift > 30 ||
         y_shift < 0 || y_shift > 30;
}

// K5's shapes: multiples of 4 within the reference's alm_viable (its int8
// working set at 128 problems within 100 MiB), each side at most 4096 so
// that a cluster of 8 blocks of 512 threads holds a row a thread.
bool k5_takes(int Tp, int Cp) {
  if (Tp <= 0 || Cp <= 0 || Tp % 4 || Cp % 4 || Tp > 4096 || Cp > 4096) return false;
  const long t = Tp, c = Cp;
  return t * t + 2 * t * c + 8 * (t + c) <= 409600 && wide_cluster(Tp, Cp) > 0;
}

}  // namespace

// K4 past 64 lanes (csrc/pgd_hqt.cu's entries): the cluster kernel with no
// constraint rows.  words: lanes and out are (B, Tp) int8 packed control
// words, else (B, Tp) int32 lanes; hqt_pm: hqt problem-major.
cudaError_t pint_pgd_wide(const void* lanes, const int* g, const int8_t* hqt,
                          const int* hs_num, const int* hs_den, void* out, int B,
                          int Tp, int iters, int g_shift, bool words, bool hqt_pm,
                          cudaStream_t stream) {
  if (words) {
    const WideArgs<int8_t> a{static_cast<const int8_t*>(lanes), g, hqt, nullptr, nullptr,
                             nullptr, nullptr, nullptr, nullptr, nullptr, hs_num, hs_den,
                             static_cast<int8_t*>(out), nullptr, B, Tp, 0, 1, iters,
                             g_shift, 0, (int)hqt_pm};
    return launch_wide(a, stream);
  }
  const WideArgs<int> a{static_cast<const int*>(lanes), g, hqt, nullptr, nullptr, nullptr,
                        nullptr, nullptr, nullptr, nullptr, hs_num, hs_den,
                        static_cast<int*>(out), nullptr, B, Tp, 0, 1, iters, g_shift, 0,
                        (int)hqt_pm};
  return launch_wide(a, stream);
}

extern "C" int pint_alm(const void* lanes, const void* g, const void* hqt,
                        const void* sqj, const void* sqc, const void* coff,
                        const void* lo, const void* hi, const void* lam,
                        const void* sc, void* out_lanes, void* out_lam, int B,
                        int Tp, int Cp, int outer, int inners, int g_shift,
                        int y_shift, int orders, void* stream) {
  const int m = Tp > Cp ? Tp : Cp;
  // orders (bits 0-2: hqt, sqc, sqj problem-major) only past 64, where the
  // cluster kernel takes either order of each slab
  if (bad_loop(B, outer, inners, g_shift, y_shift) || !k5_takes(Tp, Cp) ||
      (orders & ~7) || (orders && m <= 64))
    return (int)cudaErrorInvalidValue;
  const int* l = static_cast<const int*>(lanes);
  const int* gg = static_cast<const int*>(g);
  const int8_t* h = static_cast<const int8_t*>(hqt);
  const int8_t* sj = static_cast<const int8_t*>(sqj);
  const int8_t* scc = static_cast<const int8_t*>(sqc);
  const int* co = static_cast<const int*>(coff);
  const int* lo_ = static_cast<const int*>(lo);
  const int* hi_ = static_cast<const int*>(hi);
  const int* la = static_cast<const int*>(lam);
  const int* rat = static_cast<const int*>(sc);
  int* ol = static_cast<int*>(out_lanes);
  int* om = static_cast<int*>(out_lam);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 32)
    return (int)launch_alm_reg<1>(l, gg, h, scc, co, lo_, hi_, la, rat, ol, om, B,
                                  Tp, Cp, outer, inners, g_shift, y_shift, s);
  if (m <= 64)
    return (int)launch_alm_reg<2>(l, gg, h, scc, co, lo_, hi_, la, rat, ol, om, B,
                                  Tp, Cp, outer, inners, g_shift, y_shift, s);
  const WideArgs<int> a{l,  gg,      h,       scc,     sj, co, lo_, hi_, la, rat,
                        nullptr, nullptr, ol, om, B,  Tp, Cp,  outer, inners,
                        g_shift, y_shift, orders};
  return (int)launch_wide(a, s);
}

// The scratch K7 needs at (B, Tp, Cp): none to W = 256, past it the wide
// form's padded [Hq; Sq] and Sq^T, u, y_hi, y_lo and the error feedback.
extern "C" long long pint_alm_shared_scratch(int B, int Tp, int Cp) {
  if (B <= 0 || Tp <= 0 || Cp <= 0 || (Tp <= 256 && Cp <= 256) || Tp > kMmaMaxW ||
      Cp > kMmaMaxW)
    return 0;
  return (long long)mma_wide_plan(B, Tp, Cp).bytes;
}

// K7's shapes: Tp and Cp multiples of 4 in [4, 4096]; past 256 the wide
// form, with pint_alm_shared_scratch bytes of scratch.
extern "C" int pint_alm_shared(const void* lanes, const void* g,
                               const void* coff, const void* lam,
                               const void* hq, const void* sq, const void* lo,
                               const void* hi, void* out_lanes, void* out_lam,
                               void* scratch, int B, int Tp, int Cp, int outer,
                               int inners, int g_shift, int y_shift, int hs_num,
                               int hs_den, int cs_num, int cs_den, int eh_num,
                               int eh_den, int el_num, int el_den,
                               void* stream) {
  if (bad_loop(B, outer, inners, g_shift, y_shift) || Tp <= 0 || Cp <= 0 || Tp % 4 ||
      Cp % 4 || Tp > kMmaMaxW || Cp > kMmaMaxW)
    return (int)cudaErrorInvalidValue;
  const int dens[4] = {hs_den, cs_den, eh_den, el_den};
  for (int d : dens)
    if (d < 0 || d > 31) return (int)cudaErrorInvalidValue;
  const Rationals r{hs_num, hs_den, cs_num, cs_den,
                    eh_num, eh_den, el_num, el_den};
  const int* l = static_cast<const int*>(lanes);
  const int* gg = static_cast<const int*>(g);
  const int* co = static_cast<const int*>(coff);
  const int* la = static_cast<const int*>(lam);
  const int8_t* h = static_cast<const int8_t*>(hq);
  const int8_t* sqq = static_cast<const int8_t*>(sq);
  const int* lo_ = static_cast<const int*>(lo);
  const int* hi_ = static_cast<const int*>(hi);
  int* ol = static_cast<int*>(out_lanes);
  int* om = static_cast<int*>(out_lam);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = Tp > Cp ? Tp : Cp;
  auto run = [&](auto launch) {
    return (int)launch(l, gg, co, la, h, sqq, lo_, hi_, ol, om, B, Tp, Cp, outer, inners,
                       g_shift, y_shift, r, s);
  };
  if (m <= 32) return run(launch_mma<32>);
  if (m <= 64) return run(launch_mma<64>);
  if (m <= 128) return run(launch_mma<128>);
  if (m <= 256) return run(launch_mma<256>);
  const uintptr_t i32 = reinterpret_cast<uintptr_t>(gg) | reinterpret_cast<uintptr_t>(co) |
                        reinterpret_cast<uintptr_t>(lo_) | reinterpret_cast<uintptr_t>(hi_) |
                        reinterpret_cast<uintptr_t>(ol) | reinterpret_cast<uintptr_t>(om);
  const int vec = (i32 % 16 == 0 ? 1 : 0) |
                  ((reinterpret_cast<uintptr_t>(h) & 3) == 0 ? 2 : 0) |
                  ((reinterpret_cast<uintptr_t>(sqq) & 3) == 0 ? 4 : 0);
  const MmaWideArgs a{l,  gg, co,    la,     h,       sqq,     lo_, hi_, ol, om,
                      static_cast<int8_t*>(scratch), B, Tp, Cp, outer, inners,
                      g_shift, y_shift, vec, r};
  return (int)launch_mma_wide(a, s);
}
