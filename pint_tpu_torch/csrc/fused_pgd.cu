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
// (fused_pgd_wide_kernel) reads its B fragments from L2 each iteration and
// keeps the state in shared memory, to Tp 4096.
//
// Input lanes must lie in [-128, 127] (unpacked int8 control lanes).
#include "common.cuh"
#include "mma_tile.cuh"

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

// -- K2 and K2p past Tp 256 ----------------------------------------------------
//
// Hq (Tp^2 bytes, 256 KB at Tp = 512) no longer fits beside the tile, so its
// B fragments are read from global memory each iteration (pint::frag_word):
// Hq is one matrix for every block and stays resident in the 50 MB L2 (4 MB
// at Tp = 2048).  A block of kWideWarps warps owns a tile of 16 problems;
// each warp walks the column groups w, w + 16, ... of the (16 x Tp) product,
// one group's whole k-loop at a time, and updates that group's lanes at
// once.  Tp pads to KC = ceil(Tp / 32) k-chunks; A columns past Tp meet zero
// B rows, so what they hold is never read into a sum.  The state lives in
// shared memory: two 16 x (32 KC + 16) byte tiles of y (iteration it reads
// tile it & 1 and writes y of the next iteration into the other, so one
// barrier an iteration) and, with momentum, x as int8 (16 x Tp); half - g
// is re-read from g (L2) at each update.  The same int32 exactness holds:
// |acc| <= 128 * 128 * Tp < 2^31 for Tp < 131,072.  Shared memory is
// 32 (32 KC + 16) + 16 Tp bytes: 193 KB at Tp = 4096, the limit this form
// states (Hq 16 MB).
template <bool MOM, typename L>
__global__ void __launch_bounds__(pint::kWideWarps * 32)
fused_pgd_wide_kernel(const L* __restrict__ lanes, const int* __restrict__ g,
                      const int8_t* __restrict__ hq, L* __restrict__ out, int B, int Tp,
                      int iters, int hs_num, int hs_den, int g_shift, int beta_num,
                      int beta_den) {
  constexpr bool PACKED = sizeof(L) == 1;
  constexpr int NW = pint::kWideWarps;
  extern __shared__ __align__(16) unsigned char smem[];
  const int KC = (Tp + 31) / 32, RS = 32 * KC + 16, G = (Tp + 7) / 8;
  int8_t* xs = reinterpret_cast<int8_t*>(smem + 32 * RS);  // MOM: x, 16 x Tp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int half = 1 << (g_shift - 1);
  const bool hq4 = (reinterpret_cast<uintptr_t>(hq) & 3) == 0;
  const int ntiles = (B + 15) / 16;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * 16, rows = min(16, B - row0);
    __syncthreads();  // every read of the last tile's state is done
    // tile 0 holds y of iteration 0: the lanes, or with momentum clip(x)
    if constexpr (PACKED) {
      const int wpr = Tp / 4;  // words a row
      const uint32_t* src = reinterpret_cast<const uint32_t*>(lanes) + (size_t)row0 * wpr;
      for (int u = threadIdx.x; u < 16 * wpr; u += blockDim.x) {
        const int r = u / wpr, q = u - r * wpr;
        *reinterpret_cast<uint32_t*>(smem + r * RS + 4 * q) = r < rows ? src[u] : 0u;
      }
    } else {
      const int* src = reinterpret_cast<const int*>(lanes) + (size_t)row0 * Tp;
      for (int u = threadIdx.x; u < 16 * Tp; u += blockDim.x) {
        const int r = u / Tp, c = u - r * Tp;
        const int v = r < rows ? src[u] : 0;
        smem[r * RS + c] = (unsigned char)(MOM ? clampi(v, -127, 127) : v);
        if constexpr (MOM) xs[u] = (int8_t)v;
      }
    }
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
      const unsigned char* cur = smem + (it & 1) * 16 * RS;
      unsigned char* nxt = smem + ((it + 1) & 1) * 16 * RS;
      for (int grp = warp; grp < G; grp += NW) {
        const int n = 8 * grp + gq, c0 = 8 * grp + 2 * tq;
        int acc[4] = {0, 0, 0, 0};
#pragma unroll 4
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t a[4];
          pint::load_a(cur, RS, gq, tq, kc, a);
          const int k0 = 32 * kc + 4 * tq;
          pint::mma_s8(acc, a, pint::frag_word(hq, Tp, n, k0, Tp, Tp, hq4),
                       pint::frag_word(hq, Tp, n, k0 + 16, Tp, Tp, hq4));
        }
        int yn[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = gq + 8 * (e >> 1), c = c0 + (e & 1);
          yn[e] = 0;
          if (c >= Tp) continue;  // a padded lane: no g, no x
          const int gv = r < rows ? g[(size_t)(row0 + r) * Tp + c] : 0;
          const int pre = wrap_mul(acc[e], hs_num) >> hs_den;
          const int delta = clampi(wrap_sub(wrap_sub(half, gv), pre) >> g_shift, -128, 127);
          const int x = clampi((int)(int8_t)cur[r * RS + c] + delta, -127, 127);
          if constexpr (MOM) {
            const int xo = xs[r * Tp + c];
            xs[r * Tp + c] = (int8_t)x;
            yn[e] = clampi(x + (wrap_mul(beta_num, x - xo) >> beta_den), -127, 127);
          } else {
            yn[e] = x;
          }
        }
        pint::store_pairs(nxt, RS, gq, c0, yn);
      }
      __syncthreads();  // nxt holds y; every read of cur is done
    }
    // the lanes: x (momentum), else the last y, in tile iters & 1
    const unsigned char* fin = smem + (iters & 1) * 16 * RS;
    if constexpr (PACKED) {
      const int wpr = Tp / 4;
      uint32_t* dst = reinterpret_cast<uint32_t*>(out) + (size_t)row0 * wpr;
      for (int u = threadIdx.x; u < rows * wpr; u += blockDim.x) {
        const int r = u / wpr, q = u - r * wpr;
        dst[u] = *reinterpret_cast<const uint32_t*>(fin + r * RS + 4 * q);
      }
    } else {
      int* dst = reinterpret_cast<int*>(out) + (size_t)row0 * Tp;
      for (int u = threadIdx.x; u < rows * Tp; u += blockDim.x) {
        const int r = u / Tp, c = u - r * Tp;
        dst[u] = MOM ? (int)xs[u] : (int)(int8_t)fin[r * RS + c];
      }
    }
  }
}

template <bool MOM, typename L>
cudaError_t launch_wide(const L* lanes, const int* g, const int8_t* hq, L* out, int B,
                        int Tp, int iters, int hs_num, int hs_den, int g_shift,
                        int beta_num, int beta_den, cudaStream_t stream) {
  auto kernel = fused_pgd_wide_kernel<MOM, L>;
  constexpr int threads = pint::kWideWarps * 32;
  const size_t bytes = 32 * (size_t)(32 * ((Tp + 31) / 32) + 16) + (MOM ? 16 * (size_t)Tp : 0);
  cudaError_t err = pint_allow_smem(kernel, bytes);
  int grid = 0;
  if (err == cudaSuccess)
    err = pint_persistent_grid(kernel, threads, bytes, (B + 15) / 16, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(lanes, g, hq, out, B, Tp, iters, hs_num, hs_den,
                                           g_shift, beta_num, beta_den);
  return cudaGetLastError();
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

// The widest Tp the wide form takes (Hq 16 MB, shared memory 193 KB).
constexpr int kMaxTp = 4096;

template <bool MOM, typename L>
int dispatch(const void* lanes, const void* g, const void* hq, void* out, int B, int Tp,
             int iters, int hs_num, int hs_den, int g_shift, int beta_num, int beta_den,
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
    err = launch_wide<MOM, L>(l, gg, h, o, B, Tp, iters, hs_num, hs_den, g_shift, beta_num,
                              beta_den, s);
  return (int)err;
}

}  // namespace

extern "C" int pint_fused_pgd(const void* lanes, const void* g, const void* hq,
                              void* out, int B, int Tp, int iters, int hs_num,
                              int hs_den, int g_shift, int momentum,
                              int beta_num, int beta_den, void* stream) {
  return momentum ? dispatch<true, int>(lanes, g, hq, out, B, Tp, iters, hs_num, hs_den,
                                        g_shift, beta_num, beta_den, stream)
                  : dispatch<false, int>(lanes, g, hq, out, B, Tp, iters, hs_num, hs_den,
                                         g_shift, beta_num, beta_den, stream);
}

// words, out: (B, Tp/4) packed control words, the (B, Tp) int8 lanes in memory
extern "C" int pint_fused_pgd_packed(const void* words, const void* g,
                                     const void* hq, void* out, int B, int Tp,
                                     int iters, int hs_num, int hs_den,
                                     int g_shift, void* stream) {
  return dispatch<false, int8_t>(words, g, hq, out, B, Tp, iters, hs_num, hs_den,
                                 g_shift, 0, 0, stream);
}

extern "C" const char* pint_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
