// An SQP iteration's reduce for reduce="sym" (Q = L L^T), in one launch: the
// condensed Hessian and linear term of each problem b from the propagator
// stacks the recursion writes (contiguous, batch-first), Abar (B, T, n, n),
// Bbar (B, T, n, Tm) and Cbar (B, T, n), Tm = T m:
//   Ht = sum_t W_t^T W_t + BQT^T B_{T-1} + R_kron,  W_t = L^T Bbar_t,
//        BQT = dQ^T B_{T-1}, dQ = Qf - Q;
//   g  = G x0 + g_ref,  G = sum_t W_t^T L^T Abar_t + BQT^T Abar_{T-1},
//        g_ref = sum_t W_t^T L^T Cx_t + BQT^T Cx_{T-1},  Cx_t = Cbar_t - x_ref_t.
// Ht goes out in the order the quantization reads it: to 64 lanes batch-last
// (Tm, Tm, B), past them problem-major (B, Tm, Tm), as DeviceSQP._hand_over
// gave it.  W is never stored in device memory.  Its plain version is
// mpc/reduce.py's reduce_plain.
//
// Replaces no Pallas kernel: the reference's reduce is XLA jnp
// (pint_tpu/mpc/device_sqp.py, _reduce_sym).  The torch form that ported it
// (DeviceSQP._reduce_sym) runs dense f32 GEMMs over both triangles and over
// the zero columns, and copies W four times in permutes.
//
// Rounding, bit for bit with reduce_plain on the card.  Every product and sum
// is __fmul_rn / __fadd_rn / __fsub_rn, which nvcc's default --fmad=true does
// not contract.  A dot over i, l or q rounds each product and adds them from
// the first, in index order.  Each accumulator starts at +0.0 and adds step
// t's dot, t ascending, over the live steps alone: column j of Bbar_t is zero
// for t < j / m (control j moves no earlier state), so Ht[j1, j2] sums t >=
// max(j1, j2) / m and g[j] sums t >= j / m; masked entries are left as they
// are, not multiplied by zero, so a NaN in a dead column reaches nothing.  Then
// Ht[j1, j2] = (acc + BQT[:, a] . B_{T-1}[:, b]) + R_kron[a, b], a, b =
// min, max(j1, j2): each entry of the upper triangle is summed by one thread
// and written with its mirror, so Ht is exactly symmetric.  No atomics: the
// result is the same from run to run.
//
// What bounds it on the H100 (utils/profiling.kernel_cost("reduce")), priced
// at one f32 instruction a rounding (33.5 T/s) and 3.35 TB/s for the live
// columns of Bbar, Abar and Cbar read and Ht and g written: at T 32 (Tm 64),
// B 4096 and 16384, its bytes (0.038 and 0.151 ms); at T 128 (Tm 256), B
// 4096, its instructions, the upper triangle's n m^2 T^3 / 6 products a
// problem and their sums (1.15 ms).  On one H100 80GB HBM3 it takes 0.19 /
// 0.64 / 4.0 ms there (PERF.md); builds with the staging or the sums switched
// off show the two adding up nearly in series.
//
// Design.  A block takes G problems and one S x S tile (I, J), I <= J, of the
// upper triangle of Ht, G S^2 / 32 = 256 threads, a thread a 4 x 8 sub-tile
// of one problem summed in registers: to 64 lanes (batch-last) G = 8 and S =
// 32, so the 8 lanes of a sub-tile entry write one full 32-byte sector; past
// them (problem-major) G = 2 and S = 64, so each column of Bbar is read into
// fewer tiles, and each thread writes its sub-tile's rows and their mirror as
// 16-byte stores.  The tiles of a group of problems are consecutive blocks,
// so their reads of Bbar meet in L2.  Chunks of steps (as many as fit twice
// in 108 KB of shared memory, two blocks an SM) alternate between two
// buffers: the live columns of Bbar of the tile's rows (and, off the
// diagonal, its columns) for the next chunk land by cp.async, 16 bytes of a
// row a copy, while the block sums the current one; then the thread that
// copied a granule of 4 columns turns it into W_t = L^T Bbar_t in place, and
// one barrier a chunk hands the buffer over.  W lies in those granules, the
// G problems' side by side and permuted by granule, so that a quarter warp's
// 16-byte accesses meet distinct banks.  Sub-tiles wholly
// below the diagonal of a diagonal tile sit idle; those across it sum every
// entry and write those on or above it.  On the diagonal tiles Abar_t, Cbar_t
// and x_ref_t land the same way, and a thread a (problem, column) sums G and
// g_ref.  B_{T-1} and the tile of R_kron are kept in shared memory for the
// terminal term.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 256;              // a thread a (problem, sub-tile)
constexpr int kR = 4;                      // rows of a thread's sub-tile
constexpr int kC = 8;                      // its columns
constexpr int kSmemBudget = 108 * 1024;    // bytes of shared memory a block, two an SM
constexpr int kMaxChunk = 16;              // steps a chunk

// a block's shape: G problems and an S x S tile, G S^2 / (kR kC) = kThreads
template <int G>
struct Shape {
  static constexpr int S = G == 8 ? 32 : 64;
  static constexpr int RowBlocks = S / kR;    // sub-tiles down a tile
  static constexpr int Gran = S * G;          // floats of a staged row l of a step
  static_assert(G * (S / kR) * (S / kC) == kThreads, "a thread a sub-tile");
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct Args {
  const float* abar;
  const float* bbar;
  const float* cbar;
  const float* x0;
  const float* L;     // (n, n), L[i][l]
  const float* dq;    // (n, n), Qf - Q
  const float* rk;    // (Tm, Tm), R_kron
  const float* xref;  // (T, n)
  float* ht;
  float* g;           // (B, Tm)
  int B, T, m, Tm, tiles, pm;
};

// shared memory: L and dQ, B_{T-1} of the tile's rows and columns, the
// tile of R_kron (rows padded to S + 4 floats, so that the rows a quarter
// warp reads spread over the banks), then two
// buffers of a chunk, each a step the staged W of the tile's rows and
// columns and (diagonal tiles) L^T Abar_t, L^T Cx_t and x_ref_t of the G
// problems
template <int N, int G>
__host__ __device__ constexpr int head_floats() {
  return (2 * N * N + 3) / 4 * 4 + 2 * N * Shape<G>::Gran + Shape<G>::S * (Shape<G>::S + 4);
}
template <int N, int G>
__host__ __device__ constexpr int step_floats() {  // a multiple of 4: buffers 16-byte aligned
  return (2 * N * Shape<G>::Gran + G * N * N + 2 * G * N + 3) / 4 * 4;
}
// steps a chunk: as many as fit kSmemBudget twice over, at most kMaxChunk
template <int N, int G>
__host__ __device__ constexpr int chunk_steps() {
  return (kSmemBudget / 4 - head_floats<N, G>()) / (2 * step_floats<N, G>()) < kMaxChunk
             ? (kSmemBudget / 4 - head_floats<N, G>()) / (2 * step_floats<N, G>())
             : kMaxChunk;
}

// the float offset of column col (of the tile's S) of problem p in a staged
// row: granules of 4 columns, the G problems' side by side, the problems of
// granule cg permuted by (cg G / 8) mod G, so that a warp's stores (32
// columns of one problem) and a quarter warp's 16-byte loads (a sub-tile's
// granule for 8 problem-slot pairs) each meet distinct banks
template <int G>
__device__ __forceinline__ int gran(int col, int p) {
  const int cg = col / 4;
  return (cg * G + (p ^ ((cg * G / 8) % G))) * 4 + col % 4;
}

// 16 bytes, of which the first `bytes` are read and the rest zero-filled
// (both addresses 16-byte aligned)
__device__ __forceinline__ void cp_async16_prefix(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(pint::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// a thread's operands of a staged step (or of B_{T-1}): rows ra * 4 .. + 3
// of `rows`, columns cb * 8 .. + 7 of `cols`, problem p: three 16-byte loads
// a row l of the n
template <int N, int G>
__device__ __forceinline__ void load_sub(const float* rows, const float* cols, int ra, int cb,
                                         int p, float (&wr)[N][kR], float (&wc)[N][kC]) {
  constexpr int Gran = Shape<G>::Gran;
#pragma unroll
  for (int l = 0; l < N; ++l) {
    const float4 v = *reinterpret_cast<const float4*>(rows + l * Gran + gran<G>(ra * kR, p));
    const float4 u0 = *reinterpret_cast<const float4*>(cols + l * Gran + gran<G>(cb * kC, p));
    const float4 u1 =
        *reinterpret_cast<const float4*>(cols + l * Gran + gran<G>(cb * kC + 4, p));
    wr[l][0] = v.x, wr[l][1] = v.y, wr[l][2] = v.z, wr[l][3] = v.w;
    wc[l][0] = u0.x, wc[l][1] = u0.y, wc[l][2] = u0.z, wc[l][3] = u0.w;
    wc[l][4] = u1.x, wc[l][5] = u1.y, wc[l][6] = u1.z, wc[l][7] = u1.w;
  }
}

// acc += W[:, rows] . W[:, cols] for a step; Masked: only the entries live
// at the step, those whose larger index is below e = (t + 1) m
template <int N, bool Masked>
__device__ __forceinline__ void step_update(float (&acc)[kR][kC], const float (&wr)[N][kR],
                                            const float (&wc)[N][kC], int e, int r0,
                                            int c0) {
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float d = mul(wr[0][r], wc[0][c]);
#pragma unroll
      for (int l = 1; l < N; ++l) d = add(d, mul(wr[l][r], wc[l][c]));
      if (!Masked || max(r0 + r, c0 + c) < e) acc[r][c] = add(acc[r][c], d);
    }
}

template <int N, int G>
__global__ void __launch_bounds__(kThreads, 2) reduce_kernel(const Args a) {
  using Sh = Shape<G>;
  constexpr int S = Sh::S, Gran = Sh::Gran, CH = chunk_steps<N, G>();
  constexpr int GR = S / 4;  // granules of 4 columns a staged row
  static_assert(CH >= 1, "a step of W does not fit the shared memory");
  extern __shared__ float4 smem4[];
  float* const sL = reinterpret_cast<float*>(smem4);
  float* const sdq = sL + N * N;
  float* const Br = sL + (2 * N * N + 3) / 4 * 4;  // B_{T-1}, staged as W is
  float* const sR = Br + 2 * N * Gran;             // R_kron[row0 .., col0 ..]
  float* const W0 = sL + head_floats<N, G>();  // the chunks' two buffers
  const int tid = threadIdx.x;
  const int T = a.T, m = a.m, Tm = a.Tm;
  const int ntile = a.tiles * (a.tiles + 1) / 2;
  const long long b0 = (long long)(blockIdx.x / ntile) * G;
  int I = blockIdx.x % ntile, J = 0;  // tile k -> (I, J): J's tiles are I = 0 .. J
  while (I > J) I -= ++J;
  const bool diag = I == J;
  const int row0 = I * S, col0 = J * S;
  float* const Bc = diag ? Br : Br + N * Gran;
  for (int i = tid; i < N * N; i += kThreads) {
    sL[i] = a.L[i];
    sdq[i] = a.dq[i];
  }

  // this thread: problem p, sub-tile (ra, cb) of the tile, rows r0 .. r0 + 3
  // and columns c0 .. c0 + 7 of Ht; on a diagonal tile also g's column
  // row0 + slot, for slot < S.  A warp's sub-tiles share cb, so their first
  // live steps are close.
  const int p = tid % G, slot = tid / G;
  const int ra = slot % Sh::RowBlocks, cb = slot / Sh::RowBlocks;
  const int r0 = row0 + ra * kR, c0 = col0 + cb * kC;
  const bool active = r0 < c0 + kC;  // not wholly below the diagonal
  const int t_lo = max(r0, c0) / m;  // the sub-tile's first live step
  const int t_all = max(r0 + kR - 1, c0 + kC - 1) / m;  // all of it live from here
  const bool gthread = diag && slot < S && row0 + slot < Tm;
  const int jg = row0 + slot;
  const long long b = b0 + p;

  float acc[kR][kC];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[r][c] = 0.0f;
  float accG[N], accR = 0.0f;
#pragma unroll
  for (int q = 0; q < N; ++q) accG[q] = 0.0f;

  // staging of a chunk into buffer u: W_t of the tile's rows (set 0) and
  // columns (set 1) at Wr(u), Wc(u); L^T Abar_t and L^T Cx_t at LA(u), LC(u)
  auto Wr = [&](int u) { return W0 + u * CH * step_floats<N, G>(); };
  auto Wc = [&](int u) { return diag ? Wr(u) : Wr(u) + CH * N * Gran; };
  auto LA = [&](int u) { return Wr(u) + 2 * CH * N * Gran; };
  auto LC = [&](int u) { return LA(u) + CH * G * N * N; };
  auto XR = [&](int u) { return LC(u) + CH * G * N; };
  // A copy a row i of a granule (4 columns of one problem, 16 bytes), the
  // G problems of a granule on consecutive threads, so that a quarter warp's
  // 16-byte shared accesses meet distinct banks; each granule's copies are
  // made and, once they have landed, turned into W_t in place by one thread.
  // The live columns of a granule are a prefix (col < (t + 1) m and < Tm):
  // the copy reads those and zero-fills the rest, as past the batch
  auto granule = [&](int it, int& tt, int& set, int& sp, int& gr) {
    sp = it % G;
    gr = (it / G) % GR;
    set = (it / (G * GR)) % 2;
    tt = it / (2 * G * GR);
  };
  auto fetch = [&](int t0, int u) {
    for (int it = tid; it < CH * 2 * G * GR; it += kThreads) {
      int tt, set, sp, gr;
      granule(it, tt, set, sp, gr);
      if (set == 1 && diag) continue;
      const int t = t0 + tt, gcol = (set ? col0 : row0) + gr * 4;
      const long long sb = b0 + sp;
      const int cols = t < T && sb < a.B ? min(4, min((t + 1) * m, Tm) - gcol) : 0;
      const int bytes = cols > 0 ? 4 * cols : 0;
      const float* src = bytes ? a.bbar + (sb * T + t) * N * (long long)Tm + gcol : a.bbar;
      float* dst = (set ? Wc(u) : Wr(u)) + tt * N * Gran + gran<G>(gr * 4, sp);
#pragma unroll
      for (int i = 0; i < N; ++i)
        cp_async16_prefix(dst + i * Gran, src + (bytes ? (long long)i * Tm : 0), bytes);
    }
    // diagonal tiles: Abar_t, Cbar_t and x_ref_t of a (step, problem) a
    // thread, where LA_t, LCx_t go, turned by the same thread
    for (int it = tid; diag && it < CH * G; it += kThreads) {
      const int tt = it / G, t = t0 + tt;
      const long long bb = b0 + it % G;
      const bool live = bb < a.B && t < T;
      const long long at = live ? bb * T + t : 0;
#pragma unroll
      for (int j = 0; j < N * N; ++j)
        pint::cp_async4(LA(u) + it * N * N + j, a.abar + at * N * N + j, live);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        pint::cp_async4(LC(u) + it * N + i, a.cbar + at * N + i, live);
        pint::cp_async4(XR(u) + it * N + i, a.xref + (live ? (long long)t * N : 0) + i, live);
      }
    }
    pint::cp_async_commit();
  };
  auto stage = [&](int t0, int u) {
    pint::cp_async_wait<0>();
    for (int it = tid; it < CH * 2 * G * GR; it += kThreads) {
      int tt, set, sp, gr;
      granule(it, tt, set, sp, gr);
      if (set == 1 && diag) continue;
      const int at = tt * N * Gran + gran<G>(gr * 4, sp);
      float* dst = (set ? Wc(u) : Wr(u)) + at;
      float bv[N][4];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(dst + i * Gran);
        bv[i][0] = v.x, bv[i][1] = v.y, bv[i][2] = v.z, bv[i][3] = v.w;
        if (t0 + tt == T - 1)  // keep B_{T-1} for the terminal term
          *reinterpret_cast<float4*>((set ? Bc : Br) + i * Gran + at - tt * N * Gran) = v;
      }
      // W_t[l, col] = sum_i L[i, l] Bbar_t[i, col]
#pragma unroll
      for (int l = 0; l < N; ++l) {
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          w[e] = mul(sL[l], bv[0][e]);
#pragma unroll
          for (int i = 1; i < N; ++i) w[e] = add(w[e], mul(sL[i * N + l], bv[i][e]));
        }
        *reinterpret_cast<float4*>(dst + l * Gran) = make_float4(w[0], w[1], w[2], w[3]);
      }
    }
    // LA_t[l, q] = sum_i L[i, l] Abar_t[i, q], LCx_t[l] = sum_i L[i, l] Cx_t[i]
    for (int it = tid; diag && it < CH * G; it += kThreads) {
      float A[N * N], cx[N];
      float* la = LA(u) + it * N * N;
      float* lc = LC(u) + it * N;
#pragma unroll
      for (int j = 0; j < N * N; ++j) A[j] = la[j];
#pragma unroll
      for (int i = 0; i < N; ++i) cx[i] = sub(lc[i], XR(u)[it * N + i]);
#pragma unroll
      for (int l = 0; l < N; ++l) {
#pragma unroll
        for (int q = 0; q < N; ++q) {
          float s = mul(sL[l], A[q]);
#pragma unroll
          for (int i = 1; i < N; ++i) s = add(s, mul(sL[i * N + l], A[i * N + q]));
          la[l * N + q] = s;
        }
        float c = mul(sL[l], cx[0]);
#pragma unroll
        for (int i = 1; i < N; ++i) c = add(c, mul(sL[i * N + l], cx[i]));
        lc[l] = c;
      }
    }
  };

  // chunk c in buffer c % 2: the next chunk's copies are in flight while the
  // block sums this one, and one barrier a chunk
  __syncthreads();  // L and dQ
  int t0 = col0 / m, u = 0;
  for (int it = tid; it < S * GR; it += kThreads) {  // the tile of R_kron, with chunk 0
    const int r = it / GR, c = (it % GR) * 4, row = row0 + r, col = col0 + c;
    const int bytes = row < Tm && col < Tm ? 16 : 0;
    cp_async16_prefix(sR + r * (S + 4) + c, a.rk + (bytes ? (long long)row * Tm + col : 0),
                      bytes);
  }
  fetch(t0, 0);
  stage(t0, 0);
  __syncthreads();
  for (; t0 < T; t0 += CH, u ^= 1) {
    const int nst = min(CH, T - t0);
    const bool more = t0 + CH < T;
    if (more) fetch(t0 + CH, u ^ 1);
    if (active) {
      for (int tt = max(0, t_lo - t0); tt < nst; ++tt) {
        float wr[N][kR], wc[N][kC];
        load_sub<N, G>(Wr(u) + tt * N * Gran, Wc(u) + tt * N * Gran, ra, cb, p, wr, wc);
        const int t = t0 + tt;
        if (t >= t_all)
          step_update<N, false>(acc, wr, wc, 0, r0, c0);
        else
          step_update<N, true>(acc, wr, wc, (t + 1) * m, r0, c0);
      }
    }
    if (gthread) {  // G[jg, :] and g_ref[jg] of problem p
      for (int tt = max(0, jg / m - t0); tt < nst; ++tt) {
        const float* pw = Wr(u) + tt * N * Gran + gran<G>(slot, p);
        const float* la = LA(u) + (tt * G + p) * N * N;
        const float* lc = LC(u) + (tt * G + p) * N;
        float wj[N];
#pragma unroll
        for (int l = 0; l < N; ++l) wj[l] = pw[l * Gran];
#pragma unroll
        for (int q = 0; q < N; ++q) {
          float d = mul(wj[0], la[q]);
#pragma unroll
          for (int l = 1; l < N; ++l) d = add(d, mul(wj[l], la[l * N + q]));
          accG[q] = add(accG[q], d);
        }
        float d = mul(wj[0], lc[0]);
#pragma unroll
        for (int l = 1; l < N; ++l) d = add(d, mul(wj[l], lc[l]));
        accR = add(accR, d);
      }
    }
    if (more) stage(t0 + CH, u ^ 1);
    __syncthreads();  // the next buffer is whole; this one is read
  }

  if (b >= a.B) return;
  if (active) {
    // BQT[k, row] = sum_i dQ[i, k] B_{T-1}[i, row] of the sub-tile's rows
    float br[N][kR], bt[N][kC], bq[N][kR], h[kR][kC];
    load_sub<N, G>(Br, Bc, ra, cb, p, br, bt);
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float s = mul(sdq[k], br[0][r]);
#pragma unroll
        for (int i = 1; i < N; ++i) s = add(s, mul(sdq[i * N + k], br[i][r]));
        bq[k][r] = s;
      }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      // R_kron[row, c0 .. c0 + 7] of the sub-tile's row
      const float* rk = sR + (ra * kR + r) * (S + 4) + cb * kC;
      const float4 v0 = *reinterpret_cast<const float4*>(rk);
      const float4 v1 = *reinterpret_cast<const float4*>(rk + 4);
      const float rkv[kC] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float term = mul(bq[0][r], bt[0][c]);
#pragma unroll
        for (int i = 1; i < N; ++i) term = add(term, mul(bq[i][r], bt[i][c]));
        h[r][c] = add(add(acc[r][c], term), rkv[c]);
      }
    }
    if (a.pm) {
      float* hb = a.ht + b * Tm * (long long)Tm;
      if (r0 + kR <= c0 && c0 + kC <= Tm) {  // all above the diagonal: rows and mirror
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          float4* dst = reinterpret_cast<float4*>(hb + (long long)(r0 + r) * Tm + c0);
          dst[0] = make_float4(h[r][0], h[r][1], h[r][2], h[r][3]);
          dst[1] = make_float4(h[r][4], h[r][5], h[r][6], h[r][7]);
        }
#pragma unroll
        for (int c = 0; c < kC; ++c)
          *reinterpret_cast<float4*>(hb + (long long)(c0 + c) * Tm + r0) =
              make_float4(h[0][c], h[1][c], h[2][c], h[3][c]);
      } else {
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const int row = r0 + r, col = c0 + c;
            if (row <= col && col < Tm) {
              hb[(long long)row * Tm + col] = h[r][c];
              if (row < col) hb[(long long)col * Tm + row] = h[r][c];
            }
          }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int row = r0 + r, col = c0 + c;
          if (row <= col && col < Tm) {
            a.ht[((long long)row * Tm + col) * a.B + b] = h[r][c];
            if (row < col) a.ht[((long long)col * Tm + row) * a.B + b] = h[r][c];
          }
        }
    }
  }
  if (gthread) {
    float bq[N], cx[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = mul(sdq[k], Br[gran<G>(slot, p)]);
#pragma unroll
      for (int i = 1; i < N; ++i) s = add(s, mul(sdq[i * N + k], Br[i * Gran + gran<G>(slot, p)]));
      bq[k] = s;
    }
    const float* AT = a.abar + (b * T + T - 1) * N * N;
    const float* CT = a.cbar + (b * T + T - 1) * N;
    const float* xr = a.xref + (long long)(T - 1) * N;
#pragma unroll
    for (int i = 0; i < N; ++i) cx[i] = sub(CT[i], xr[i]);
    float gx = 0.0f;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      float s = mul(bq[0], AT[q]);
#pragma unroll
      for (int i = 1; i < N; ++i) s = add(s, mul(bq[i], AT[i * N + q]));
      const float Gq = add(accG[q], s);
      gx = q == 0 ? mul(Gq, a.x0[b * N]) : add(gx, mul(Gq, a.x0[b * N + q]));
    }
    float s = mul(bq[0], cx[0]);
#pragma unroll
    for (int i = 1; i < N; ++i) s = add(s, mul(bq[i], cx[i]));
    a.g[b * Tm + jg] = add(gx, add(accR, s));
  }
}

template <int N, int G>
int launch(Args a, cudaStream_t stream) {
  constexpr int S = Shape<G>::S;
  a.tiles = (a.Tm + S - 1) / S;
  const size_t smem =
      (size_t)(head_floats<N, G>() + 2 * chunk_steps<N, G>() * step_floats<N, G>()) * 4;
  const long long groups = ((long long)a.B + G - 1) / G;
  const long long blocks = groups * (a.tiles * (a.tiles + 1) / 2);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t err = pint_allow_smem(reduce_kernel<N, G>, smem);
  if (err != cudaSuccess) return (int)err;
  reduce_kernel<N, G><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// batch-last (to 64 lanes): 8 problems a block, whose stores of an entry
// fill a 32-byte sector; problem-major: 2 problems and 64 x 64 tiles, which
// read each column of Bbar into fewer tiles
template <int N>
int launch_n(Args a, cudaStream_t stream) {
  return a.pm ? launch<N, 2>(a, stream) : launch<N, 8>(a, stream);
}

}  // namespace

// abar (B, T, n, n), bbar (B, T, n, T m), cbar (B, T, n), x0 (B, n), L and dq
// (n, n), rk (Tm, Tm), xref (T, n), f32 and contiguous; writes ht (Tm, Tm, B)
// batch-last, or with problem_major (B, Tm, Tm), 16-byte aligned, and g (B,
// Tm); ht and bbar 16-byte aligned.  n 1 to 6; Tm = T m to 4096 and a multiple of 4.
extern "C" int pint_reduce(const void* abar, const void* bbar, const void* cbar,
                           const void* x0, const void* L, const void* dq, const void* rk,
                           const void* xref, void* ht, void* g, int B, int T, int n, int m,
                           int problem_major, void* stream) {
  if (B <= 0 || T <= 0 || m <= 0 || (long long)T * m > 4096 || (T * m) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(ht) % 16 != 0 || reinterpret_cast<uintptr_t>(bbar) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(abar), static_cast<const float*>(bbar),
         static_cast<const float*>(cbar), static_cast<const float*>(x0),
         static_cast<const float*>(L),    static_cast<const float*>(dq),
         static_cast<const float*>(rk),   static_cast<const float*>(xref),
         static_cast<float*>(ht),         static_cast<float*>(g),
         B, T, m, T * m, 0, problem_major != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch_n<1>(a, s);
    case 2: return launch_n<2>(a, s);
    case 3: return launch_n<3>(a, s);
    case 4: return launch_n<4>(a, s);
    case 5: return launch_n<5>(a, s);
    case 6: return launch_n<6>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
