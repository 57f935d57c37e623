// K4: PGD with a per-problem int8 Hessian, per-problem step rationals and
// error feedback -- the DeviceSQP inner solve.
//
// Replaces pint_tpu/mpc/fused_alm.py:402 (_pgd_kernel_factory, pallas_call
// at :546 in pgd_fused_words_pre).  Each iteration, per problem b:
//   acc[j] = sum_k hqt[k, j, b] * lanes[k]
//   pre    = (acc * hs_num[b]) >> hs_den[b]
//   step   = -(pre + g) + carry
//   delta  = clip((step + half) >> g_shift, -128, 127)
//   carry  = step - (delta << g_shift)
//   lanes  = clip(lanes + delta, -127, 127)
//
// Bound on the H100 at the main-path shape (B = 4096, Tp = 64, 30
// iterations): hqt 16.8 MB read once, the words (1 MB) and g (1 MB) read and
// the words (1 MB) written once, 19.9 MB over 3.35 TB/s = 0.0059 ms;
// 30 x Tp^2 x B = 0.50 G int8 MACs (1.0 G operations) over 1,979 TOP/s is
// 0.0005 ms.  Memory sets the bound.
//
// The first design (0.138 ms, 0.29 with the unpack and pack around it)
// staged a block's 16 problems one byte a thread: 16 contiguous bytes a row
// kj, 512 bytes a round trip, and a transposing byte store whose problem
// stride covered 2 banks.  The 30 __dp4a iterations after it take a few µs.
//
// This design:
// * Where B % 16 == 0, a block's group of 16 problems lands as [kj][16]
//   bytes, one 16-byte cp.async a row kj, in a ring of two landing buffers
//   over a persistent grid: group i+1 is in flight while the warps iterate
//   on group i.  A pass in shared memory then turns each 4 x 16-byte block
//   (4 k of one row j) into the 16 problems' words of 4 k with __byte_perm
//   4x4 byte transposes, so each problem's row j is contiguous in k.  A
//   ragged batch stages the rows straight from global memory one byte a
//   thread.
// * Rows are padded to an odd number of 16-byte units, so the 16-byte row
//   reads of a warp (lane j on row j) are free of bank conflicts.  One warp
//   runs a problem: lanes, g, carry and the lane's Hessian rows (32
//   registers at Tp = 64) in registers, so an iteration reads only the lane
//   vector, re-broadcast through shared memory, 16 bytes at a time for
//   __dp4a.  Only the final lanes are written.
// * L = int reads and writes (B, Tp) int32 lanes; L = int8_t reads and
//   writes the (B, Tp/4) packed control words, which on this little-endian
//   card are the int8 lanes in memory (K2p's precedent): the words entry
//   needs no unpack or pack around it.
//
// Past 64 lanes, up to the reference's pgd_viable (Tp <= 632), a lane's
// rows no longer fit its registers: the entries launch alm.cu's cluster
// kernel (pint_pgd_wide), a problem a block (or a cluster of blocks past
// Tp = 464), a row a thread or two, on hqt batch-last or problem-major.  An earlier design here ran one warp a problem
// over rows in shared memory, a lane 8 rows at Tp = 256: 11.91 ms at B =
// 4096 and 30 iterations on one H100 80GB HBM3, where the cluster kernel
// takes 4.41 ms at Tp = 260.
//
// Input lanes must lie in [-128, 127] (unpacked int8 control lanes).
#include "common.cuh"

namespace {

constexpr int kProbs = 16;  // problems a group: 16 bytes a row kj

struct Layout {
  int rs;        // row stride, bytes: >= Tp rounded to 16, odd x 16
  int tp16;      // Tp rounded up to 16
  size_t ps;     // problem stride in the rows buffer, bytes
  size_t land;   // bytes of one landing buffer
};

__host__ __device__ inline Layout layout(int Tp) {
  Layout l;
  l.tp16 = (Tp + 15) & ~15;
  l.rs = (l.tp16 / 16) % 2 ? l.tp16 : l.tp16 + 16;
  l.ps = (size_t)Tp * l.rs;
  l.land = (size_t)Tp * Tp * kProbs;
  return l;
}

// rows + lane vectors (+ two landing buffers when async)
inline size_t smem_bytes(const Layout& l, int probs, bool async) {
  return probs * (l.ps + l.tp16) + (async ? 2 * l.land : 0);
}

__device__ __forceinline__ void transpose4x4(uint32_t a, uint32_t b, uint32_t c,
                                             uint32_t d, uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const uint32_t t2 = __byte_perm(c, d, 0x5140);  // c0 d0 c1 d1
  const uint32_t t3 = __byte_perm(c, d, 0x7362);  // c2 d2 c3 d3
  o[0] = __byte_perm(t0, t2, 0x5410);             // a0 b0 c0 d0
  o[1] = __byte_perm(t0, t2, 0x7632);             // a1 b1 c1 d1
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// L: int (lanes) or int8_t (packed words, read and written as bytes).
// NJ = 1 (Tp <= 32) or 2 (Tp <= 64): lane l owns rows l + 32q, q < NJ.
template <int NJ, typename L>
__global__ void __launch_bounds__(kProbs * 32, 1)
pgd_hqt_kernel(const L* __restrict__ lanes, const int* __restrict__ g,
               const int8_t* __restrict__ hqt, const int* __restrict__ hs_num,
               const int* __restrict__ hs_den, L* __restrict__ out, int B,
               int Tp, int iters, int g_shift, int probs, int async) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(Tp);
  unsigned char* rows = smem;                        // [probs][Tp][rs]
  int8_t* lvec = reinterpret_cast<int8_t*>(smem + probs * lay.ps);
  unsigned char* land = smem + probs * (lay.ps + lay.tp16);  // 2 x [kj][16]
  const int nthreads = blockDim.x;
  const int mm = Tp * Tp;
  const int ngroups = (B + probs - 1) / probs;

  // pad bytes of rows and lane vectors stay zero: nothing below writes them
  for (size_t i = threadIdx.x * 16; i < probs * (lay.ps + lay.tp16);
       i += (size_t)nthreads * 16)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0, 0, 0, 0);

  auto issue = [&](int t) {  // group t of this block -> landing t % 2
    const int grp = blockIdx.x + t * gridDim.x;
    if (grp < ngroups) {
      unsigned char* dst = land + (t & 1) * lay.land;
      const int8_t* src = hqt + (size_t)grp * kProbs;
      for (int kj = threadIdx.x; kj < mm; kj += nthreads)
        pint::cp_async16(dst + kj * 16, src + (size_t)kj * B, true);
    }
    pint::cp_async_commit();
  };
  if (async) issue(0);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int half = 1 << (g_shift - 1);
  for (int t = 0;; ++t) {
    const int grp = blockIdx.x + t * gridDim.x;
    if (grp >= ngroups) break;
    const int b0 = grp * probs;
    const int nb = min(probs, B - b0);
    if (async) {
      issue(t + 1);
      pint::cp_async_wait<1>();
      __syncthreads();
      // landing [k*Tp + j][p] -> rows[p][j][k], 4 k of one row j a task
      const unsigned char* src = land + (t & 1) * lay.land;
      for (int i = threadIdx.x; i < mm / 4; i += nthreads) {
        const int j = i % Tp;
        const int k0 = (i / Tp) * 4;
        uint4 c[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          c[r] = *reinterpret_cast<const uint4*>(src + ((k0 + r) * Tp + j) * 16);
        unsigned char* dst = rows + (size_t)j * lay.rs + k0;
#pragma unroll
        for (int w = 0; w < 4; ++w) {  // problems 4w .. 4w + 3
          uint32_t o[4];
          transpose4x4(word_of(c[0], w), word_of(c[1], w), word_of(c[2], w),
                       word_of(c[3], w), o);
#pragma unroll
          for (int p = 0; p < 4; ++p)
            *reinterpret_cast<uint32_t*>(dst + (4 * w + p) * lay.ps) = o[p];
        }
      }
    } else {
      // hqt[kj, b0 + p] -> rows[p][j][k], consecutive threads on
      // consecutive problems
      for (int i = threadIdx.x; i < mm * probs; i += nthreads) {
        const int p = i % probs;
        const int kj = i / probs;
        if (p < nb) {
          const int k = kj / Tp;
          rows[p * lay.ps + (size_t)(kj - k * Tp) * lay.rs + k] =
              (unsigned char)hqt[(size_t)kj * B + b0 + p];
        }
      }
    }
    __syncthreads();

    if (warp < nb) {
      const int b = b0 + warp;
      const unsigned char* H = rows + warp * lay.ps;
      int8_t* lv = lvec + warp * lay.tp16;
      const int num = hs_num[b];
      const int den = hs_den[b];
      const size_t base = (size_t)b * Tp;
      const int chunks = lay.tp16 / 16;
      // this lane's rows (NJ x up to 2 NJ chunks of 16 bytes) live in
      // registers for all iterations
      uint4 rr[NJ][2 * NJ];
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
#pragma unroll
        for (int c = 0; c < 2 * NJ; ++c)
          rr[q][c] = j < Tp && c < chunks
                         ? *reinterpret_cast<const uint4*>(H + (size_t)j * lay.rs + 16 * c)
                         : make_uint4(0, 0, 0, 0);
      }
      int x[NJ], gj[NJ], carry[NJ];
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
        x[q] = j < Tp ? (int)lanes[base + j] : 0;
        gj[q] = j < Tp ? g[base + j] : 0;
        carry[q] = 0;
      }
      for (int it = 0; it < iters; ++it) {
        __syncwarp();
#pragma unroll
        for (int q = 0; q < NJ; ++q) {
          const int j = lane + 32 * q;
          if (j < Tp) lv[j] = (int8_t)x[q];
        }
        __syncwarp();
        int acc[NJ], acc2[NJ];  // two partial sums: shorter __dp4a chains
#pragma unroll
        for (int q = 0; q < NJ; ++q) acc[q] = 0, acc2[q] = 0;
#pragma unroll
        for (int c = 0; c < 2 * NJ; ++c) {
          if (c < chunks) {
            const uint4 l4 = *reinterpret_cast<const uint4*>(lv + 16 * c);
#pragma unroll
            for (int q = 0; q < NJ; ++q) {
              int& a = c & 1 ? acc2[q] : acc[q];
              a = __dp4a((int)rr[q][c].x, (int)l4.x, a);
              a = __dp4a((int)rr[q][c].y, (int)l4.y, a);
              a = __dp4a((int)rr[q][c].z, (int)l4.z, a);
              a = __dp4a((int)rr[q][c].w, (int)l4.w, a);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < NJ; ++q) acc[q] += acc2[q];  // exact: |acc| < 2^22
#pragma unroll
        for (int q = 0; q < NJ; ++q) {
          const int pre = pint::wrap_mul(acc[q], num) >> den;
          const int step = pint::wrap_add(
              pint::wrap_sub(0, pint::wrap_add(pre, gj[q])), carry[q]);
          const int delta =
              pint::clampi(pint::wrap_add(step, half) >> g_shift, -128, 127);
          carry[q] = pint::wrap_sub(step, pint::wrap_shl(delta, g_shift));
          x[q] = pint::clampi(x[q] + delta, -127, 127);
        }
      }
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
        if (j < Tp) out[base + j] = (L)x[q];
      }
    }
    __syncthreads();  // rows are free for the next group
  }
  pint::cp_async_wait<0>();
}

template <int NJ, typename L>
cudaError_t launch(const L* lanes, const int* g, const int8_t* hqt,
                   const int* hs_num, const int* hs_den, L* out, int B, int Tp,
                   int iters, int g_shift, cudaStream_t stream) {
  const Layout lay = layout(Tp);
  const bool async = B % kProbs == 0 && reinterpret_cast<uintptr_t>(hqt) % 16 == 0;
  const int probs = kProbs;
  const size_t smem = smem_bytes(lay, probs, async);  // 214,016 bytes at Tp = 64
  auto kernel = pgd_hqt_kernel<NJ, L>;
  cudaError_t err = pint_allow_smem(kernel, smem);
  int grid = 0;
  if (err == cudaSuccess)
    err = pint_persistent_grid(kernel, probs * 32, smem, (B + probs - 1) / probs,
                               &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, probs * 32, smem, stream>>>(lanes, g, hqt, hs_num, hs_den, out,
                                             B, Tp, iters, g_shift, probs,
                                             (int)async);
  return cudaGetLastError();
}

// orders: bit 0 set when hqt is problem-major (hqt[b Tp^2 + j Tp + k]),
// which only the cluster kernel (Tp > 64) reads; else batch-last.
template <typename L>
int dispatch(const void* lanes, const void* g, const void* hqt,
             const void* hs_num, const void* hs_den, void* out, int B, int Tp,
             int iters, int g_shift, int orders, void* stream) {
  // the reference's pgd_viable: the int8 working set of 128 problems
  // within 100 MiB
  if (B <= 0 || Tp <= 0 || Tp % 4 || (long)Tp * Tp + 16L * Tp > 409600 || iters < 0 ||
      g_shift < 1 || g_shift > 30 || (orders & ~1) || (orders && Tp <= 64))
    return (int)cudaErrorInvalidValue;
  const L* l = static_cast<const L*>(lanes);
  const int* gg = static_cast<const int*>(g);
  const int8_t* h = static_cast<const int8_t*>(hqt);
  const int* num = static_cast<const int*>(hs_num);
  const int* den = static_cast<const int*>(hs_den);
  L* o = static_cast<L*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tp > 64)
    return (int)pint_pgd_wide(lanes, gg, h, num, den, out, B, Tp, iters, g_shift,
                              sizeof(L) == 1, orders & 1, s);
  if (Tp <= 32) return (int)launch<1, L>(l, gg, h, num, den, o, B, Tp, iters, g_shift, s);
  return (int)launch<2, L>(l, gg, h, num, den, o, B, Tp, iters, g_shift, s);
}

}  // namespace

// lanes, out: (B, Tp) int32 lanes
extern "C" int pint_pgd_hqt(const void* lanes, const void* g, const void* hqt,
                            const void* hs_num, const void* hs_den, void* out,
                            int B, int Tp, int iters, int g_shift, int orders,
                            void* stream) {
  return dispatch<int>(lanes, g, hqt, hs_num, hs_den, out, B, Tp, iters,
                       g_shift, orders, stream);
}

// words, out: (B, Tp/4) packed control words, read and written as bytes
extern "C" int pint_pgd_hqt_words(const void* words, const void* g,
                                  const void* hqt, const void* hs_num,
                                  const void* hs_den, void* out, int B, int Tp,
                                  int iters, int g_shift, int orders, void* stream) {
  return dispatch<int8_t>(words, g, hqt, hs_num, hs_den, out, B, Tp, iters,
                          g_shift, orders, stream);
}
