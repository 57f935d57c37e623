// K5 and K7: the augmented-Lagrangian (ALM) inner of the state-constrained
// tier, the whole outer x inners loop in one launch.
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
// Integer products and sums that XLA lets wrap go through common.cuh's
// uint32_t helpers; >> of a negative int is arithmetic, as XLA's.
//
// What bounds it on the H100: K5's operands are per problem, Hq (Tp x Tp)
// and Sq in two orientations (2 x Cp x Tp), 12 KB at Tp = Cp = 64, 48 MB
// at B = 4096, and every one of the 3 x 30 iterations reads all of them:
// streamed from device memory that is ~4.4 GB a solve, so the kernel would
// be bound by memory traffic; kept on chip it is bound by the int8 dot
// issue rate and by the dependent chain of one iteration.  K7's operands
// are 12 KB in all; its 12 x 60 iterations are bound by the same dot chain.
// Design (K4's, csrc/pgd_hqt.cu, and K2's, csrc/fused_pgd.cu): a K5 block
// takes `probs` consecutive problems and stages their matrices from the
// batch-last layout into shared memory once, consecutive threads on
// consecutive problems; a K7 block stages the shared matrices once.  Each
// matrix is stored by output row (Hq by j, Sq by c for Sq u, Sq by j for
// Sq^T y), rows padded by one word so the 32 rows a warp reads sit on
// distinct banks.  One warp owns a problem for the whole loop: lanes,
// linear term, carry, offsets, bounds, ey and lam live in registers, and
// the lane vector and the two y planes are re-broadcast through shared
// memory as packed int8, so each of the four matvecs an iteration (Hq u,
// Sq u, Sq^T y_hi, Sq^T y_lo) is a row of __dp4a.  Only the final lanes and
// multipliers are written.  Tensor cores (s8 wgmma) are later work.
//
// Input lanes must lie in [-128, 127] (unpacked int8 control lanes).
#include "common.cuh"

namespace {

constexpr int kLamCap = 1 << 22;
constexpr int kYCap = (1 << 13) - 1;
constexpr int kSharedWarps = 8;

struct Rationals {
  int hs_num, hs_den, cs_num, cs_den, eh_num, eh_den, el_num, el_den;
};

__device__ __forceinline__ int shr_mul(int acc, int num, int den) {
  return pint::wrap_mul(acc, num) >> den;
}

// One problem's whole ALM loop, run by one warp.  H is Hq by rows j,
// Sc is Sq by rows c (both row stride Tp + 4), Sj is Sq by rows j (row
// stride Cp + 4); s_lane (Tp), s_yhi and s_ylo (Cp) are this warp's
// broadcast buffers.  lanes/g/out_lanes point at the problem's Tp values,
// coff/lo/hi/lam0/out_lam at its Cp values.  N >= ceil(max(Tp, Cp) / 32).
template <int N>
__device__ void alm_problem(const int8_t* __restrict__ H,
                            const int8_t* __restrict__ Sc,
                            const int8_t* __restrict__ Sj, int8_t* s_lane,
                            int8_t* s_yhi, int8_t* s_ylo,
                            const int* __restrict__ lanes,
                            const int* __restrict__ g,
                            const int* __restrict__ coff,
                            const int* __restrict__ lo,
                            const int* __restrict__ hi,
                            const int* __restrict__ lam0,
                            int* __restrict__ out_lanes,
                            int* __restrict__ out_lam, const Rationals r,
                            int Tp, int Cp, int outer, int inners, int g_shift,
                            int y_shift) {
  const int lane = threadIdx.x & 31;
  const int tw = Tp >> 2, cw = Cp >> 2;
  const int hs = Tp + 4, js = Cp + 4;
  const int half = 1 << (g_shift - 1);
  const int y_half = (1 << y_shift) >> 1;
  const int* lw = reinterpret_cast<const int*>(s_lane);
  const int* yhw = reinterpret_cast<const int*>(s_yhi);
  const int* ylw = reinterpret_cast<const int*>(s_ylo);

  int x[N], gj[N], carry[N];
  int co[N], clo[N], chi[N], lam[N], ey[N];
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const int j = lane + 32 * q;
    x[q] = j < Tp ? lanes[j] : 0;
    gj[q] = j < Tp ? g[j] : 0;
    carry[q] = 0;
    const int c = j;
    co[q] = c < Cp ? coff[c] : 0;
    clo[q] = c < Cp ? lo[c] : 0;
    chi[q] = c < Cp ? hi[c] : 0;
    lam[q] = c < Cp ? lam0[c] : 0;
    ey[q] = 0;
  }

  for (int o = 0; o < outer; ++o) {
    for (int it = 0; it < inners; ++it) {
      __syncwarp();
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const int j = lane + 32 * q;
        if (j < Tp) s_lane[j] = (int8_t)x[q];
      }
      __syncwarp();
      // constraint side: t, the violation y and its 14-bit split
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const int c = lane + 32 * q;
        if (c < Cp) {
          const int acc =
              pint::dot_i8(reinterpret_cast<const int*>(Sc + c * hs), lw, tw);
          const int t = pint::wrap_add(
              pint::wrap_add(shr_mul(acc, r.cs_num, r.cs_den), co[q]), lam[q]);
          const int y = pint::wrap_add(
              pint::wrap_sub(t, pint::clampi(t, clo[q], chi[q])), ey[q]);
          const int y14 =
              pint::clampi(pint::wrap_add(y, y_half) >> y_shift, -kYCap, kYCap);
          ey[q] = pint::wrap_sub(y, pint::wrap_shl(y14, y_shift));
          const int yh = y14 >> 7;
          s_yhi[c] = (int8_t)yh;
          s_ylo[c] = (int8_t)(y14 - (yh << 7));
        }
      }
      __syncwarp();
      // objective side and the penalty gradient, then the update
#pragma unroll
      for (int q = 0; q < N; ++q) {
        const int j = lane + 32 * q;
        if (j < Tp) {
          const int acc =
              pint::dot_i8(reinterpret_cast<const int*>(H + j * hs), lw, tw);
          const int* srow = reinterpret_cast<const int*>(Sj + j * js);
          const int eh = pint::dot_i8(srow, yhw, cw);
          const int el = pint::dot_i8(srow, ylw, cw);
          const int extra = pint::wrap_add(shr_mul(eh, r.eh_num, r.eh_den),
                                           shr_mul(el, r.el_num, r.el_den));
          const int sum = pint::wrap_add(
              pint::wrap_add(shr_mul(acc, r.hs_num, r.hs_den), gj[q]), extra);
          const int step = pint::wrap_add(pint::wrap_sub(0, sum), carry[q]);
          const int delta =
              pint::clampi(pint::wrap_add(step, half) >> g_shift, -128, 127);
          carry[q] = pint::wrap_sub(step, pint::wrap_shl(delta, g_shift));
          x[q] = pint::clampi(x[q] + delta, -127, 127);
        }
      }
    }
    // multiplier update from the exact int32 violation at the inner solution
    __syncwarp();
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int j = lane + 32 * q;
      if (j < Tp) s_lane[j] = (int8_t)x[q];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int c = lane + 32 * q;
      if (c < Cp) {
        const int acc =
            pint::dot_i8(reinterpret_cast<const int*>(Sc + c * hs), lw, tw);
        const int t = pint::wrap_add(
            pint::wrap_add(shr_mul(acc, r.cs_num, r.cs_den), co[q]), lam[q]);
        lam[q] = pint::clampi(pint::wrap_sub(t, pint::clampi(t, clo[q], chi[q])),
                              -kLamCap, kLamCap);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const int j = lane + 32 * q;
    if (j < Tp) out_lanes[j] = x[q];
    if (j < Cp) out_lam[j] = lam[q];
  }
}

// Shared-memory bytes of one K5 problem: Hq by j, Sq by c, Sq by j, and the
// three broadcast buffers (a multiple of 4: Tp and Cp are).
__host__ __device__ inline size_t alm_per_problem(int Tp, int Cp) {
  return (size_t)Tp * (Tp + 4) + (size_t)Cp * (Tp + 4) +
         (size_t)Tp * (Cp + 4) + Tp + 2 * Cp;
}

// K5: a block of `probs` problems (one warp each) stages their batch-last
// hqt (Tp,Tp,B), sqc (Cp,Tp,B) and sqj (Tp,Cp,B) once.
template <int N>
__global__ void __launch_bounds__(16 * 32) alm_kernel(const int* __restrict__ lanes,
                           const int* __restrict__ g,
                           const int8_t* __restrict__ hqt,
                           const int8_t* __restrict__ sqj,
                           const int8_t* __restrict__ sqc,
                           const int* __restrict__ coff,
                           const int* __restrict__ lo,
                           const int* __restrict__ hi,
                           const int* __restrict__ lam,
                           const int* __restrict__ sc,
                           int* __restrict__ out_lanes,
                           int* __restrict__ out_lam, int B, int Tp, int Cp,
                           int outer, int inners, int g_shift, int y_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s = reinterpret_cast<int8_t*>(smem);
  const int probs = blockDim.x >> 5;
  const int hs = Tp + 4, js = Cp + 4;
  const size_t hbytes = (size_t)Tp * hs, cbytes = (size_t)Cp * hs;
  const size_t jbytes = (size_t)Tp * js;
  const size_t per = alm_per_problem(Tp, Cp);
  const int b0 = blockIdx.x * probs;
  const int nb = min(probs, B - b0);

  // hqt[k, j, b0 + p] -> H_p[j][k]
  for (int i = threadIdx.x; i < Tp * Tp * probs; i += blockDim.x) {
    const int p = i % probs;
    const int kj = i / probs;
    if (p < nb) {
      const int k = kj / Tp;
      s[p * per + (kj - k * Tp) * hs + k] = hqt[(size_t)kj * B + b0 + p];
    }
  }
  // sqc[c, j, b0 + p] -> Sc_p[c][j]
  for (int i = threadIdx.x; i < Cp * Tp * probs; i += blockDim.x) {
    const int p = i % probs;
    const int cj = i / probs;
    if (p < nb) {
      const int c = cj / Tp;
      s[p * per + hbytes + c * hs + (cj - c * Tp)] = sqc[(size_t)cj * B + b0 + p];
    }
  }
  // sqj[j, c, b0 + p] -> Sj_p[j][c]
  for (int i = threadIdx.x; i < Tp * Cp * probs; i += blockDim.x) {
    const int p = i % probs;
    const int jc = i / probs;
    if (p < nb) {
      const int j = jc / Cp;
      s[p * per + hbytes + cbytes + j * js + (jc - j * Cp)] =
          sqj[(size_t)jc * B + b0 + p];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (warp >= nb) return;
  const int b = b0 + warp;
  int8_t* base = s + warp * per;
  int8_t* buf = base + hbytes + cbytes + jbytes;
  const Rationals r{sc[b],         sc[B + b],     sc[2 * B + b],
                    sc[3 * B + b], sc[4 * B + b], sc[5 * B + b],
                    sc[6 * B + b], sc[7 * B + b]};
  const size_t bt = (size_t)b * Tp, bc = (size_t)b * Cp;
  alm_problem<N>(base, base + hbytes, base + hbytes + cbytes, buf, buf + Tp,
                 buf + Tp + Cp, lanes + bt, g + bt, coff + bc, lo + bc,
                 hi + bc, lam + bc, out_lanes + bt, out_lam + bc, r, Tp, Cp,
                 outer, inners, g_shift, y_shift);
}

// K7: the shared Hq (Tp,Tp) and Sq (Cp,Tp) staged once a block; each warp
// walks problems with a grid stride.
template <int N>
__global__ void __launch_bounds__(kSharedWarps * 32)
alm_shared_kernel(const int* __restrict__ lanes, const int* __restrict__ g,
                  const int* __restrict__ coff, const int* __restrict__ lam,
                  const int8_t* __restrict__ hq, const int8_t* __restrict__ sq,
                  const int* __restrict__ lo, const int* __restrict__ hi,
                  int* __restrict__ out_lanes, int* __restrict__ out_lam,
                  int B, int Tp, int Cp, int outer, int inners, int g_shift,
                  int y_shift, Rationals r) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s = reinterpret_cast<int8_t*>(smem);
  const int hs = Tp + 4, js = Cp + 4;
  int8_t* H = s;
  int8_t* Sc = H + Tp * hs;
  int8_t* Sj = Sc + Cp * hs;
  for (int i = threadIdx.x; i < Tp * Tp; i += blockDim.x) {
    const int j = i / Tp;
    H[j * hs + (i - j * Tp)] = hq[i];
  }
  for (int i = threadIdx.x; i < Cp * Tp; i += blockDim.x) {
    const int c = i / Tp;
    const int j = i - c * Tp;
    Sc[c * hs + j] = sq[i];
    Sj[j * js + c] = sq[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  int8_t* buf = Sj + Tp * js + warp * (Tp + 2 * Cp);
  for (int b = blockIdx.x * kSharedWarps + warp; b < B;
       b += gridDim.x * kSharedWarps) {
    const size_t bt = (size_t)b * Tp, bc = (size_t)b * Cp;
    alm_problem<N>(H, Sc, Sj, buf, buf + Tp, buf + Tp + Cp, lanes + bt,
                   g + bt, coff + bc, lo, hi, lam + bc, out_lanes + bt,
                   out_lam + bc, r, Tp, Cp, outer, inners, g_shift, y_shift);
  }
}

// Problems per K5 block: up to 16, as many as fit in shared memory.
int alm_probs(int Tp, int Cp) {
  const size_t p = kPintMaxSmem / alm_per_problem(Tp, Cp);
  return p > 16 ? 16 : (int)p;
}

template <int N>
cudaError_t launch_alm(const int* lanes, const int* g, const int8_t* hqt,
                       const int8_t* sqj, const int8_t* sqc, const int* coff,
                       const int* lo, const int* hi, const int* lam,
                       const int* sc, int* out_lanes, int* out_lam, int B,
                       int Tp, int Cp, int outer, int inners, int g_shift,
                       int y_shift, cudaStream_t stream) {
  const int probs = alm_probs(Tp, Cp);
  if (probs < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)probs * alm_per_problem(Tp, Cp);
  cudaError_t err = pint_allow_smem(alm_kernel<N>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + probs - 1) / probs;
  alm_kernel<N><<<blocks, probs * 32, smem, stream>>>(
      lanes, g, hqt, sqj, sqc, coff, lo, hi, lam, sc, out_lanes, out_lam, B,
      Tp, Cp, outer, inners, g_shift, y_shift);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_shared(const int* lanes, const int* g, const int* coff,
                          const int* lam, const int8_t* hq, const int8_t* sq,
                          const int* lo, const int* hi, int* out_lanes,
                          int* out_lam, int B, int Tp, int Cp, int outer,
                          int inners, int g_shift, int y_shift, Rationals r,
                          cudaStream_t stream) {
  const size_t smem = (size_t)Tp * (Tp + 4) + (size_t)Cp * (Tp + 4) +
                      (size_t)Tp * (Cp + 4) +
                      (size_t)kSharedWarps * (Tp + 2 * Cp);
  if (smem > kPintMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = pint_allow_smem(alm_shared_kernel<N>, smem);
  if (err != cudaSuccess) return err;
  int blocks = (B + kSharedWarps - 1) / kSharedWarps;
  if (blocks > 132 * 8) blocks = 132 * 8;
  alm_shared_kernel<N><<<blocks, kSharedWarps * 32, smem, stream>>>(
      lanes, g, coff, lam, hq, sq, lo, hi, out_lanes, out_lam, B, Tp, Cp,
      outer, inners, g_shift, y_shift, r);
  return cudaGetLastError();
}

bool bad_geometry(int B, int Tp, int Cp, int outer, int inners, int g_shift,
                  int y_shift) {
  return B <= 0 || Tp <= 0 || Cp <= 0 || Tp % 4 || Cp % 4 || Tp > 256 ||
         Cp > 256 || outer < 0 || inners < 0 || g_shift < 1 || g_shift > 30 ||
         y_shift < 0 || y_shift > 30;
}

// The register-array width: a power of two >= ceil(max(Tp, Cp) / 32).
int width_for(int Tp, int Cp) {
  const int n = ((Tp > Cp ? Tp : Cp) + 31) / 32;
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : 8;
}

}  // namespace

extern "C" int pint_alm(const void* lanes, const void* g, const void* hqt,
                        const void* sqj, const void* sqc, const void* coff,
                        const void* lo, const void* hi, const void* lam,
                        const void* sc, void* out_lanes, void* out_lam, int B,
                        int Tp, int Cp, int outer, int inners, int g_shift,
                        int y_shift, void* stream) {
  if (bad_geometry(B, Tp, Cp, outer, inners, g_shift, y_shift))
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
  switch (width_for(Tp, Cp)) {
#define PINT_CASE(n)                                                         \
  case n:                                                                    \
    return (int)launch_alm<n>(l, gg, h, sj, scc, co, lo_, hi_, la, rat, ol,  \
                              om, B, Tp, Cp, outer, inners, g_shift,         \
                              y_shift, s);
    PINT_CASE(1) PINT_CASE(2) PINT_CASE(4) PINT_CASE(8)
#undef PINT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int pint_alm_shared(const void* lanes, const void* g,
                               const void* coff, const void* lam,
                               const void* hq, const void* sq, const void* lo,
                               const void* hi, void* out_lanes, void* out_lam,
                               int B, int Tp, int Cp, int outer, int inners,
                               int g_shift, int y_shift, int hs_num,
                               int hs_den, int cs_num, int cs_den, int eh_num,
                               int eh_den, int el_num, int el_den,
                               void* stream) {
  if (bad_geometry(B, Tp, Cp, outer, inners, g_shift, y_shift))
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
  switch (width_for(Tp, Cp)) {
#define PINT_CASE(n)                                                         \
  case n:                                                                    \
    return (int)launch_shared<n>(l, gg, co, la, h, sqq, lo_, hi_, ol, om, B, \
                                 Tp, Cp, outer, inners, g_shift, y_shift, r, \
                                 s);
    PINT_CASE(1) PINT_CASE(2) PINT_CASE(4) PINT_CASE(8)
#undef PINT_CASE
  }
  return (int)cudaErrorInvalidValue;
}
