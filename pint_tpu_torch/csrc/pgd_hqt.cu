// K4: PGD with a per-problem int8 Hessian, per-problem step rationals and
// error feedback -- the DeviceSQP inner solve.
//
// Replaces pint_tpu/mpc/fused_alm.py:402 (_pgd_kernel_factory, pallas_call
// at :546 in _pgd_fused_core).  Each iteration, per problem b:
//   acc[j] = sum_k hqt[k, j, b] * lanes[k]
//   pre    = (acc * hs_num[b]) >> hs_den[b]
//   step   = -(pre + g) + carry
//   delta  = clip((step + half) >> g_shift, -128, 127)
//   carry  = step - (delta << g_shift)
//   lanes  = clip(lanes + delta, -127, 127)
//
// What bounds it on the H100: the Hessian is per problem, Tp*Tp bytes (4 KB
// at Tp = 64, 16 MB for B = 4096), and it is read every iteration.  Read
// from device memory each time that is 30 x 16 MB a solve, so the kernel
// would be bound by memory traffic; kept on chip it is bound by the int8
// dot issue rate.  Design: a block takes `probs` consecutive problems and
// stages their Hessians into shared memory once.  The batch-last layout
// (Tp, Tp, B) that lipq emits is read with consecutive threads on
// consecutive problems, so each (k, j) entry of the block's problems is one
// contiguous run.  In shared memory each problem's matrix is stored
// row-major by output j (row stride padded by one word, so the 32 rows a
// warp reads sit on distinct banks).  Then one warp per problem runs all
// iterations with lanes, linear term and carry in registers, the lane
// vector re-broadcast through shared memory as packed int8 for __dp4a, as
// in K2.  Only the final lanes are written.
//
// Input lanes must lie in [-128, 127] (unpacked int8 control lanes).
#include "common.cuh"

namespace {

template <int NJ>
__global__ void pgd_hqt_kernel(const int* __restrict__ lanes,
                               const int* __restrict__ g,
                               const int8_t* __restrict__ hqt,
                               const int* __restrict__ hs_num,
                               const int* __restrict__ hs_den,
                               int* __restrict__ out, int B, int Tp, int iters,
                               int g_shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int probs = blockDim.x >> 5;
  const int stride = Tp + 4;
  const int per = Tp * stride;
  int8_t* s_h = reinterpret_cast<int8_t*>(smem);
  const int b0 = blockIdx.x * probs;
  const int nb = min(probs, B - b0);

  // stage hqt[k, j, b0 + p] -> s_h[p][j][k]
  const int total = Tp * Tp * probs;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int p = i % probs;
    const int kj = i / probs;
    if (p < nb) {
      const int k = kj / Tp;
      s_h[p * per + (kj - k * Tp) * stride + k] = hqt[(size_t)kj * B + b0 + p];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (warp >= nb) return;
  const int lane = threadIdx.x & 31;
  const int b = b0 + warp;
  const int8_t* H = s_h + warp * per;
  int8_t* s_lane = s_h + probs * per + warp * Tp;
  const int* lw = reinterpret_cast<const int*>(s_lane);
  const int words = Tp >> 2;
  const int half = 1 << (g_shift - 1);
  const int num = hs_num[b];
  const int den = hs_den[b];
  const size_t base = (size_t)b * Tp;

  int x[NJ], gj[NJ], carry[NJ];
#pragma unroll
  for (int q = 0; q < NJ; ++q) {
    const int j = lane + 32 * q;
    x[q] = j < Tp ? lanes[base + j] : 0;
    gj[q] = j < Tp ? g[base + j] : 0;
    carry[q] = 0;
  }
  for (int it = 0; it < iters; ++it) {
    __syncwarp();
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int j = lane + 32 * q;
      if (j < Tp) s_lane[j] = (int8_t)x[q];
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int j = lane + 32 * q;
      if (j < Tp) {
        const int acc = pint::dot_i8(
            reinterpret_cast<const int*>(H + j * stride), lw, words);
        const int pre = pint::wrap_mul(acc, num) >> den;
        const int step = pint::wrap_add(
            pint::wrap_sub(0, pint::wrap_add(pre, gj[q])), carry[q]);
        const int delta =
            pint::clampi(pint::wrap_add(step, half) >> g_shift, -128, 127);
        carry[q] = pint::wrap_sub(step, pint::wrap_shl(delta, g_shift));
        x[q] = pint::clampi(x[q] + delta, -127, 127);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NJ; ++q) {
    const int j = lane + 32 * q;
    if (j < Tp) out[base + j] = x[q];
  }
}

// Problems per block: up to 16, as many as fit in shared memory.
int probs_for(int Tp) {
  const size_t per = (size_t)Tp * (Tp + 4) + Tp;
  size_t p = kPintMaxSmem / per;
  return p > 16 ? 16 : (int)p;
}

template <int NJ>
cudaError_t launch(const int* lanes, const int* g, const int8_t* hqt,
                   const int* hs_num, const int* hs_den, int* out, int B,
                   int Tp, int iters, int g_shift, cudaStream_t stream) {
  const int probs = probs_for(Tp);
  const size_t smem = (size_t)probs * ((size_t)Tp * (Tp + 4) + Tp);
  cudaError_t err = pint_allow_smem(pgd_hqt_kernel<NJ>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + probs - 1) / probs;
  pgd_hqt_kernel<NJ><<<blocks, probs * 32, smem, stream>>>(
      lanes, g, hqt, hs_num, hs_den, out, B, Tp, iters, g_shift);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pint_pgd_hqt(const void* lanes, const void* g, const void* hqt,
                            const void* hs_num, const void* hs_den, void* out,
                            int B, int Tp, int iters, int g_shift,
                            void* stream) {
  if (B <= 0 || Tp <= 0 || Tp % 4 || Tp > 256 || iters < 0 || g_shift < 1 ||
      g_shift > 30)
    return (int)cudaErrorInvalidValue;
  const int* l = static_cast<const int*>(lanes);
  const int* gg = static_cast<const int*>(g);
  const int8_t* h = static_cast<const int8_t*>(hqt);
  const int* num = static_cast<const int*>(hs_num);
  const int* den = static_cast<const int*>(hs_den);
  int* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((Tp + 31) / 32) {
#define PINT_CASE(n)                                                      \
  case n:                                                                 \
    err = launch<n>(l, gg, h, num, den, o, B, Tp, iters, g_shift, s);     \
    break;
    PINT_CASE(1) PINT_CASE(2) PINT_CASE(3) PINT_CASE(4)
    PINT_CASE(5) PINT_CASE(6) PINT_CASE(7) PINT_CASE(8)
#undef PINT_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
