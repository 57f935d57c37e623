// K2: box-QP projected gradient descent with one shared int8 Hessian.
//
// Replaces pint_tpu/mpc/fused.py:119 (FusedPGD._kernel, iteration body
// _body at :91, pallas_call at :256).  Each iteration, per problem b:
//   acc   = lanes . Hq^T                       (int8 x int8 -> int32)
//   pre   = (acc * hs_num) >> hs_den
//   delta = clip((-(pre + g) + half) >> g_shift, -128, 127)
//   lanes = clip(lanes + delta, -127, 127)
// and, with momentum, the matvec and update run on the extrapolation
//   y = clip(x + ((beta_num * (x - x_prev)) >> beta_den), -127, 127).
//
// What bounds it on the H100: at the serving shape (B = 8192, Tp = 64,
// 15-40 iterations) the work is 4096 int8 MACs a problem an iteration and
// the data is 4 MB in and 2 MB out, so a kernel that re-read the lanes from
// device memory every iteration would be bound by that traffic, and one that
// kept them would be bound by the int8 dot issue rate and by latency.
// Design: the 4 KB Hessian is loaded into shared memory once per block (row
// stride padded by one word so the 32 rows a warp reads sit on distinct
// banks); one warp owns one problem for all iterations, each thread keeping
// its Tp/32 lanes, linear terms and momentum state in registers; the lane
// vector is re-broadcast through 64 bytes of shared memory each iteration as
// packed int8 so the dot is __dp4a, 16 of them per output at Tp = 64.  Only
// the final lanes are written.  Tensor cores (s8 wgmma) are later work.
//
// Input lanes must lie in [-128, 127] (unpacked int8 control lanes).
//
// K2p: replaces pint_tpu/mpc/fused.py:136 (FusedPGD._kernel_packed,
// pallas_call at :215), the same loop with packed words in and out.  The
// SWAR control word holds lane k of word j in bits 8k..8k+7, so on this
// little-endian card a (B, Tp/4) int32 word tensor IS the (B, Tp) int8
// lanes in memory: K2p is K2's body instantiated on int8_t I/O.  Each thread
// loads its lanes as sign-extended bytes (a warp reads 32 consecutive
// bytes) and stores the final lanes as bytes, lane & 0xFF, which is the
// packed word.  No unpack or pack pass, and a quarter of K2's lane traffic.
// The reference's grouped lane order and permuted Hessian (fused.py:189-194)
// work around Mosaic's lane shuffles and have no counterpart here; the
// words are read in their natural order.  No momentum branch, as in the
// reference's packed kernel.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

// L is the lane I/O type: int (K2, unpacked lanes) or int8_t (K2p, words).
template <int NJ, typename L>
__global__ void __launch_bounds__(kWarps * 32)
fused_pgd_kernel(const L* __restrict__ lanes, const int* __restrict__ g,
                 const int8_t* __restrict__ hq, L* __restrict__ out, int B,
                 int Tp, int iters, int hs_num, int hs_den, int g_shift,
                 int momentum, int beta_num, int beta_den) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = Tp + 4;
  int8_t* s_hq = reinterpret_cast<int8_t*>(smem);
  for (int i = threadIdx.x; i < Tp * Tp; i += blockDim.x) {
    const int j = i / Tp;
    s_hq[j * stride + (i - j * Tp)] = hq[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int8_t* s_lane = s_hq + Tp * stride + warp * Tp;
  const int* lw = reinterpret_cast<const int*>(s_lane);
  const int words = Tp >> 2;
  const int half = 1 << (g_shift - 1);

  for (int b = blockIdx.x * kWarps + warp; b < B; b += gridDim.x * kWarps) {
    const size_t base = (size_t)b * Tp;
    int x[NJ], xp[NJ], gj[NJ];
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int j = lane + 32 * q;
      x[q] = j < Tp ? lanes[base + j] : 0;
      gj[q] = j < Tp ? g[base + j] : 0;
      xp[q] = x[q];
    }
    for (int it = 0; it < iters; ++it) {
      int y[NJ];
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        y[q] = momentum ? pint::clampi(
                              x[q] + ((beta_num * (x[q] - xp[q])) >> beta_den),
                              -127, 127)
                        : x[q];
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
        if (j < Tp) s_lane[j] = (int8_t)y[q];
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
        if (j < Tp) {
          const int acc = pint::dot_i8(
              reinterpret_cast<const int*>(s_hq + j * stride), lw, words);
          const int pre = pint::wrap_mul(acc, hs_num) >> hs_den;
          const int step = pint::wrap_sub(0, pint::wrap_add(pre, gj[q]));
          const int delta =
              pint::clampi(pint::wrap_add(step, half) >> g_shift, -128, 127);
          xp[q] = x[q];
          x[q] = pint::clampi(y[q] + delta, -127, 127);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int j = lane + 32 * q;
      if (j < Tp) out[base + j] = (L)x[q];
    }
  }
}

template <int NJ, typename L>
cudaError_t launch(const L* lanes, const int* g, const int8_t* hq, L* out,
                   int B, int Tp, int iters, int hs_num, int hs_den,
                   int g_shift, int momentum, int beta_num, int beta_den,
                   cudaStream_t stream) {
  const size_t smem = (size_t)Tp * (Tp + 4) + (size_t)kWarps * Tp;
  cudaError_t err = pint_allow_smem(fused_pgd_kernel<NJ, L>, smem);
  if (err != cudaSuccess) return err;
  int blocks = (B + kWarps - 1) / kWarps;
  if (blocks > 132 * 8) blocks = 132 * 8;
  fused_pgd_kernel<NJ, L><<<blocks, kWarps * 32, smem, stream>>>(
      lanes, g, hq, out, B, Tp, iters, hs_num, hs_den, g_shift, momentum,
      beta_num, beta_den);
  return cudaGetLastError();
}

template <typename L>
int dispatch(const void* lanes, const void* g, const void* hq, void* out,
             int B, int Tp, int iters, int hs_num, int hs_den, int g_shift,
             int momentum, int beta_num, int beta_den, void* stream) {
  if (B <= 0 || Tp <= 0 || Tp % 4 || Tp > 256 || iters < 0 || g_shift < 1 ||
      g_shift > 30 || hs_den < 0 || hs_den > 31 || beta_den < 0 ||
      beta_den > 30)
    return (int)cudaErrorInvalidValue;
  const L* l = static_cast<const L*>(lanes);
  const int* gg = static_cast<const int*>(g);
  const int8_t* h = static_cast<const int8_t*>(hq);
  L* o = static_cast<L*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((Tp + 31) / 32) {
#define PINT_CASE(n)                                                        \
  case n:                                                                   \
    err = launch<n, L>(l, gg, h, o, B, Tp, iters, hs_num, hs_den, g_shift,  \
                       momentum, beta_num, beta_den, s);                    \
    break;
    PINT_CASE(1) PINT_CASE(2) PINT_CASE(3) PINT_CASE(4)
    PINT_CASE(5) PINT_CASE(6) PINT_CASE(7) PINT_CASE(8)
#undef PINT_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace

extern "C" int pint_fused_pgd(const void* lanes, const void* g, const void* hq,
                              void* out, int B, int Tp, int iters, int hs_num,
                              int hs_den, int g_shift, int momentum,
                              int beta_num, int beta_den, void* stream) {
  return dispatch<int>(lanes, g, hq, out, B, Tp, iters, hs_num, hs_den,
                       g_shift, momentum, beta_num, beta_den, stream);
}

// words, out: (B, Tp/4) packed control words, read and written as bytes
extern "C" int pint_fused_pgd_packed(const void* words, const void* g,
                                     const void* hq, void* out, int B, int Tp,
                                     int iters, int hs_num, int hs_den,
                                     int g_shift, void* stream) {
  return dispatch<int8_t>(words, g, hq, out, B, Tp, iters, hs_num, hs_den,
                          g_shift, 0, 0, 0, stream);
}

extern "C" const char* pint_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
