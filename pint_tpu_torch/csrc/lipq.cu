// K3: power-iteration Lipschitz estimate + int8 quantization of the
// condensed Hessian, one pass over it.
//
// Replaces pint_tpu/mpc/condense_fused.py:77 (_lipq_kernel_factory,
// pallas_call at :182 in lipq_fused).  Per problem b of Ht (Tm, Tm, B) f32:
//   v0 = 1/sqrt(Tm); `power_iters` times: w = H^T v (accumulated over k in
//   order), v = w / (|w| + 1e-30)
//   lip  = 1.05 * v . (H^T v)
//   hmax = max |H|
//   hqt[k, j, b] = clip(round_half_even(Ht[k, j, b] * (127 / max(hmax,
//   1e-30))), -127, 127) as int8
//
// What bounds it on the H100: 16 KB of f32 a problem (64 MB at B = 4096,
// more than the 50 MB L2).  Streamed from device memory once per power
// step it is 17 passes, about 1.1 GB a call, so a kernel that re-read it
// would be bound by memory bandwidth; read once it is bound by the one pass
// plus about 4.5 MFLOP a problem.  Design: a block takes `probs` consecutive
// problems and stages their Ht slabs into shared memory once, consecutive
// threads on consecutive problems so the batch-last reads come in contiguous
// runs.  Then one warp a problem runs the whole power iteration out of shared
// memory, each thread owning Tm/32 output rows j.  The int8 result is
// written back in the same batch-last order, as the staging read it.
//
// Rounding: products and sums use __fmul_rn/__fadd_rn, which nvcc never
// contracts into FMA, so the k-ordered accumulation rounds twice per term
// like the TPU kernel and the plain PyTorch version; the norm and the
// v.Hv sum are warp tree reductions, so `lip` agrees with the plain version
// to f32 roundoff, not bit for bit.  hmax (a max) and hqt (one multiply and
// rintf, round half to even like jnp.round / torch.round, per element) are
// bit-identical.
#include "common.cuh"

namespace {

template <int NJ>
__global__ void lipq_kernel(const float* __restrict__ ht,
                            int8_t* __restrict__ hqt, float* __restrict__ lip,
                            float* __restrict__ hmax, int B, int Tm,
                            int power_iters, float inv_sqrt) {
  extern __shared__ __align__(16) float fsm[];
  const int probs = blockDim.x >> 5;
  const int mm = Tm * Tm;
  float* s_h = fsm;                       // probs x (Tm, Tm), [k][j]
  float* s_v = s_h + (size_t)probs * mm;  // probs x Tm
  float* s_scale = s_v + probs * Tm;      // probs
  const int b0 = blockIdx.x * probs;
  const int nb = min(probs, B - b0);

  const int total = mm * probs;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int p = i % probs;
    const int kj = i / probs;
    if (p < nb) s_h[p * mm + kj] = ht[(size_t)kj * B + b0 + p];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < nb) {
    const float* H = s_h + warp * mm;
    float* v = s_v + warp * Tm;
    const int b = b0 + warp;

    float hm = 0.0f;
    for (int i = lane; i < mm; i += 32) hm = pint::nan_max(hm, fabsf(H[i]));
    hm = pint::warp_max(hm);

#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int j = lane + 32 * q;
      if (j < Tm) v[j] = inv_sqrt;
    }
    float w[NJ];
    for (int it = 0; it <= power_iters; ++it) {
      __syncwarp();
      float part = 0.0f;
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
        w[q] = 0.0f;
        if (j < Tm) {
          float acc = __fmul_rn(H[j], v[0]);
          for (int k = 1; k < Tm; ++k)
            acc = __fadd_rn(acc, __fmul_rn(H[k * Tm + j], v[k]));
          w[q] = acc;
          part = it < power_iters ? __fadd_rn(part, __fmul_rn(acc, acc))
                                  : __fadd_rn(part, __fmul_rn(v[j], acc));
        }
      }
      const float s = pint::warp_sum(part);
      if (it == power_iters) {
        if (lane == 0) lip[b] = __fmul_rn(s, 1.05f);
        break;
      }
      const float nrm = __fadd_rn(__fsqrt_rn(s), 1e-30f);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
        if (j < Tm) v[j] = __fdiv_rn(w[q], nrm);
      }
    }
    if (lane == 0) {
      hmax[b] = hm;
      const float den = hm != hm ? hm : fmaxf(hm, 1e-30f);
      s_scale[warp] = __fdiv_rn(127.0f, den);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int p = i % probs;
    const int kj = i / probs;
    if (p < nb) {
      float r = rintf(__fmul_rn(s_h[p * mm + kj], s_scale[p]));
      r = fminf(fmaxf(r, -127.0f), 127.0f);
      hqt[(size_t)kj * B + b0 + p] = (int8_t)(int)r;
    }
  }
}

// Problems per block: up to 8, as many f32 slabs as fit in shared memory.
int probs_for(int Tm) {
  const size_t per = ((size_t)Tm * Tm + Tm + 1) * sizeof(float);
  const size_t p = kPintMaxSmem / per;
  return p > 8 ? 8 : (int)p;
}

template <int NJ>
cudaError_t launch(const float* ht, int8_t* hqt, float* lip, float* hmax,
                   int B, int Tm, int power_iters, float inv_sqrt,
                   cudaStream_t stream) {
  const int probs = probs_for(Tm);
  if (probs < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)probs * ((size_t)Tm * Tm + Tm + 1) * sizeof(float);
  cudaError_t err = pint_allow_smem(lipq_kernel<NJ>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + probs - 1) / probs;
  lipq_kernel<NJ><<<blocks, probs * 32, smem, stream>>>(
      ht, hqt, lip, hmax, B, Tm, power_iters, inv_sqrt);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pint_lipq(const void* ht, void* hqt, void* lip, void* hmax,
                         int B, int Tm, int power_iters, void* stream) {
  if (B <= 0 || Tm <= 0 || Tm > 224 || power_iters < 0)
    return (int)cudaErrorInvalidValue;
  // the same f32 constant as np.float32(1.0 / np.sqrt(Tm))
  const float inv_sqrt = (float)(1.0 / sqrt((double)Tm));
  const float* h = static_cast<const float*>(ht);
  int8_t* q = static_cast<int8_t*>(hqt);
  float* l = static_cast<float*>(lip);
  float* m = static_cast<float*>(hmax);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch ((Tm + 31) / 32) {
#define PINT_CASE(n)                                                  \
  case n:                                                             \
    err = launch<n>(h, q, l, m, B, Tm, power_iters, inv_sqrt, s);     \
    break;
    PINT_CASE(1) PINT_CASE(2) PINT_CASE(3) PINT_CASE(4)
    PINT_CASE(5) PINT_CASE(6) PINT_CASE(7)
#undef PINT_CASE
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
