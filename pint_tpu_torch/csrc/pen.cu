// K6: penalty power iteration + int8 quantization of the state-constraint
// rows, one pass over them.
//
// Replaces pint_tpu/mpc/condense_fused.py:198 (_pen_kernel_factory,
// pallas_call at :303 in pen_fused).  Per problem b of S_t (C, Tm, B) f32:
//   v0 = 1/sqrt(Tm); `power_iters` times: w = S v (over j in order),
//   u = S^T w (over c in order), v = u / (|u| + 1e-30)
//   pen_lip = 1.05 * v . (S^T S v)
//   s_scale = max|S| * f32(1/127)       (the reference's max|S| / 127 as
//                                        XLA compiles it)
//   row_amp = 127 * max_c sum_j |S[c, j]|   (sum over j in order)
//   sqc[c, j, b] = sqj[j, c, b] = clip(round_half_even(S[c, j] *
//                  (127 / max(max|S|, 1e-30))), -127, 127) as int8
//
// What bounds it on the H100: 8 KB of f32 a problem at C = 32, Tm = 64 (32
// MB at B = 4096).  Streamed from device memory twice per power step it is
// 33 passes, about 1 GB a call, so a kernel that re-read it would be bound
// by memory bandwidth; read once it is bound by the one pass plus about
// 2 x 17 x C x Tm multiply-adds a problem.  Design (K3's, csrc/lipq.cu): a
// block takes `probs` consecutive problems and stages their S slabs into
// shared memory once, consecutive threads on consecutive problems, rows
// padded to an odd stride so the 32 rows a warp walks sit on distinct
// banks.  One warp a problem runs the whole power iteration out of shared
// memory: for S v each thread owns rows c, for S^T w rows j, w and v
// broadcast through shared memory.  Both int8 orientations are written in
// the batch-last order the staging read.
//
// Past 64 rows or columns (pen_rows_kernel; the long-horizon path runs it
// at C = 128, Tm = 256) a slab takes most of a block's shared memory, so the
// design above ran one warp on an SM, each lane walking 4 to 8 rows of 256
// serial sums; it took 36.9 ms at B = 4096 on one H100 80GB HBM3.  There one
// problem takes a block of max(C, Tm) threads: thread c sums row c of S v,
// thread j column j of S^T w, each in the same index order, and the norm's
// lane partials go through shared memory in the warp design's order.
//
// Rounding: products and sums use __fmul_rn/__fadd_rn, which nvcc never
// contracts into FMA, and every sum is added in a fixed order (the row
// loops in index order, the norms as lane-ordered partials and an xor
// butterfly), so the plain PyTorch version (pen_plain), which adds in the
// same order, is bit-identical on every output; rintf rounds half to even
// like torch.round and jnp.round, and the divisions are IEEE.
#include "common.cuh"

namespace {

constexpr float kInv127 = (float)(1.0 / 127.0);

template <int N>
__global__ void pen_kernel(const float* __restrict__ st,
                           int8_t* __restrict__ sqc, int8_t* __restrict__ sqj,
                           float* __restrict__ lip, float* __restrict__ sscale,
                           float* __restrict__ rowamp, int B, int C, int Tm,
                           int power_iters, float inv_sqrt) {
  extern __shared__ __align__(16) float fsm[];
  const int probs = blockDim.x >> 5;
  const int ss = Tm + 1;                       // odd row stride
  const int slab = C * ss;
  float* s_S = fsm;                            // probs x [C][ss]
  float* s_v = s_S + (size_t)probs * slab;     // probs x Tm
  float* s_w = s_v + probs * Tm;               // probs x C
  float* s_scale = s_w + probs * C;            // probs
  const int b0 = blockIdx.x * probs;
  const int nb = min(probs, B - b0);

  const int total = C * Tm * probs;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int p = i % probs;
    const int cj = i / probs;
    if (p < nb) {
      const int c = cj / Tm;
      s_S[p * slab + c * ss + (cj - c * Tm)] = st[(size_t)cj * B + b0 + p];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < nb) {
    const float* S = s_S + warp * slab;
    float* v = s_v + warp * Tm;
    float* w = s_w + warp * C;
    const int b = b0 + warp;

    float sm = 0.0f, ra = 0.0f;
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int c = lane + 32 * q;
      if (c < C) {
        const float* row = S + c * ss;
        float acc = fabsf(row[0]);
        sm = pint::nan_max(sm, acc);
        for (int j = 1; j < Tm; ++j) {
          const float a = fabsf(row[j]);
          sm = pint::nan_max(sm, a);
          acc = __fadd_rn(acc, a);
        }
        ra = pint::nan_max(ra, acc);
      }
    }
    sm = pint::warp_max(sm);
    ra = pint::warp_max(ra);

#pragma unroll
    for (int q = 0; q < N; ++q) {
      const int j = lane + 32 * q;
      if (j < Tm) v[j] = inv_sqrt;
    }
    float u[N];
    for (int it = 0; it <= power_iters; ++it) {
      __syncwarp();
#pragma unroll
      for (int q = 0; q < N; ++q) {            // w = S v
        const int c = lane + 32 * q;
        if (c < C) {
          const float* row = S + c * ss;
          float acc = __fmul_rn(row[0], v[0]);
          for (int j = 1; j < Tm; ++j)
            acc = __fadd_rn(acc, __fmul_rn(row[j], v[j]));
          w[c] = acc;
        }
      }
      __syncwarp();
      float part = 0.0f;
#pragma unroll
      for (int q = 0; q < N; ++q) {            // u = S^T w
        const int j = lane + 32 * q;
        u[q] = 0.0f;
        if (j < Tm) {
          float acc = __fmul_rn(S[j], w[0]);
          for (int c = 1; c < C; ++c)
            acc = __fadd_rn(acc, __fmul_rn(S[c * ss + j], w[c]));
          u[q] = acc;
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
      for (int q = 0; q < N; ++q) {
        const int j = lane + 32 * q;
        if (j < Tm) v[j] = __fdiv_rn(u[q], nrm);
      }
    }
    if (lane == 0) {
      sscale[b] = __fmul_rn(sm, kInv127);
      rowamp[b] = __fmul_rn(127.0f, ra);
      const float den = sm != sm ? sm : fmaxf(sm, 1e-30f);
      s_scale[warp] = __fdiv_rn(127.0f, den);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int p = i % probs;
    const int cj = i / probs;
    if (p < nb) {
      const int c = cj / Tm;
      const int j = cj - c * Tm;
      float r = rintf(__fmul_rn(s_S[p * slab + c * ss + j], s_scale[p]));
      r = fminf(fmaxf(r, -127.0f), 127.0f);
      sqc[(size_t)cj * B + b0 + p] = (int8_t)(int)r;
    }
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int p = i % probs;
    const int jc = i / probs;
    if (p < nb) {
      const int j = jc / C;
      const int c = jc - j * C;
      float r = rintf(__fmul_rn(s_S[p * slab + c * ss + j], s_scale[p]));
      r = fminf(fmaxf(r, -127.0f), 127.0f);
      sqj[(size_t)jc * B + b0 + p] = (int8_t)(int)r;
    }
  }
}

// One problem a block (blockIdx.x), nt = 32 ceil(max(C, Tm) / 32) threads.
// Shared memory: the slab [C][Tm + 1], then v (Tm), w (C), 32 more floats
// and the norm; the lane partials (32 ceil(Tm / 32) floats) reuse v, w and
// the 32 floats once a step has read them.
__global__ void __launch_bounds__(256)
pen_rows_kernel(const float* __restrict__ st, int8_t* __restrict__ sqc,
                int8_t* __restrict__ sqj, float* __restrict__ lip,
                float* __restrict__ sscale, float* __restrict__ rowamp, int B,
                int C, int Tm, int power_iters, float inv_sqrt) {
  extern __shared__ __align__(16) float fsm[];
  const int ss = Tm + 1;
  float* S = fsm;
  float* v = S + (size_t)C * ss;
  float* w = v + Tm;
  float* red = v;                // [32 ceil(Tm / 32)], after a step's reads
  float* s_sum = w + C + 32;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const int b = blockIdx.x;
  const int mm = C * Tm;

  for (int i = t; i < mm; i += blockDim.x) {
    const int c = i / Tm;
    S[c * ss + (i - c * Tm)] = st[(size_t)i * B + b];
  }
  __syncthreads();

  // max |S| and the largest row sum of |S| (row c in order, thread c)
  float sm = 0.0f, ra = 0.0f;
  if (t < C) {
    const float* row = S + t * ss;
    float acc = fabsf(row[0]);
    sm = acc;
    for (int j = 1; j < Tm; ++j) {
      const float a = fabsf(row[j]);
      sm = pint::nan_max(sm, a);
      acc = __fadd_rn(acc, a);
    }
    ra = acc;
  }
  sm = pint::warp_max(sm);
  ra = pint::warp_max(ra);
  if (lane == 0) red[warp] = sm, red[nw + warp] = ra;
  __syncthreads();
  if (t == 0) {
    for (int q = 1; q < nw; ++q) sm = pint::nan_max(sm, red[q]);
    for (int q = 1; q < nw; ++q) ra = pint::nan_max(ra, red[nw + q]);
    sscale[b] = __fmul_rn(sm, kInv127);
    rowamp[b] = __fmul_rn(127.0f, ra);
    const float den = sm != sm ? sm : fmaxf(sm, 1e-30f);
    s_sum[0] = __fdiv_rn(127.0f, den);
  }
  __syncthreads();
  const float scale = s_sum[0];
  if (t < Tm) v[t] = inv_sqrt;
  __syncthreads();

  for (int it = 0;; ++it) {
    if (t < C) {                       // w = S v
      const float* row = S + t * ss;
      float acc = __fmul_rn(row[0], v[0]);
      for (int j = 1; j < Tm; ++j) acc = __fadd_rn(acc, __fmul_rn(row[j], v[j]));
      w[t] = acc;
    }
    __syncthreads();
    float u = 0.0f, x = 0.0f;
    if (t < Tm) {                      // u = S^T w
      u = __fmul_rn(S[t], w[0]);
      for (int c = 1; c < C; ++c) u = __fadd_rn(u, __fmul_rn(S[c * ss + t], w[c]));
      x = it < power_iters ? __fmul_rn(u, u) : __fmul_rn(v[t], u);
    }
    __syncthreads();                   // v and w read
    const int nj = (Tm + 31) >> 5;
    if (t < nj * 32) red[t] = x;
    __syncthreads();
    if (warp == 0) {                   // lane partials in row order, then the butterfly
      float part = 0.0f;
      for (int q = 0; q < nj; ++q)
        if (lane + 32 * q < Tm) part = __fadd_rn(part, red[lane + 32 * q]);
      part = pint::warp_sum(part);
      if (lane == 0) s_sum[1] = part;
    }
    __syncthreads();
    const float sum = s_sum[1];
    if (it == power_iters) {
      if (t == 0) lip[b] = __fmul_rn(sum, 1.05f);
      break;
    }
    if (t < Tm) v[t] = __fdiv_rn(u, __fadd_rn(__fsqrt_rn(sum), 1e-30f));
    __syncthreads();
  }

  for (int i = t; i < mm; i += blockDim.x) {
    const int c = i / Tm, j = i - c * Tm;
    float r = rintf(__fmul_rn(S[c * ss + j], scale));
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    sqc[(size_t)i * B + b] = (int8_t)(int)r;
  }
  for (int i = t; i < mm; i += blockDim.x) {
    const int j = i / C, c = i - j * C;
    float r = rintf(__fmul_rn(S[c * ss + j], scale));
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    sqj[(size_t)i * B + b] = (int8_t)(int)r;
  }
}

size_t pen_per_problem(int C, int Tm) {
  return ((size_t)C * (Tm + 1) + Tm + C + 1) * sizeof(float);
}

// pen_rows_kernel's shared memory: the slab, v, w, 32 floats, the scale and
// the norm.
size_t pen_rows_bytes(int C, int Tm) {
  return ((size_t)C * (Tm + 1) + Tm + C + 34) * sizeof(float);
}

cudaError_t launch_rows(const float* st, int8_t* sqc, int8_t* sqj, float* lip,
                        float* sscale, float* rowamp, int B, int C, int Tm,
                        int power_iters, float inv_sqrt, cudaStream_t stream) {
  const size_t smem = pen_rows_bytes(C, Tm);
  if (smem > kPintMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = pint_allow_smem(pen_rows_kernel, smem);
  if (err != cudaSuccess) return err;
  const int threads = ((C > Tm ? C : Tm) + 31) / 32 * 32;
  pen_rows_kernel<<<B, threads, smem, stream>>>(st, sqc, sqj, lip, sscale, rowamp, B,
                                                C, Tm, power_iters, inv_sqrt);
  return cudaGetLastError();
}

// Problems per block: up to 8, as many f32 slabs as fit in shared memory.
int pen_probs(int C, int Tm) {
  const size_t p = kPintMaxSmem / pen_per_problem(C, Tm);
  return p > 8 ? 8 : (int)p;
}

template <int N>
cudaError_t launch(const float* st, int8_t* sqc, int8_t* sqj, float* lip,
                   float* sscale, float* rowamp, int B, int C, int Tm,
                   int power_iters, float inv_sqrt, cudaStream_t stream) {
  const int probs = pen_probs(C, Tm);
  if (probs < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)probs * pen_per_problem(C, Tm);
  cudaError_t err = pint_allow_smem(pen_kernel<N>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + probs - 1) / probs;
  pen_kernel<N><<<blocks, probs * 32, smem, stream>>>(
      st, sqc, sqj, lip, sscale, rowamp, B, C, Tm, power_iters, inv_sqrt);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pint_pen(const void* st, void* sqc, void* sqj, void* lip,
                        void* sscale, void* rowamp, int B, int C, int Tm,
                        int power_iters, void* stream) {
  if (B <= 0 || C <= 0 || Tm <= 0 || C > 256 || Tm > 256 || power_iters < 0)
    return (int)cudaErrorInvalidValue;
  // the same f32 constant as np.float32(1.0 / np.sqrt(Tm))
  const float inv_sqrt = (float)(1.0 / sqrt((double)Tm));
  const float* s = static_cast<const float*>(st);
  int8_t* qc = static_cast<int8_t*>(sqc);
  int8_t* qj = static_cast<int8_t*>(sqj);
  float* l = static_cast<float*>(lip);
  float* sc = static_cast<float*>(sscale);
  float* ra = static_cast<float*>(rowamp);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int n = ((C > Tm ? C : Tm) + 31) / 32;
  if (n > 2)
    return (int)launch_rows(s, qc, qj, l, sc, ra, B, C, Tm, power_iters, inv_sqrt, strm);
  switch (n <= 1 ? 1 : 2) {
#define PINT_CASE(k)                                                        \
  case k:                                                                   \
    return (int)launch<k>(s, qc, qj, l, sc, ra, B, C, Tm, power_iters,      \
                          inv_sqrt, strm);
    PINT_CASE(1) PINT_CASE(2)
#undef PINT_CASE
  }
  return (int)cudaErrorInvalidValue;
}
