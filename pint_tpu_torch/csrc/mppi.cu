// One MPPI update of the unicycle (mpc/mppi.py, QuantizedMPPI._update) in one
// launch: from the nominal plans' words (B, L/4), each problem's K x L int8
// noise slab and the start states (B, 3), the new words and the best cost a
// problem.  Its plain version is mpc/mppi.py's mppi_update_plain.
//
// Replaces no Pallas kernel: the reference's MPPI is XLA jnp
// (pint_tpu/mpc/mppi.py).  The torch form that ported it ran an update as
// some 1,900 operations on (B, K, .) tensors, writing every candidate's
// lanes, all T + 1 states and every cost term to device memory.
//
// What bounds it on the H100: int32 issue.  A candidate step is some 22
// int32 ALU instructions (the saturating lane adds, the parabolic sine and
// cosine, the x, y and theta updates) and 4 products (portbench/mppi_bound.py),
// 2.1 M candidates x 50 steps an update at B 4096, K 512; beside them the
// step's score in float32 on the FMA pipe.  The bytes are the noise read
// once (K L bytes a problem, 210 MB an update) and the words.  So nothing a
// candidate computes goes to device memory: its lanes, states and cost terms
// live in registers, and the block holds the rest in shared memory.
//
// Design: one block a problem, one thread a candidate (K threads, K a power
// of two from 32 to 1024).  The block stages its noise slab (K L bytes) with
// 16-byte streaming loads, read once from device memory, and the nominal
// words.  Each thread then walks its candidate word by word: one SWAR
// signed-saturating add (swar.cuh, CONTROL_LAYOUT) makes four lanes, two
// steps of (v, w); the fixed-point map runs with its shifts merged (x += (v
// c) >> xs, th += w << ws, bit for bit the model's map on lanes of at most
// 128, mpc/mppi.py merged_shifts), every sum wrapping in int32; the score
// adds each step's squared distance to the goal as it comes.  Row k of the
// slab is read as words k L/4 + j, so a warp's loads meet distinct banks
// where L/4 is odd (25 at H 50).  The costs then stay in the block: a
// bitonic sort (shuffles below a stride of 32, shared memory above) gives
// the minimum and the median (the mean of ranks K/2 - 1 and K/2, as
// jnp.median), then the softmax of -(c - min) / ((median - min + 1e-6)
// temperature) as torch.softmax forms it (less the maximum, expf, the sum,
// a division).  The weighted mean recomputes each candidate lane from the
// staged slab and the nominal lane: warp w takes lanes w, w + K/32, ...,
// lane t of it sums k = t, t + 32, ... in order, then a shuffle tree over t.
// rintf (half to even, as torch.round), a clamp to +-127 and the pack give
// the new words.  Three blocks an SM (48 warps; the slab and its companions
// take 57.5 KB a block at K 512, H 50) cap a thread at 40 registers, and
// ptxas spills 16 bytes; on one H100 (PERF.md) an update at B 4096 took
// 0.3145 ms queued so, against 0.333 ms at two blocks an SM (64 registers,
// no spill).  On the first design (the candidate lanes converted with
// I2F, 0.321 ms) one block an SM (80 registers) took 0.441 ms, and with the
// weighted mean left out 0.237 ms, the sort 0.315: the rollout sets the time.
//
// Rounding, bit for bit with mppi_update_plain on the card: every float32
// product, sum and quotient is __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, which nvcc's default --fmad=true does not contract; expf is
// the full-precision one (no --use_fast_math).  Each sum runs in one fixed
// order: the running cost from step 1 in step order; the softmax's sum as a
// tree, the first half plus the second, over K; the weighted mean as above.
// The control effort is an exact int32 sum of squared lanes (below 2^24, so
// exact in float32 whatever the order).  The integer rollout is the torch
// path's bit for bit.
#include "common.cuh"
#include "swar.cuh"

namespace {

struct Args {
  const uint32_t* words;  // (B, L/4)
  const int8_t* noise;    // problem b's (K, L) slab at noise + b * stride
  const int32_t* state0;  // (B, 3)
  uint32_t* out;          // (B, L/4)
  float* best;            // (B,)
  long long stride;       // bytes between problems' slabs
  int B, L, xs, ws;
  float scale, gx, gy, temperature;
};

// the int8 lanes' signed-saturating add on four lanes a word
// (CONTROL_LAYOUT, pint_tpu_torch/ops/swar.py _c_layout)
__device__ __forceinline__ uint32_t add_lanes(uint32_t a, uint32_t b) {
  constexpr pint::SwarLayout kControl{
      0x80808080u, 0x7F7F7F7Fu, 0x01010101u, 0, {}, {0x01010101u}, {7}, {0}, {8},
      1, 0, 1, 8, 1, 8};
  return pint::add_signed_saturate<uint32_t>(kControl, pint::Word<uint32_t>(a),
                                             pint::Word<uint32_t>(b)).v;
}

// lane q of a word, sign-extended
__device__ __forceinline__ int32_t lane(uint32_t w, int q) {
  return (int32_t)(w << (24 - 8 * q)) >> 24;
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// the model's parabolic sine of a Q16 angle, in Q14
__device__ __forceinline__ int32_t sin_q14(int32_t t) {
  const int32_t h = t & 0x7FFF;
  const int32_t val = (h * (0x8000 - h)) >> 14;
  return (t & 0x8000) ? -val : val;
}

// the block's K values of v combined by op, in every thread; red holds K/32
template <int K, class Op>
__device__ __forceinline__ float block_reduce(float v, float* red, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int i = 1; i < K / 32; ++i) v = op(v, red[i]);
  __syncthreads();
  return v;
}

template <int K>
constexpr int kMinBlocks = K >= 1024 ? 1 : (1536 / K > 32 ? 32 : 1536 / K);

template <int K>
__global__ void __launch_bounds__(K, kMinBlocks<K>) mppi_update_kernel(
    const __grid_constant__ Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, W = L / 4;
  int8_t* slab = reinterpret_cast<int8_t*>(smem);            // (K, L)
  float* buf = reinterpret_cast<float*>(smem + (size_t)K * L);  // K: sort, sums
  float* wts = buf + K;                                      // K: weights
  float* red = wts + K;                                      // K / 32
  uint32_t* nom = reinterpret_cast<uint32_t*>(red + K / 32); // W
  uint32_t* fresh = nom + W;                                 // W: the new words
  const int k = threadIdx.x, t = k % 32, warp = k / 32;
  const long long b = blockIdx.x;

  {  // stage the slab, 16 bytes a load, and the nominal words
    const uint4* src = reinterpret_cast<const uint4*>(a.noise + b * a.stride);
    uint4* dst = reinterpret_cast<uint4*>(slab);
    const int n16 = K * L / 16;
    for (int i = k; i < n16; i += K) dst[i] = __ldcs(src + i);
    for (int j = k; j < W; j += K) nom[j] = a.words[b * W + j];
  }
  const int32_t x0 = a.state0[b * 3], y0 = a.state0[b * 3 + 1], th0 = a.state0[b * 3 + 2];
  __syncthreads();

  // candidate k: rollout and score
  float c;
  {
    const uint32_t* row = reinterpret_cast<const uint32_t*>(slab + (size_t)k * L);
    int32_t x = x0, y = y0, th = th0, effort = 0;
    float run = 0.0f, d2 = 0.0f;
    for (int j = 0; j < W; ++j) {
      const uint32_t cw = add_lanes(nom[j], row[j]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int32_t v = lane(cw, 2 * h), w = lane(cw, 2 * h + 1);
        effort += v * v + w * w;
        const int32_t cs = sin_q14(wrap_add(th, 1 << 14)), sn = sin_q14(th);
        x = wrap_add(x, (v * cs) >> a.xs);
        y = wrap_add(y, (v * sn) >> a.xs);
        th = wrap_add(th, (int32_t)((uint32_t)w << a.ws));
        const float dx = __fsub_rn(__fmul_rn(__int2float_rn(x), a.scale), a.gx);
        const float dy = __fsub_rn(__fmul_rn(__int2float_rn(y), a.scale), a.gy);
        d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        run = __fadd_rn(run, d2);
      }
    }
    c = __fadd_rn(__fadd_rn(run, __fmul_rn(20.0f, d2)),
                  __fmul_rn(1e-4f, __int2float_rn(effort)));
  }

  // the minimum and the median: a bitonic sort, thread k ending with rank k
  float mu, med;
  {
    float v = c;
    for (int size = 2; size <= K; size <<= 1) {
      for (int stride = size / 2; stride > 0; stride >>= 1) {
        float p;
        if (stride >= 32) {
          buf[k] = v;
          __syncthreads();
          p = buf[k ^ stride];
          __syncthreads();
        } else {
          p = __shfl_xor_sync(0xFFFFFFFFu, v, stride);
        }
        v = (((k & stride) == 0) == ((k & size) == 0)) ? fminf(v, p) : fmaxf(v, p);
      }
    }
    buf[k] = v;
    __syncthreads();
    mu = buf[0];
    med = __fmul_rn(__fadd_rn(buf[(K - 1) / 2], buf[K / 2]), 0.5f);
    __syncthreads();
  }

  // the softmax: less the maximum, expf, the sum as a tree over k, a division
  {
    const float den = __fmul_rn(__fadd_rn(__fsub_rn(med, mu), 1e-6f), a.temperature);
    const float z = __fdiv_rn(-__fsub_rn(c, mu), den);
    const float zmax = block_reduce<K>(z, red, [](float p, float q) { return fmaxf(p, q); });
    const float e = expf(__fsub_rn(z, zmax));
    buf[k] = e;
    __syncthreads();
#pragma unroll
    for (int h = K / 2; h >= 32; h >>= 1) {
      if (k < h) buf[k] = __fadd_rn(buf[k], buf[k + h]);
      __syncthreads();
    }
    if (warp == 0) {
      float s = buf[t];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xFFFFFFFFu, s, o));
      if (t == 0) red[0] = s;
    }
    __syncthreads();
    wts[k] = __fdiv_rn(e, red[0]);
    __syncthreads();
  }

  // the weighted mean of each lane over the candidates, rounded and packed.
  // A candidate lane, clamp(n + z, -128, 127), is formed in float32 with no
  // conversion: the noise byte z added to the bits of 1.5 x 2^23 is the
  // float 1.5 x 2^23 + z, and less 1.5 x 2^23 - n it is n + z, all exact.
  for (int l = warp; l < L; l += K / 32) {
    const float off = 12582912.0f - (float)lane(nom[l / 4], l % 4);
    float acc = 0.0f;
#pragma unroll 4
    for (int j = 0; j < K / 32; ++j) {
      const int kk = t + 32 * j;
      const float z = __int_as_float(0x4B400000 + (int32_t)slab[(size_t)kk * L + l]);
      const float cand = fminf(fmaxf(__fsub_rn(z, off), -128.0f), 127.0f);
      const float p = __fmul_rn(wts[kk], cand);
      acc = j == 0 ? p : __fadd_rn(acc, p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(0xFFFFFFFFu, acc, o));
    if (t == 0) {
      const float r = fminf(fmaxf(rintf(acc), -127.0f), 127.0f);
      reinterpret_cast<int8_t*>(fresh)[l] = (int8_t)(int32_t)r;
    }
  }
  __syncthreads();
  for (int j = k; j < W; j += K) a.out[b * W + j] = fresh[j];
  if (k == 0) a.best[b] = mu;
}

template <int K>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)K * a.L + 8 * K + 4 * (K / 32) + 2 * a.L;
  if (smem > kPintMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = pint_allow_smem(mppi_update_kernel<K>, smem);
  if (err != cudaSuccess) return (int)err;
  mppi_update_kernel<K><<<(unsigned)a.B, K, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// words (B, L/4) int32 and state0 (B, 3) int32 contiguous; noise int8, each
// problem's (K, L) slab contiguous at noise + b * noise_stride, the pointer
// and the stride multiples of 16 bytes; writes out (B, L/4) and best (B,).
// K a power of two from 32 to 1024, L a positive multiple of 4, xs and ws
// the merged shifts (0 to 31), scale 2^-frac_bits.
extern "C" int pint_mppi_update(const void* words, const void* noise, const void* state0,
                                void* out, void* best, int B, int K, int L,
                                long long noise_stride, int xs, int ws, float scale,
                                float gx, float gy, float temperature, void* stream) {
  if (B <= 0 || L <= 0 || L % 4 != 0 || xs < 0 || xs > 31 || ws < 0 || ws > 31 ||
      noise_stride % 16 != 0 || reinterpret_cast<uintptr_t>(noise) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const uint32_t*>(words), static_cast<const int8_t*>(noise),
         static_cast<const int32_t*>(state0), static_cast<uint32_t*>(out),
         static_cast<float*>(best), noise_stride, B, L, xs, ws, scale, gx, gy, temperature};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    case 128: return launch<128>(a, s);
    case 256: return launch<256>(a, s);
    case 512: return launch<512>(a, s);
    case 1024: return launch<1024>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
