// The serial chain of one SQP iteration on the unicycle, in one launch (and,
// after this note's first part, on the planar quadrotor).  For
// each problem b: the f32 rollout (Unicycle.rollout_f32), its linearization
// (Unicycle.linearize_f32, as DeviceSQP._linearize_phase forms it) and the
// propagator recursion (DeviceSQP._propagate_unrolled), writing the stacks
// the recursion returns, contiguous and batch-first:
//   Abar (B, T, 3, 3)   P_k = A_k P_{k-1}, P_{-1} = I
//   Bbar (B, T, 3, Tm)  S_k = A_k S_{k-1} + [0 .. B_k s .. 0], Tm = 2 T
//   Cbar (B, T, 3)      c_k = A_k c_{k-1} + c_seq_k
// Its plain version is that torch chain (mpc/propagate.py, chain_plain).
//
// Replaces no Pallas kernel: the reference's rollout, linearization and
// condensation are XLA jnp (pint_tpu/mpc/device_sqp.py).  The torch chain
// that ported them issues about 25 tiny kernels a step for the rollout and
// linearization, and for the recursion a (B, 3, 3, Tm) broadcast product,
// its sum and, after the T steps, a stack of the states.
//
// Bit for bit with the torch chain on the card.  Each operation of that
// chain is a kernel of its own, so none of its products is fused into an
// add: every product and sum here is __fmul_rn / __fadd_rn / __fsub_rn, in
// the torch expression's order ((v * sin) * dt, then x + that), which
// nvcc's default --fmad=true does not contract.  torch.remainder of a float
// is fmod, plus the divisor where the signs differ.  A torch sum starts from
// +0.0 and adds its terms; A_k = [[1, 0, a], [0, 1, b], [0, 0, 1]], so each
// 3-term sum of the recursion and of c_seq holds at most two nonzero terms
// and is one rounding in any order, and the kernel adds from +0.0 as well
// (sum3), every 3 x 3 product of a live column in full.  For finite inputs
// the columns j >= (k+1) m of S_k are +0.0 in the torch chain; the kernel
// writes +0.0 there without computing them.  (Where x0 is not finite the
// torch chain spreads NaN into those columns and the kernel does not; that
// problem's stacks alone differ.)
//
// What bounds it on the H100: its writes.  Bbar is 12 T Tm bytes a problem
// (24 KB at T 32, 393 KB at T 128) and Abar and Cbar 48 T: 107 MB at T 32,
// B 4096 (0.032 ms at 3.35 TB/s) and 1.63 GB at T 128 (0.49 ms).  It reads
// 8 T + 12 bytes a problem, and its arithmetic (about 18 flops a live
// column a step, and the scalar rollout) is far below the card's rate.
//
// Design: a warp owns one problem's tile of column pairs (pair p is step
// p's (v, w) columns 2p and 2p + 1): lane l holds pairs tile 32 Q + l + 32 q,
// q < Q, each as 3 rows of 2 floats in registers, with Q = min(4, ceil(T /
// 32)) pairs a lane chosen from the horizon, so registers stay bounded at
// any T (T 32: a pair a lane and a warp a problem, 4096 warps at B 4096 over
// 132 SMs; T 128: four pairs a lane, still a warp a problem; T 316: three
// warps a problem).  Every lane redoes the problem's scalar rollout and
// linearization, which costs less than handing it out: the plan's lanes
// arrive 32 steps at a time, one 8-byte load a lane, and go round by
// shuffles.  Lanes 0-11 carry one value each of P_k and c_k, the other
// rows of A_k P_{k-1} coming by three shuffles, and write them (48
// contiguous bytes a step, tile 0).  Each step's three rows of the tile
// leave as 8-byte stores, 256 contiguous bytes a warp, issued and not waited
// for, so the warps of an SM keep the writes streaming while each works
// through its chain of steps.  At T 32 the chain's instructions, not the
// writes, set the time (PERF.md): fmod by trunc, and P and c a value a lane,
// keep each step short.
//
// The planar quadrotor's form (propagate_quad_kernel, C entry
// pint_propagate_quad): the same chain on PlanarQuadrotor.rollout_f32 and
// linearize_f32, n 6 and m 2, writing Abar (B, T, 6, 6), Bbar (B, T, 6, Tm)
// and Cbar (B, T, 6), bit for bit with chain_plain on the card for every
// problem whose state is finite, for the unicycle's reason: each row of the
// quadrotor's A_k has at most two nonzero entries ([1, dt] on x, y and
// theta, [a, 1] on vx and vy, [1] on omega) and each row of B_k at most two,
// so every sum of the recursion and of c_seq is one rounding in any order;
// the kernel adds each row's nonzero products to +0.0 (apply_quad), every
// product and sum __fmul_rn / __fadd_rn in the torch expression's order.
// Where x0 is not finite it departs as the unicycle's form does: the torch
// chain's 0 x NaN products spread NaN through that problem's stacks, the
// kernel's dropped zero products do not; that problem's stacks alone differ.
//
// Its bound at the benchmark's cell (T 16, B 4096): 61.96 MB written
// (4 (36 T + 6 T Tm + 6 T) bytes, 15.1 KB a problem), 0.0185 ms at 3.35 TB/s; its f32 operations (72 a live column a step in
// kernel_cost's count) are far below the card's rate.  Design: P_k and c_k
// are 42 values, so they are columns too: lanes 0-5 of a problem's group
// hold column j of P_k (6 floats) and lane 6 c_k, each updated in registers
// with no shuffle; the column pairs of S_k are tiled as the unicycle's, Q
// pairs a lane.  At T 16 a warp a problem would leave half its lanes without
// a pair, so a problem takes kQuadLanes = 16 lanes, two problems a warp, and
// every lane redoes the scalar rollout.  Measured (one H100 80GB HBM3 at
// 700 W, queued behind a device sleep; 16 / 8 / 32 lanes a problem): T 16,
// B 4096: 0.0273 / 0.0275 / 0.0312 ms (0.68 of the bound at 16); B 16384:
// 0.1044 / 0.1132 / 0.1049; T 32: 0.0887 / 0.0902 / 0.0894; T 64: 0.3225 /
// 0.3257 / 0.3078 (0.79 at 16), where the torch chain takes 6.47 / 7.07 /
// 19.8 / 31.4 ms.  70 registers at one pair a lane, 128 at four, no spill.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kWarps = 4;      // warps a block
constexpr int kMaxPairs = 4;   // column pairs a lane

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// a torch sum of three terms: from +0.0, in index order
__device__ __forceinline__ float sum3(float p0, float p1, float p2) {
  return add(add(add(0.0f, p0), p1), p2);
}

// fmod(a, 1) and fmod(t, 0.5) exactly, as fmodf gives them (the part past a
// whole multiple of the divisor, with the dividend's sign; NaN for an
// infinite a), without fmodf's general loop: a - trunc(a) is exact
// (Sterbenz), and so is t - trunc(2t) / 2 for the t in [0, 1] it is given
__device__ __forceinline__ float fmod_one(float a) { return copysignf(sub(a, truncf(a)), a); }
__device__ __forceinline__ float fmod_half(float t) {
  return copysignf(sub(t, mul(0.5f, truncf(mul(2.0f, t)))), t);
}

// torch.remainder of floats (floor-mod, as jnp.mod): fmod, plus the divisor
// where the signs differ
__device__ __forceinline__ float floor_mod(float r, float b) {
  return r != 0.0f && ((b < 0.0f) != (r < 0.0f)) ? add(r, b) : r;
}

// _sin_turns_f32 and _dsin_turns_f32 of theta in turns
__device__ __forceinline__ void sin_turns(float theta, float& val, float& dval) {
  const float t = floor_mod(fmod_one(theta), 1.0f);
  const float half = floor_mod(fmod_half(t), 0.5f);
  const float v = mul(mul(16.0f, half), sub(0.5f, half));
  const float d = mul(16.0f, sub(0.5f, mul(2.0f, half)));
  val = t >= 0.5f ? -v : v;
  dval = t >= 0.5f ? -d : d;
}

// out = A x for A = [[1, 0, a], [0, 1, b], [0, 0, 1]], each row a torch sum
__device__ __forceinline__ void apply_a(float a, float b, const float (&x)[3],
                                        float (&out)[3]) {
  out[0] = sum3(mul(1.0f, x[0]), mul(0.0f, x[1]), mul(a, x[2]));
  out[1] = sum3(mul(0.0f, x[0]), mul(1.0f, x[1]), mul(b, x[2]));
  out[2] = sum3(mul(0.0f, x[0]), mul(0.0f, x[1]), mul(1.0f, x[2]));
}

template <int Q>
__global__ void __launch_bounds__(kWarps * 32)
propagate_kernel(const int2* __restrict__ lanes, const float* __restrict__ x0,
                 const float* __restrict__ scales, float* __restrict__ abar,
                 float* __restrict__ bbar, float* __restrict__ cbar, int B, int T,
                 int tiles, float dt) {
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (gw >= (long long)B * tiles) return;  // a whole warp: the shuffles below see 32 lanes
  const long long b = gw / tiles;
  const int tile = (int)(gw % tiles);
  const long long Tm = 2LL * T;
  const int first = tile * 32 * Q + lane;  // this lane's pair q is first + 32 q
  const float s0 = scales[0], s1 = scales[1];
  float x = x0[3 * b], y = x0[3 * b + 1], th = x0[3 * b + 2];
  // lanes 0-8 carry P_k[e / 3][e % 3] and lanes 9-11 c_k[e - 9] (e = min(lane,
  // 11)): row r of A_k times the column of P_{k-1} (or c_{k-1}) held by
  // lanes src, src + 3, src + 6 (or 9, 10, 11)
  const int e = lane < 12 ? lane : 11;
  const int r = e < 9 ? e / 3 : e - 9;
  const int src = e < 9 ? e % 3 : 9;
  const int step = e < 9 ? 3 : 1;
  float pc = e < 9 && r == e % 3 ? 1.0f : 0.0f;  // P_{-1} = I, c_{-1} = 0
  float S[Q][2][3];  // pair q, column j of the pair, row i
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 3; ++i) S[q][j][i] = 0.0f;
  const int2* lb = lanes + b * T;
  float* bb = bbar + b * T * 3 * Tm;
  float* ab = abar + b * T * 9;
  float* cb = cbar + b * T * 3;
  for (int k0 = 0; k0 < T; k0 += 32) {
    const int2 mine = k0 + lane < T ? lb[k0 + lane] : make_int2(0, 0);
    const int steps = min(32, T - k0);
    for (int kk = 0; kk < steps; ++kk) {
      const int k = k0 + kk;
      // u_phys = f32(lane) * s
      const float v = mul((float)__shfl_sync(0xffffffffu, mine.x, kk), s0);
      const float w = mul((float)__shfl_sync(0xffffffffu, mine.y, kk), s1);
      float cs, dcs, sn, dsn;
      sin_turns(add(th, 0.25f), cs, dcs);
      sin_turns(th, sn, dsn);
      // rollout_f32's step
      const float xn = add(x, mul(mul(v, cs), dt));
      const float yn = add(y, mul(mul(v, sn), dt));
      const float thn = add(th, mul(w, dt));
      // linearize_f32: A_k as above, B_k = [[cs dt, 0], [sn dt, 0], [0, dt]]
      const float a = mul(mul(v, dcs), dt), bq = mul(mul(v, dsn), dt);
      const float b00 = mul(cs, dt), b10 = mul(sn, dt);
      // c_seq = x_{k+1} - A_k x_k - B_k u_k
      const float xs[3] = {x, y, th};
      float ax[3];
      apply_a(a, bq, xs, ax);
      const float cq[3] = {
          sub(sub(xn, ax[0]), add(add(0.0f, mul(b00, v)), mul(0.0f, w))),
          sub(sub(yn, ax[1]), add(add(0.0f, mul(b10, v)), mul(0.0f, w))),
          sub(sub(thn, ax[2]), add(add(0.0f, mul(0.0f, v)), mul(dt, w)))};
      // B_k s, lane-scaled
      const float bl[3][2] = {{mul(b00, s0), mul(0.0f, s1)},
                              {mul(b10, s0), mul(0.0f, s1)},
                              {mul(0.0f, s0), mul(dt, s1)}};
      // P_k = A_k P_{k-1}, c_k = A_k c_{k-1} + c_seq_k, a value a lane
      {
        const float v0 = __shfl_sync(0xffffffffu, pc, src);
        const float v1 = __shfl_sync(0xffffffffu, pc, src + step);
        const float v2 = __shfl_sync(0xffffffffu, pc, src + 2 * step);
        const float a0 = r == 0 ? 1.0f : 0.0f, a1 = r == 1 ? 1.0f : 0.0f;
        const float a2 = r == 0 ? a : (r == 1 ? bq : 1.0f);
        pc = sum3(mul(a0, v0), mul(a1, v1), mul(a2, v2));
        if (e >= 9) pc = add(pc, r == 0 ? cq[0] : (r == 1 ? cq[1] : cq[2]));
      }
      // S_k's live columns: A_k applied to pairs before k, pair k injected
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int p = first + 32 * q;
        if (p < k) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float out[3];
            apply_a(a, bq, S[q][j], out);
#pragma unroll
            for (int i = 0; i < 3; ++i) S[q][j][i] = out[i];
          }
        } else if (p == k) {
          const float zero[3] = {0.0f, 0.0f, 0.0f};
          float out[3];
          apply_a(a, bq, zero, out);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 3; ++i) S[q][j][i] = add(out[i], bl[i][j]);
        }
      }
      // the step's rows of this tile; pairs past k are still +0.0
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float2* row = reinterpret_cast<float2*>(bb + (3LL * k + i) * Tm);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int p = first + 32 * q;
          if (p < T) row[p] = make_float2(S[q][0][i], S[q][1][i]);
        }
      }
      if (tile == 0 && lane < 12) {
        if (lane < 9)
          ab[9LL * k + lane] = pc;
        else
          cb[3LL * k + lane - 9] = pc;
      }
      x = xn;
      y = yn;
      th = thn;
    }
  }
}

template <int Q>
int launch(const void* lanes, const void* x0, const void* scales, void* abar, void* bbar,
           void* cbar, int B, int T, float dt, cudaStream_t stream) {
  const int tiles = (T + 32 * Q - 1) / (32 * Q);
  const long long blocks = ((long long)B * tiles + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  propagate_kernel<Q><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const int2*>(lanes), static_cast<const float*>(x0),
      static_cast<const float*>(scales), static_cast<float*>(abar),
      static_cast<float*>(bbar), static_cast<float*>(cbar), B, T, tiles, dt);
  return (int)cudaGetLastError();
}


// ---- the planar quadrotor ----------------------------------------------------

constexpr int kQuadLanes = 16;  // lanes a problem's tile: two problems a warp

struct QuadConsts {  // PlanarQuadrotor._f32_consts: dt, g, 2 x hover thrust, 2**-torque_shift
  float dt, g, hover2, k;
};

// out = A_k x for the quadrotor's A_k, whose rows are [1 . . dt . .],
// [. 1 . . dt .], [. . 1 . . dt], [. . a3 1 . .], [. . a4 . 1 .] and
// [. . . . . 1]: each row a torch sum from +0.0 of its nonzero products (the
// others are +-0.0 for finite x and change no sum), 1 x exact
__device__ __forceinline__ void apply_quad(float dt, float a3, float a4, const float (&x)[6],
                                           float (&out)[6]) {
  out[0] = add(add(0.0f, x[0]), mul(dt, x[3]));
  out[1] = add(add(0.0f, x[1]), mul(dt, x[4]));
  out[2] = add(add(0.0f, x[2]), mul(dt, x[5]));
  out[3] = add(add(0.0f, mul(a3, x[2])), x[3]);
  out[4] = add(add(0.0f, mul(a4, x[2])), x[4]);
  out[5] = add(0.0f, x[5]);
}

// Q column pairs a lane, kQuadLanes lanes a problem's tile
template <int Q>
__global__ void __launch_bounds__(kWarps * 32)
propagate_quad_kernel(const int2* __restrict__ lanes, const float* __restrict__ x0,
                      const float* __restrict__ scales, float* __restrict__ abar,
                      float* __restrict__ bbar, float* __restrict__ cbar, int B, int T,
                      int tiles, QuadConsts c) {
  constexpr int G = kQuadLanes;
  constexpr int kGroups = kWarps * 32 / G;  // tiles a block
  const int gl = threadIdx.x % G;           // lane in the group
  const long long unit = (long long)blockIdx.x * kGroups + threadIdx.x / G;
  if (unit >= (long long)B * tiles) return;  // a whole group: its shuffles see its G lanes
  const unsigned mask = ((1u << G) - 1u) << ((threadIdx.x & 31) / G * G);
  const long long b = unit / tiles;
  const int tile = (int)(unit % tiles);
  const long long Tm = 2LL * T;
  const int first = tile * G * Q + gl;  // this lane's pair q is first + G q
  const float s0 = scales[0], s1 = scales[1];
  const float dt = c.dt;
  const float b50 = -(dt * c.k), b51 = dt * c.k;  // B_k's last row, exact powers of two
  float st[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) st[i] = x0[6 * b + i];
  // lanes 0-5 carry column gl of P_k (P_{-1} = I), lane 6 carries c_k (c_{-1} = 0)
  float pc[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) pc[i] = i == gl ? 1.0f : 0.0f;
  float S[Q][2][6];  // pair q, column j of the pair, row i
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 6; ++i) S[q][j][i] = 0.0f;
  const int2* lb = lanes + b * T;
  float* bb = bbar + b * T * 6 * Tm;
  float* ab = abar + b * T * 36;
  float* cb = cbar + b * T * 6;
  for (int k0 = 0; k0 < T; k0 += G) {
    const int2 mine = k0 + gl < T ? lb[k0 + gl] : make_int2(0, 0);
    const int steps = min(G, T - k0);
    for (int kk = 0; kk < steps; ++kk) {
      const int k = k0 + kk;
      // u_phys = f32(lane) * s
      const float u0 = mul((float)__shfl_sync(mask, mine.x, kk, G), s0);
      const float u1 = mul((float)__shfl_sync(mask, mine.y, kk, G), s1);
      float sn, dsn, cs, dcs;
      sin_turns(st[2], sn, dsn);
      sin_turns(add(st[2], 0.25f), cs, dcs);
      // rollout_f32's step
      const float total = add(add(c.hover2, u0), u1);
      const float ax = mul(-total, sn);
      const float ay = sub(mul(total, cs), c.g);
      const float dom = mul(sub(u1, u0), c.k);
      const float nx[6] = {add(st[0], mul(st[3], dt)), add(st[1], mul(st[4], dt)),
                           add(st[2], mul(st[5], dt)), add(st[3], mul(ax, dt)),
                           add(st[4], mul(ay, dt)),    add(st[5], mul(dom, dt))};
      // linearize_f32: A_k as above, B_k's rows 3-5 [b3 b3], [b4 b4], [b50 b51]
      const float a3 = mul(mul(total, -dt), dsn), a4 = mul(mul(total, dt), dcs);
      const float b3 = mul(sn, -dt), b4 = mul(cs, dt);
      if (gl < 7) {
        // P_k = A_k P_{k-1}; c_k = A_k c_{k-1} + c_seq_k, c_seq = x_{k+1} - A_k x_k - B_k u_k
        float out[6];
        apply_quad(dt, a3, a4, pc, out);
        if (gl == 6) {
          float axk[6];
          apply_quad(dt, a3, a4, st, axk);
          const float bu[6] = {0.0f, 0.0f, 0.0f, add(add(0.0f, mul(b3, u0)), mul(b3, u1)),
                               add(add(0.0f, mul(b4, u0)), mul(b4, u1)),
                               add(add(0.0f, mul(b50, u0)), mul(b51, u1))};
#pragma unroll
          for (int i = 0; i < 6; ++i) out[i] = add(out[i], sub(sub(nx[i], axk[i]), bu[i]));
        }
#pragma unroll
        for (int i = 0; i < 6; ++i) pc[i] = out[i];
      }
      // S_k's live columns: A_k applied to pairs before k, pair k injected as B_k s
      // (rows 0-2 of B_k are +0.0)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int p = first + G * q;
        if (p < k) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float out[6];
            apply_quad(dt, a3, a4, S[q][j], out);
#pragma unroll
            for (int i = 0; i < 6; ++i) S[q][j][i] = out[i];
          }
        } else if (p == k) {
          S[q][0][3] = add(0.0f, mul(b3, s0));
          S[q][1][3] = add(0.0f, mul(b3, s1));
          S[q][0][4] = add(0.0f, mul(b4, s0));
          S[q][1][4] = add(0.0f, mul(b4, s1));
          S[q][0][5] = add(0.0f, mul(b50, s0));
          S[q][1][5] = add(0.0f, mul(b51, s1));
        }
      }
      // the step's rows of this tile; pairs past k are still +0.0
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float2* row = reinterpret_cast<float2*>(bb + (6LL * k + i) * Tm);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const int p = first + G * q;
          if (p < T) row[p] = make_float2(S[q][0][i], S[q][1][i]);
        }
      }
      if (tile == 0 && gl < 7) {
        if (gl < 6) {
#pragma unroll
          for (int i = 0; i < 6; ++i) ab[36LL * k + 6 * i + gl] = pc[i];
        } else {
          float2* cr = reinterpret_cast<float2*>(cb + 6LL * k);
#pragma unroll
          for (int i = 0; i < 3; ++i) cr[i] = make_float2(pc[2 * i], pc[2 * i + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) st[i] = nx[i];
    }
  }
}

template <int Q>
int launch_quad(const void* lanes, const void* x0, const void* scales, void* abar, void* bbar,
                void* cbar, int B, int T, QuadConsts c, cudaStream_t stream) {
  constexpr int G = kQuadLanes;
  constexpr int kGroups = kWarps * 32 / G;
  const int tiles = (T + G * Q - 1) / (G * Q);
  const long long blocks = ((long long)B * tiles + kGroups - 1) / kGroups;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  propagate_quad_kernel<Q><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const int2*>(lanes), static_cast<const float*>(x0),
      static_cast<const float*>(scales), static_cast<float*>(abar),
      static_cast<float*>(bbar), static_cast<float*>(cbar), B, T, tiles, c);
  return (int)cudaGetLastError();
}

}  // namespace

// lanes (B, 2T) int32, x0 (B, 3) f32, scales (2,) f32 the lane scales, all
// contiguous (lanes 8-byte aligned); writes abar (B, T, 3, 3), bbar (B, T,
// 3, 2T) and cbar (B, T, 3) f32, contiguous.  dt is the model's f32 step.
extern "C" int pint_propagate(const void* lanes, const void* x0, const void* scales,
                              void* abar, void* bbar, void* cbar, int B, int T, float dt,
                              void* stream) {
  if (B <= 0 || T <= 0 || T > INT_MAX / 2 || reinterpret_cast<uintptr_t>(lanes) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const int pairs = (T + 31) / 32;
  switch (pairs < kMaxPairs ? pairs : kMaxPairs) {
    case 1:
      return launch<1>(lanes, x0, scales, abar, bbar, cbar, B, T, dt, strm);
    case 2:
      return launch<2>(lanes, x0, scales, abar, bbar, cbar, B, T, dt, strm);
    case 3:
      return launch<3>(lanes, x0, scales, abar, bbar, cbar, B, T, dt, strm);
    default:
      return launch<4>(lanes, x0, scales, abar, bbar, cbar, B, T, dt, strm);
  }
}

// The planar quadrotor's chain: lanes (B, 2T) int32, x0 (B, 6) f32, scales
// (2,) f32, all contiguous (lanes 8-byte aligned); writes abar (B, T, 6, 6),
// bbar (B, T, 6, 2T) and cbar (B, T, 6) f32, contiguous.  dt, g, hover2 and
// k are PlanarQuadrotor._f32_consts().
extern "C" int pint_propagate_quad(const void* lanes, const void* x0, const void* scales,
                                   void* abar, void* bbar, void* cbar, int B, int T, float dt,
                                   float g, float hover2, float k, void* stream) {
  if (B <= 0 || T <= 0 || T > INT_MAX / 2 || reinterpret_cast<uintptr_t>(lanes) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  const QuadConsts c{dt, g, hover2, k};
  const int pairs = (T + kQuadLanes - 1) / kQuadLanes;
  switch (pairs < kMaxPairs ? pairs : kMaxPairs) {
    case 1:
      return launch_quad<1>(lanes, x0, scales, abar, bbar, cbar, B, T, c, strm);
    case 2:
      return launch_quad<2>(lanes, x0, scales, abar, bbar, cbar, B, T, c, strm);
    case 3:
      return launch_quad<3>(lanes, x0, scales, abar, bbar, cbar, B, T, c, strm);
    default:
      return launch_quad<4>(lanes, x0, scales, abar, bbar, cbar, B, T, c, strm);
  }
}
