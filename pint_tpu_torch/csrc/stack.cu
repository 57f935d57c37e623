// An SQP iteration's constraint stacking, in one launch: the rows of the
// state constraints lo <= F x_k <= hi from the propagator stacks the
// recursion writes (contiguous, batch-first), Abar (B, T, n, n), Bbar (B, T,
// n, Tm) and Cbar (B, T, n), and F (Cs, n), batch-last as K6 and the torch
// forms after it read them:
//   S_t (C, Tm, B)  S_t[k Cs + c, j, b] = sum_i F[c, i] Bbar[b, k, i, j]
//   P_t (C, n, B)   P_t[k Cs + c, q, b] = sum_i F[c, i] Abar[b, k, i, q]
//   r_t (C, B)      r_t[k Cs + c, b]    = sum_i F[c, i] Cbar[b, k, i]
// with C = T Cs.  Its plain version is mpc/stack.py's stack_plain.
//
// Replaces no Pallas kernel: the reference stacks the rows with XLA jnp
// (pint_tpu/mpc/device_constrained.py, _stack_constraints).  The torch form
// that ported it (two einsums, their permuted copies and a .contiguous())
// moved Bbar about five times over.
//
// Rounding, bit for bit with stack_plain on the card.  Every product and sum
// is __fmul_rn / __fadd_rn, which nvcc's default --fmad=true does not
// contract: each product is rounded alone, and a sum starts from the first
// product and adds the others in index order over i.  Every row of Bbar is
// read and multiplied, where F is zero too, so a NaN or an infinity anywhere
// in a problem's stacks reaches its rows as in the plain version; the dead
// columns j >= (k + 1) m, zero in the recursion's stacks, are read like the
// others for the same reason (the torch chain leaves NaN there for a
// non-finite state).
//
// What bounds it on the H100 (utils/profiling.kernel_cost("stack")): its
// bytes, Bbar, Abar and Cbar read once and S_t, P_t and r_t written once,
// 4 (n T Tm + n^2 T + n T) + 4 Cs T (Tm + n + 1) bytes a problem: 2.18 GB
// at T 128 (Tm 256), B 4096 and Cs 1, 0.65 ms at 3.35 TB/s; 0.043 / 0.170
// ms at T 32, B 4096 / 16384; 0.021 ms for the quadrotor (n 6) at T 16.
// Its arithmetic, 2n - 1 roundings an output, is far below the card's rate.
//
// Design: a transposition, the batch moving from outermost to innermost.  A
// block of 256 threads takes 32 problems at one step k and U tiles of 32
// columns j (U = 2 where Tm has two, else 1): a warp reads 4 problems' rows
// of Bbar, 8 lanes a row and 16 bytes a lane, so each (problem, row) of a
// tile is one whole 128-byte line, and every lane holds its n rows of 4
// columns of each tile in registers, all U n loads issued before the first
// is used; it forms the Cs dot products there and stages them in shared
// memory, (c, j, problem) with rows padded to 33 floats, so that the writes
// and the reads of a warp meet distinct banks.  Then each warp writes 4 U of
// the (c, j) rows, S_t[k Cs + c, j, b0 .. b0 + 31], 128 contiguous bytes,
// whole 32-byte sectors.  The blocks of the first column tiles also write
// P_t and r_t: warp q < n forms column q of P for its lane's problem, warp
// n forms r (a few per cent of the bytes).  F arrives as a kernel argument,
// its loops unrolled to kMaxRows so that every coefficient is a
// constant-bank operand.  On one H100 (PERF.md), two tiles a block and plain
// loads took 0.75 ms at T 128 against 0.82 ms for one tile, and at the
// quadrotor's Tm 32 (one tile) the streaming load (__ldcs) 0.023 ms against
// 0.029 ms for a plain one: so U = 1 streams and U = 2 does not.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kProblems = 32;   // problems a block: a store of a (c, j) row is 128 bytes
constexpr int kCols = 32;       // columns of a tile: 8 lanes of 16 bytes a row
constexpr int kPitch = kProblems + 1;  // floats of a staged (c, j) row
constexpr int kMaxRows = 8;     // Cs
constexpr int kMaxStates = 6;   // n

struct Args {
  const float* abar;
  const float* bbar;
  const float* cbar;
  float* st;
  float* pt;
  float* rt;
  float f[kMaxRows][kMaxStates];  // F[c][i]
  int B, T, Tm, cs;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// sum_i F[c, i] x[i]: each product rounded, added from the first in order
template <int N>
__device__ __forceinline__ float frow(const Args& a, int c, const float (&x)[N]) {
  float s = mul(a.f[c][0], x[0]);
#pragma unroll
  for (int i = 1; i < N; ++i) s = add(s, mul(a.f[c][i], x[i]));
  return s;
}

template <int N, int U>
__global__ void __launch_bounds__(kThreads) stack_rows_kernel(const __grid_constant__ Args a) {
  constexpr int W = U * kCols;     // columns of Bbar a block
  extern __shared__ float tile[];  // [cs][W][kPitch]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long b0 = (long long)blockIdx.x * kProblems;
  const int k = blockIdx.y, j0 = blockIdx.z * W;
  const long long B = a.B;
  const int T = a.T, Tm = a.Tm;

  // this lane's problem and columns jl .. jl + 3 of each 32-column tile u:
  // U n loads of 16 bytes, all issued before any is used
  const int p = warp * 4 + lane / 8, jl = (lane % 8) * 4;
  const long long b = b0 + p;
  const float* src = a.bbar + ((b * T + k) * N) * (long long)Tm + j0 + jl;
  float4 v[U][N];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (b < B && j0 + kCols * u + jl < Tm) {  // Tm % 4 == 0: 4 columns all in or all out
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float4* q = reinterpret_cast<const float4*>(src + (long long)i * Tm + kCols * u);
        v[u][i] = U == 1 ? __ldcs(q) : *q;
      }
    }

  // P_t and r_t: warp q < n column q of P, warp n r; a lane a problem
  if (blockIdx.z == 0 && warp <= N && b0 + lane < B) {
    const long long bb = b0 + lane;
    float x[N];
    if (warp < N) {
      const float* s = a.abar + (bb * T + k) * N * N + warp;
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = s[i * N];
    } else {
      const float* s = a.cbar + (bb * T + k) * N;
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = s[i];
    }
#pragma unroll
    for (int c = 0; c < kMaxRows; ++c) {
      if (c >= a.cs) break;
      const long long row = (long long)k * a.cs + c;
      const float s = frow<N>(a, c, x);
      if (warp < N)
        a.pt[(row * N + warp) * B + bb] = s;
      else
        a.rt[row * B + bb] = s;
    }
  }

#pragma unroll
  for (int u = 0; u < U; ++u)
    if (b < B && j0 + kCols * u + jl < Tm) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x[N];
#pragma unroll
        for (int i = 0; i < N; ++i)
          x[i] = e == 0 ? v[u][i].x : e == 1 ? v[u][i].y : e == 2 ? v[u][i].z : v[u][i].w;
#pragma unroll
        for (int c = 0; c < kMaxRows; ++c) {
          if (c >= a.cs) break;
          tile[(c * W + kCols * u + jl + e) * kPitch + p] = frow<N>(a, c, x);
        }
      }
    }
  __syncthreads();

  // warp w writes rows j = w W / 8 .. (w + 1) W / 8 - 1 of each c, lane = problem
  if (b0 + lane < B) {
    for (int c = 0; c < a.cs; ++c) {
      float* dst = a.st + ((long long)k * a.cs + c) * Tm * B + b0 + lane;
#pragma unroll
      for (int r = 0; r < W / 8; ++r) {
        const int j = warp * (W / 8) + r;
        if (j0 + j < Tm) dst[(long long)(j0 + j) * B] = tile[(c * W + j) * kPitch + lane];
      }
    }
  }
}

template <int N, int U>
int launch(const Args& a, cudaStream_t stream) {
  const long long tiles = ((long long)a.B + kProblems - 1) / kProblems;
  const int cols = (a.Tm + U * kCols - 1) / (U * kCols);
  if (tiles > INT_MAX || a.T > 65535 || cols > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)a.cs * U * kCols * kPitch * sizeof(float);
  const cudaError_t err = pint_allow_smem(stack_rows_kernel<N, U>, smem);
  if (err != cudaSuccess) return (int)err;
  stack_rows_kernel<N, U><<<dim3((unsigned)tiles, a.T, cols), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// two column tiles a block where Tm has them, else one
template <int N>
int launch_n(const Args& a, cudaStream_t stream) {
  return a.Tm >= 2 * kCols ? launch<N, 2>(a, stream) : launch<N, 1>(a, stream);
}

}  // namespace

// abar (B, T, n, n), bbar (B, T, n, Tm), cbar (B, T, n) f32 and contiguous,
// bbar 16-byte aligned; f (cs, n) f32 on the host, row-major; writes st (T
// cs, Tm, B), pt (T cs, n, B) and rt (T cs, B).  n 1 to 6, cs 1 to 8, Tm a
// multiple of 4, T and Tm / 32 to 65535.
extern "C" int pint_stack(const void* abar, const void* bbar, const void* cbar, const void* f,
                          void* st, void* pt, void* rt, int B, int T, int n, int Tm, int cs,
                          void* stream) {
  if (B <= 0 || T <= 0 || Tm <= 0 || Tm % 4 != 0 || cs < 1 || cs > kMaxRows || n < 1 ||
      n > kMaxStates || reinterpret_cast<uintptr_t>(bbar) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(abar), static_cast<const float*>(bbar),
         static_cast<const float*>(cbar), static_cast<float*>(st),
         static_cast<float*>(pt), static_cast<float*>(rt), {}, B, T, Tm, cs};
  const float* fh = static_cast<const float*>(f);
  for (int c = 0; c < cs; ++c)
    for (int i = 0; i < n; ++i) a.f[c][i] = fh[c * n + i];
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
