// K6: penalty power iteration + int8 quantization of the state-constraint
// rows, one pass over them.
//
// Replaces pint_tpu/mpc/condense_fused.py:198 (_pen_kernel_factory,
// pallas_call at :303 in pen_fused).  Per problem b of S_t (C, Tm, B) f32:
//   v0 = 1/sqrt(Tm); `power_iters` times: w = S v, u = S^T w (each sum over
//   k = j or c as four partial sums, term k to partial k % 4 in order from
//   +0, then (p0 + p1) + (p2 + p3)), v = u * (1 / (|u| + 1e-30))
//   pen_lip = 1.05 * v . (S^T S v)
//   s_scale = max|S| * f32(1/127)       (the reference's max|S| / 127 as
//                                        XLA compiles it)
//   row_amp = 127 * max_c sum_j |S[c, j]|   (sum over j in order)
//   sqc[c, j, b] = sqj[j, c, b] = clip(round_half_even(S[c, j] *
//                  (127 / max(max|S|, 1e-30))), -127, 127) as int8
//                  (NaN to 0, as XLA converts it)
// Every shape the reference's pen_viable takes (C Tm <= 68266).
//
// What bounds it on the H100: 8 KB of f32 a problem at C = 32, Tm = 64 (32
// MB at B = 4096) read once and 4 KB of int8 written: 50 MB, 0.015 ms at
// 3.35 TB/s; the 17 pairs of matvecs are 2.3 GFLOP, 0.034 ms of f32 at 67
// TFLOP/s if every product and sum were one instruction (they are two: no
// FMA, so that the plain version can round the same way).
//
// C <= 32, Tm <= 64 (the main path is 32 x 64; pen_reg_kernel), K3's design
// (csrc/lipq.cu): a block of 8 warps walks pairs of octets of problems (single
// octets when B % 16 != 0) over a persistent grid.  An octet's slab lands in
// one slot as [c j][8] f32 rows (one 32-byte sector a row) by TMA boxes on an
// mbarrier (4-byte cp.async when B % 4 != 0), and the next octet lands while
// the warps iterate: each warp first moves its problem into registers, lane l holding
// columns j = l, l + 32 for every c (read out of the slot) and row c = l for
// every j (the columns transposed through a padded per-warp scratch, free of
// bank conflicts).  A power step then reads only v and w, broadcast float4s
// out of shared memory: lane c sums row c of S v, lane j column j of S^T w,
// each as four partial sums (four chains of dependent additions, not one).
// The int8 rows of a unit (16 or 8 problems) are staged in shared memory, sqc
// from the column registers and sqj from the row registers (consecutive
// lanes on consecutive rows, the words of a row rotated against bank
// conflicts), and go out as 16-byte rows (8 bytes, or bytes, when B % 16 !=
// 0) during the next octet's power steps.
//
// 32 < C <= 64, Tm <= 64 (pen_warp_kernel): a warp a problem out of shared
// memory (see there).
//
// Every other shape (pen_wide_kernel; the long-horizon path runs it at C =
// 128, Tm = 256 and C = 136, Tm = 272): one problem a block, or 2, 4 or 8
// blocks when its slab outgrows the 227 KB a block holds, in clusters of 8
// blocks.  A cluster takes 8 / NS consecutive
// problems at a time: every thread of the cluster loads whole 32-byte
// sectors (16-byte loads: 4 problems' floats of a (c, j) row) of 4 columns
// of a row and sends each problem's 4 floats to the block that owns them
// with one 16-byte store into its shared memory (distributed shared memory),
// so no sector is fetched for one float.  A block holds its problem's slab,
// or its share, as rows of stride 4 (odd) floats: a thread sums a row c of S
// v with 16-byte loads and a column j of S^T w, each as the four partial
// sums.  Past one block the problem is split along its longer side: by rows
// c (S v local, S^T w's partial sums passed on from block to block in c
// order, the last block's v sent to all) or by columns j (S v's partial
// sums passed on in j order and its w sent to all, S^T w local, the norm's
// lane partials passed on in j order), a cluster barrier between the steps.
// Each block writes its int8 rows batch-first into scratch, a warp's 32
// bytes contiguous (8 bytes of a sector written by each of 4 clusters took
// as long as the power steps).  Past 64 rows or columns they stay there and
// the caller hands them to K5 problem-major (batch_first); else
// pen_transpose_kernel turns them batch-last (0.486 ms at 128 x 256, B
// 4096, on one H100 80GB HBM3, before that shape stopped needing it).
//
// Rounding: products and sums use __fmul_rn/__fadd_rn, which nvcc never
// contracts into FMA, and every sum is added in a fixed order (S v and S^T w
// as four partial sums, term k to partial k % 4 in order from +0, then (p0
// + p1) + (p2 + p3); the row sums of |S| in order; the norms as lane-ordered
// partials and an xor butterfly), so the plain PyTorch version (pen_plain),
// which adds in the same order, is bit-identical on every output; the
// quantization rounds half to even like torch.round and jnp.round, and the
// divisions (127 / max|S| and the norm's reciprocal) are IEEE.  A
// reciprocal and a product, not u / |u| a column: on the main path's real
// operands an IEEE division a column took its slow path often enough to
// cost 0.6 us a power step (PERF.md).
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr float kInv127 = (float)(1.0 / 127.0);

// clip(round_half_even(s * scale), -127, 127), and NaN to 0.  Adding 1.5 *
// 2^23 rounds an |x| <= 127 to an integer half to even, which then sits in
// the low bits of the sum.
__device__ __forceinline__ int8_t q8(float s, float scale) {
  const float y = __fmul_rn(s, scale);
  if (y != y) return 0;
  const float x = fminf(fmaxf(y, -127.0f), 127.0f);
  return (int8_t)(__float_as_int(__fadd_rn(x, 12582912.0f)) - 0x4B400000);
}

__device__ __forceinline__ float quant_scale(float sm) {
  return __fdiv_rn(127.0f, sm != sm ? sm : fmaxf(sm, 1e-30f));
}

inline bool aligned(const void* p, int n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// -- C <= 32, Tm <= 64: the slab in registers ---------------------------------

constexpr int kOct = 8;       // problems an octet, one warp each
constexpr int kBoxC = 8;      // rows c a TMA box
constexpr int kScr = 32 * 33; // floats of a warp's transpose scratch

// Word of (row cj, problem w) in an octet slot [cj][8] f32: the two 16-byte
// halves of a row swap on bit 2 of cj (the TMA's 32-byte swizzle).
__device__ __forceinline__ int oct_word(int cj, int w) {
  return cj * 8 + ((((w >> 2) ^ (cj >> 2)) & 1) << 2) + (w & 3);
}

// Byte of (row r, problem p of 16) in an int8 staging [r][16]: the four
// words of a row rotate on bits 3-4 of r, so the byte stores of a warp (one
// problem, 32 consecutive rows) fall on 32 banks.
__device__ __forceinline__ int out_byte(int r, int p) {
  return r * 16 + ((((p >> 2) ^ (r >> 3)) & 3) << 2) + (p & 3);
}

struct RegLayout {
  size_t slot;   // floats: [ceil(C / 8) * 8 * Tm][8]
  size_t obuf;   // bytes of each staging: [C * Tm][16]
  int tm4;       // Tm rounded up to 4 (v's stride)
};

__host__ __device__ inline RegLayout reg_layout(int C, int Tm) {
  RegLayout l;
  l.slot = (size_t)((C + kBoxC - 1) / kBoxC * kBoxC) * Tm * kOct;
  l.obuf = (size_t)C * Tm * 16;
  l.tm4 = (Tm + 3) & ~3;
  return l;
}

// the slot, the sqc and sqj stagings, 8 scratches, 8 x (v, w), the mbarrier
inline size_t reg_smem_bytes(int C, int Tm) {
  const RegLayout l = reg_layout(C, Tm);
  return l.slot * sizeof(float) + 2 * l.obuf +
         (size_t)kOct * (kScr + l.tm4 + 32) * sizeof(float) + sizeof(uint64_t);
}

// NJ = 1 (Tm <= 32) or 2 (Tm <= 64): lane l holds columns l + 32q, q < NJ,
// for every c < C <= 32, and row c = l for every j.  TM, CC: the kernel
// built for Tm = TM and C = CC (64 and 32, the main path: the guards fold
// into constants), 0 for any Tm <= 32 NJ and C <= 32.  tma: thread 0 stages
// an octet with the boxes of `map` (B % 4 == 0, st 16-byte aligned), else
// every thread with 4-byte copies; sw: the int8 rows' store width, 16
// (B % 16 == 0, sqc and sqj 16-byte aligned), 8 (B % 8 == 0) or 1 byte.
template <int NJ, int TM, int CC>
__global__ void __launch_bounds__(kOct * 32, 1)
pen_reg_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ st,
               int8_t* __restrict__ sqc, int8_t* __restrict__ sqj,
               float* __restrict__ lip, float* __restrict__ sscale,
               float* __restrict__ rowamp, int B, int C_arg, int Tm_arg,
               int power_iters, float inv_sqrt, int tma, int sw) {
  constexpr int TK = TM ? TM : 32 * NJ;  // columns j a row holds
  const int Tm = TM ? TM : Tm_arg;
  const int C = CC ? CC : C_arg;
  extern __shared__ __align__(1024) float fsm[];
  const RegLayout lay = reg_layout(C, Tm);
  const int mm = C * Tm;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* slot = fsm;
  unsigned char* oc = reinterpret_cast<unsigned char*>(fsm + lay.slot);  // sqc rows
  unsigned char* oj = oc + lay.obuf;                                     // sqj rows
  float* rest = reinterpret_cast<float*>(oj + lay.obuf);
  float* scr = rest + warp * kScr;                             // [32][33]
  float* v = rest + kOct * kScr + warp * (lay.tm4 + 32);       // [tm4]
  float* w = v + lay.tm4;                                      // [32]
  uint64_t* full = reinterpret_cast<uint64_t*>(rest + kOct * (kScr + lay.tm4 + 32));
  // a unit of work: a pair of octets when its rows go out as 16-byte
  // stores, else one octet (twice the blocks at a small batch)
  const int per = sw == 16 ? 2 : 1;
  const int nunits = (B + kOct * per - 1) / (kOct * per);

  if (threadIdx.x == 0) {
    pint::mbar_init(full, tma ? 1 : kOct * 32);
    pint::mbar_init_fence();
  }
  __syncthreads();

  auto first_of = [&](int s) {  // the s-th octet's first problem, or -1
    const int unit = blockIdx.x + (s / per) * gridDim.x;
    return unit < nunits ? (unit * per + s % per) * kOct : -1;
  };
  auto issue = [&](int s) {
    const int b0 = first_of(s);
    if (b0 < 0) return;
    if (tma) {  // problems past B and rows past C arrive as zeros
      if (threadIdx.x == 0) {
        pint::mbar_expect_tx(full, (uint32_t)(lay.slot * sizeof(float)));
        for (int c0 = 0; c0 < C; c0 += kBoxC)
          pint::tma_load_3d(slot + (size_t)c0 * Tm * kOct, &map, b0, 0, c0, full);
      }
      return;
    }
    for (int i = threadIdx.x; i < mm * kOct; i += kOct * 32) {
      const int cj = i >> 3, b = b0 + (i & 7);
      pint::cp_async4(slot + oct_word(cj, i & 7), b < B ? st + (size_t)cj * B + b : st,
                      b < B);
    }
    pint::cp_async_arrive(full);
  };

  // The int8 rows of a unit wait in oc/oj (pend = its first problem) and go
  // out during the next octet's power steps, a row a thread at a time (a
  // byte a thread at sw = 1, consecutive threads on a row's 8 bytes).
  int pend = -1;
  const int items = sw == 1 ? 2 * mm * kOct : 2 * mm;
  const int rows_per_thread = (items + kOct * 32 - 1) / (kOct * 32);
  auto flush_row = [&](int m) {
    const int i = threadIdx.x + m * kOct * 32;
    int r = sw == 1 ? i / kOct : i;
    const unsigned char* buf = oc;
    int8_t* dst = sqc;
    if (r >= mm) r -= mm, buf = oj, dst = sqj;
    if (r >= mm) return;
    int8_t* row = dst + (size_t)r * B + pend;
    const int rot = (r >> 3) & 3;  // word c of the row sits at c ^ rot
    if (sw == 16) {
      uint4 x = *reinterpret_cast<const uint4*>(buf + r * 16);
      if (rot & 1) x = make_uint4(x.y, x.x, x.w, x.z);
      if (rot & 2) x = make_uint4(x.z, x.w, x.x, x.y);
      __stcs(reinterpret_cast<uint4*>(row), x);  // streaming
    } else if (sw == 8) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(buf + r * 16);
      __stcs(reinterpret_cast<uint2*>(row), make_uint2(w[rot], w[1 ^ rot]));
    } else {
      const int c = i % kOct;
      if (pend + c < B) row[c] = (int8_t)buf[out_byte(r, c)];
    }
  };

  issue(0);
  for (int s = 0;; ++s) {
    const int b0 = first_of(s);
    if (b0 < 0) break;
    const int b = b0 + warp;
    pint::mbar_wait(full, s & 1);
    float hc[NJ][32];  // hc[q][c] = S[c][lane + 32q]
    float sm = 0.0f;
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int j = lane + 32 * q;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        hc[q][c] = c < C && j < Tm ? slot[oct_word(c * Tm + j, warp)] : 0.0f;
        sm = pint::nan_max(sm, fabsf(hc[q][c]));
      }
    }
    __syncthreads();  // every warp holds its slab: the slot is free
    issue(s + 1);

    float hr[TK];  // hr[j] = S[lane][j], the columns transposed through scr
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
#pragma unroll
      for (int c = 0; c < 32; ++c) scr[c * 33 + lane] = hc[q][c];
      __syncwarp();
#pragma unroll
      for (int jl = 0; jl < 32; ++jl)
        if (32 * q + jl < TK) hr[32 * q + jl] = scr[lane * 33 + jl];
      __syncwarp();
    }
    float ra = fabsf(hr[0]);  // row c = lane's sum of |S|, j in order
#pragma unroll
    for (int j = 1; j < TK; ++j)
      if (j < Tm) ra = __fadd_rn(ra, fabsf(hr[j]));
    sm = pint::warp_max(sm);
    ra = pint::warp_max(ra);

#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int j = lane + 32 * q;
      if (j < lay.tm4) v[j] = j < Tm ? inv_sqrt : 0.0f;
    }
    __syncwarp();
    for (int it = 0;; ++it) {
      if (pend >= 0)
        for (int m = it; m < rows_per_thread; m += power_iters + 1) flush_row(m);
      float pw[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // w[lane] = S v: j to partial j % 4
#pragma unroll
      for (int k = 0; k < TK; k += 4) {
        if (k < Tm) {
          const float4 x = *reinterpret_cast<const float4*>(v + k);
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (k + i < Tm) pw[i] = __fadd_rn(pw[i], __fmul_rn(hr[k + i], xs[i]));
        }
      }
      w[lane] = __fadd_rn(__fadd_rn(pw[0], pw[1]), __fadd_rn(pw[2], pw[3]));
      __syncwarp();
      float pu[NJ][4];  // u[q] = (S^T w)[lane + 32q]: c to partial c % 4
#pragma unroll
      for (int q = 0; q < NJ; ++q) pu[q][0] = pu[q][1] = pu[q][2] = pu[q][3] = 0.0f;
#pragma unroll
      for (int c = 0; c < 32; c += 4) {
        if (c < C) {
          const float4 x = *reinterpret_cast<const float4*>(w + c);
          const float ws[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int q = 0; q < NJ; ++q)
              if (c + i < C) pu[q][i] = __fadd_rn(pu[q][i], __fmul_rn(hc[q][c + i], ws[i]));
          }
        }
      }
      float u[NJ];
#pragma unroll
      for (int q = 0; q < NJ; ++q)
        u[q] = __fadd_rn(__fadd_rn(pu[q][0], pu[q][1]), __fadd_rn(pu[q][2], pu[q][3]));
      float part = 0.0f;  // the lane's columns in order, then the butterfly
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
        if (j < Tm)
          part = __fadd_rn(part, it < power_iters ? __fmul_rn(u[q], u[q])
                                                  : __fmul_rn(v[j], u[q]));
      }
      const float sum = pint::warp_sum(part);
      if (it == power_iters) {
        if (lane == 0 && b < B) lip[b] = __fmul_rn(sum, 1.05f);
        break;
      }
      const float rn = __frcp_rn(__fadd_rn(__fsqrt_rn(sum), 1e-30f));
      __syncwarp();
#pragma unroll
      for (int q = 0; q < NJ; ++q)
        if (lane + 32 * q < Tm) v[lane + 32 * q] = __fmul_rn(u[q], rn);
      __syncwarp();
    }

    if (pend >= 0) {  // every row of the waiting unit has been stored
      __syncthreads();
      pend = -1;
    }
    if (lane == 0 && b < B) {
      sscale[b] = __fmul_rn(sm, kInv127);
      rowamp[b] = __fmul_rn(127.0f, ra);
    }
    const float scale = quant_scale(sm);
    const int p = (s % per) * kOct + warp;
#pragma unroll
    for (int q = 0; q < NJ; ++q) {  // sqc rows c Tm + j: lane j, c in order
      const int j = lane + 32 * q;
#pragma unroll
      for (int c = 0; c < 32; ++c)
        if (c < C && j < Tm) oc[out_byte(c * Tm + j, p)] = (unsigned char)q8(hc[q][c], scale);
    }
    if (lane < C) {  // sqj rows j C + c: lane c, j in order
#pragma unroll
      for (int j = 0; j < TK; ++j)
        if (j < Tm) oj[out_byte(j * C + lane, p)] = (unsigned char)q8(hr[j], scale);
    }
    if (s % per == per - 1) pend = b0 - (per - 1) * kOct;  // the unit is staged
  }
  if (pend >= 0) {  // the last unit: nothing left to hide its stores behind
    __syncthreads();
    for (int m = 0; m < rows_per_thread; ++m) flush_row(m);
  }
  pint::cp_async_wait<0>();
}

// The tensor map of S_t as (B, Tm, C) f32, innermost first, boxes of (kOct,
// Tm, kBoxC) in the 32-byte swizzle of oct_word.
cudaError_t encode_map(CUtensorMap* map, const float* st, int B, int C, int Tm) {
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)Tm, (cuuint64_t)C};
  const cuuint64_t strides[2] = {(cuuint64_t)B * sizeof(float),
                                 (cuuint64_t)B * Tm * sizeof(float)};
  const cuuint32_t box[3] = {kOct, (cuuint32_t)Tm, kBoxC};
  return pint_encode_map3d_f32(map, st, dims, strides, box);
}

cudaError_t launch_reg(const float* st, int8_t* sqc, int8_t* sqj, float* lip,
                       float* sscale, float* rowamp, int B, int C, int Tm,
                       int power_iters, float inv_sqrt, cudaStream_t stream) {
  const size_t smem = reg_smem_bytes(C, Tm);
  const int tma = B % 4 == 0 && aligned(st, 16);
  const int sw = B % 16 == 0 && aligned(sqc, 16) && aligned(sqj, 16) ? 16
                 : B % 8 == 0 && aligned(sqc, 8) && aligned(sqj, 8)   ? 8
                                                                      : 1;
  CUtensorMap map{};
  cudaError_t err = tma ? encode_map(&map, st, B, C, Tm) : cudaSuccess;
  if (err != cudaSuccess) return err;
  auto kernel = Tm == 64 && C == 32 ? pen_reg_kernel<2, 64, 32>
                : Tm <= 32          ? pen_reg_kernel<1, 0, 0>
                                    : pen_reg_kernel<2, 0, 0>;
  err = pint_allow_smem(kernel, smem);
  int grid = 0;
  if (err == cudaSuccess)
    err = pint_persistent_grid(kernel, kOct * 32, smem,
                               sw == 16 ? (B + 15) / 16 : (B + kOct - 1) / kOct, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kOct * 32, smem, stream>>>(map, st, sqc, sqj, lip, sscale, rowamp, B,
                                            C, Tm, power_iters, inv_sqrt, tma, sw);
  return cudaGetLastError();
}

// -- 32 < C <= 64, Tm <= 64: a warp a problem out of shared memory ---------

// The register kernel with two rows a lane (2 Tm floats of registers, and
// the columns read out of a copy in shared memory) spilled past Tm 32 and,
// holding 8 problems an SM, read slower than the first design's warp kernel
// at 36 x 30, B = 4096, where it did not.  So these shapes (a 2-row constraint at T = 17-32 is C = Tm = 2T, a 3-row one at T
// = 11-21 C = 3T, Tm = 2T) keep the first design's warp kernel in the order
// above: a block stages 8 consecutive problems' slabs, 8 problems' floats of
// a (c, j) row a sector, into [C][Tm | 1] copies (odd rows: a warp's reads
// of a row and of a column both meet 32 banks), and a warp a problem runs
// the power iteration out of its copy (lane l on rows l and l + 32 of S v
// and columns l and l + 32 of S^T w, each as the four partial sums), about
// 4 blocks an SM at 40 x 40.  It runs while two blocks fit an SM (C Tm <=
// ~3500); at one block an SM the cluster kernel read faster (64 x 64, B =
// 4096; PERF.md).
constexpr int kWarpProbs = 8;  // problems (warps) a block

struct WarpLayout {
  int ps;        // a copy's row stride, odd
  size_t bytes;  // 8 x (copy [C][ps], v [64], w [64]) and 8 scales
};

inline WarpLayout warp_layout(int C, int Tm) {
  WarpLayout l;
  l.ps = Tm | 1;
  l.bytes = ((size_t)kWarpProbs * ((size_t)C * l.ps + 128) + kWarpProbs) * sizeof(float);
  return l;
}

__global__ void __launch_bounds__(kWarpProbs * 32)
pen_warp_kernel(const float* __restrict__ st, int8_t* __restrict__ sqc,
                int8_t* __restrict__ sqj, float* __restrict__ lip,
                float* __restrict__ sscale, float* __restrict__ rowamp, int B, int C,
                int Tm, int power_iters, float inv_sqrt) {
  extern __shared__ __align__(1024) float fsm[];  // pen_reg_kernel's symbol
  const int ps = Tm | 1, slab = C * ps;
  float* s_S = fsm;                                  // 8 x [C][ps]
  float* s_v = s_S + (size_t)kWarpProbs * slab;      // 8 x [64]
  float* s_w = s_v + kWarpProbs * 64;                // 8 x [64]
  float* s_scale = s_w + kWarpProbs * 64;            // 8
  const int b0 = blockIdx.x * kWarpProbs;
  const int nb = min(kWarpProbs, B - b0);
  const int mm = C * Tm;

  for (int i = threadIdx.x; i < mm * kWarpProbs; i += blockDim.x) {
    const int p = i % kWarpProbs, cj = i / kWarpProbs;
    if (p < nb) {
      const int c = cj / Tm;
      s_S[p * slab + c * ps + (cj - c * Tm)] = st[(size_t)cj * B + b0 + p];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < nb) {
    const float* S = s_S + warp * slab;
    float* v = s_v + warp * 64;
    float* w = s_w + warp * 64;
    const int b = b0 + warp;

    float sm = 0.0f, ra = 0.0f;  // max|S|; rows' sums of |S|, j in order
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = lane + 32 * q;
      if (c < C) {
        const float* row = S + c * ps;
        float acc = fabsf(row[0]);
        sm = pint::nan_max(sm, acc);
        for (int j = 1; j < Tm; ++j) {
          const float a = fabsf(row[j]);
          sm = pint::nan_max(sm, a);
          acc = __fadd_rn(acc, a);
        }
        ra = q ? pint::nan_max(ra, acc) : acc;
      }
    }
    sm = pint::warp_max(sm);
    ra = pint::warp_max(ra);

#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (lane + 32 * q < Tm) v[lane + 32 * q] = inv_sqrt;
    float u[2];
    for (int it = 0;; ++it) {
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // w = S v: j to partial j % 4
        const int c = lane + 32 * q;
        if (c < C) {
          const float* row = S + c * ps;
          float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          int j = 0;
#pragma unroll 4
          for (; j + 4 <= Tm; j += 4) {
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = __fadd_rn(p[i], __fmul_rn(row[j + i], v[j + i]));
          }
#pragma unroll
          for (int i = 0; i < 3; ++i)
            if (j + i < Tm) p[i] = __fadd_rn(p[i], __fmul_rn(row[j + i], v[j + i]));
          w[c] = __fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3]));
        }
      }
      __syncwarp();
      float part = 0.0f;  // the lane's columns in order, then the butterfly
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // u = S^T w: c to partial c % 4
        const int j = lane + 32 * q;
        u[q] = 0.0f;
        if (j < Tm) {
          float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          int c = 0;
#pragma unroll 4
          for (; c + 4 <= C; c += 4) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              p[i] = __fadd_rn(p[i], __fmul_rn(S[(c + i) * ps + j], w[c + i]));
          }
#pragma unroll
          for (int i = 0; i < 3; ++i)
            if (c + i < C) p[i] = __fadd_rn(p[i], __fmul_rn(S[(c + i) * ps + j], w[c + i]));
          u[q] = __fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3]));
          part = __fadd_rn(part, it < power_iters ? __fmul_rn(u[q], u[q])
                                                  : __fmul_rn(v[j], u[q]));
        }
      }
      const float sum = pint::warp_sum(part);
      if (it == power_iters) {
        if (lane == 0) lip[b] = __fmul_rn(sum, 1.05f);
        break;
      }
      const float rn = __frcp_rn(__fadd_rn(__fsqrt_rn(sum), 1e-30f));
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (lane + 32 * q < Tm) v[lane + 32 * q] = __fmul_rn(u[q], rn);
    }
    if (lane == 0) {
      sscale[b] = __fmul_rn(sm, kInv127);
      rowamp[b] = __fmul_rn(127.0f, ra);
      s_scale[warp] = quant_scale(sm);
    }
  }
  __syncthreads();

  // both orientations batch-last, 8 problems' bytes of a row together
  for (int i = threadIdx.x; i < mm * kWarpProbs; i += blockDim.x) {
    const int p = i % kWarpProbs, cj = i / kWarpProbs;
    if (p < nb) {
      const int c = cj / Tm;
      sqc[(size_t)cj * B + b0 + p] = q8(s_S[p * slab + c * ps + (cj - c * Tm)], s_scale[p]);
    }
  }
  for (int i = threadIdx.x; i < mm * kWarpProbs; i += blockDim.x) {
    const int p = i % kWarpProbs, jc = i / kWarpProbs;
    if (p < nb) {
      const int j = jc / C;
      sqj[(size_t)jc * B + b0 + p] = q8(s_S[p * slab + (jc - j * C) * ps + j], s_scale[p]);
    }
  }
}

cudaError_t launch_warp(const float* st, int8_t* sqc, int8_t* sqj, float* lip,
                        float* sscale, float* rowamp, int B, int C, int Tm,
                        int power_iters, float inv_sqrt, cudaStream_t stream) {
  const WarpLayout l = warp_layout(C, Tm);
  cudaError_t err = pint_allow_smem(pen_warp_kernel, l.bytes);
  if (err != cudaSuccess) return err;
  pen_warp_kernel<<<(B + kWarpProbs - 1) / kWarpProbs, kWarpProbs * 32, l.bytes, stream>>>(
      st, sqc, sqj, lip, sscale, rowamp, B, C, Tm, power_iters, inv_sqrt);
  return cudaGetLastError();
}

// -- every other shape: a problem a block, or NS blocks of a cluster ---------

constexpr int kCluster = 8;     // blocks a cluster: 8 problems' sectors
constexpr int kWideMax = 512;   // threads a block
constexpr int kMisc = 56;       // floats: red[32], comb[16], sum[8]

// One block's share of a problem split NS ways, along C (rows, a multiple
// of 4 a block) or, when `cols`, along Tm (columns, whole 32-column
// groups), so a block's rows and columns start at a multiple of 4 and its
// partial sums k % 4 are the problem's.  The slab is [rows][ss], ss a
// multiple of 4 with ss / 4 odd (a warp's 16-byte loads of 32 rows' same
// columns meet no bank conflict), then v and u (nv each: Tm, or the block's
// columns), w (nw: the block's rows, or C), the chain of the four partial
// sums (4 nch: Tm, or C) and kMisc floats.
struct WideLayout {
  int ns, cols, rows, ncols, ss, nv, nw, nch, threads;
  size_t v, u, w, ch, misc, bytes;
};

__host__ __device__ inline WideLayout wide_layout(int C, int Tm, int ns, int cols) {
  WideLayout l;
  l.ns = ns;
  l.cols = cols;
  if (cols) {
    l.rows = C;
    l.ncols = 32 * (((Tm + 31) / 32 + ns - 1) / ns);
  } else {
    l.rows = 4 * (((C + ns - 1) / ns + 3) / 4);
    l.ncols = Tm;
  }
  l.ss = 4 * (((l.ncols + 3) / 4) | 1);
  l.nv = (l.ncols + 3) & ~3;
  l.nw = ((cols ? C : l.rows) + 3) & ~3;
  l.nch = ns == 1 ? 0 : cols ? C : l.nv;
  const int big = l.rows > l.ncols ? l.rows : l.ncols;
  l.threads = (big + 31) / 32 * 32;
  if (l.threads > kWideMax) l.threads = kWideMax;
  l.v = (size_t)l.rows * l.ss;
  l.u = l.v + l.nv;
  l.w = l.u + l.nv;
  l.ch = l.w + l.nw;
  l.misc = l.ch + 4 * (size_t)l.nch;
  l.bytes = (l.misc + kMisc) * sizeof(float);
  return l;
}

// The fewest blocks a problem (1, 2, 4 or 8) whose share fits a block,
// split along the longer side; ns = 0 if none.
WideLayout wide_choice(int C, int Tm) {
  for (int ns = 1; ns <= kCluster; ns *= 2) {
    const WideLayout l = wide_layout(C, Tm, ns, ns > 1 && Tm > C);
    if (l.bytes <= kPintMaxSmem) return l;
  }
  WideLayout none{};
  return none;
}

struct PenArgs {
  const float* st;
  int8_t *qcb, *qjb;  // (B, C Tm) and (B, Tm C): the int8 rows batch-first
  float *lip, *sscale, *rowamp;
  int B, C, Tm, power_iters, ns, cols, vec4;
  float inv_sqrt;
};

__device__ __forceinline__ float sum4(const float4 p) {
  return __fadd_rn(__fadd_rn(p.x, p.y), __fadd_rn(p.z, p.w));
}

// the four partial sums p continued over j < n by row[j] * x[j], term j to
// partial j % 4 in order (row and x 16-byte aligned, 4 columns a load)
__device__ __forceinline__ float4 dot4(const float* __restrict__ row,
                                       const float* __restrict__ x, int n, float4 p) {
  const int n4 = n & ~3;
#pragma unroll 8
  for (int j = 0; j < n4; j += 4) {
    const float4 r = *reinterpret_cast<const float4*>(row + j);
    const float4 v = *reinterpret_cast<const float4*>(x + j);
    p.x = __fadd_rn(p.x, __fmul_rn(r.x, v.x));
    p.y = __fadd_rn(p.y, __fmul_rn(r.y, v.y));
    p.z = __fadd_rn(p.z, __fmul_rn(r.z, v.z));
    p.w = __fadd_rn(p.w, __fmul_rn(r.w, v.w));
  }
  if (n4 < n) p.x = __fadd_rn(p.x, __fmul_rn(row[n4], x[n4]));
  if (n4 + 1 < n) p.y = __fadd_rn(p.y, __fmul_rn(row[n4 + 1], x[n4 + 1]));
  if (n4 + 2 < n) p.z = __fadd_rn(p.z, __fmul_rn(row[n4 + 2], x[n4 + 2]));
  return p;
}

// the four partial sums p continued over rows r < n of column j by
// S[r][j] * w[r] (row stride ss), term r to partial r % 4 in order
__device__ __forceinline__ float4 col4(const float* __restrict__ S, int ss, int j,
                                       const float* __restrict__ w, int n, float4 p) {
  const int n4 = n & ~3;
  const float* s = S + j;
#pragma unroll 8
  for (int r = 0; r < n4; r += 4, s += 4 * ss) {
    const float4 x = *reinterpret_cast<const float4*>(w + r);
    p.x = __fadd_rn(p.x, __fmul_rn(s[0], x.x));
    p.y = __fadd_rn(p.y, __fmul_rn(s[ss], x.y));
    p.z = __fadd_rn(p.z, __fmul_rn(s[2 * ss], x.z));
    p.w = __fadd_rn(p.w, __fmul_rn(s[3 * ss], x.w));
  }
  if (n4 < n) p.x = __fadd_rn(p.x, __fmul_rn(s[0], w[n4]));
  if (n4 + 1 < n) p.y = __fadd_rn(p.y, __fmul_rn(s[ss], w[n4 + 1]));
  if (n4 + 2 < n) p.z = __fadd_rn(p.z, __fmul_rn(s[2 * ss], w[n4 + 2]));
  return p;
}

// acc continued (or, with start, begun by the first term) over j < n in
// order by |row[j]|, and *sm = max(*sm, |row[j]|)
__device__ __forceinline__ float abs_on(const float* __restrict__ row, int n, float acc,
                                        bool start, float* sm) {
  const int n4 = n & ~3;
  int j = 0;
  float m = *sm;
#pragma unroll 4
  for (; j < n4; j += 4) {
    const float4 r = *reinterpret_cast<const float4*>(row + j);
    const float a[4] = {fabsf(r.x), fabsf(r.y), fabsf(r.z), fabsf(r.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = start && j + i == 0 ? a[i] : __fadd_rn(acc, a[i]);
      m = pint::nan_max(m, a[i]);
    }
  }
  for (; j < n; ++j) {
    const float a = fabsf(row[j]);
    acc = start && j == 0 ? a : __fadd_rn(acc, a);
    m = pint::nan_max(m, a);
  }
  *sm = m;
  return acc;
}

__global__ void __launch_bounds__(kWideMax) pen_wide_kernel(const PenArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int B = a.B, C = a.C, Tm = a.Tm, ns = a.ns, P = kCluster / ns;
  const WideLayout L = wide_layout(C, Tm, ns, a.cols);
  extern __shared__ __align__(1024) float fsm[];  // pen_reg_kernel's symbol
  float* S = fsm;
  float* v = fsm + L.v;
  float* u = fsm + L.u;
  float* w = fsm + L.w;
  float4* ch = reinterpret_cast<float4*>(fsm + L.ch);  // the partial sums' chain
  float* red = fsm + L.misc;  // [32]
  float* comb = red + 32;     // [2 ns]: each part's max|S| and row-sum max
  float* ssum = comb + 16;    // the norm
  const int pslot = rank / ns, part = rank % ns;
  const int t = threadIdx.x, T = blockDim.x, lane = t & 31, warp = t >> 5;
  const bool cols = a.cols;
  // this block's rows [c0, c0 + nrow) and columns [j0, j0 + ncol)
  const int c0 = cols ? 0 : part * L.rows, j0 = cols ? part * L.ncols : 0;
  const int nrow = cols ? C : max(0, min(L.rows, C - c0));
  const int ncol = cols ? max(0, min(L.ncols, Tm - j0)) : Tm;
  const int ss = L.ss, mm = C * Tm;
  // whole quads of columns: 16-byte moves through distributed shared memory
  const bool quad = Tm % 4 == 0;
  auto remote = [&](float* p, int r) {  // p in block r of the cluster
    return r == rank ? p : cluster.map_shared_rank(p, r);
  };
  auto peer = [&](auto* p, int q) {  // p in part q of this problem
    return q == part ? p : cluster.map_shared_rank(p, pslot * ns + q);
  };
  auto csync = [&] {  // a barrier over the blocks of a problem
    if (ns == 1)
      __syncthreads();
    else
      cluster.sync();
  };
  // where element (c, j) of a problem lives: its part and its slab index
  auto owner = [&](int c, int j, int* li) {
    if (cols) {
      const int q = j / L.ncols;
      *li = c * ss + (j - q * L.ncols);
      return q;
    }
    const int q = c / L.rows;
    *li = (c - q * L.rows) * ss + j;
    return q;
  };
  const int gt = rank * T + t, gT = kCluster * T;
  const int nclusters = gridDim.x / kCluster;
  const int nq = quad ? mm / 4 : mm;  // work items: quads of a row, or elements
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int base = (blockIdx.x / kCluster) * P; base < B; base += nclusters * P) {
    const int b = base + pslot;
    const bool valid = b < B;
    cluster.sync();  // the last round's readers are done with every slab

    // the cluster's P problems, whole sectors: each (c, j) row's P floats,
    // 4 columns of a row at a time, each problem's 4 to the block that owns
    // them in one 16-byte store
    for (int i = gt; i < nq; i += gT) {
      const int e = quad ? 4 * i : i;
      const int nr = quad ? 4 : 1;
      float x[4][kCluster];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* src = a.st + (size_t)(e + (r < nr ? r : 0)) * B + base;
        if (a.vec4) {
#pragma unroll
          for (int h = 0; h < kCluster / 4; ++h) {
            float4 f = zero4;
            if (r < nr && 4 * h < P && base + 4 * h < B)
              f = *reinterpret_cast<const float4*>(src + 4 * h);
            x[r][4 * h] = f.x, x[r][4 * h + 1] = f.y, x[r][4 * h + 2] = f.z,
            x[r][4 * h + 3] = f.w;
          }
        } else {
#pragma unroll
          for (int p = 0; p < kCluster; ++p)
            x[r][p] = r < nr && p < P && base + p < B ? src[p] : 0.0f;
        }
      }
      int li;
      const int q = owner(e / Tm, e % Tm, &li);
#pragma unroll
      for (int p = 0; p < kCluster; ++p) {
        if (p < P && base + p < B) {
          float* dst = remote(S + li, p * ns + q);
          if (quad)
            *reinterpret_cast<float4*>(dst) = make_float4(x[0][p], x[1][p], x[2][p], x[3][p]);
          else
            *dst = x[0][p];
        }
      }
    }
    cluster.sync();  // every slab is complete

    // max |S| and the largest row sum of |S| (j in order; by columns the
    // row sums continue from part to part)
    float sm = 0.0f, ra = 0.0f;
    float* rs = reinterpret_cast<float*>(ch);  // the row sums' chain
    for (int ph = 0; ph < (cols ? ns : 1); ++ph) {
      if ((!cols || part == ph) && valid) {
        const bool start = !cols || ph == 0;
        for (int r = t; r < nrow; r += T) {
          const float acc = abs_on(S + r * ss, ncol, start ? 0.0f : rs[r], start, &sm);
          if (cols && ph < ns - 1)
            peer(rs, ph + 1)[r] = acc;
          else
            ra = pint::nan_max(ra, acc);
        }
      }
      if (cols) csync();
    }
    sm = pint::warp_max(sm);
    ra = pint::warp_max(ra);
    if (lane == 0) red[warp] = sm, red[16 + warp] = ra;
    __syncthreads();
    if (t == 0) {
      for (int q = 1; q < T / 32; ++q) sm = pint::nan_max(sm, red[q]);
      for (int q = 1; q < T / 32; ++q) ra = pint::nan_max(ra, red[16 + q]);
      for (int q = 0; q < ns; ++q) {
        float* cb = peer(comb, q);
        cb[2 * part] = sm;
        cb[2 * part + 1] = ra;
      }
    }
    csync();
    sm = comb[0], ra = comb[1];
    for (int q = 1; q < ns; ++q) {
      sm = pint::nan_max(sm, comb[2 * q]);
      ra = pint::nan_max(ra, comb[2 * q + 1]);
    }
    if (part == 0 && t == 0 && valid) {
      a.sscale[b] = __fmul_rn(sm, kInv127);
      a.rowamp[b] = __fmul_rn(127.0f, ra);
    }

    // the power iteration
    for (int j = t; j < L.nv; j += T) v[j] = j < (cols ? ncol : Tm) ? a.inv_sqrt : 0.0f;
    __syncthreads();
    for (int it = 0;; ++it) {
      float sum;
      if (!cols) {
        if (valid) {  // w = S v over this block's rows
          for (int r = t; r < nrow; r += T) w[r] = sum4(dot4(S + r * ss, v, Tm, zero4));
        }
        __syncthreads();
        for (int ph = 0; ph < ns; ++ph) {  // u = S^T w, over the parts in c order
          if (part == ph && valid) {
            for (int j = t; j < Tm; j += T) {
              const float4 p = col4(S, ss, j, w, nrow, ph ? ch[j] : zero4);
              if (ph < ns - 1)
                peer(ch, ph + 1)[j] = p;
              else
                u[j] = sum4(p);
            }
          }
          csync();
        }
        if (part == ns - 1 && valid && warp == 0) {  // the norm: the last part
          float pt = 0.0f;  // lane's columns in order, then the butterfly
          for (int j = lane; j < Tm; j += 32)
            pt = __fadd_rn(pt, it < a.power_iters ? __fmul_rn(u[j], u[j])
                                                   : __fmul_rn(v[j], u[j]));
          pt = pint::warp_sum(pt);
          if (lane == 0) ssum[0] = pt;
        }
        __syncthreads();
        sum = ssum[0];
        if (it == a.power_iters) {
          if (part == ns - 1 && valid && t == 0) a.lip[b] = __fmul_rn(sum, 1.05f);
          break;
        }
        if (part == ns - 1 && valid) {  // the new v, into every part
          const float rn = __frcp_rn(__fadd_rn(__fsqrt_rn(sum), 1e-30f));
          for (int j = t; j < Tm; j += T) {
            const float x = __fmul_rn(u[j], rn);
            for (int q = 0; q < ns; ++q) peer(v, q)[j] = x;
          }
        }
        csync();
      } else {
        for (int ph = 0; ph < ns; ++ph) {  // w = S v, over the parts in j order
          if (part == ph && valid) {
            for (int c = t; c < C; c += T) {
              const float4 p = dot4(S + c * ss, v, ncol, ph ? ch[c] : zero4);
              if (ph < ns - 1) {
                peer(ch, ph + 1)[c] = p;
              } else {
                const float x = sum4(p);
                for (int q = 0; q < ns; ++q) peer(w, q)[c] = x;
              }
            }
          }
          csync();
        }
        if (valid) {  // u = S^T w over this block's columns
          for (int j = t; j < ncol; j += T) u[j] = sum4(col4(S, ss, j, w, C, zero4));
        }
        __syncthreads();
        for (int ph = 0; ph < ns; ++ph) {  // the norm's lane partials over the parts
          if (part == ph && valid && warp == 0) {
            float pt = ph == 0 ? 0.0f : red[lane];
            for (int j = lane; j < ncol; j += 32)
              pt = __fadd_rn(pt, it < a.power_iters ? __fmul_rn(u[j], u[j])
                                                     : __fmul_rn(v[j], u[j]));
            if (ph < ns - 1) {
              peer(red, ph + 1)[lane] = pt;
            } else {
              pt = pint::warp_sum(pt);
              if (lane == 0)
                for (int q = 0; q < ns; ++q) peer(ssum, q)[0] = pt;
            }
          }
          csync();
        }
        sum = ssum[0];
        if (it == a.power_iters) {
          if (part == 0 && valid && t == 0) a.lip[b] = __fmul_rn(sum, 1.05f);
          break;
        }
        const float rn = __frcp_rn(__fadd_rn(__fsqrt_rn(sum), 1e-30f));
        for (int j = t; j < ncol; j += T) v[j] = __fmul_rn(u[j], rn);
        __syncthreads();
      }
    }
    // the int8 rows of this block's share of its problem, batch-first: bytes
    // b mm + c Tm + j of qcb and b mm + j C + c of qjb, a warp's 32 bytes
    // consecutive (the transpose to batch-last is pen_transpose_kernel)
    if (valid) {
      const float scale = quant_scale(sm);
      int8_t* qc = a.qcb + (size_t)b * mm;
      int8_t* qj = a.qjb + (size_t)b * mm;
      const int nw = T / 32;
      for (int r = warp; r < nrow; r += nw)
        for (int j = lane; j < ncol; j += 32)
          qc[(size_t)(c0 + r) * Tm + j0 + j] = q8(S[r * ss + j], scale);
      for (int j = warp; j < ncol; j += nw)
        for (int r = lane; r < nrow; r += 32)
          qj[(size_t)(j0 + j) * C + c0 + r] = q8(S[r * ss + j], scale);
    }
  }
  cluster.sync();  // no block leaves while another may still read from it
}

// y (n, B) = x (B, n) transposed, bytes, for the two arrays (blockIdx.z):
// tiles of 64 x 64 through shared memory, a warp's loads and stores 32
// consecutive bytes.
constexpr int kTile = 64;

__global__ void __launch_bounds__(256)
pen_transpose_kernel(const int8_t* __restrict__ x0, int8_t* __restrict__ y0,
                     const int8_t* __restrict__ x1, int8_t* __restrict__ y1, int B,
                     int n) {
  __shared__ int8_t tile[kTile][kTile + 1];
  const int8_t* x = blockIdx.z ? x1 : x0;
  int8_t* y = blockIdx.z ? y1 : y0;
  const int n0 = blockIdx.x * kTile, b0 = blockIdx.y * kTile;
  const int t = threadIdx.x, lo = t % kTile, hi = t / kTile;
  for (int k = hi; k < kTile; k += 256 / kTile) {
    const int b = b0 + k, i = n0 + lo;
    tile[k][lo] = b < B && i < n ? x[(size_t)b * n + i] : 0;
  }
  __syncthreads();
  for (int k = hi; k < kTile; k += 256 / kTile) {
    const int i = n0 + k, b = b0 + lo;
    if (i < n && b < B) y[(size_t)i * B + b] = tile[lo][k];
  }
}

// scratch: 2 B C Tm bytes for the batch-first int8 rows, which stay there
// (batch_first: the caller hands them over problem-major) or which
// pen_transpose_kernel writes batch-last into sqc and sqj
cudaError_t launch_wide(const float* st, int8_t* sqc, int8_t* sqj, float* lip,
                        float* sscale, float* rowamp, int8_t* scratch, int B, int C,
                        int Tm, int power_iters, float inv_sqrt, bool batch_first,
                        cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const WideLayout L = wide_choice(C, Tm);
  if (L.ns == 0) return cudaErrorInvalidValue;
  cudaError_t err = pint_allow_smem(pen_wide_kernel, L.bytes);
  if (err != cudaSuccess) return err;
  // clusters of 8 blocks: whole 32-byte sectors of 8 problems (2-block
  // clusters kept more blocks resident and took 7.21 ms against 3.34 at C
  // 128 x Tm 256, B = 4096 on one H100 80GB HBM3; PERF.md)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(L.threads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0, sms = 0, active = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // as many clusters as may be resident at once, and no more than rounds
  cfg.gridDim = dim3(kCluster * sms);
  err = cudaOccupancyMaxActiveClusters(&active, pen_wide_kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (active < 1) return cudaErrorInvalidConfiguration;
  const int P = kCluster / L.ns, rounds = (B + P - 1) / P;
  const size_t mm = (size_t)C * Tm;
  // 16-byte loads of 4 problems' floats: P >= 4 and B % 4 == 0
  PenArgs args{st, scratch, scratch + (size_t)B * mm, lip, sscale, rowamp, B, C, Tm,
               power_iters, L.ns, L.cols, P >= 4 && B % 4 == 0 && aligned(st, 16),
               inv_sqrt};
  const dim3 grid((unsigned)((mm + kTile - 1) / kTile), (B + kTile - 1) / kTile, 2);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cfg.gridDim = dim3(kCluster * (rounds < active ? rounds : active));
  err = cudaLaunchKernelEx(&cfg, pen_wide_kernel, args);
  if (err != cudaSuccess || batch_first) return err;
  pen_transpose_kernel<<<grid, 256, 0, stream>>>(args.qcb, sqc, args.qjb, sqj, B, (int)mm);
  return cudaGetLastError();
}

}  // namespace

namespace {

// the register kernel, the warp kernel, else the cluster kernel
enum class PenPath { reg, warp, wide };

PenPath pen_path(int C, int Tm) {
  if (C <= 32 && Tm <= 64) return PenPath::reg;
  if (C <= 64 && Tm <= 64 && warp_layout(C, Tm).bytes <= kPintMaxSmem / 2)
    return PenPath::warp;
  return PenPath::wide;
}

}  // namespace

// Bytes of scratch pint_pen needs at this shape: the cluster kernel's.
extern "C" long long pint_pen_scratch(int B, int C, int Tm) {
  return pen_path(C, Tm) == PenPath::wide ? 2LL * B * C * Tm : 0;
}

// The reference's pen_viable: 2 (C Tm 128 6) <= 100 MiB.  batch_first
// (the cluster kernel only): the int8 rows stay batch-first in scratch, sqc
// = scratch (B, C, Tm) and sqj = scratch + B C Tm (B, Tm, C), which the
// caller hands over problem-major; else they are written batch-last.
extern "C" int pint_pen(const void* st, void* sqc, void* sqj, void* lip,
                        void* sscale, void* rowamp, void* scratch, int B, int C, int Tm,
                        int power_iters, int batch_first, void* stream) {
  if (B <= 0 || C <= 0 || Tm <= 0 || power_iters < 0 ||
      (long long)C * Tm * 1536 > 100LL * (1 << 20) ||
      (batch_first && pen_path(C, Tm) != PenPath::wide))
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
  const PenPath path = pen_path(C, Tm);
  if (path == PenPath::reg)
    return (int)launch_reg(s, qc, qj, l, sc, ra, B, C, Tm, power_iters, inv_sqrt, strm);
  if (path == PenPath::warp)
    return (int)launch_warp(s, qc, qj, l, sc, ra, B, C, Tm, power_iters, inv_sqrt, strm);
  return (int)launch_wide(s, qc, qj, l, sc, ra, static_cast<int8_t*>(scratch), B, C, Tm,
                          power_iters, inv_sqrt, batch_first != 0, strm);
}
