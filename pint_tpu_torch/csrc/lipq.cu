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
// Bound on the H100 at the main-path shape (B = 4096, Tm = 64, 16 power
// steps): 67.1 MB of Ht read once and 16.8 MB of hqt written once, 83.9 MB
// over 3.35 TB/s = 0.025 ms; 17 x 2 x Tm^2 x B = 0.57 GFLOP of f32 over 67
// TFLOP/s = 0.0085 ms.  Memory sets the bound.
//
// The first design (0.517 ms) staged a block's 8 problems with one 4-byte
// load a thread, consecutive threads on consecutive problems: about 1 KB in
// flight per SM, 133 KB of shared memory for 8 warps, one block an SM, and
// an 8-way bank conflict on every staging store.  Loading and the power
// iteration never overlapped.
//
// This design, for Tm <= 64 (the main path; lipq_reg_kernel):
// * A block of 8 warps takes an octet of 8 consecutive problems at a time,
//   pairs of octets in turn (16 consecutive problems).  The octet's slab
//   lands as [kj][8] f32, 32 contiguous bytes a row kj, by TMA: thread 0
//   asks for ceil(Tm / 8) boxes of the (B, Tm, Tm) tensor map and they count
//   their bytes down on an mbarrier, so no warp spends instructions or
//   registers on the copy.  A ragged batch (B % 4 != 0: rows not 16-byte
//   aligned, which TMA needs) takes 4-byte cp.async copies from every thread,
//   zero-filled past the batch, in the same swizzled layout.
// * Each warp moves its problem's slab from the slot into registers (lane l
//   holds rows l and l + 32 for every k: 128 registers at Tm = 64), so the
//   slot is free again at once and the next octet lands while the warps
//   iterate; the power steps read only v, a broadcast float4 a 4 k.  The
//   arithmetic is the first design's: lane j % 32 owns rows j, each k sum in
//   order with __fmul_rn/__fadd_rn, the lane's rows in order and then the
//   xor butterfly, so hqt, hmax and lip are bit-identical to lipq_plain.
// * The int8 result of both octets of a pair is staged as [kj][16] (words of
//   a row rotated on kj so the byte stores of a warp meet no bank conflict)
//   and written with one 16-byte store a row kj (B % 16 == 0), else bytes,
//   spread over the next octet's power steps so the stores drain while the
//   warps compute.
// For 64 < Tm <= 224 (lipq_kernel): quads of 4 problems (or single
// problems past Tm = 118) in a ring of up to 3 shared-memory slots with 2
// groups of warps, thread j holding row j of the quad, so the next quad lands
// while both groups iterate on theirs.  For 224 < Tm <= 286 (the reference's
// lipq_viable; T = 128 at two controls is Tm = 256, the long-horizon path)
// one problem's f32 slab no longer fits the 227 KB a block may hold: the
// first krows rows k of the slab land in one shared-memory slot as before and
// thread j holds H[k][j] for the remaining k (at most kRegRows) in registers,
// loaded once a problem; the matvec adds the shared rows and then the
// register rows, k still in order, so the result stays bit-identical.
//
// What holds it above the bound (PERF.md): at 0 power steps the kernel
// already takes three quarters of its time at 16, so staging, moving the
// slab into registers (4-way bank conflicts: a warp reads one word of 32
// rows of 32 bytes) and the int8 stores cost more than the 17 dependent
// matvecs.  The first octet's load is not hidden, and it reads each
// 128-byte line of a row for half of its bytes (the pair's other octet
// follows later, from L2).  An earlier version of this design staged by
// 16-byte cp.async from every thread; there each power step added its
// whole time to the call, as if the loads did not overlap the power steps.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 448;  // 2 groups of 7 warps (Tm = 224)
constexpr int kMaxTm = 286;       // the reference's lipq_viable
constexpr int kRegRows = 96;      // rows k a thread may hold past the slot

template <int G>
__device__ __forceinline__ void load_g(const float* p, float (&x)[G]) {
  if constexpr (G == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) x[g] = p[g];
  }
}

// acc[g] = sum_k H[k][j][g] * v[k][g], k in order, rounding each product
// and sum; with MAX also hm[g] = max(hm[g], |H[k][j][g]|)
// (rows k < krows of the slab H, row length Tm)
template <int G, bool MAX>
__device__ __forceinline__ void matvec(const float* H, const float* v, int Tm,
                                       int krows, int j, float (&acc)[G],
                                       float (&hm)[G]) {
  float h[G], x[G];
  load_g<G>(H + j * G, h);
  load_g<G>(v, x);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    acc[g] = __fmul_rn(h[g], x[g]);
    if (MAX) hm[g] = pint::nan_max(hm[g], fabsf(h[g]));
  }
  const float* hp = H + (size_t)(Tm + j) * G;
#pragma unroll 4
  for (int k = 1; k < krows; ++k, hp += (size_t)Tm * G) {
    load_g<G>(hp, h);
    load_g<G>(v + k * G, x);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      acc[g] = __fadd_rn(acc[g], __fmul_rn(h[g], x[g]));
      if (MAX) hm[g] = pint::nan_max(hm[g], fabsf(h[g]));
    }
  }
}

// clip(round_half_even(h * scale), -127, 127).  Clipping first is the same
// (|x| > 127 rounds to beyond 127 either way; NaN clips to -127 as before),
// and adding 1.5 * 2^23 rounds an |x| <= 127 to an integer half to even,
// which then sits in the low bits of the sum: no conversion instruction.
__device__ __forceinline__ int8_t q8(float h, float scale) {
  const float x = fminf(fmaxf(__fmul_rn(h, scale), -127.0f), 127.0f);
  return (int8_t)(__float_as_int(__fadd_rn(x, 12582912.0f)) - 0x4B400000);
}

struct Geometry {
  int nq;             // warps a group: ceil(Tm / 32)
  size_t slab;        // floats a slot: rows k < krows
  size_t per_group;   // floats a group: v, red, scale
};

__host__ __device__ inline Geometry geometry(int Tm, int G, int krows) {
  Geometry g;
  g.nq = (Tm + 31) / 32;
  g.slab = ((size_t)krows * Tm * G + 31) & ~(size_t)31;
  g.per_group = ((size_t)Tm * G + (size_t)G * g.nq * 32 + 4 + 3) & ~(size_t)3;
  return g;
}

inline size_t smem_bytes(const Geometry& geo, int slots, int groups) {
  return (slots * geo.slab + groups * geo.per_group) * sizeof(float) +
         slots * sizeof(uint64_t);
}

// G problems a slot (4, or 1 for large Tm); vec: B % 4 == 0 and G == 4,
// so every row of a quad is one aligned 16-byte copy.  R = 0: the slot holds
// the whole slab (krows = Tm).  R > 0 (G = 1, one slot, one group): rows
// k >= krows, at most R, live in the registers of thread j.
template <int G, int R>
__global__ void __launch_bounds__(R ? 320 : kMaxThreads)
lipq_kernel(const float* __restrict__ ht, int8_t* __restrict__ hqt,
            float* __restrict__ lip, float* __restrict__ hmax, int B, int Tm,
            int power_iters, float inv_sqrt, int slots, int groups, int vec,
            int krows) {
  static_assert(R == 0 || G == 1, "register rows hold one problem");
  extern __shared__ __align__(1024) float fsm[];  // lipq_reg_kernel's symbol
  const Geometry geo = geometry(Tm, G, krows);
  const int nt = geo.nq * 32;
  const int group = threadIdx.x / nt;
  const int tid = threadIdx.x - group * nt;  // = the row j this thread owns
  const int q = tid >> 5;
  const int lane = tid & 31;
  const int mm = krows * Tm;  // slab values a problem in the slot
  float* v = fsm + slots * geo.slab + group * geo.per_group;  // [Tm][G]
  float* red = v + Tm * G;                                    // [G][nq][32]
  float* s_scale = red + G * geo.nq * 32;                     // [G]
  uint64_t* full = reinterpret_cast<uint64_t*>(fsm + slots * geo.slab +
                                               groups * geo.per_group);
  const int nquads = (B + G - 1) / G;

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) pint::mbar_init(&full[s], nt);
    pint::mbar_init_fence();
  }
  __syncthreads();

  // this group's threads copy the block's t-th quad into slot t % slots
  auto issue = [&](int t) {
    const int quad = blockIdx.x + t * gridDim.x;
    if (quad >= nquads) return;
    float* dst = fsm + (t % slots) * geo.slab;
    const int b0 = quad * G;
    if (G == 4 && vec) {
      for (int kj = tid; kj < mm; kj += nt)
        pint::cp_async16(dst + kj * 4, ht + (size_t)kj * B + b0, true);
    } else {
      for (int i = tid; i < mm * G; i += nt) {
        const int kj = i / G;
        const int b = b0 + i - kj * G;
        pint::cp_async4(dst + i, b < B ? ht + (size_t)kj * B + b : ht, b < B);
      }
    }
    pint::cp_async_arrive(&full[t % slots]);
  };

  for (int t = group; t < slots; t += groups) issue(t);

  const int bar = 1 + group;
  for (int t = group;; t += groups) {
    const int quad = blockIdx.x + t * gridDim.x;
    if (quad >= nquads) break;
    const int b0 = quad * G;
    const float* H = fsm + (t % slots) * geo.slab;
    if (tid < Tm) {
#pragma unroll
      for (int g = 0; g < G; ++g) v[tid * G + g] = inv_sqrt;
    }
    float hm[G], acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) hm[g] = 0.0f, acc[g] = 0.0f;
    float hr[R ? R : 1];  // H[krows + r][tid] (R > 0)
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool in = tid < Tm && krows + r < Tm;
        hr[r] = in ? ht[((size_t)(krows + r) * Tm + tid) * B + b0] : 0.0f;
        hm[0] = pint::nan_max(hm[0], fabsf(hr[r]));
      }
    }
    pint::mbar_wait(&full[t % slots], (t / slots) & 1);
    pint::named_sync(bar, nt);

    for (int it = 0;; ++it) {
      float c[G];
#pragma unroll
      for (int g = 0; g < G; ++g) c[g] = 0.0f;
      if (tid < Tm) {
        if (it == 0)
          matvec<G, true>(H, v, Tm, krows, tid, acc, hm);
        else
          matvec<G, false>(H, v, Tm, krows, tid, acc, hm);
        if constexpr (R > 0) {
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (krows + r < Tm)
              acc[0] = __fadd_rn(acc[0], __fmul_rn(hr[r], v[krows + r]));
        }
        float vj[G];
        load_g<G>(v + tid * G, vj);
#pragma unroll
        for (int g = 0; g < G; ++g)
          c[g] = it < power_iters ? __fmul_rn(acc[g], acc[g])
                                  : __fmul_rn(vj[g], acc[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) red[(g * geo.nq + q) * 32 + lane] = c[g];
      pint::named_sync(bar, nt);
      float sum[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.0f;  // lane's rows in order, then the butterfly
        for (int r = 0; r < geo.nq; ++r)
          part = __fadd_rn(part, red[(g * geo.nq + r) * 32 + lane]);
        sum[g] = pint::warp_sum(part);
      }
      if (it == power_iters) {
        if (tid == 0) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (b0 + g < B) lip[b0 + g] = __fmul_rn(sum[g], 1.05f);
        }
        break;
      }
      if (tid < Tm) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          v[tid * G + g] =
              __fdiv_rn(acc[g], __fadd_rn(__fsqrt_rn(sum[g]), 1e-30f));
      }
      pint::named_sync(bar, nt);
    }

    pint::named_sync(bar, nt);  // every warp has read red
#pragma unroll
    for (int g = 0; g < G; ++g) red[(g * geo.nq + q) * 32 + lane] = hm[g];
    pint::named_sync(bar, nt);
    if (q == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float m = 0.0f;
        for (int r = 0; r < geo.nq; ++r)
          m = pint::nan_max(m, red[(g * geo.nq + r) * 32 + lane]);
        m = pint::warp_max(m);
        if (lane == 0) {
          if (b0 + g < B) hmax[b0 + g] = m;
          const float den = m != m ? m : fmaxf(m, 1e-30f);
          s_scale[g] = __fdiv_rn(127.0f, den);
        }
      }
    }
    pint::named_sync(bar, nt);

    if (G == 4 && vec) {
      const float s0 = s_scale[0], s1 = s_scale[1 % G], s2 = s_scale[2 % G],
                  s3 = s_scale[3 % G];
      for (int kj = tid; kj < mm; kj += nt) {
        const float4 h = *reinterpret_cast<const float4*>(H + kj * 4);
        const uint32_t word = (uint32_t)(uint8_t)q8(h.x, s0) |
                              (uint32_t)(uint8_t)q8(h.y, s1) << 8 |
                              (uint32_t)(uint8_t)q8(h.z, s2) << 16 |
                              (uint32_t)(uint8_t)q8(h.w, s3) << 24;
        *reinterpret_cast<uint32_t*>(hqt + (size_t)kj * B + b0) = word;
      }
    } else {
      for (int i = tid; i < mm * G; i += nt) {
        const int kj = i / G;
        const int g = i - kj * G;
        if (b0 + g < B) hqt[(size_t)kj * B + b0 + g] = q8(H[i], s_scale[g]);
      }
    }
    if constexpr (R > 0) {
      if (tid < Tm) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (krows + r < Tm)
            hqt[((size_t)(krows + r) * Tm + tid) * B + b0] = q8(hr[r], s_scale[0]);
      }
    }
    pint::named_sync(bar, nt);  // the slot, v and s_scale are free
    issue(t + slots);
  }
  pint::cp_async_wait<0>();  // no copy outlives the thread that issued it
}

// -- Tm <= 64: the slab in registers ------------------------------------------

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

constexpr int kOct = 8;  // problems an octet, one warp each

// Word of (row kj, problem w) in an octet slot [kj][8] f32: the two 16-byte
// halves of a row swap on bit 2 of kj (the TMA's 32-byte swizzle: address
// bit 4 ^= bit 7), so a warp reading one problem down 32 rows meets 4-way
// bank conflicts, not 8-way.
__device__ __forceinline__ int oct_word(int kj, int w) {
  return kj * 8 + ((((w >> 2) ^ (kj >> 2)) & 1) << 2) + (w & 3);
}

// Byte of (row kj, problem p of 16) in the int8 staging [kj][16]: the four
// words of a row rotate on bits 3-4 of kj, so the byte stores of a warp
// (one problem, 32 rows) fall on 32 banks.
__device__ __forceinline__ int out_byte(int kj, int p) {
  return kj * 16 + ((((p >> 2) ^ (kj >> 3)) & 3) << 2) + (p & 3);
}

// The TMA box: kOct problems x Tm rows j x kBoxK values of k, 256 * Tm
// bytes; ceil(Tm / kBoxK) boxes fill a slot, the last one zero-padded past
// k = Tm (so the slot holds whole boxes).  Each box starts 256-byte aligned
// in the slot, where the 32-byte swizzle pattern repeats.
constexpr int kBoxK = 8;

struct RegLayout {
  size_t slot;   // floats: [ceil(Tm / kBoxK) * kBoxK * Tm][8]
  size_t obuf;   // bytes: [Tm * Tm][16]
  int tm4;       // Tm rounded up to 4 (v's stride)
};

__host__ __device__ inline RegLayout reg_layout(int Tm) {
  RegLayout l;
  l.slot = (size_t)((Tm + kBoxK - 1) / kBoxK * kBoxK) * Tm * kOct;
  l.obuf = (size_t)Tm * Tm * 16;
  l.tm4 = (Tm + 3) & ~3;
  return l;
}

inline size_t reg_smem_bytes(int Tm) {
  const RegLayout l = reg_layout(Tm);
  return l.slot * sizeof(float) + l.obuf + (size_t)kOct * l.tm4 * sizeof(float) +
         sizeof(uint64_t);
}

// NJ = 1 (Tm <= 32) or 2 (Tm <= 64): lane l holds rows l + 32q, q < NJ, of
// its problem's slab, for every k, in registers.  TM = Tm when the kernel is
// built for one Tm (64, the main path: the guards and the shared-memory
// offsets fold into constants), 0 for any Tm <= 32 NJ.  A block walks pairs of
// octets (16 consecutive problems); the octet slot takes the next octet as
// soon as the warps hold the current one.  tma: thread 0 stages an octet
// with the boxes of `map` (B % 4 == 0 and ht 16-byte aligned), else every
// thread with 4-byte copies; wide: 16-byte stores of the int8 output
// (B % 16 == 0 and hqt 16-byte aligned), else byte stores.
template <int NJ, int TM>
__global__ void __launch_bounds__(kOct * 32, 1)
lipq_reg_kernel(const __grid_constant__ CUtensorMap map, const float* __restrict__ ht,
                int8_t* __restrict__ hqt, float* __restrict__ lip,
                float* __restrict__ hmax, int B, int Tm_arg, int power_iters,
                float inv_sqrt, int tma, int wide) {
  constexpr int TK = TM ? TM : 32 * NJ;  // k range held
  const int Tm = TM ? TM : Tm_arg;
  extern __shared__ __align__(1024) float fsm[];
  const RegLayout lay = reg_layout(Tm);
  const int mm = Tm * Tm;
  float* slot = fsm;
  unsigned char* obuf = reinterpret_cast<unsigned char*>(fsm + lay.slot);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* v = reinterpret_cast<float*>(obuf + lay.obuf) + warp * lay.tm4;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(reinterpret_cast<float*>(obuf + lay.obuf) +
                                  kOct * lay.tm4);
  const int npairs = (B + 15) / 16;

  if (threadIdx.x == 0) {
    pint::mbar_init(full, tma ? 1 : kOct * 32);
    pint::mbar_init_fence();
  }
  __syncthreads();

  auto first_of = [&](int s) {  // the s-th octet's first problem, or -1
    const int pair = blockIdx.x + (s >> 1) * gridDim.x;
    return pair < npairs ? pair * 16 + (s & 1) * kOct : -1;
  };
  auto issue = [&](int s) {
    const int b0 = first_of(s);
    if (b0 < 0) return;
    if (tma) {  // problems past B arrive as zeros
      if (threadIdx.x == 0) {
        pint::mbar_expect_tx(full, (uint32_t)(lay.slot * sizeof(float)));
        for (int k0 = 0; k0 < Tm; k0 += kBoxK)
          pint::tma_load_3d(slot + (size_t)k0 * Tm * kOct, &map, b0, 0, k0, full);
      }
      return;
    }
    for (int i = threadIdx.x; i < mm * kOct; i += kOct * 32) {
      const int kj = i >> 3, b = b0 + (i & 7);
      pint::cp_async4(slot + oct_word(kj, i & 7),
                      b < B ? ht + (size_t)kj * B + b : ht, b < B);
    }
    pint::cp_async_arrive(full);
  };

  // The int8 result of a pair waits in obuf (pend = its first problem) and
  // goes out during the next octet's power steps, a row kj a thread at a
  // time, so the stores drain while the warps compute.
  int pend = -1;
  const int rows_per_thread = (mm + kOct * 32 - 1) / (kOct * 32);
  auto flush_row = [&](int m) {
    const int kj = threadIdx.x + m * kOct * 32;
    if (kj >= mm) return;
    if (wide) {
      uint4 r = *reinterpret_cast<const uint4*>(obuf + kj * 16);
      const int rot = (kj >> 3) & 3;  // word c of the row sits at c ^ rot
      if (rot & 1) r = make_uint4(r.y, r.x, r.w, r.z);
      if (rot & 2) r = make_uint4(r.z, r.w, r.x, r.y);
      *reinterpret_cast<uint4*>(hqt + (size_t)kj * B + pend) = r;
    } else {
      for (int c = 0; c < 16; ++c)
        if (pend + c < B) hqt[(size_t)kj * B + pend + c] = (int8_t)obuf[out_byte(kj, c)];
    }
  };

  issue(0);
  for (int s = 0;; ++s) {
    const int b0 = first_of(s);
    if (b0 < 0) break;
    const int b = b0 + warp;
    pint::mbar_wait(full, s & 1);
    float h[NJ][TK];
    float hm = 0.0f;
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int j = lane + 32 * q;
#pragma unroll
      for (int k = 0; k < TK; ++k) {
        h[q][k] = j < Tm && k < Tm ? slot[oct_word(k * Tm + j, warp)] : 0.0f;
        hm = pint::nan_max(hm, fabsf(h[q][k]));
      }
    }
    __syncthreads();  // every warp holds its slab: the slot is free
    issue(s + 1);

#pragma unroll
    for (int q = 0; q < NJ; ++q)
      if (lane + 32 * q < Tm) v[lane + 32 * q] = inv_sqrt;
    __syncwarp();
    for (int it = 0;; ++it) {
      if (pend >= 0)
        for (int m = it; m < rows_per_thread; m += power_iters + 1) flush_row(m);
      float acc[NJ];
#pragma unroll
      for (int k = 0; k < TK; k += 4) {
        if (k < Tm) {
          const float4 x = *reinterpret_cast<const float4*>(v + k);
          const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int q = 0; q < NJ; ++q) {
              if (k + i == 0)
                acc[q] = __fmul_rn(h[q][0], xs[0]);
              else if (k + i < Tm)
                acc[q] = __fadd_rn(acc[q], __fmul_rn(h[q][k + i], xs[i]));
            }
          }
        }
      }
      float part = 0.0f;  // the lane's rows in order, then the butterfly
#pragma unroll
      for (int q = 0; q < NJ; ++q) {
        const int j = lane + 32 * q;
        if (j < Tm)
          part = __fadd_rn(part, it < power_iters ? __fmul_rn(acc[q], acc[q])
                                                  : __fmul_rn(v[j], acc[q]));
      }
      const float sum = pint::warp_sum(part);
      if (it == power_iters) {
        if (lane == 0 && b < B) lip[b] = __fmul_rn(sum, 1.05f);
        break;
      }
      const float nrm = __fadd_rn(__fsqrt_rn(sum), 1e-30f);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < NJ; ++q)
        if (lane + 32 * q < Tm) v[lane + 32 * q] = __fdiv_rn(acc[q], nrm);
      __syncwarp();
    }

    if (pend >= 0) {  // every row of the waiting pair has been stored
      __syncthreads();
      pend = -1;
    }
    hm = pint::warp_max(hm);
    if (lane == 0 && b < B) hmax[b] = hm;
    const float scale = __fdiv_rn(127.0f, hm != hm ? hm : fmaxf(hm, 1e-30f));
    const int p = (s & 1) * kOct + warp;
#pragma unroll
    for (int q = 0; q < NJ; ++q) {
      const int j = lane + 32 * q;
#pragma unroll
      for (int k = 0; k < TK; ++k)
        if (j < Tm && k < Tm)
          obuf[out_byte(k * Tm + j, p)] = (unsigned char)q8(h[q][k], scale);
    }

    if (s & 1) pend = b0 - kOct;  // the pair's 16 problems are in obuf
  }
  if (pend >= 0) {  // the last pair: nothing left to hide its stores behind
    __syncthreads();
    for (int m = 0; m < rows_per_thread; ++m) flush_row(m);
  }
  pint::cp_async_wait<0>();
}

// The tensor map of Ht as (B, Tm, Tm) f32, innermost first, boxes of
// (kOct, Tm, kBoxK) in the 32-byte swizzle of oct_word; L2 fetches whole
// 128-byte lines, whose other octets the neighbouring blocks read.
cudaError_t encode_map(CUtensorMap* map, const float* ht, int B, int Tm) {
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)Tm, (cuuint64_t)Tm};
  const cuuint64_t strides[2] = {(cuuint64_t)B * sizeof(float),
                                 (cuuint64_t)B * Tm * sizeof(float)};
  const cuuint32_t box[3] = {kOct, (cuuint32_t)Tm, kBoxK};
  return pint_encode_map3d_f32(map, ht, dims, strides, box);
}

cudaError_t launch_reg(const float* ht, int8_t* hqt, float* lip, float* hmax,
                       int B, int Tm, int power_iters, float inv_sqrt,
                       cudaStream_t stream) {
  const size_t smem = reg_smem_bytes(Tm);
  const int tma = B % 4 == 0 && aligned16(ht);
  const int wide = B % 16 == 0 && aligned16(hqt);
  CUtensorMap map{};
  cudaError_t err = tma ? encode_map(&map, ht, B, Tm) : cudaSuccess;
  if (err != cudaSuccess) return err;
  auto kernel = Tm == 64   ? lipq_reg_kernel<2, 64>
                : Tm <= 32 ? lipq_reg_kernel<1, 0>
                           : lipq_reg_kernel<2, 0>;
  err = pint_allow_smem(kernel, smem);
  int grid = 0;
  if (err == cudaSuccess)
    err = pint_persistent_grid(kernel, kOct * 32, smem, (B + 15) / 16, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kOct * 32, smem, stream>>>(map, ht, hqt, lip, hmax, B, Tm,
                                            power_iters, inv_sqrt, tma, wide);
  return cudaGetLastError();
}

// A ring of up to 3 slots with 2 groups, else 2 slots with 1 group (double
// buffer), else 1 slot (one stage).  Returns false when no slot fits.
bool ring(const Geometry& geo, int* slots, int* groups) {
  for (int s = 3; s >= 1; --s) {
    const int g = s == 3 ? 2 : 1;
    if (smem_bytes(geo, s, g) <= kPintMaxSmem) {
      *slots = s, *groups = g;
      return true;
    }
  }
  return false;
}

// The rows k of one problem's slab that fit one slot beside one group's
// vectors: Tm when the whole slab fits.
int slot_rows(int Tm) {
  int k = Tm;
  while (k > 1 && smem_bytes(geometry(Tm, 1, k), 1, 1) > kPintMaxSmem) --k;
  return k;
}

template <int G, int R>
cudaError_t launch(const float* ht, int8_t* hqt, float* lip, float* hmax,
                   int B, int Tm, int power_iters, float inv_sqrt,
                   cudaStream_t stream) {
  const int krows = R ? slot_rows(Tm) : Tm;
  if (Tm - krows > R) return cudaErrorInvalidValue;
  const Geometry geo = geometry(Tm, G, krows);
  int slots = 1, groups = 1;
  if (!R && !ring(geo, &slots, &groups)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(geo, slots, groups);
  const int threads = groups * geo.nq * 32;
  auto kernel = lipq_kernel<G, R>;
  cudaError_t err = pint_allow_smem(kernel, smem);
  int grid = 0;
  if (err == cudaSuccess)
    err = pint_persistent_grid(kernel, threads, smem, (B + G - 1) / G, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(
      ht, hqt, lip, hmax, B, Tm, power_iters, inv_sqrt, slots, groups,
      G == 4 && B % 4 == 0 && aligned16(ht), krows);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pint_lipq(const void* ht, void* hqt, void* lip, void* hmax,
                         int B, int Tm, int power_iters, void* stream) {
  if (B <= 0 || Tm <= 0 || Tm > kMaxTm || power_iters < 0)
    return (int)cudaErrorInvalidValue;
  // the same f32 constant as np.float32(1.0 / np.sqrt(Tm))
  const float inv_sqrt = (float)(1.0 / sqrt((double)Tm));
  const float* h = static_cast<const float*>(ht);
  int8_t* q = static_cast<int8_t*>(hqt);
  float* l = static_cast<float*>(lip);
  float* m = static_cast<float*>(hmax);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int slots, groups;
  cudaError_t err;
  if (Tm <= 64)
    err = launch_reg(h, q, l, m, B, Tm, power_iters, inv_sqrt, s);
  else if (ring(geometry(Tm, 4, Tm), &slots, &groups))
    err = launch<4, 0>(h, q, l, m, B, Tm, power_iters, inv_sqrt, s);
  else if (ring(geometry(Tm, 1, Tm), &slots, &groups))
    err = launch<1, 0>(h, q, l, m, B, Tm, power_iters, inv_sqrt, s);
  else
    err = launch<1, kRegRows>(h, q, l, m, B, Tm, power_iters, inv_sqrt, s);
  return (int)err;
}
