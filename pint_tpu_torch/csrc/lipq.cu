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
// For 64 < Tm <= 286 (the reference's lipq_viable; T = 128 at two controls
// is Tm = 256, the long-horizon path; lipq_long_kernel) Ht arrives
// problem-major, each problem's slab one contiguous run (the reduce hands
// over the batch-first Hb as it is), and hqt leaves problem-major with rows
// j.  The first design here gathered Ht batch-last, one 4-byte copy of each
// float from its own 32-byte sector, with one slot and no overlap: 9.39 ms
// at Tm 256 and B 4096 on one H100 80GB HBM3, 8.72 of it with no power step.
// Now a group of warps takes one problem, thread j owning column j; its
// rows land in a slot by bulk copies that read every sector once and whole,
// into a ring that overlaps the next problem's copy where two or more slabs
// fit (Tm <= 160), else behind an L2 prefetch of the next slab; past Tm =
// 224 the slot holds the first krows rows and thread j the others of its
// column in registers.  The matvec adds the slot's rows and then the
// register rows, k in order, so the result stays bit-identical.
//
// What holds the register kernel above the bound (PERF.md): at 0 power
// steps it already takes three quarters of its time at 16, so staging, moving the
// slab into registers (4-way bank conflicts: a warp reads one word of 32
// rows of 32 bytes) and the int8 stores cost more than the 17 dependent
// matvecs.  The first octet's load is not hidden, and it reads each
// 128-byte line of a row for half of its bytes (the pair's other octet
// follows later, from L2).  An earlier version of this design staged by
// 16-byte cp.async from every thread; there each power step added its
// whole time to the call, as if the loads did not overlap the power steps.
#include "common.cuh"

namespace {

constexpr int kMaxTm = 286;  // the reference's lipq_viable

// clip(round_half_even(h * scale), -127, 127).  Clipping first is the same
// (|x| > 127 rounds to beyond 127 either way; NaN clips to -127 as before),
// and adding 1.5 * 2^23 rounds an |x| <= 127 to an integer half to even,
// which then sits in the low bits of the sum: no conversion instruction.
__device__ __forceinline__ int8_t q8(float h, float scale) {
  const float x = fminf(fmaxf(__fmul_rn(h, scale), -127.0f), 127.0f);
  return (int8_t)(__float_as_int(__fadd_rn(x, 12582912.0f)) - 0x4B400000);
}

// -- 64 < Tm <= 286: problem-major slabs ------------------------------------

constexpr int kLongThreads = 448;  // groups x ceil(Tm / 32) warps, all groups
constexpr int kMaxSlots = 8;       // slots of the ring
constexpr int kRegRows = 96;       // rows k a thread may hold past the slot
constexpr uint32_t kBulkChunk = 32768;  // bytes a bulk copy

// Shared memory of lipq_long_kernel: `slots` slots of krows rows k of one
// problem's slab ([k][j] f32, as it lies in problem-major Ht), then a
// group's v [tm4], red [nq][32] and scale, then an mbarrier a slot.
struct LongGeometry {
  int nq;            // warps a group: ceil(Tm / 32)
  int tm4;           // Tm rounded up to 4 (v in float4s)
  size_t slab;       // floats a slot: krows Tm, rounded up to 128 bytes
  size_t per_group;  // floats a group
};

__host__ __device__ inline LongGeometry long_geometry(int Tm, int krows) {
  LongGeometry g;
  g.nq = (Tm + 31) / 32;
  g.tm4 = (Tm + 3) & ~3;
  g.slab = ((size_t)krows * Tm + 31) & ~(size_t)31;
  g.per_group = ((size_t)g.tm4 + (size_t)g.nq * 32 + 4 + 3) & ~(size_t)3;
  return g;
}

inline size_t long_smem(const LongGeometry& g, int slots, int groups) {
  return (slots * g.slab + groups * g.per_group) * sizeof(float) +
         slots * sizeof(uint64_t);
}

// sum_k H[k][j] v[k] over the slot's rows k < krows, k in order, each product
// and sum rounded (the first product alone, then +); with MAX also
// hm = max(hm, |H[k][j]|).  Eight rows at a time, the next eight loaded
// while this eight's products are added (the adds are one dependent chain,
// so the loads must run ahead of it), v read as broadcast float4s.
template <bool MAX>
__device__ __forceinline__ float column_dot(const float* H, const float* v, int Tm,
                                            int krows, int j, float& hm) {
  const float* col = H + j;
  const int full = krows & ~7;  // rows in whole groups of eight
  float acc = 0.0f, h[8];
  if (full) {
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = col[i * Tm];
  }
  for (int k0 = 0; k0 < full; k0 += 8) {
    float hn[8];
    const int kn = k0 + 8 < full ? k0 + 8 : k0;  // the next group (this one at the end)
#pragma unroll
    for (int i = 0; i < 8; ++i) hn[i] = col[(kn + i) * Tm];
    const float4 xa = *reinterpret_cast<const float4*>(v + k0);
    const float4 xb = *reinterpret_cast<const float4*>(v + k0 + 4);
    const float xs[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p = __fmul_rn(h[i], xs[i]);
      acc = k0 + i == 0 ? p : __fadd_rn(acc, p);
      if (MAX) hm = pint::nan_max(hm, fabsf(h[i]));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = hn[i];
  }
  for (int k = full; k < krows; ++k) {
    const float hk = col[k * Tm];
    const float p = __fmul_rn(hk, v[k]);
    acc = k == 0 ? p : __fadd_rn(acc, p);
    if (MAX) hm = pint::nan_max(hm, fabsf(hk));
  }
  return acc;
}

__device__ __forceinline__ uint32_t q8x4(float a, float b, float c, float d, float s) {
  return (uint32_t)(uint8_t)q8(a, s) | (uint32_t)(uint8_t)q8(b, s) << 8 |
         (uint32_t)(uint8_t)q8(c, s) << 16 | (uint32_t)(uint8_t)q8(d, s) << 24;
}

// The register rows hr[0..R) of a thread, by template recursion so that
// every index is a constant (a loop over R that the compiler does not
// unroll whole would put hr in local memory).  Rows r >= n are not real.
template <int I, int R>
__device__ __forceinline__ void load_rows(float (&hr)[R], const float* src, int Tm, int n) {
  if constexpr (I < R) {
    hr[I] = I < n ? src[(size_t)I * Tm] : 0.0f;
    load_rows<I + 1, R>(hr, src, Tm, n);
  }
}

template <int I, int R>
__device__ __forceinline__ void max_rows(const float (&hr)[R], float& hm) {
  if constexpr (I < R) {
    hm = pint::nan_max(hm, fabsf(hr[I]));
    max_rows<I + 1, R>(hr, hm);
  }
}

// acc += hr[r] v[r] for r < n, in order
template <int I, int R>
__device__ __forceinline__ void add_rows(const float (&hr)[R], const float* v, int n,
                                         float& acc) {
  if constexpr (I < R) {
    if (I < n) acc = __fadd_rn(acc, __fmul_rn(hr[I], v[I]));
    add_rows<I + 1, R>(hr, v, n, acc);
  }
}

// row[r] = q8(hr[r]) for r < n: words of 4 (n % 4 == 0, row 4-byte
// aligned: words) or bytes
template <int I, int R>
__device__ __forceinline__ void store_rows(const float (&hr)[R], int8_t* row, int n,
                                           float s, bool words) {
  if constexpr (I < R) {
    if (I < n) {
      if (words)
        *reinterpret_cast<uint32_t*>(row + I) = q8x4(hr[I], hr[I + 1], hr[I + 2], hr[I + 3], s);
      else
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (I + i < n) row[I + i] = q8(hr[I + i], s);
    }
    store_rows<I + 4, R>(hr, row, n, s, words);
  }
}

// 64 < Tm <= 286 (the long-horizon path: T = 128 at two controls is Tm =
// 256).  Ht problem-major: problem b's slab is the contiguous run
// ht[b Tm^2 + k Tm + j]; hqt is written problem-major with rows j,
// hqt[b Tm^2 + j Tm + k].  A group of ceil(Tm / 32) warps takes one
// problem at a time, thread j owning column j.  Its first krows rows k land
// in a slot of the ring by bulk copies (one thread, whole 32 KB runs that
// count their bytes down on the slot's mbarrier; 4-byte cp.async from every
// thread of the group when Tm is odd or Ht is not 16-byte aligned), so every
// sector is read once and whole.  With 2 or more slots (Tm <= 160) `groups`
// = slots - 1 groups iterate while the last slot fills.  One slot (Tm > 160)
// cannot overlap the next problem's copy, so the group asks L2 to prefetch
// the next slab (one bulk prefetch) when it starts a problem, and the copy
// then comes from L2.  Past Tm = 224 (R > 0) the slot holds krows < Tm rows
// (a multiple of 16) and thread j holds H[k][j] of the other rows, at most
// R, in registers, loaded once a problem by coalesced loads.
template <int R>
__global__ void __launch_bounds__(R ? 320 : kLongThreads)
lipq_long_kernel(const float* __restrict__ ht, int8_t* __restrict__ hqt,
                 float* __restrict__ lip, float* __restrict__ hmax, int B, int Tm,
                 int power_iters, float inv_sqrt, int slots, int groups, int krows,
                 int bulk, int ow) {
  extern __shared__ __align__(1024) float fsm[];  // lipq_reg_kernel's symbol
  const LongGeometry geo = long_geometry(Tm, krows);
  const int nt = geo.nq * 32;
  const int group = threadIdx.x / nt;
  const int tid = threadIdx.x - group * nt;  // = the column j this thread owns
  const int q = tid >> 5;
  const int lane = tid & 31;
  const size_t mm = (size_t)Tm * Tm;
  const int kk = krows * Tm;  // floats a slot takes
  float* v = fsm + slots * geo.slab + group * geo.per_group;  // [tm4]
  float* red = v + geo.tm4;                                   // [nq][32]
  float* s_scale = red + geo.nq * 32;
  uint64_t* full = reinterpret_cast<uint64_t*>(fsm + slots * geo.slab +
                                               groups * geo.per_group);

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) pint::mbar_init(&full[s], bulk ? 1 : nt);
    pint::mbar_init_fence();
  }
  __syncthreads();

  // this group copies the block's t-th problem's first krows rows into
  // slot t % slots
  auto issue = [&](int t) {
    const int b = blockIdx.x + t * gridDim.x;
    if (b >= B) return;
    float* dst = fsm + (t % slots) * geo.slab;
    const float* src = ht + (size_t)b * mm;
    uint64_t* bar = &full[t % slots];
    if (bulk) {
      if (tid == 0) {
        const uint32_t bytes = (uint32_t)kk * sizeof(float);
        pint::mbar_expect_tx(bar, bytes);
        for (uint32_t off = 0; off < bytes; off += kBulkChunk)
          pint::bulk_load(dst + off / 4, src + off / 4, min(kBulkChunk, bytes - off), bar);
      }
      return;
    }
    for (int i = tid; i < kk; i += nt) pint::cp_async4(dst + i, src + i, true);
    pint::cp_async_arrive(bar);
  };

  for (int t = group; t < slots; t += groups) issue(t);

  const int bar = 1 + group;
  for (int t = group;; t += groups) {
    const int b = blockIdx.x + t * gridDim.x;
    if (b >= B) break;
    const float* H = fsm + (t % slots) * geo.slab;
    if (slots == 1 && bulk && tid == 0 && b + (int)gridDim.x < B)
      pint::prefetch_l2(ht + (size_t)(b + gridDim.x) * mm, (uint32_t)(mm * sizeof(float)));
    if (tid < Tm) v[tid] = inv_sqrt;
    float hm = 0.0f, acc = 0.0f;
    float hr[R ? R : 1];  // H[krows + r][tid] (R > 0)
    if constexpr (R > 0) {  // every load in flight before the first max
      load_rows<0, R>(hr, ht + (size_t)b * mm + (size_t)krows * Tm + tid, Tm,
                      tid < Tm ? Tm - krows : 0);
      max_rows<0, R>(hr, hm);
    }
    pint::mbar_wait(&full[t % slots], (t / slots) & 1);
    pint::named_sync(bar, nt);

    for (int it = 0;; ++it) {
      float c = 0.0f;
      if (tid < Tm) {
        acc = it == 0 ? column_dot<true>(H, v, Tm, krows, tid, hm)
                      : column_dot<false>(H, v, Tm, krows, tid, hm);
        if constexpr (R > 0) add_rows<0, R>(hr, v + krows, Tm - krows, acc);
        c = it < power_iters ? __fmul_rn(acc, acc) : __fmul_rn(v[tid], acc);
      }
      red[q * 32 + lane] = c;
      pint::named_sync(bar, nt);
      float part = 0.0f;  // the lane's rows in order, then the butterfly
      for (int r = 0; r < geo.nq; ++r) part = __fadd_rn(part, red[r * 32 + lane]);
      const float sum = pint::warp_sum(part);
      if (it == power_iters) {
        if (tid == 0) lip[b] = __fmul_rn(sum, 1.05f);
        break;
      }
      if (tid < Tm) v[tid] = __fdiv_rn(acc, __fadd_rn(__fsqrt_rn(sum), 1e-30f));
      pint::named_sync(bar, nt);
    }

    pint::named_sync(bar, nt);  // every warp has read red
    red[q * 32 + lane] = hm;
    pint::named_sync(bar, nt);
    if (q == 0) {
      float m = 0.0f;
      for (int r = 0; r < geo.nq; ++r) m = pint::nan_max(m, red[r * 32 + lane]);
      m = pint::warp_max(m);
      if (lane == 0) {
        hmax[b] = m;
        s_scale[0] = __fdiv_rn(127.0f, m != m ? m : fmaxf(m, 1e-30f));
      }
    }
    pint::named_sync(bar, nt);

    // row j of the problem's int8 slab, problem-major: 16-byte stores (ow
    // 16: Tm % 16 == 0), words (ow 4: Tm % 4 == 0) or bytes
    if (tid < Tm) {
      const float s = s_scale[0];
      int8_t* row = hqt + (size_t)b * mm + (size_t)tid * Tm;
      const float* col = H + tid;
      if (ow == 16) {
        for (int k = 0; k < krows; k += 16) {
          const float* h = col + (size_t)k * Tm;
          *reinterpret_cast<uint4*>(row + k) = make_uint4(
              q8x4(h[0], h[Tm], h[2 * Tm], h[3 * Tm], s),
              q8x4(h[4 * Tm], h[5 * Tm], h[6 * Tm], h[7 * Tm], s),
              q8x4(h[8 * Tm], h[9 * Tm], h[10 * Tm], h[11 * Tm], s),
              q8x4(h[12 * Tm], h[13 * Tm], h[14 * Tm], h[15 * Tm], s));
        }
      } else if (ow == 4) {
        for (int k = 0; k < krows; k += 4) {
          const float* h = col + (size_t)k * Tm;
          *reinterpret_cast<uint32_t*>(row + k) =
              q8x4(h[0], h[Tm], h[2 * Tm], h[3 * Tm], s);
        }
      } else {
        for (int k = 0; k < krows; ++k) row[k] = q8(col[(size_t)k * Tm], s);
      }
      if constexpr (R > 0)  // krows % 16 == 0: words stay aligned
        store_rows<0, R>(hr, row + krows, Tm - krows, s, ow > 1);
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

// The ring of the long form: the most whole slabs (at most kMaxSlots) that
// fit with slots - 1 groups iterating, else one whole slab, else one slot of
// krows rows (a multiple of 16) with the rest, at most kRegRows, in
// registers.  False when nothing fits.
struct LongPlan {
  int krows, slots, groups;
};

bool long_plan(int Tm, LongPlan* p) {
  const LongGeometry g = long_geometry(Tm, Tm);
  const int nt = g.nq * 32;
  for (int s = kMaxSlots; s >= 2; --s) {
    if ((s - 1) * nt <= kLongThreads && long_smem(g, s, s - 1) <= kPintMaxSmem) {
      *p = LongPlan{Tm, s, s - 1};
      return true;
    }
  }
  if (long_smem(g, 1, 1) <= kPintMaxSmem) {
    *p = LongPlan{Tm, 1, 1};
    return true;
  }
  int k = Tm / 16 * 16;
  while (k > 0 && long_smem(long_geometry(Tm, k), 1, 1) > kPintMaxSmem) k -= 16;
  if (k <= 0 || Tm - k > kRegRows) return false;
  *p = LongPlan{k, 1, 1};
  return true;
}

cudaError_t launch_long(const float* ht, int8_t* hqt, float* lip, float* hmax, int B,
                        int Tm, int power_iters, float inv_sqrt, cudaStream_t stream) {
  LongPlan pl;
  if (!long_plan(Tm, &pl)) return cudaErrorInvalidValue;
  const LongGeometry geo = long_geometry(Tm, pl.krows);
  const size_t smem = long_smem(geo, pl.slots, pl.groups);
  const int threads = pl.groups * geo.nq * 32;
  // whole bulk copies: every slab starts 16-byte aligned (Tm even)
  const int bulk = Tm % 2 == 0 && aligned16(ht);
  const int ow = Tm % 16 == 0 && aligned16(hqt)                                 ? 16
                 : Tm % 4 == 0 && reinterpret_cast<uintptr_t>(hqt) % 4 == 0 ? 4
                                                                               : 1;
  // as few register rows as cover Tm - krows (32 at Tm 256, 64 at 272)
  const int rr = Tm - pl.krows;
  auto kernel = rr == 0    ? lipq_long_kernel<0>
                : rr <= 32 ? lipq_long_kernel<32>
                : rr <= 64 ? lipq_long_kernel<64>
                           : lipq_long_kernel<kRegRows>;
  cudaError_t err = pint_allow_smem(kernel, smem);
  int grid = 0;
  if (err == cudaSuccess) err = pint_persistent_grid(kernel, threads, smem, B, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(ht, hqt, lip, hmax, B, Tm, power_iters,
                                          inv_sqrt, pl.slots, pl.groups, pl.krows, bulk,
                                          ow);
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
  if (Tm <= 64) return (int)launch_reg(h, q, l, m, B, Tm, power_iters, inv_sqrt, s);
  return (int)launch_long(h, q, l, m, B, Tm, power_iters, inv_sqrt, s);
}
