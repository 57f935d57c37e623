// K10: one tp rank's column matvec, launched once a PGD iteration of the
// column-sharded inners, with the int32 all-reduce between launches.
//
// Replaces pint_tpu/mpc/fused_alm.py:429 (_matvec_kernel_factory, entry
// pgd_matvec_cols at :441, pallas_call at :482).  For each problem b and
// output row j:
//   out[b, j] = sum_k hqt_r[k, j, b] * lanes[b, k]
// over this rank's K columns, in uint32_t so it wraps as XLA's int32 does,
// for every int32 lane value.  rows is Tm (DeviceSQP) or Tm + Cp (the
// constrained combined slab).
//
// What bounds it on the H100: one launch reads the rank's K x rows x B int8
// slab once (8 MiB at K = 32, rows = 64, B = 4096), the (B, K) lanes and
// writes the (B, rows) result: about 10 MB, 3.0 us at 3.35 TB/s.  One MAC a
// slab byte is far below the ALUs' rate, so the slab's loads bound it.
//
// Design: a thread owns 16 consecutive problems of one row j and reads
// each (k, j) row's 16 bytes for them with one 16-byte load, so a warp's
// load is 4 rows x 128 contiguous bytes (lane = group * 4 + row: 8 groups of
// 16 problems, 4 rows).  A block is 128 problems x 16 rows (4 warps): 128
// blocks at B = 4096, rows = 64, one wave over the 132 SMs.  A thread
// issues all its loads of a chunk of up to 32 k before any arithmetic (all
// of K at K <= 32: 16 KB in flight a warp); while they are in flight the
// chunk's lanes of the block's 128 problems land by cp.async (16 bytes a
// copy, each problem's k contiguous, rows padded so that the 8 groups'
// 16-byte reads of a quarter-warp sit on distinct banks).  Lanes within
// int8, which are all the solvers pass, are packed four k to a word and
// each problem's k-quad of slab bytes is gathered by a 4 x 4 byte transpose
// (__byte_perm) for one __dp4a; a block holding any other int32 lane takes
// the exact path, bytes sign-extended with prmt and multiplied and added in
// uint32_t.  Both are exact modulo 2^32.  The 16 x 128 results go back
// through shared memory (rows padded so a warp's stores meet no bank
// conflict) and out as each problem's contiguous run of 16 rows.  K % 4 !=
// 0 stages the lanes by 4-byte copies.
//
// What holds it above the bound (PERF.md): an empty kernel queued the same
// way takes 0.0020 ms, and each SM holds one block, whose loads, lane
// staging, arithmetic and stores follow one another (blocks of 8 or 4 rows,
// twice and four times the blocks, read slower at every main-path slab).
//
// The first design (matvec_bytes_kernel: 32 problems x 8 rows a block, one
// byte load a lane, 8 loads in flight a warp) read 0.0084 ms at K = 32, rows
// = 64, B = 4096 on one H100 80GB HBM3 (PERF.md).  It takes the shapes the
// 16-byte loads cannot (B % 16 != 0, or a slab not 16-byte aligned, where
// a byte load a lane read faster than 16 byte loads a thread) and the
// smallest slabs (K rows <= 1024, the tp = 4 DeviceSQP slab, where its 1024
// blocks hide the latency better; PERF.md).
#include "common.cuh"

namespace {

constexpr int kGroup = 16;                 // problems a thread
constexpr int kGroups = 8;                 // groups a block
constexpr int kProbs = kGroup * kGroups;   // problems a block: 128
constexpr int kWarps = 4;
constexpr int kRowsWarp = 4;               // rows j a warp
constexpr int kRows = kWarps * kRowsWarp;  // rows a block: 16
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 32;                 // k a stage
constexpr int kLaneStride = kChunk + 4;    // ints a problem's staged lanes
constexpr int kLaneTile = kProbs * kLaneStride + kGroups * 4;
constexpr int kOutStride = kProbs + 8;     // result rows: conflict-free stores
constexpr int kPackStride = kChunk / 4 + 1;  // words a problem's packed lanes

// problem p's staged lanes: rows of kLaneStride, 4 more ints a group of 16
__device__ __forceinline__ int lane_at(int p) {
  return p * kLaneStride + (p >> 4) * 4;
}

// byte n of w, sign-extended to 32 bits: prmt with the sign-replicate
// selector (0x8880 for byte 0, 0x9991, 0xAAA2, 0xBBB3)
__device__ __forceinline__ uint32_t sext8(uint32_t w, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(w), "r"(0u), "r"(sel));
  return r;
}

// the 4 x 4 byte transpose: in, 4 words of 4 problems' bytes at k, k + 1,
// k + 2, k + 3; out, a word of k-quad bytes for each problem
__device__ __forceinline__ void quad_t(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                       uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(a, b, 0x7362);
  const uint32_t t2 = __byte_perm(c, d, 0x5140), t3 = __byte_perm(c, d, 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410), o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410), o[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint32_t word_of(const uint4& h, int q) {
  return q == 0 ? h.x : q == 1 ? h.y : q == 2 ? h.z : h.w;
}

// B % 16 == 0 and hqt 16-byte aligned: every group's 16 bytes of a row are
// one aligned load.  LVEC: K % 4 == 0 and lanes 16-byte aligned (16-byte
// lane copies).
template <bool LVEC>
__global__ void __launch_bounds__(kThreads)
matvec_cols_kernel(const int* __restrict__ lanes, const int8_t* __restrict__ hqt,
                   int* __restrict__ out, int B, int K, int rows) {
  constexpr int CH = kChunk;
  __shared__ __align__(16) int s_l[kLaneTile];              // [p][k]
  __shared__ __align__(16) int s_o[kRows * kOutStride];     // [row][problem]
  __shared__ uint32_t s_p[kProbs * kPackStride];            // [p][k-quad]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;
  const int jj = warp * kRowsWarp + (lane & 3);
  const int b0 = blockIdx.x * kProbs;
  const int j = blockIdx.y * kRows + jj;
  const int bg = b0 + g * kGroup;            // this thread's first problem
  const bool live = j < rows && bg < B;
  const size_t kstride = (size_t)rows * B;
  const int8_t* h = hqt + (size_t)j * B + bg;

  uint32_t acc[kGroup];
#pragma unroll
  for (int p = 0; p < kGroup; ++p) acc[p] = 0;

  for (int k0 = 0; k0 < K; k0 += CH) {
    const int nk = min(CH, K - k0);
    if (k0) __syncthreads();  // the last chunk's lanes are read
    // the chunk's slab loads, all in flight before any arithmetic ...
    uint4 hv[CH];
#pragma unroll
    for (int kk = 0; kk < CH; ++kk) {
      hv[kk] = make_uint4(0, 0, 0, 0);
      if (live && kk < nk) hv[kk] = *reinterpret_cast<const uint4*>(h + (k0 + kk) * kstride);
    }
    // ... while the chunk's lanes of the block's problems land by cp.async
    if (LVEC) {
      const int nc = (nk + 3) >> 2;
      for (int i = tid; i < kProbs * nc; i += kThreads) {
        const int p = i / nc, c = i - p * nc;
        const bool ok = b0 + p < B;
        pint::cp_async16(s_l + lane_at(p) + 4 * c,
                         ok ? lanes + (size_t)(b0 + p) * K + k0 + 4 * c : lanes, ok);
      }
    } else {
      for (int i = tid; i < kProbs * nk; i += kThreads) {
        const int p = i / nk, kk = i - p * nk;
        const bool ok = b0 + p < B;
        pint::cp_async4(s_l + lane_at(p) + kk,
                        ok ? lanes + (size_t)(b0 + p) * K + k0 + kk : lanes, ok);
      }
    }
    pint::cp_async_commit();
    pint::cp_async_wait<0>();
    __syncthreads();
    // Lanes within int8 (all the solvers pass) go through __dp4a on k-quads,
    // packed 4 to a word here (0 past nk); any other lane makes the block
    // take the exact path below.  Either way the sum is exact modulo 2^32.
    bool small = true;
    for (int p = tid; p < kProbs; p += kThreads) {
      const int* l = s_l + lane_at(p);
#pragma unroll
      for (int k4 = 0; k4 < CH; k4 += 4) {
        const int4 v = *reinterpret_cast<const int4*>(l + k4);
        const int xs[4] = {v.x, v.y, v.z, v.w};
        uint32_t word = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x = k4 + i < nk ? xs[i] : 0;
          small = small && x >= -128 && x <= 127;
          word |= (uint32_t)(x & 0xFF) << (8 * i);
        }
        s_p[p * kPackStride + k4 / 4] = word;
      }
    }
    if (__syncthreads_and(small)) {
#pragma unroll
      for (int k4 = 0; k4 < CH; k4 += 4) {
        if (k4 < nk) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t o[4];
            quad_t(word_of(hv[k4], q), word_of(hv[k4 + 1], q), word_of(hv[k4 + 2], q),
                   word_of(hv[k4 + 3], q), o);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int pp = g * kGroup + 4 * q + i;
              acc[4 * q + i] = (uint32_t)__dp4a((int)o[i], (int)s_p[pp * kPackStride + k4 / 4],
                                                (int)acc[4 * q + i]);
            }
          }
        }
      }
      continue;
    }
    // k in order within the chunk: 4 k of a problem's lanes a 16-byte read
    // (a k past nk meets a zero slab byte)
#pragma unroll
    for (int k4 = 0; k4 < CH; k4 += 4) {
      if (k4 < nk) {
#pragma unroll
        for (int p = 0; p < kGroup; ++p) {
          const uint4 l = *reinterpret_cast<const uint4*>(s_l + lane_at(g * kGroup + p) + k4);
          const uint32_t lw[4] = {l.x, l.y, l.z, l.w};
          const uint32_t sel = 0x8880u + 0x1111u * (p & 3);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[p] += sext8(word_of(hv[k4 + i], p >> 2), sel) * lw[i];
        }
      }
    }
  }

  // results through shared memory: a problem's 16 rows go out as one run
#pragma unroll
  for (int p = 0; p < kGroup; ++p) {
    const int pp = g * kGroup + p;
    s_o[jj * kOutStride + pp + (pp >> 4)] = (int)acc[p];
  }
  __syncthreads();
  for (int i = tid; i < kProbs * kRows; i += kThreads) {
    const int p = i / kRows, r = i - p * kRows;
    const int jo = blockIdx.y * kRows + r;
    if (b0 + p < B && jo < rows)
      out[(size_t)(b0 + p) * rows + jo] = s_o[r * kOutStride + p + (p >> 4)];
  }
}

// The first design: 32 problems x 8 rows a block, one row a warp, lane b on
// problem b0 + b, so a warp's read of one (k, j) is 32 consecutive bytes (any
// B and alignment); the lanes staged transposed, kStage k at a time, the
// results through shared memory.
namespace bytes {

constexpr int kProbs = 32;  // problems a block: one a warp lane
constexpr int kRows = 8;    // output rows a block, one a warp
constexpr int kWarps = 8;
constexpr int kStage = 64;  // k a stage of lanes

__global__ void __launch_bounds__(kWarps * 32)
matvec_bytes_kernel(const int* __restrict__ lanes, const int8_t* __restrict__ hqt,
                    int* __restrict__ out, int B, int K, int rows) {
  __shared__ int s_l[kStage * (kProbs + 1)];  // [k][problem]
  __shared__ int s_o[kProbs * (kRows + 1)];   // [problem][row]
  const int b0 = blockIdx.x * kProbs;
  const int j0 = blockIdx.y * kRows;
  const int nb = min(kProbs, B - b0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = j0 + warp;
  const size_t kstride = (size_t)rows * B;
  const bool live = j < rows && lane < nb;
  const int8_t* h = hqt + (size_t)j * B + b0 + lane;
  uint32_t acc = 0;
  for (int k0 = 0; k0 < K; k0 += kStage) {
    const int nk = min(kStage, K - k0);
    if (k0) __syncthreads();  // the last stage's lanes are read
    for (int i = threadIdx.x; i < kProbs * nk; i += blockDim.x) {
      const int p = i / nk;
      const int k = i - p * nk;
      s_l[k * (kProbs + 1) + p] = p < nb ? lanes[(size_t)(b0 + p) * K + k0 + k] : 0;
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int k = 0; k < nk; ++k)
        acc += (uint32_t)(int)h[(size_t)(k0 + k) * kstride] *
               (uint32_t)s_l[k * (kProbs + 1) + lane];
    }
  }
  s_o[lane * (kRows + 1) + warp] = (int)acc;
  __syncthreads();
  for (int i = threadIdx.x; i < kProbs * kRows; i += blockDim.x) {
    const int p = i / kRows;
    const int jj = i - p * kRows;
    if (p < nb && j0 + jj < rows)
      out[(size_t)(b0 + p) * rows + j0 + jj] = s_o[p * (kRows + 1) + jj];
  }
}

}  // namespace bytes

}  // namespace

// lanes (B, K) int32, hqt (K, rows, B) int8 -> out (B, rows) int32
extern "C" int pint_matvec_cols(const void* lanes, const void* hqt, void* out,
                                int B, int K, int rows, void* stream) {
  // rows tiles of 16 on the grid's y axis (at most 65535)
  if (B <= 0 || K <= 0 || rows <= 0 || (rows + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const int* l = static_cast<const int*>(lanes);
  const int8_t* h = static_cast<const int8_t*>(hqt);
  int* o = static_cast<int*>(out);
  cudaStream_t strm = static_cast<cudaStream_t>(stream);
  if ((long long)K * rows <= 1024 || B % kGroup != 0 ||
      reinterpret_cast<uintptr_t>(hqt) % 16 != 0) {
    const dim3 grid((B + bytes::kProbs - 1) / bytes::kProbs,
                    (rows + bytes::kRows - 1) / bytes::kRows);
    if (grid.y > 65535) return (int)cudaErrorInvalidValue;
    bytes::matvec_bytes_kernel<<<grid, bytes::kWarps * 32, 0, strm>>>(l, h, o, B, K, rows);
    return (int)cudaGetLastError();
  }
  const dim3 grid((B + kProbs - 1) / kProbs, (rows + kRows - 1) / kRows);
  const bool lvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(lanes) % 16 == 0;
  auto kernel = lvec ? matvec_cols_kernel<true> : matvec_cols_kernel<false>;
  kernel<<<grid, kThreads, 0, strm>>>(l, h, o, B, K, rows);
  return (int)cudaGetLastError();
}
