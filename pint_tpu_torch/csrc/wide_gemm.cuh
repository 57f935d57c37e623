// The wide forms of K2, K2p and K7 (past 256 lanes or rows): each pass of
// their loops is one int8 product across the whole batch, run by a grid of
// blocks that stays resident for the whole call.
//
// Every problem shares Hq (and K7's Sq), so an iteration is a GEMM with an
// elementwise epilogue: the batch's int8 vectors (B x K) times a shared
// int8 matrix whose rows are the output columns (N x K: Hq, [Hq; Sq] or
// Sq^T).  A block is one warpgroup; it computes output tiles of 64
// problems x 128 columns (K7's second pass: 64 x 64 for two matrices, y_hi
// and y_lo, against one B tile) with wgmma m64nNk32 s8 -> s32, both
// operands read from shared memory (64 accumulators a thread).  Two
// blocks share an SM, so one block's epilogue overlaps another's product.
//
// The operands live in the caller's scratch in a tiled layout (tiled()):
// blocks of 128 rows x 64 bytes of k, 8 KB each, with the 64-byte swizzle
// that wgmma reads, written by the kernel's first pass (K padded to a
// multiple of 64 and the rows to 128 with zeros, so columns past the true
// K meet zero B rows).  A chunk of a tile (A's 64 rows, B's 128) is then
// two contiguous bulk copies (cp.async.bulk) that one thread issues and
// an mbarrier counts, into a ring of kStages slots; so a byte of Hq
// fetched from L2 feeds 64 problems, not 16, and no thread spends
// instructions on addresses.  Rows of A past the batch hold whatever the
// scratch holds and are never stored (an int8 product cannot trap).
//
// Passes are separated by a grid barrier (cooperative_groups::this_grid,
// under cudaLaunchCooperativeKernel, which refuses a grid that the card
// cannot hold at once; the wrappers then raise).  One launch a call.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace pint {
namespace wide {

constexpr int kThreads = 128;              // one warpgroup a block
constexpr int kTileM = 64, kTileN = 128;   // output tile: problems x columns (paired: 64 x 64)
constexpr int kTileK = 64;                 // bytes of k a chunk
constexpr int kChunk = 128 * kTileK;       // a block of 128 rows x 64 bytes: 8 KB
constexpr int kHalf = kChunk / 2;          // 64 of its rows
constexpr int kStages = 6;                 // slots in the ring (5 chunks in flight)
constexpr int kSlot = 3 * kHalf;           // A's 64 rows and B's 128 (paired: A's two, B's 64)
constexpr size_t kSmem = (size_t)kStages * kSlot + kStages * sizeof(uint64_t);  // 72 KB
constexpr int kBlocksPerSm = 2;            // blocks an SM holds (up to 255 registers a thread)

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

__host__ __device__ constexpr size_t round16(size_t x) { return (x + 15) / 16 * 16; }

// The tiled layout of an operand with nkc chunks of k (kp = 64 nkc bytes a
// row; rows padded to a multiple of 128): block (row / 128, k / 64) is
// 8 KB at ((row / 128) nkc + k / 64) 8 KB, row r = row % 128 at r 64 within
// it, and its 16-byte piece p at p ^ ((r >> 1) & 3): a block is one bulk
// copy, and the layout is wgmma's 64-byte swizzle.
__host__ __device__ inline size_t tiled(int row, int k, int nkc) {
  const int r = row & 127, p = (k >> 4) & 3;
  return (((size_t)(row >> 7) * nkc + (k >> 6)) * 128 + r) * 64 + ((p ^ ((r >> 1) & 3)) << 4) +
         (k & 15);
}

// what this thread wrote with ordinary stores is visible to the bulk
// copies (the async proxy) of any block after the next grid barrier
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// One output tile's operands, as tiled-layout blocks at chunk 0 (chunk kt
// is kt 8 KB further): A's 64 rows are the 4 KB at a0 and B's 128 rows the
// 8 KB at b; paired (a1 not null), a1 holds the same 64 problems of a
// second matrix and b 64 rows of B (4 KB); nk chunks.
struct Tile {
  const int8_t *a0, *a1, *b;
  int nk;
};

// The block's ring: kStages slots of A's and B's chunk, each with an
// mbarrier that its bulk copies complete; `next` counts the chunks this
// block has taken, so chunk g lives in slot g % kStages, use g / kStages.
struct Ring {
  unsigned char* smem;
  uint64_t* bar;
  int next;
  __device__ __forceinline__ explicit Ring(unsigned char* s)
      : smem(s), bar(reinterpret_cast<uint64_t*>(s + kStages * kSlot)), next(0) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(&bar[i], 1);
      mbar_init_fence();
    }
    __syncthreads();
  }
  // thread 0: chunk kt of tile t, the ring's chunk g
  __device__ __forceinline__ void issue(const Tile& t, int kt, int g) {
    if (threadIdx.x != 0) return;
    const int slot = g % kStages;
    unsigned char* d = smem + slot * kSlot;
    const size_t off = (size_t)kt * kChunk;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the slot's reads are done
    mbar_expect_tx(&bar[slot], kSlot);
    bulk_load(d, t.a0 + off, kHalf, &bar[slot]);
    if (t.a1 != nullptr) {
      bulk_load(d + kHalf, t.a1 + off, kHalf, &bar[slot]);
      bulk_load(d + 2 * kHalf, t.b + off, kHalf, &bar[slot]);
    } else {
      bulk_load(d + kHalf, t.b + off, kChunk, &bar[slot]);
    }
  }
  // the first kStages - 1 chunks of the tile the block takes next
  __device__ __forceinline__ void prologue(const Tile& t) {
    for (int s = 0; s < kStages - 1 && s < t.nk; ++s) issue(t, s, next + s);
  }
};

// -- the product on wgmma ------------------------------------------------------
//
// A chunk in the tiled layout is exactly wgmma's K-major operand with the
// 64-byte swizzle: 8-row atoms of 512 bytes (SBO), 16-byte pieces XORed
// with (row >> 1) & 3 (the ring's slots sit at multiples of 12 KB from a
// 1 KB-aligned base, its 4 KB halves on 512-byte atoms).  The second k32
// step of a chunk starts 32 bytes further.  The block's warpgroup runs
// m64nNk32 s8 -> s32 with both operands read from shared memory.

__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving the accumulators' reads and writes across
// the asynchronous products
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (m64n128 s32, 64 a thread) += A . B over one k32 step, both from shared memory
__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64n64 s32, 32 a thread) += A . B over one k32 step, both from shared memory
__device__ __forceinline__ void wgmma_n64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// acc = A . B^T for one output tile whose prologue() has been issued, on
// wgmma.  PAIRED false: m64n128, acc[4 i + 2 h + q] is A's row 16 w + gq +
// 8 h (w the warp), column 8 i + 2 tq + q.  PAIRED true (K7's pass 2): two
// m64n64 against the same 64 B rows, acc[4 i + 2 h + q] from A's first
// matrix and acc[32 + 4 i + 2 h + q] from its second, row 16 w + gq + 8 h,
// column 8 i + 2 tq + q.  The block's threads all call it; it leaves the
// ring free.
template <bool PAIRED>
__device__ __forceinline__ void product(int (&acc)[64], const Tile& t, Ring& ring) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  fence_acc(acc);
  for (int kt = 0; kt < t.nk; ++kt) {
    const int g = ring.next + kt;
    mbar_wait(&ring.bar[g % kStages], (g / kStages) & 1);
    const unsigned char* sa = ring.smem + (g % kStages) * kSlot;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kTileK / 32; ++ks) {
      if constexpr (PAIRED) {
        const uint64_t db = wg_desc(sa + 2 * kHalf + 32 * ks);
        wgmma_n64(acc, wg_desc(sa + 32 * ks), db);
        wgmma_n64(acc + 32, wg_desc(sa + kHalf + 32 * ks), db);
      } else {
        wgmma_n128(acc, wg_desc(sa + 32 * ks), wg_desc(sa + kHalf + 32 * ks));
      }
    }
    wg_commit();
    wg_wait<1>();     // the products of chunk kt - 1 are done
    __syncthreads();  // in every warp: chunk kt - 1's slot is free
    if (kt + kStages - 1 < t.nk) ring.issue(t, kt + kStages - 1, g + kStages - 1);
  }
  wg_wait<0>();
  fence_acc(acc);
  ring.next += t.nk;
  __syncthreads();  // every warp is done with the ring
}

// Every tile of a pass, tile(t) for t = blockIdx.x, + gridDim.x, ... below
// `tiles`: the product, then epilogue(t, acc), with the next tile's first
// chunks already in flight during the epilogue.  Ends with the proxy fence
// that lets the next pass's bulk copies see what the epilogues stored.
template <bool PAIRED = false, typename TileOf, typename Epilogue>
__device__ __forceinline__ void for_tiles(int tiles, TileOf tile, Epilogue epilogue,
                                          Ring& ring) {
  int t = blockIdx.x;
  if (t < tiles) ring.prologue(tile(t));
  for (; t < tiles; t += gridDim.x) {
    int acc[64];
    product<PAIRED>(acc, tile(t), ring);
    if (t + (int)gridDim.x < tiles) ring.prologue(tile(t + gridDim.x));
    epilogue(t, acc);
  }
  fence_to_async();
}

// for u in [0, n) across the grid, U items a thread at a time, the U loads
// issued before any store (so they are in flight together)
template <int U, typename T, typename Load, typename Store>
__device__ __forceinline__ void grid_copy(long n, Load load, Store store) {
  const long step = (long)gridDim.x * blockDim.x;
  for (long u0 = (long)blockIdx.x * blockDim.x + threadIdx.x; u0 < n; u0 += U * step) {
    T v[U];
#pragma unroll
    for (int q = 0; q < U; ++q)
      if (u0 + q * step < n) v[q] = load(u0 + q * step);
#pragma unroll
    for (int q = 0; q < U; ++q)
      if (u0 + q * step < n) store(u0 + q * step, v[q]);
  }
  fence_to_async();
}

// Where a thread's accumulators lie in the tile (product's layouts):
// acc[4 i + 2 h + q] (paired: and acc[32 + 4 i + 2 h + q]) is row row(h),
// column col(i) + q.
struct Frag {
  int w, gq, tq;
  __device__ __forceinline__ Frag() {
    w = threadIdx.x >> 5;
    gq = (threadIdx.x & 31) >> 2;
    tq = threadIdx.x & 3;
  }
  __device__ __forceinline__ int row(int h) const { return 16 * w + gq + 8 * h; }
  __device__ __forceinline__ int col(int i) const { return 8 * i + 2 * tq; }
};

// -- the epilogues ------------------------------------------------------------
//
// An epilogue first moves the tile's accumulators out of the wgmma
// fragments into shared memory past the ring (acc_to_smem), then steps the
// tile in groups of 4 lanes: thread u takes lanes 4 (u % 16) + 64 m of rows
// u / 16 + 8 k, so each load and store of a warp covers two rows'
// contiguous bytes (int32 arrays row-major; int8 operands a row's 64 bytes
// of the tiled layout), each group's address is a constant offset from its
// row's, and a thread's loads are all issued before its steps.  Stepping
// the fragments' lane pairs where they lie (2-byte loads and stores, an
// address a pair) left the epilogue, which runs on 8 warps an SM, bound by
// its instructions' latency.

// 64 rows of kAccRow int32 (8 words more than 128, so that the fragments'
// 8-byte stores meet no bank twice), after the ring
constexpr int kAccRow = 136;
constexpr size_t kSmemAcc = kSmem + 64 * kAccRow * 4;  // 106 KB

// acc (product's layouts) into accs: row row(h), column col(i) + q holds
// acc[4 i + 2 h + q], i < 16 (paired: the first matrix in columns 0-63, the
// second in 64-127); then a barrier
__device__ __forceinline__ void acc_to_smem(const int (&acc)[64], int* accs) {
  const Frag f;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      *reinterpret_cast<int2*>(accs + f.row(h) * kAccRow + f.col(i)) =
          make_int2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
  __syncthreads();
}

// this thread's group: lanes lanes4() of row rows8() + 8 k
__device__ __forceinline__ int lanes4() { return 4 * (threadIdx.x & 15); }
__device__ __forceinline__ int rows8() { return threadIdx.x >> 4; }

// lane k of an int4 (k a constant once unrolled)
__device__ __forceinline__ int& lane(int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// int8 lane k of a word (the first lane in the low byte)
__device__ __forceinline__ int lane8(uint32_t w, int k) { return (int)(int8_t)(w >> (8 * k)); }

// four int32 lanes of an array this kernel writes (L2, not L1), and back;
// 16-byte accesses when vec16
__device__ __forceinline__ int4 ld4cg(const int* p, bool vec16) {
  if (vec16) return __ldcg(reinterpret_cast<const int4*>(p));
  return make_int4(__ldcg(p), __ldcg(p + 1), __ldcg(p + 2), __ldcg(p + 3));
}

__device__ __forceinline__ void st4(int* p, bool vec16, int4 v) {
  if (vec16) {
    *reinterpret_cast<int4*>(p) = v;
  } else {
    p[0] = v.x, p[1] = v.y, p[2] = v.z, p[3] = v.w;
  }
}

// four int8 lanes written by another block since the kernel began (L2)
__device__ __forceinline__ uint32_t ld8x4(const int8_t* p) {
  return __ldcg(reinterpret_cast<const unsigned*>(p));
}

// four int32 lanes at p (16-byte aligned when vec16)
__device__ __forceinline__ int4 ld_lanes4(const int* p, bool vec16) {
  if (vec16) return __ldg(reinterpret_cast<const int4*>(p));
  return make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// the low bytes of four lanes as one word (the first lane in the low byte)
__device__ __forceinline__ uint32_t bytes4(int4 v) {
  return (uint32_t)(v.x & 0xff) | (uint32_t)(v.y & 0xff) << 8 | (uint32_t)(v.z & 0xff) << 16 |
         (uint32_t)(v.w & 0xff) << 24;
}

// four bytes of a row-major int8 matrix whose rows may start at any byte
__device__ __forceinline__ uint32_t ld4(const int8_t* p, bool al4) {
  if (al4) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t w = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) w |= (uint32_t)(uint8_t)__ldg(p + q) << (8 * q);
  return w;
}

__device__ __forceinline__ void grid_sync() { cooperative_groups::this_grid().sync(); }

// Launch `kernel` (smem bytes of shared memory: the ring's kSmem first) as
// one cooperative grid of as many blocks as the card holds at once (plus
// extra_blocks, which only the card tests' check of a refused launch sets:
// the runtime then refuses the grid, and the refusal is returned, not left
// behind).
template <typename Args>
cudaError_t launch(void (*kernel)(Args), Args a, size_t smem, cudaStream_t stream,
                   int extra_blocks = 0) {
  cudaError_t err = pint_allow_smem(kernel, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(per_sm * sms + extra_blocks), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace pint
