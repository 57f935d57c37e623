// Helpers shared by the port's kernels (pint_tpu_torch/csrc/*.cu).
//
// Integer arithmetic that XLA defines to wrap modulo 2^32 (the PGD step's
// `acc * hs_num`, `-(pre + g)`, `delta << g_shift`) is done here in uint32_t
// and cast back: signed overflow is undefined in C++, and nvcc may assume it
// never happens.  `>>` of a negative int is arithmetic under nvcc, as XLA's
// shift_right_arithmetic is.
#pragma once

#include <cudaTypedefs.h>  // CUtensorMap, PFN_cuTensorMapEncodeTiled
#include <cuda_runtime.h>
#include <stdint.h>

namespace pint {

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

__device__ __forceinline__ int wrap_shl(int a, int s) {
  return (int)((uint32_t)a << s);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// max that propagates NaN, as jnp.max and torch.amax do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// -- asynchronous staging (K3, K4, K5) ----------------------------------------
//
// cp.async copies global memory into shared memory without passing through
// registers.  A thread learns that its own copies have landed either by
// cp.async.wait_group or by arriving on an mbarrier when they land
// (cp.async.mbarrier.arrive.noinc), which lets one group of warps fill a
// buffer that another group then waits for.  A TMA copy (one thread, one
// box of a tensor map) counts its bytes down on an mbarrier instead.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (both addresses 16-byte aligned), or 16 zero bytes when !valid
// (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes (both addresses 8-byte aligned)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 4 bytes, or 4 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive on `bar` once every cp.async this thread has issued has landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive on `bar` and add `bytes` to the bytes its phase waits for (those of
// the bulk copies that complete on it)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: copy the box at element coordinates (x, y, z) of the 3-D tensor map
// `map` (a __grid_constant__ kernel parameter) to `dst`; its bytes complete
// on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int x, int y,
                                            int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_addr(bar))
      : "memory");
}

// bulk copy of `bytes` contiguous bytes (a multiple of 16; both addresses
// 16-byte aligned) from global to shared memory; its bytes complete on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ask L2 to fetch `bytes` contiguous bytes (a multiple of 16, src 16-byte
// aligned) ahead of their use; no thread waits for it
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// barrier over `threads` threads (a multiple of 32) under named barrier `id`
// (1..15; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace pint

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
static cudaError_t pint_allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Shared memory a block may use on sm_90 (227 KB).
constexpr size_t kPintMaxSmem = 232448;

// K4 past 64 lanes (defined in alm.cu, launched by pgd_hqt.cu's entries):
// one problem a cluster of blocks.  words: lanes and out are the (B, Tp/4)
// packed control words, else (B, Tp) int32 lanes; hqt_pm: hqt problem-major
// (hqt[b Tp^2 + j Tp + k]), else batch-last.
cudaError_t pint_pgd_wide(const void* lanes, const int* g, const int8_t* hqt,
                          const int* hs_num, const int* hs_den, void* out, int B,
                          int Tp, int iters, int g_shift, bool words, bool hqt_pm,
                          cudaStream_t stream);

// Blocks of `kernel` (`threads` threads, `smem` bytes) for a grid that
// stays resident: as many as fit on every SM at once, and no more than
// `work` items.
template <typename K>
static cudaError_t pint_persistent_grid(K kernel, int threads, size_t smem,
                                        int work, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long cap = (long)per_sm * sms;
  *grid = (int)(work < cap ? work : cap);
  return cudaSuccess;
}

// A 3-D tensor map of f32 (dims innermost first; strides in bytes of dims 1
// and 2) with boxes of `box`, in the 32-byte swizzle (K3's oct_word, K6's
// too) and 128-byte L2 promotion; out-of-bounds box elements land as zeros.
// The encoder comes from the CUDA runtime's entry-point query (no link to
// libcuda).
static inline cudaError_t pint_encode_map3d_f32(CUtensorMap* map, const float* base,
                                                const cuuint64_t dims[3],
                                                const cuuint64_t strides[2],
                                                const cuuint32_t box[3]) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                            const_cast<float*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
