// Helpers shared by the port's kernels (pint_tpu_torch/csrc/*.cu).
//
// Integer arithmetic that XLA defines to wrap modulo 2^32 (the PGD step's
// `acc * hs_num`, `-(pre + g)`, `delta << g_shift`) is done here in uint32_t
// and cast back: signed overflow is undefined in C++, and nvcc may assume it
// never happens.  `>>` of a negative int is arithmetic under nvcc, as XLA's
// shift_right_arithmetic is.
#pragma once

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

// int8 . int8 -> int32 dot of one Hessian row against the lane vector, both
// packed four int8 values to a word.  Exact: |sum| <= 128 * 127 * Tp.
__device__ __forceinline__ int dot_i8(const int* row, const int* lanes,
                                      int words) {
  int acc = 0;
  for (int w = 0; w < words; ++w) acc = __dp4a(row[w], lanes[w], acc);
  return acc;
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
