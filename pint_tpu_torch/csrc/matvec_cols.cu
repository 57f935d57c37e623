// K10: one tp rank's column matvec, launched once a PGD iteration of the
// column-sharded inners, with the int32 all-reduce between launches.
//
// Replaces pint_tpu/mpc/fused_alm.py:429 (_matvec_kernel_factory, entry
// pgd_matvec_cols at :441, pallas_call at :482).  For each problem b and
// output row j:
//   out[b, j] = sum_k hqt_r[k, j, b] * lanes[b, k]
// over this rank's K columns, in uint32_t so it wraps as XLA's int32 does.
// rows is Tm (DeviceSQP) or Tm + Cp (the constrained combined slab).
//
// What bounds it on the H100: one launch reads the rank's K x rows x B int8
// slab once (8 MiB at K = 32, rows = 64, B = 4096) and does one MAC a byte,
// so it is bound by device memory and, at 30-90 launches an SQP iteration,
// by launches.  Design: a block takes 32 problems x 8 output rows, one row
// a warp.  Lane b of each warp owns problem b0 + b, so with the slab
// batch-last the warp's 32 reads of one (k, j) entry are 32 consecutive
// bytes.  Each warp's K loads are independent, so the kernel is bound by
// how many are in flight: small row tiles give many blocks (1024 at B =
// 4096, rows = 64).  The block's lanes[b0:b0+32, :] are staged once,
// transposed, in shared memory, and the 32 x 8 results go back through
// shared memory so that each problem's row segment is written as one
// contiguous run.  Both tiles are padded by one word a row against bank
// conflicts.  __dp4a over 4-column groups is later work.
#include "common.cuh"

namespace {

constexpr int kProbs = 32;  // problems a block: one a warp lane
constexpr int kRows = 8;    // output rows a block, one a warp
constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
matvec_cols_kernel(const int* __restrict__ lanes,
                   const int8_t* __restrict__ hqt, int* __restrict__ out,
                   int B, int K, int rows) {
  extern __shared__ int smem[];
  int* s_l = smem;                           // [K][kProbs + 1]
  int* s_o = smem + K * (kProbs + 1);        // [kProbs][kRows + 1]
  const int b0 = blockIdx.x * kProbs;
  const int j0 = blockIdx.y * kRows;
  const int nb = min(kProbs, B - b0);

  for (int i = threadIdx.x; i < kProbs * K; i += blockDim.x) {
    const int p = i / K;
    const int k = i - p * K;
    s_l[k * (kProbs + 1) + p] = p < nb ? lanes[(size_t)(b0 + p) * K + k] : 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t kstride = (size_t)rows * B;
  for (int jj = warp; jj < kRows; jj += kWarps) {
    const int j = j0 + jj;
    uint32_t acc = 0;
    if (j < rows && lane < nb) {
      const int8_t* h = hqt + (size_t)j * B + b0 + lane;
#pragma unroll 8
      for (int k = 0; k < K; ++k)
        acc += (uint32_t)(int)h[k * kstride] *
               (uint32_t)s_l[k * (kProbs + 1) + lane];
    }
    s_o[lane * (kRows + 1) + jj] = (int)acc;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kProbs * kRows; i += blockDim.x) {
    const int p = i / kRows;
    const int jj = i - p * kRows;
    if (p < nb && j0 + jj < rows)
      out[(size_t)(b0 + p) * rows + j0 + jj] = s_o[p * (kRows + 1) + jj];
  }
}

}  // namespace

// lanes (B, K) int32, hqt (K, rows, B) int8 -> out (B, rows) int32
extern "C" int pint_matvec_cols(const void* lanes, const void* hqt, void* out,
                                int B, int K, int rows, void* stream) {
  // the staged lanes and the result tile; K <= 1752 fits a block
  const long long smem =
      4LL * ((long long)K * (kProbs + 1) + kProbs * (kRows + 1));
  if (B <= 0 || K <= 0 || rows <= 0 || smem > (long long)kPintMaxSmem ||
      (rows + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = pint_allow_smem(matvec_cols_kernel, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + kProbs - 1) / kProbs, (rows + kRows - 1) / kRows);
  matvec_cols_kernel<<<grid, kWarps * 32, (size_t)smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lanes), static_cast<const int8_t*>(hqt),
      static_cast<int*>(out), B, K, rows);
  return (int)cudaGetLastError();
}
