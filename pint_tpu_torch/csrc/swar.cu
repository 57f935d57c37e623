// K1, K9, K8 and their u64 pair forms K11a-c: the SWAR elementwise kernels.
//
// Replaces pint_tpu/ops/pallas.py: _binop_impl (:148, pallas_call :104),
// _shift_impl (:306, :324), _sat_accum_impl (:407, :433), _binop_pair_impl
// (:222, :248), _shift_pair_impl (:341, :364) and _sat_accum_split_impl
// (:469, :506).  Six TPU kernels become three kernel bodies -- binop, shift
// and sat_accum -- each templated on the word type (uint8_t ... uint64_t)
// and on its I/O: native words, or (uint64_t only) planar u32 pairs, a low
// plane and a high plane combined into one uint64_t in registers and split
// again on store.  Hopper has 64-bit integer ALUs, so the pair forms run the
// same formulas as the native u64 words; the TPU's SplitWord emulation is
// not needed.
//
// What bounds them on the H100: a word costs 10-50 integer ops (swar.cuh)
// and 2-3 words of device-memory traffic (binop: 2 in, 1 out; shift: 1 in,
// 1 out; sat_accum: 1 + steps in, 1 out), far below the card's integer rate
// per byte, so every kernel is bound by device memory, and what limits it
// is how many bytes each thread has in flight.  Design: one pass; each
// thread takes kWords words (coalesced: word u of a block's threads is one
// contiguous run) and issues all their loads before any arithmetic, with a
// flat bounds check (the TPU's (rows, 512) padding is not needed).  A
// grid-stride loop over one word a thread ran at 0.62 of the raw int32 add's
// rate on an H100 80GB HBM3 (700 W): its loop set-up runs before the first
// load of a thread that lives for one word.  The layout's masks arrive by value in the parameter space; the
// shift amount's masks are worked out once per thread.  The shift amount is
// read from device memory when it is a tensor on the card, so a shift needs
// no host sync.
#include "common.cuh"
#include "swar.cuh"

namespace {

using pint::SwarLayout;
using pint::Word;

constexpr int kThreads = 256;
constexpr int kWords = 4;  // words a thread
constexpr int64_t kBlockWords = kThreads * kWords;

// Word u of this thread: index base + u * kThreads (coalesced across threads).
__device__ __forceinline__ int64_t word_base() {
  return (int64_t)blockIdx.x * kBlockWords + threadIdx.x;
}

// Word i of a native array, or of a planar pair array whose high plane
// starts `hi` words after its low plane.
template <typename T, bool PAIR>
__device__ __forceinline__ Word<T> load(const void* p, int64_t i, int64_t hi) {
  if constexpr (PAIR) {
    const uint32_t* q = static_cast<const uint32_t*>(p);
    return Word<T>((uint64_t)q[i] | ((uint64_t)q[hi + i] << 32));
  } else {
    return Word<T>(static_cast<const T*>(p)[i]);
  }
}

template <typename T, bool PAIR>
__device__ __forceinline__ void store(void* p, int64_t i, int64_t hi, Word<T> w) {
  if constexpr (PAIR) {
    uint32_t* q = static_cast<uint32_t*>(p);
    q[i] = (uint32_t)w.v;
    q[hi + i] = (uint32_t)(w.v >> 32);
  } else {
    static_cast<T*>(p)[i] = w.v;
  }
}

template <typename T, int OP, bool PAIR>
__global__ void __launch_bounds__(kThreads)
binop_kernel(const void* __restrict__ a, const void* __restrict__ b,
             void* __restrict__ out, int64_t n, const SwarLayout L) {
  const int64_t base = word_base();
  Word<T> x[kWords], y[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < n) {
      x[u] = load<T, PAIR>(a, i, n);
      y[u] = load<T, PAIR>(b, i, n);
    }
  }
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < n) store<T, PAIR>(out, i, n, pint::binop<T, OP>(L, x[u], y[u]));
  }
}

template <typename T, bool LEFT, bool PAIR>
__global__ void __launch_bounds__(kThreads)
shift_kernel(const void* __restrict__ v, void* __restrict__ out, int64_t n,
             const int64_t* __restrict__ amount_dev, int64_t amount,
             const SwarLayout L) {
  const int64_t base = word_base();
  Word<T> x[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < n) x[u] = load<T, PAIR>(v, i, n);
  }
  const uint64_t raw = (uint64_t)(amount_dev ? *amount_dev : amount);
  const pint::ShiftPlan<T> plan = pint::shift_plan<T, LEFT>(L, raw);
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < n) store<T, PAIR>(out, i, n, pint::apply_shift<T, LEFT>(plan, x[u]));
  }
}

// deltas are (steps, n) words; as pairs, (2, steps, n)
template <typename T, bool SIGNED, bool PAIR>
__global__ void __launch_bounds__(kThreads)
sat_accum_kernel(const void* __restrict__ acc, const void* __restrict__ d,
                 void* __restrict__ out, int64_t n, int steps,
                 const SwarLayout L) {
  const int64_t base = word_base();
  const int64_t dhi = (int64_t)steps * n;
  Word<T> x[kWords];
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < n) x[u] = load<T, PAIR>(acc, i, n);
  }
  for (int s = 0; s < steps; ++s) {
    Word<T> y[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int64_t i = base + u * kThreads;
      if (i < n) y[u] = load<T, PAIR>(d, (int64_t)s * n + i, dhi);
    }
#pragma unroll
    for (int u = 0; u < kWords; ++u)
      x[u] = SIGNED ? pint::add_signed_saturate(L, x[u], y[u])
                    : pint::add_unsigned_saturate(L, x[u], y[u]);
  }
#pragma unroll
  for (int u = 0; u < kWords; ++u) {
    const int64_t i = base + u * kThreads;
    if (i < n) store<T, PAIR>(out, i, n, x[u]);
  }
}

// Blocks covering n words; gridDim.x is below 2^31.
constexpr int64_t kMaxWords = (((int64_t)1 << 31) - 1) * kBlockWords;

unsigned grid_for(int64_t n) {
  return (unsigned)((n + kBlockWords - 1) / kBlockWords);
}

bool layout_ok(const SwarLayout* L) {
  return L && L->n_sat >= 1 && L->n_sat <= pint::kMaxTerms &&
         L->n_groups >= 1 && L->n_groups <= pint::kMaxTerms &&
         L->max_width >= 1 && L->max_width <= 64;
}

template <typename T, bool PAIR>
cudaError_t launch_binop(int op, const void* a, const void* b, void* out,
                         int64_t n, const SwarLayout& L, cudaStream_t s) {
  const unsigned g = grid_for(n);
  switch (op) {
#define PINT_OP(k)                                                         \
  case k:                                                                  \
    binop_kernel<T, k, PAIR><<<g, kThreads, 0, s>>>(a, b, out, n, L);      \
    break;
    PINT_OP(0) PINT_OP(1) PINT_OP(2) PINT_OP(3) PINT_OP(4)
    PINT_OP(5) PINT_OP(6) PINT_OP(7) PINT_OP(8) PINT_OP(9)
#undef PINT_OP
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, bool PAIR>
cudaError_t launch_shift(int left, const void* v, void* out, int64_t n,
                         const int64_t* amount_dev, int64_t amount,
                         const SwarLayout& L, cudaStream_t s) {
  const unsigned g = grid_for(n);
  if (left)
    shift_kernel<T, true, PAIR><<<g, kThreads, 0, s>>>(v, out, n, amount_dev,
                                                       amount, L);
  else
    shift_kernel<T, false, PAIR><<<g, kThreads, 0, s>>>(v, out, n, amount_dev,
                                                        amount, L);
  return cudaGetLastError();
}

template <typename T, bool PAIR>
cudaError_t launch_sat_accum(int is_signed, const void* acc, const void* d,
                             void* out, int64_t n, int steps,
                             const SwarLayout& L, cudaStream_t s) {
  const unsigned g = grid_for(n);
  if (is_signed)
    sat_accum_kernel<T, true, PAIR><<<g, kThreads, 0, s>>>(acc, d, out, n,
                                                           steps, L);
  else
    sat_accum_kernel<T, false, PAIR><<<g, kThreads, 0, s>>>(acc, d, out, n,
                                                            steps, L);
  return cudaGetLastError();
}

// Runs F<T, PAIR>(args...) for the word width; pairs only for 64-bit words.
#define PINT_BY_WIDTH(F, ...)                                              \
  switch (pair ? -word_bits : word_bits) {                                 \
    case 8: return (int)F<uint8_t, false>(__VA_ARGS__);                    \
    case 16: return (int)F<uint16_t, false>(__VA_ARGS__);                  \
    case 32: return (int)F<uint32_t, false>(__VA_ARGS__);                  \
    case 64: return (int)F<uint64_t, false>(__VA_ARGS__);                  \
    case -64: return (int)F<uint64_t, true>(__VA_ARGS__);                  \
    default: return (int)cudaErrorInvalidValue;                            \
  }

}  // namespace

// a, b, out: n words (pair: (2, n) planes).  op: index in BINOP_NAMES.
extern "C" int pint_swar_binop(int word_bits, int pair, int op, const void* a,
                               const void* b, void* out, int64_t n,
                               const SwarLayout* L, void* stream) {
  if (n < 0 || n > kMaxWords || !layout_ok(L) || op < 0 || op > 9)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PINT_BY_WIDTH(launch_binop, op, a, b, out, n, *L, s)
}

// amount_dev: an int64 on the card, or null to use `amount`.
extern "C" int pint_swar_shift(int word_bits, int pair, int left, const void* v,
                               void* out, int64_t n, const void* amount_dev,
                               int64_t amount, const SwarLayout* L,
                               void* stream) {
  if (n < 0 || n > kMaxWords || !layout_ok(L)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ad = static_cast<const int64_t*>(amount_dev);
  PINT_BY_WIDTH(launch_shift, left, v, out, n, ad, amount, *L, s)
}

// acc, out: n words; d: (steps, n) words (pair: (2, n) and (2, steps, n)).
extern "C" int pint_swar_sat_accum(int word_bits, int pair, int is_signed,
                                   const void* acc, const void* d, void* out,
                                   int64_t n, int steps, const SwarLayout* L,
                                   void* stream) {
  if (n < 0 || n > kMaxWords || steps < 0 || !layout_ok(L))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PINT_BY_WIDTH(launch_sat_accum, is_signed, acc, d, out, n, steps, *L, s)
}
