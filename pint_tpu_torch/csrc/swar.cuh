// The SWAR word formulas of pint_tpu/ops/word.py (pint.hpp:375-1029) as
// __device__ functions on one unsigned word type T (uint8_t ... uint64_t).
//
// Integer promotion: uint8_t and uint16_t operands promote to int, so
// `~a`, `a + b`, `a - b` and `a << s` carry bits above the word, and a later
// `>>` would bring them down.  Every operation here goes through Word<T>,
// whose operators cast the result back to T.  The formulas are therefore
// exact modulo 2^(8 sizeof T) on every bit pattern, as the plain PyTorch
// version in its int8/16/32/64 container is, not only on canonical words.
//
// No shift is by the word width or more (undefined in C++): the runtime
// shifts split such a shift in two, as pint_tpu's _shl_full does.
#pragma once

#include <stdint.h>

namespace pint {

// Layout masks, by value in the kernel's parameter space.  Distinct lane
// widths sum to at most 64, so a layout has at most 10 of them, and at most
// 10 saturation terms and width groups (pint_tpu/layout.py:205-231).
constexpr int kMaxTerms = 10;

struct SwarLayout {
  uint64_t hi_mask, body_mask, lo_mask, sat_final_mask;
  uint64_t sat_mask[kMaxTerms];    // sat_terms: (shift, mask or none)
  uint64_t group_mask[kMaxTerms];  // width_groups: (width, lo mask)
  int32_t sat_shift[kMaxTerms];
  int32_t sat_has_mask[kMaxTerms];
  int32_t group_width[kMaxTerms];
  int32_t n_sat, has_final_mask, n_groups, max_width, all_same, width0;
};

template <typename T>
struct Word {
  T v;
  __device__ __forceinline__ Word() : v(0) {}
  __device__ __forceinline__ explicit Word(T x) : v(x) {}
  __device__ __forceinline__ static Word of(uint64_t m) { return Word((T)m); }
  __device__ __forceinline__ Word operator&(Word o) const { return Word((T)(v & o.v)); }
  __device__ __forceinline__ Word operator|(Word o) const { return Word((T)(v | o.v)); }
  __device__ __forceinline__ Word operator^(Word o) const { return Word((T)(v ^ o.v)); }
  __device__ __forceinline__ Word operator+(Word o) const { return Word((T)(v + o.v)); }
  __device__ __forceinline__ Word operator-(Word o) const { return Word((T)(v - o.v)); }
  __device__ __forceinline__ Word operator~() const { return Word((T)~v); }
  // s < 8 * sizeof(T) always (callers guarantee it)
  __device__ __forceinline__ Word operator<<(uint32_t s) const { return Word((T)(v << s)); }
  __device__ __forceinline__ Word operator>>(uint32_t s) const { return Word((T)(v >> s)); }
};

template <typename T>
constexpr uint32_t kBits = 8 * sizeof(T);

// -- carry / borrow / overflow bit vectors (pint.hpp:375-388) --------------

template <typename T>
__device__ __forceinline__ Word<T> carry_add(Word<T> a, Word<T> b) {
  return (a & b) | ((a | b) & ~(a + b));
}

template <typename T>
__device__ __forceinline__ Word<T> carry_sub(Word<T> a, Word<T> b) {
  return (~a & b) | (~(a ^ b) & (a - b));
}

template <typename T>
__device__ __forceinline__ Word<T> overflow_sub(Word<T> a, Word<T> b, Word<T> r) {
  return (~a & b & r) | (a & ~(b | r));
}

// -- saturation masks (pint.hpp:443-590) ------------------------------------

template <typename T>
__device__ __forceinline__ Word<T> dispatch(const SwarLayout& L, Word<T> c) {
  Word<T> acc;
#pragma unroll
  for (int t = 0; t < kMaxTerms; ++t) {
    if (t < L.n_sat) {
      Word<T> x = c >> (uint32_t)L.sat_shift[t];
      if (L.sat_has_mask[t]) x = x & Word<T>::of(L.sat_mask[t]);
      acc = acc | x;
    }
  }
  if (L.has_final_mask) acc = acc & Word<T>::of(L.sat_final_mask);
  return acc;
}

template <typename T>
__device__ __forceinline__ Word<T> smear(const SwarLayout& L, Word<T> c) {
  return (c << 1u) - dispatch(L, c);
}

template <typename T>
__device__ __forceinline__ Word<T> signed_sat_mask(const SwarLayout& L, Word<T> o) {
  return o - dispatch(L, o);
}

template <typename T>
__device__ __forceinline__ Word<T> apply_signed_saturation(const SwarLayout& L,
                                                           Word<T> total,
                                                           Word<T> ovf) {
  const Word<T> m1 = signed_sat_mask(L, ovf);
  const Word<T> m2 = signed_sat_mask(L, ovf & ~total);
  return ((total ^ ovf) | m1) ^ m2;
}

// -- the ten binops (pint.hpp:826-1004), in BINOP_NAMES order ---------------

template <typename T>
__device__ __forceinline__ Word<T> add_wrap(const SwarLayout& L, Word<T> a, Word<T> b) {
  const Word<T> m2 = Word<T>::of(L.hi_mask), m1 = Word<T>::of(L.body_mask);
  return ((a & m1) + (b & m1)) ^ ((a ^ b) & m2);
}

template <typename T>
__device__ __forceinline__ Word<T> add_unsigned_saturate(const SwarLayout& L,
                                                         Word<T> a, Word<T> b) {
  const Word<T> carries = carry_add(a, b) & Word<T>::of(L.hi_mask);
  return add_wrap(L, a, b) | smear(L, carries);
}

template <typename T>
__device__ __forceinline__ Word<T> add_signed_saturate(const SwarLayout& L,
                                                       Word<T> a, Word<T> b) {
  const Word<T> wrapped = add_wrap(L, a, b);
  const Word<T> ovf = ~(a ^ b) & (wrapped ^ b) & Word<T>::of(L.hi_mask);
  return apply_signed_saturation(L, wrapped, ovf);
}

template <typename T>
__device__ __forceinline__ Word<T> sub_wrap(const SwarLayout& L, Word<T> a, Word<T> b) {
  const Word<T> m3 = Word<T>::of(L.lo_mask), m2 = Word<T>::of(L.hi_mask),
                m1 = Word<T>::of(L.body_mask);
  const Word<T> nb = ~b;
  return ((a & m1) + (nb & m1) + (m3 & m1)) ^ ((a ^ nb) & m2) ^ (m2 & m3);
}

template <typename T>
__device__ __forceinline__ Word<T> sub_unsigned_saturate(const SwarLayout& L,
                                                         Word<T> a, Word<T> b) {
  const Word<T> partial = add_wrap(L, a, ~b);
  const Word<T> borrows = carry_sub(a, b) & Word<T>::of(L.hi_mask);
  return add_wrap(L, partial | smear(L, borrows), Word<T>::of(L.lo_mask));
}

template <typename T>
__device__ __forceinline__ Word<T> sub_signed_saturate(const SwarLayout& L,
                                                       Word<T> a, Word<T> b) {
  const Word<T> diff = sub_wrap(L, a, b);
  const Word<T> ovf = overflow_sub(a, b, diff) & Word<T>::of(L.hi_mask);
  return apply_signed_saturation(L, diff, ovf);
}

template <typename T>
__device__ __forceinline__ Word<T> interleave(Word<T> a, Word<T> b, Word<T> m) {
  return (a & m) | (b & ~m);
}

template <typename T>
__device__ __forceinline__ Word<T> min_unsigned(const SwarLayout& L, Word<T> a, Word<T> b) {
  const Word<T> m2 = Word<T>::of(L.hi_mask);
  return interleave(a, b, smear(L, carry_sub(a, b) & m2));
}

template <typename T>
__device__ __forceinline__ Word<T> max_unsigned(const SwarLayout& L, Word<T> a, Word<T> b) {
  const Word<T> m2 = Word<T>::of(L.hi_mask);
  return interleave(a, b, smear(L, carry_sub(b, a) & m2));
}

template <typename T>
__device__ __forceinline__ Word<T> min_signed(const SwarLayout& L, Word<T> a, Word<T> b) {
  const Word<T> m2 = Word<T>::of(L.hi_mask);
  return interleave(a, b, smear(L, carry_sub(a ^ m2, b ^ m2) & m2));
}

template <typename T>
__device__ __forceinline__ Word<T> max_signed(const SwarLayout& L, Word<T> a, Word<T> b) {
  const Word<T> m2 = Word<T>::of(L.hi_mask);
  return interleave(a, b, smear(L, carry_sub(b ^ m2, a ^ m2) & m2));
}

template <typename T, int OP>
__device__ __forceinline__ Word<T> binop(const SwarLayout& L, Word<T> a, Word<T> b) {
  if constexpr (OP == 0) return add_wrap(L, a, b);
  else if constexpr (OP == 1) return add_unsigned_saturate(L, a, b);
  else if constexpr (OP == 2) return add_signed_saturate(L, a, b);
  else if constexpr (OP == 3) return sub_wrap(L, a, b);
  else if constexpr (OP == 4) return sub_unsigned_saturate(L, a, b);
  else if constexpr (OP == 5) return sub_signed_saturate(L, a, b);
  else if constexpr (OP == 6) return min_unsigned(L, a, b);
  else if constexpr (OP == 7) return max_unsigned(L, a, b);
  else if constexpr (OP == 8) return min_signed(L, a, b);
  else return max_signed(L, a, b);
}

// -- runtime lane shifts (pint.hpp:610-705, 1006-1029) ----------------------

// x << k, exact modulo 2^bits for k in [0, bits]: never a shift by bits.
template <typename T>
__device__ __forceinline__ Word<T> shl_full(Word<T> x, uint32_t k) {
  const uint32_t k1 = min(k, kBits<T> - 1);
  return (x << k1) << (k - k1);
}

template <typename T>
__device__ __forceinline__ Word<T> shr_full(Word<T> x, uint32_t k) {
  const uint32_t k1 = min(k, kBits<T> - 1);
  return (x >> k1) >> (k - k1);
}

// 0 if the word's sign bit is set, else x (pint.hpp:616-620)
template <typename T>
__device__ __forceinline__ Word<T> sat_to_zero(Word<T> x) {
  return ((x >> (kBits<T> - 1)) - Word<T>(1)) & x;
}

// What a shift does to every word, worked out once from the amount:
// out = guard & shift(x & mask, amt).
template <typename T>
struct ShiftPlan {
  Word<T> guard, mask;
  uint32_t amt;
};

// `raw` is the amount as pint_tpu's _amount sees it after astype(uint32):
// the guard is the sign bit of the uint32 max_width - a32 - 1 (all-ones iff
// the amount is below the widest lane), the amount is clamped to the word.
template <typename T, bool LEFT>
__device__ __forceinline__ ShiftPlan<T> shift_plan(const SwarLayout& L, uint64_t raw) {
  const uint32_t a32 = (uint32_t)raw;
  const uint32_t sign = ((uint32_t)L.max_width - a32 - 1u) >> 31;
  ShiftPlan<T> p;
  p.guard = Word<T>((T)sign) - Word<T>(1);
  p.amt = min(a32, kBits<T>);
  const Word<T> amt((T)p.amt);
  const Word<T> lo = Word<T>::of(L.lo_mask);
  Word<T> m;
  if (L.all_same) {
    if (LEFT) {
      const Word<T> keep_bits = sat_to_zero(Word<T>((T)L.width0) - amt);
      m = shl_full(lo, (uint32_t)keep_bits.v) - lo;
    } else {
      m = shl_full(lo, p.amt) - lo;
    }
  } else {
#pragma unroll
    for (int g = 0; g < kMaxTerms; ++g) {
      if (g < L.n_groups) {
        const Word<T> mw = Word<T>::of(L.group_mask[g]);
        const Word<T> w((T)L.group_width[g]);
        const Word<T> k = LEFT ? sat_to_zero(w - amt) : w - sat_to_zero(w - amt);
        m = m | (shl_full(mw, (uint32_t)k.v) - mw);
      }
    }
  }
  p.mask = LEFT ? m : ~m;  // left: keep mask; right: ~clear
  return p;
}

template <typename T, bool LEFT>
__device__ __forceinline__ Word<T> apply_shift(const ShiftPlan<T>& p, Word<T> x) {
  return p.guard & (LEFT ? shl_full(x & p.mask, p.amt) : shr_full(x & p.mask, p.amt));
}

}  // namespace pint
