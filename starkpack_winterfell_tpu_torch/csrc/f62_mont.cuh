// The f62 field (p = 2^62 - 111*2^39 + 1) in Montgomery form with R = 2^64,
// usable from host and device code: the representation of Rp62_248's state
// in the Rescue sponge kernel (csrc/rescue_sponge.cu), which alone includes
// this header.  csrc/f62.cuh (canonical words, four folds a multiply) stays
// the field of kernels 4 and 5.
//
// An element x is held as x*R mod p, lazily in [0, 2p) between operations:
//   mul(a, b), a, b < 2p:  T = a*b < 4p^2 < pR, so redc(T) = (T + m*p)/R < 2p;
//   a row of the MDS (twelve products of values below p, summed unreduced in
//   128 bits: T < 12 p^2 < 2^127.6): redc(T) < 12p^2/R + p < 4p;
//   to_mont(x), any x < 2^64: x * (R^2 mod p) < pR, so the result is below 2p
//   and exactly x*R mod p (Rp62_248's merges load digest words in [p, 2^62),
//   which map to the residue they denote, as csrc/f62.cuh's multiply maps
//   them).
// p < 2^62 keeps 4p below 2^64 and T + m*p below 2^128.  A multiply is one
// 64 x 64 -> 128 product, one 64-bit low product and one high product by p:
// no folds.  ops/rescue_sponge.py converts the constants to this form.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define F62M_HD __host__ __device__ __forceinline__
#else
#define F62M_HD inline
#endif

namespace f62m {

constexpr uint64_t P = 4611624995532046337ULL;
constexpr uint64_t NEG_PINV = 4611624995532046335ULL;  // -p^-1 mod 2^64 (= p - 2)
constexpr uint64_t R2 = 630444561284293700ULL;         // 2^128 mod p
static_assert(P * NEG_PINV == ~0ULL, "NEG_PINV must be -p^-1 mod 2^64");

F62M_HD void mul_wide(uint64_t a, uint64_t b, uint64_t& lo, uint64_t& hi) {
#ifdef __CUDA_ARCH__
  lo = a * b;
  hi = __umul64hi(a, b);
#else
  const unsigned __int128 p = (unsigned __int128)a * b;
  lo = (uint64_t)p;
  hi = (uint64_t)(p >> 64);
#endif
}

// (T + m*p) / 2^64 for T = hi*2^64 + lo, m = lo * NEG_PINV mod 2^64: the low
// word of T + m*p is 0, with a carry out exactly when lo != 0
F62M_HD uint64_t redc(uint64_t lo, uint64_t hi) {
  const uint64_t m = lo * NEG_PINV;
  uint64_t ml, mh;
  mul_wide(m, P, ml, mh);
  (void)ml;
  return hi + mh + (lo != 0 ? 1 : 0);
}

F62M_HD uint64_t sub_if(uint64_t x, uint64_t c) { return x >= c ? x - c : x; }

// a*b/R for a, b < 2p: below 2p
F62M_HD uint64_t mul(uint64_t a, uint64_t b) {
  uint64_t lo, hi;
  mul_wide(a, b, lo, hi);
  return redc(lo, hi);
}

// x*R mod p, below 2p, for any 64-bit x
F62M_HD uint64_t to_mont(uint64_t x) { return mul(x, R2); }

// the canonical value of x < 2p: redc(x) <= p, equal to p only for x = p
F62M_HD uint64_t from_mont(uint64_t x) { return sub_if(redc(x, 0), P); }

// acc (two words) += a*b
F62M_HD void mul_acc(uint64_t a, uint64_t b, uint64_t& acc_lo, uint64_t& acc_hi) {
  uint64_t lo, hi;
  mul_wide(a, b, lo, hi);
  acc_lo += lo;
  acc_hi += hi + (acc_lo < lo ? 1 : 0);
}

}  // namespace f62m
