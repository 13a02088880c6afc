// The f128 prime field (p = 2^128 - 45*2^40 + 1) on canonical {lo, hi} pairs
// of uint64_t words, usable from host and device code.
//
// Same arithmetic as ops/limb_field.py: the 128 x 128 -> 256 product is four
// 64 x 64 -> 128 products (mul.lo + __umul64hi on the device), the reduction
// folds the high 128 bits with 2^128 = 45*2^40 - 1 (mod p) twice and ends
// with one conditional subtract.  "+ DELTA modulo 2^128" is both the fold of
// a carry out of 128 bits and the subtraction of p.
//
// The kernels are templates over a field type FE; a field provides
//   FE::WORDS, FE::zero(), FE::make(words...), FE::from_words(p),
//   FE::load(lo, hi, i), FE::store(lo, hi, i, v)
//   fe_add, fe_sub, fe_mul, fe_sqr
// so another field (f62: one word per element) is another instantiation.
#pragma once

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#define FE_HD __host__ __device__ __forceinline__
#else
#define FE_HD inline
#endif

struct F128 {
  uint64_t lo, hi;

  static constexpr int WORDS = 2;  // 64-bit words per element
  static constexpr uint64_t DELTA = (45ULL << 40) - 1;  // 2^128 mod p
  static constexpr uint64_t P_LO = 0xFFFFD30000000001ULL;
  static constexpr uint64_t P_HI = 0xFFFFFFFFFFFFFFFFULL;

  static FE_HD F128 make(uint64_t lo, uint64_t hi) {
    F128 r;
    r.lo = lo;
    r.hi = hi;
    return r;
  }
  static FE_HD F128 zero() { return make(0, 0); }
  static FE_HD F128 from_words(const uint64_t* p) { return make(p[0], p[1]); }
  static FE_HD F128 load(const uint64_t* lo, const uint64_t* hi, size_t i) {
    return make(lo[i], hi[i]);
  }
  static FE_HD void store(uint64_t* lo, uint64_t* hi, size_t i, F128 v) {
    lo[i] = v.lo;
    hi[i] = v.hi;
  }
};

// (lo, hi) + carry * 2^128, the whole value below 2p -> canonical
FE_HD F128 f128_finish(uint64_t lo, uint64_t hi, bool carry) {
  if (carry || (hi == F128::P_HI && lo >= F128::P_LO)) {
    const uint64_t r = lo + F128::DELTA;
    hi += (r < lo) ? 1 : 0;
    lo = r;
  }
  return F128::make(lo, hi);
}

FE_HD F128 fe_add(F128 a, F128 b) {
  const uint64_t lo = a.lo + b.lo;
  const uint64_t t = a.hi + b.hi;
  const uint64_t hi = t + ((lo < a.lo) ? 1 : 0);
  return f128_finish(lo, hi, (t < a.hi) || (hi < t));
}

FE_HD F128 fe_sub(F128 a, F128 b) {
  uint64_t lo = a.lo - b.lo;
  const bool b0 = a.lo < b.lo;
  uint64_t hi = a.hi - b.hi - (b0 ? 1 : 0);
  if ((a.hi < b.hi) || (a.hi == b.hi && b0)) {
    // borrow: add p back, i.e. subtract DELTA modulo 2^128
    hi -= (lo < F128::DELTA) ? 1 : 0;
    lo -= F128::DELTA;
  }
  return F128::make(lo, hi);
}

FE_HD void f128_mul64(uint64_t a, uint64_t b, uint64_t& lo, uint64_t& hi) {
#ifdef __CUDA_ARCH__
  lo = a * b;
  hi = __umul64hi(a, b);
#else
  const unsigned __int128 p = (unsigned __int128)a * b;
  lo = (uint64_t)p;
  hi = (uint64_t)(p >> 64);
#endif
}

// four words of a 256-bit value below p^2 -> canonical residue
FE_HD F128 f128_reduce256(uint64_t w0, uint64_t w1, uint64_t w2, uint64_t w3) {
  uint64_t t2l, t2h, t3l, t3h, ul, uh;
  f128_mul64(w2, F128::DELTA, t2l, t2h);  // t2h, t3h < 2^46
  f128_mul64(w3, F128::DELTA, t3l, t3h);
  const uint64_t r0 = w0 + t2l;
  uint64_t c = (r0 < w0) ? 1 : 0;
  uint64_t x = w1 + t2h;
  uint64_t r2 = t3h + ((x < w1) ? 1 : 0);
  uint64_t y = x + t3l;
  r2 += (y < x) ? 1 : 0;
  const uint64_t r1 = y + c;
  r2 += (r1 < y) ? 1 : 0;  // below 2^47
  f128_mul64(r2, F128::DELTA, ul, uh);  // below 2^93
  const uint64_t s0 = r0 + ul;
  c = (s0 < r0) ? 1 : 0;
  x = r1 + uh;
  const uint64_t s1 = x + c;
  return f128_finish(s0, s1, (x < r1) || (s1 < x));
}

FE_HD F128 fe_mul(F128 a, F128 b) {
  uint64_t l00, h00, l01, h01, l10, h10, l11, h11;
  f128_mul64(a.lo, b.lo, l00, h00);
  f128_mul64(a.lo, b.hi, l01, h01);
  f128_mul64(a.hi, b.lo, l10, h10);
  f128_mul64(a.hi, b.hi, l11, h11);
  uint64_t x = h00 + l01;
  uint64_t c1 = (x < h00) ? 1 : 0;
  const uint64_t w1 = x + l10;
  c1 += (w1 < x) ? 1 : 0;
  x = h01 + h10;
  uint64_t c2 = (x < h01) ? 1 : 0;
  const uint64_t y = x + l11;
  c2 += (y < x) ? 1 : 0;
  const uint64_t w2 = y + c1;
  c2 += (w2 < y) ? 1 : 0;
  return f128_reduce256(l00, w1, w2, h11 + c2);
}

FE_HD F128 fe_sqr(F128 a) {
  uint64_t l00, h00, l01, h01, l11, h11;
  f128_mul64(a.lo, a.lo, l00, h00);
  f128_mul64(a.lo, a.hi, l01, h01);
  f128_mul64(a.hi, a.hi, l11, h11);
  uint64_t x = h00 + l01;
  uint64_t c1 = (x < h00) ? 1 : 0;
  const uint64_t w1 = x + l01;
  c1 += (w1 < x) ? 1 : 0;
  x = h01 + h01;
  uint64_t c2 = (x < h01) ? 1 : 0;
  const uint64_t y = x + l11;
  c2 += (y < x) ? 1 : 0;
  const uint64_t w2 = y + c1;
  c2 += (w2 < y) ? 1 : 0;
  return f128_reduce256(l00, w1, w2, h11 + c2);
}
