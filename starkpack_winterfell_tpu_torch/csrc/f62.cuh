// The f62 prime field (p = 2^62 - 111*2^39 + 1) on canonical uint64_t words,
// usable from host and device code.
//
// Same arithmetic as ops/limb_field.py F62Field: one 64 x 64 -> 128 product,
// folded four times at bit 62 with 2^62 = 111*2^39 - 1 (mod p), then one
// conditional subtract.  Provides the interface the kernel templates expect
// of a field type (see csrc/f128.cuh); an element is ONE word, so the second
// plane pointer of load/store is ignored.
#pragma once

#include <cstddef>
#include <cstdint>

#ifdef __CUDACC__
#define FE_HD __host__ __device__ __forceinline__
#else
#define FE_HD inline
#endif

struct F62 {
  uint64_t v;

  static constexpr int WORDS = 1;  // 64-bit words per element
  static constexpr uint64_t P = 4611624995532046337ULL;
  static constexpr uint64_t E = (1ULL << 62) - P;  // 2^62 mod p, below 2^46
  static constexpr uint64_t M62 = (1ULL << 62) - 1;

  static FE_HD F62 make(uint64_t v) {
    F62 r;
    r.v = v;
    return r;
  }
  static FE_HD F62 zero() { return make(0); }
  static FE_HD F62 from_words(const uint64_t* p) { return make(p[0]); }
  static FE_HD F62 load(const uint64_t* lo, const uint64_t*, size_t i) {
    return make(lo[i]);
  }
  static FE_HD void store(uint64_t* lo, uint64_t*, size_t i, F62 x) { lo[i] = x.v; }
};

FE_HD F62 fe_add(F62 a, F62 b) {
  uint64_t s = a.v + b.v;  // below 2^63
  if (s >= F62::P) s -= F62::P;
  return F62::make(s);
}

FE_HD F62 fe_sub(F62 a, F62 b) {
  uint64_t d = a.v - b.v;
  if (a.v < b.v) d += F62::P;
  return F62::make(d);
}

FE_HD void f62_mul64(uint64_t a, uint64_t b, uint64_t& lo, uint64_t& hi) {
#ifdef __CUDA_ARCH__
  lo = a * b;
  hi = __umul64hi(a, b);
#else
  const unsigned __int128 p = (unsigned __int128)a * b;
  lo = (uint64_t)p;
  hi = (uint64_t)(p >> 64);
#endif
}

// (lo, hi) words of v -> words of (v mod 2^62) + (v >> 62) * E, the same
// residue; v >> 62 has to fit one word
FE_HD void f62_fold(uint64_t& lo, uint64_t& hi) {
  const uint64_t top = (hi << 2) | (lo >> 62);
  uint64_t pl, ph;
  f62_mul64(top, F62::E, pl, ph);
  const uint64_t r = pl + (lo & F62::M62);
  hi = ph + ((r < pl) ? 1 : 0);
  lo = r;
}

FE_HD F62 fe_mul(F62 a, F62 b) {
  uint64_t lo, hi;
  f62_mul64(a.v, b.v, lo, hi);  // below 2^124
  f62_fold(lo, hi);             // below 2^62 + 2^108
  f62_fold(lo, hi);             // below 2^62 + 2^92
  f62_fold(lo, hi);             // below 2^62 + 2^76: top part below 2^15
  const uint64_t top = (hi << 2) | (lo >> 62);
  uint64_t v = (lo & F62::M62) + top * F62::E;  // below 2^62 + 2^61 < 2p
  if (v >= F62::P) v -= F62::P;
  return F62::make(v);
}

FE_HD F62 fe_sqr(F62 a) { return fe_mul(a, a); }
