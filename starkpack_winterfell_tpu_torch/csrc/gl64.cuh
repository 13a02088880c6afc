// Goldilocks field (p = 2^64 - 2^32 + 1) arithmetic on canonical uint64_t
// words, usable from host and device code.
//
// Same reduction identity as ops/gl64.py: for x = c3*2^96 + c2*2^64 + lo64,
// 2^64 = 2^32 - 1 (mod p) and 2^96 = -1 (mod p), so
//   x = lo64 - c3 + c2*(2^32 - 1)  (mod p).
// On the device the 128-bit product is one mul.lo + one __umul64hi.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define GL64_HD __host__ __device__ __forceinline__
#else
#define GL64_HD inline
#endif

namespace gl64 {

constexpr uint64_t P = 0xFFFFFFFF00000001ULL;
constexpr uint64_t EPS = 0xFFFFFFFFULL;  // 2^64 mod p == -p mod 2^64

GL64_HD uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  // carry out: +2^64 = +EPS; no carry but >= p: -p = +EPS (mod 2^64)
  if (s < a || s >= P) s += EPS;
  return s;
}

GL64_HD uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= EPS;  // borrow: -2^64 = -EPS
  return d;
}

GL64_HD uint64_t reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hh = hi >> 32;
  uint64_t hl = hi & EPS;
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= EPS;
  uint64_t t1 = (hl << 32) - hl;  // hl * (2^32 - 1) < 2^64
  uint64_t r = t0 + t1;
  if (r < t1 || r >= P) r += EPS;
  return r;
}

GL64_HD uint64_t mul(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return reduce128(a * b, __umul64hi(a, b));
#else
  unsigned __int128 p = (unsigned __int128)a * b;
  return reduce128((uint64_t)p, (uint64_t)(p >> 64));
#endif
}

}  // namespace gl64
