// Goldilocks (p = 2^64 - 2^32 + 1) as a field type of the kernel templates:
// the interface csrc/f128.cuh describes (WORDS, zero, make, from_words,
// load, store, fe_add, fe_sub, fe_mul, fe_sqr) over the canonical one-word
// arithmetic of csrc/gl64.cuh, usable from host and device code.  An
// element is ONE word, so the second plane pointer of load/store is
// ignored.  The Goldilocks instantiation of the DIT tile frame (kernel 3,
// csrc/ntt_dit.cu) and kernel 5's f64 bodies (the constraint kernels
// ops/cons_kernel.py emits around csrc/cons_frame.cuh) take it.
#pragma once

#include <cstddef>
#include <cstdint>

#include "gl64.cuh"

struct GL64 {
  uint64_t v;

  static constexpr int WORDS = 1;  // 64-bit words per element
  static GL64_HD GL64 make(uint64_t v) {
    GL64 r;
    r.v = v;
    return r;
  }
  static GL64_HD GL64 zero() { return make(0); }
  static GL64_HD GL64 from_words(const uint64_t* p) { return make(p[0]); }
  static GL64_HD GL64 load(const uint64_t* lo, const uint64_t*, size_t i) {
    return make(lo[i]);
  }
  static GL64_HD void store(uint64_t* lo, uint64_t*, size_t i, GL64 x) { lo[i] = x.v; }
};

GL64_HD GL64 fe_add(GL64 a, GL64 b) { return GL64::make(gl64::add(a.v, b.v)); }
GL64_HD GL64 fe_sub(GL64 a, GL64 b) { return GL64::make(gl64::sub(a.v, b.v)); }
GL64_HD GL64 fe_mul(GL64 a, GL64 b) { return GL64::make(gl64::mul(a.v, b.v)); }
GL64_HD GL64 fe_sqr(GL64 a) { return fe_mul(a, a); }
