// Radix-2^K Goldilocks NTT stages in registers, and the shared-memory row
// swizzle, for the Hopper kernels of ntt_tile.cu (kernel 1) and ntt_dit.cu
// (kernel 2, ntt_last).
//
// A thread holds R = 2^K words v[i] of one transform at the positions
//   p_i = low | (i << s0) | high,  low < 2^s0,  high a multiple of 2^(s0+K),
// so bits s0 .. s0+K-1 of the position vary with i, and runs the K radix-2
// stages on those bits without touching memory:
//   DIT (bit-reversed in, natural out): stages s = s0+1 .. s0+K, ascending,
//        (a, b) -> (a + b*w, a - b*w);
//   DIF (natural in, bit-reversed out): the same stages descending,
//        (a, b) -> (a + b, (a - b)*w);
// with w = tws[j * n/m] = root^(j * n/m) for the butterfly at position
// offset j = p mod m/2 of a size-m = 2^s group: one (n/2,) table of root
// powers serves every stage.  A transform of length n = 2^log_n is then
// ceil(log_n / K) such passes with one exchange through shared memory
// between two passes, in place of one shared-memory round trip a stage.
#pragma once

#include <cstdint>

#include "gl64.cuh"

namespace gl64 {

// Permutes the positions inside every aligned group of 16 (only the low four
// bits change), so that 16 positions spaced 2^m apart, any m < 12, fall in 16
// different 8-byte bank slots of shared memory; consecutive positions stay
// in distinct slots too.
GL64_HD int swz(int p) { return p ^ (((p >> 4) ^ (p >> 8)) & 15); }

// Bit reversal of the low `bits` bits of c (bits >= 1).
GL64_HD int rev_bits(int c, int bits) {
#ifdef __CUDA_ARCH__
  return (int)(__brev((unsigned)c) >> (32 - bits));
#else
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((c >> b) & 1) << (bits - 1 - b);
  return r;
#endif
}

// The same for a bit count and index known at compile time (register
// indices of an unrolled loop).
GL64_HD constexpr int crev(int c, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((c >> b) & 1) << (bits - 1 - b);
  return r;
}

// The K stages on bits s0 .. s0+K-1 of a length-2^log_n transform, on the
// words v[i] at positions p_i (above); `low` = the position bits below s0.
template <bool DIF, int K>
GL64_HD void radix_pass(uint64_t (&v)[1 << K], const uint64_t* tws, int log_n,
                        int s0, int low) {
  constexpr int R = 1 << K;
#pragma unroll
  for (int step = 0; step < K; ++step) {
    const int kk = DIF ? (K - 1 - step) : step;  // bit s0 + kk
    const int h = 1 << kk;
    const int shift = log_n - s0 - kk - 1;  // log2(n / m), m = 2^(s0+kk+1)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i & h) continue;
      const int j = low | ((i & (h - 1)) << s0);
      const uint64_t w = tws[j << shift];
      const uint64_t a = v[i];
      if (DIF) {
        const uint64_t c = v[i + h];
        v[i] = add(a, c);
        v[i + h] = mul(sub(a, c), w);
      } else {
        const uint64_t t = mul(v[i + h], w);
        v[i] = add(a, t);
        v[i + h] = sub(a, t);
      }
    }
  }
}

}  // namespace gl64
