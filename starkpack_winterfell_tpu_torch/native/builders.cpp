// Copy of starkpack_winterfell_tpu/native/builders.cpp; cut: nothing.
//
// Native code that fills the traces of the sequential example chains.
//
// Each chain has a single scalar dependency through the whole trace, so no
// accelerator width can hide the latency; it is built with a sequential row
// scan on the CPU using native u64 Goldilocks arithmetic (mulmod via
// __uint128_t + the 2^64 = 2^32 - 1 sparse reduction).
//
// All outputs are canonical u64 field elements, bit-identical to the
// Python builder (models/rescue_chain.py _build_chain_trace_python).

#include <cstdint>

extern "C" {

static const uint64_t P = 0xFFFFFFFF00000001ULL;  // 2^64 - 2^32 + 1

static inline uint64_t reduce128(unsigned __int128 x) {
  // x = c*2^96 + b*2^64 + a  with  2^64 = 2^32 - 1 (mod p), 2^96 = -1:
  //   x = a + b*(2^32 - 1) - c
  uint64_t lo = (uint64_t)x;
  uint64_t hi = (uint64_t)(x >> 64);
  uint32_t b = (uint32_t)hi;
  uint32_t c = (uint32_t)(hi >> 32);
  uint64_t t = lo - c;
  if (lo < c) t -= 0xFFFFFFFFULL;  // borrow: -2^64 = -(2^32 - 1)
  uint64_t bb = ((uint64_t)b << 32) - b;  // b*(2^32-1) < 2^64
  uint64_t r = t + bb;
  if (r < bb) r += 0xFFFFFFFFULL;  // carry: +2^64 = +(2^32 - 1)
  if (r >= P) r -= P;
  return r;
}

static inline uint64_t mulmod(uint64_t a, uint64_t b) {
  return reduce128((unsigned __int128)a * b);
}

static inline uint64_t addmod(uint64_t a, uint64_t b) {
  uint64_t r = a + b;
  if (r < a || r >= P) r -= P;
  return r;
}

static inline uint64_t expmod(uint64_t base, uint64_t e) {
  uint64_t r = 1, b = base;
  while (e) {
    if (e & 1) r = mulmod(r, b);
    b = mulmod(b, b);
    e >>= 1;
  }
  return r;
}

// Rescue-Prime chain trace (models/rescue_chain.py build_chain_trace):
// row 8c+k = state after k rounds of permutation c; out is column-major
// (12 columns x 8*num_perms rows), i.e. out[col*length + row].
void rescue_chain_trace(const uint64_t* seed8, uint64_t num_perms,
                        const uint64_t* mds,   // 12*12 row-major
                        const uint64_t* ark1,  // 7*12
                        const uint64_t* ark2,  // 7*12
                        uint64_t inv_alpha, uint64_t* out) {
  const int W = 12, ROUNDS = 7, CYCLE = 8;
  uint64_t length = num_perms * CYCLE;
  uint64_t state[12];
  for (int i = 0; i < 4; i++) state[i] = 0;
  for (int i = 0; i < 8; i++) state[4 + i] = seed8[i] % P;
  uint64_t tmp[12];
  for (uint64_t cyc = 0; cyc < num_perms; cyc++) {
    uint64_t base = cyc * CYCLE;
    for (int i = 0; i < W; i++) out[(uint64_t)i * length + base] = state[i];
    for (int r = 0; r < ROUNDS; r++) {
      // x^7
      for (int i = 0; i < W; i++) {
        uint64_t x = state[i];
        uint64_t x2 = mulmod(x, x);
        uint64_t x4 = mulmod(x2, x2);
        state[i] = mulmod(mulmod(x4, x2), x);
      }
      // MDS + ARK1
      for (int i = 0; i < W; i++) {
        unsigned __int128 acc = 0;
        for (int j = 0; j < W; j++)
          acc += (unsigned __int128)mds[i * W + j] * state[j];
        tmp[i] = addmod(reduce128(acc), ark1[r * W + i]);
      }
      // x^(1/7)
      for (int i = 0; i < W; i++) tmp[i] = expmod(tmp[i], inv_alpha);
      // MDS + ARK2
      for (int i = 0; i < W; i++) {
        unsigned __int128 acc = 0;
        for (int j = 0; j < W; j++)
          acc += (unsigned __int128)mds[i * W + j] * tmp[j];
        state[i] = addmod(reduce128(acc), ark2[r * W + i]);
      }
      for (int i = 0; i < W; i++)
        out[(uint64_t)i * length + base + r + 1] = state[i];
    }
  }
}

// do_work chain (models/do_work.py build_do_work_trace): x <- x^3 + 42.
void do_work_chain(uint64_t start, uint64_t length, uint64_t* out) {
  uint64_t x = start % P;
  for (uint64_t i = 0; i < length; i++) {
    out[i] = x;
    uint64_t x2 = mulmod(x, x);
    x = addmod(mulmod(x2, x), 42);
  }
}

// Fibonacci trace (prover/src/tests/mod.rs:17-29): two columns, each row
// advances (a, b) -> (a+b, a+2b); out is column-major (2 x length).
void fib_trace(uint64_t length, uint64_t* out) {
  uint64_t a = 1, b = 1;
  for (uint64_t i = 0; i < length; i++) {
    out[i] = a;
    out[length + i] = b;
    uint64_t na = addmod(a, b);
    uint64_t nb = addmod(a, addmod(b, b));
    a = na;
    b = nb;
  }
}

}  // extern "C"
