// The sponge of the algebraic hashers for Hopper (sm_90a): row hashes, 2-to-1
// merges and the proof-of-work search of Rp64_256 (Goldilocks), Rp62_248
// (f62), RpJive64_256 and GriffinJive64_256 (Goldilocks, width 8, Jive).
//
// No Pallas kernel is replaced: the JAX package computes this function in
// XLA (starkpack_winterfell_tpu/crypto/rescue.py:92 apply_permutation_limbs,
// crypto/rescue62.py:128, crypto/rescue_jive.py:67, crypto/griffin.py:78) or
// in a host sponge (native/rescue_perm.c; python ints for Griffin).  Its
// words API (rescue.py:211-261 hash_words / merge_words, rescue62.py:375-449,
// rescue_jive.py:188-239, griffin.py:194-248) is what this kernel computes:
// the port's Merkle leaves and levels on every prove path under those
// hashers; and ``merge_with_int`` over a range of nonces, the lowest one with
// enough trailing zeros kept (the proof-of-work search, prover/channel.py).
// Wrapper and plain version: ops/rescue_sponge.py.
//
// Bound on this card: operations.  A Rescue-Prime permutation is 7 rounds of
// x^alpha and x^(1/alpha) on every word by addition chains (Rp64_256 and
// RpJive64_256: 4 + 72 multiplies a word and round; Rp62_248: 2 + 72) and
// two MDS products; a Griffin permutation 7 rounds of one x^(1/7) (72), one
// x^7 (4), three multiplies for each of the other six words and one MDS
// product.  A row reads at most 2W + 8 words and writes 8.
// chip_smoke.py:sponge_bound counts the IMAD-pipe and ALU-pipe instructions
// of those operations (csrc/gl64_sass_count.py), ~2e5 a Rescue permutation
// against ~200 bytes.
//
// Design: one thread a row, the state in registers, every loop over the
// state unrolled so no index into it is dynamic.  The round constants and
// the MDS matrix sit in __constant__ memory (one table set a layout, copied
// in once when the library loads): every thread reads the same word at the
// same time.
//   * x^alpha and x^(1/alpha) run the layouts' addition chains, which
//     ops/rescue_sponge.py (ALPHA_CHAIN_*, INV_CHAIN_*, the same tuples the
//     host C sponges run) emits as the X-macros RP64_INV_CHAIN etc. in the
//     generated source that includes this file: step K (A, N, B) sets t[K] =
//     t[A]^(2^N) * t[B], all indices template arguments, so the temporaries
//     are registers.  A chain keeps 4-5 temporaries a word alive, so the
//     Rescue S-box runs over G = gcd(width, SBOX_GROUP) words at a time (a
//     loop that rotates the state by a group, one copy of the chain's code),
//     the squaring runs of a step as loops (a uniform branch a run): the
//     code stays small.
//   * The Rescue rounds are one loop over the 14 half-rounds, so the MDS
//     code is emitted once.
//   * Griffin's non-linear layer is serial in the word index (l_i reads the
//     updated s_{i-1}), so it has its own round: s0 and s1 through the
//     chains one word each, then the six quadratic words in order, (i - 1)
//     s0 as a running sum.  Its last round has no constants: it adds the
//     seventh row of its ARK table, which kernel_constants leaves zero.
//   * Rp62_248's state is in Montgomery form (csrc/f62_mont.cuh): a multiply
//     is three 64-bit products and no fold; the dense MDS sums a row's twelve
//     128-bit products unreduced and reduces once.  Constants convert on the
//     host, the state on load (digest words in [p, 2^62) map to the residue
//     they denote), the digest on store.
//   * The Goldilocks MDS matrices have entries below 32: a row is 2W
//     32 x 32 -> 64-bit multiply-adds on the state's halves and one
//     reduction.
//   * A Jive merge or search keeps the W initial words in registers for the
//     Jive sum (8 more live words).
// The layout (field, width, where the rate, the tag and the digest sit, the
// Jive rules, the round kind, the chains, the digest packing) is a template
// parameter:
//   Rp64Layout    capacity first: tag state[0], rate state[4..12), digest
//                 state[4..8); x^7 and x^(1/7); canonical Goldilocks words;
//   Rp62Layout    rate first: rate state[0..8), digest state[0..4), tag
//                 state[11]; x^3 and x^(1/3); digests are four 62-bit values
//                 bit-packed into 31 bytes, and a merge unpacks them masked to
//                 62 bits, not reduced (rescue62.py:198-224);
//   RpJiveLayout  width 8, Jive: flag state[0], rate and digest state[4..8);
//   GriffinLayout width 8, Jive, Griffin rounds: rate and digest
//                 state[0..4), flag state[4].
// A tagged hash absorbs a row's elements rate-wide (the element count as the
// tag, one permutation per started block); a Jive hash sets the flag when the
// count is not a multiple of the rate and pads the last started block with 1,
// 0, ...  A tagged merge places the two digests in the rate, tag 8; a Jive
// merge places them as state[0..8) and outputs the Jive sum init_i +
// init_{4+i} + final_i + final_{4+i}.  A search places the seed's digest
// elements at SEED_START, the nonce after them, 5 at SEARCH_TAG, permutes once
// (Jive: the Jive sum) and reads the digest's first 8 bytes.
//
// Left for later: reading the element tensors directly (half the bytes of
// the u32 words), several Merkle levels a launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "f62_mont.cuh"
#include "gl64.cuh"

#ifndef RP64_INV_CHAIN
#error "build this file through ops/rescue_sponge.py, which emits the addition chains"
#endif
#ifndef SBOX_GROUP
#define SBOX_GROUP 4
#endif
#ifndef SPONGE_SLOTS
#define SPONGE_SLOTS 4
#endif

namespace {

constexpr int MAX_WIDTH = 12;
constexpr int ROUNDS = 7;
constexpr int THREADS = 128;
constexpr int MODE_HASH = 0, MODE_MERGE = 1, MODE_SEARCH = 2;
static_assert(SPONGE_SLOTS == 4, "one constant slot a layout");

__host__ __device__ constexpr int gcd_int(int a, int b) { return b ? gcd_int(b, a % b) : a; }

// a layout's tables at MAX_WIDTH, its own width's entries first
// (ops/rescue_sponge.py:kernel_constants)
struct SpongeConsts {
  uint64_t mds[MAX_WIDTH * MAX_WIDTH];    // row-major at the layout's width
  uint64_t ark1[ROUNDS * MAX_WIDTH];      // [round][word]; Griffin's ARK
  uint64_t ark2[ROUNDS * MAX_WIDTH];      // Griffin: alpha[6], beta[6]
};

// [0] Rp64_256, [1] Rp62_248 (Montgomery form), [2] RpJive64_256,
// [3] GriffinJive64_256
__constant__ SpongeConsts kConsts[SPONGE_SLOTS];

struct SpongeArgs {
  const uint64_t* x;  // hash: (rows, >= 2 * n_elems) u32 words; merge: left digests
  const uint64_t* y;  // merge: right digests (rows, >= 8)
  uint64_t* out;      // (rows, 8) digest words, contiguous (a search: or null)
  long long x_stride, y_stride, rows;  // row strides in words
  int n_elems;
  // search: nonce start + row for each row; the lowest nonce whose digest
  // head has `bits` trailing zeros goes to *found (atomicMin)
  uint64_t seed[4];
  uint64_t start;
  unsigned long long* found;
  int bits;
};

// Goldilocks words, canonical throughout
struct Goldilocks {
  static constexpr uint64_t P = gl64::P;
  static __device__ __forceinline__ uint64_t enter(uint64_t x) { return x; }
  static __device__ __forceinline__ uint64_t leave(uint64_t x) { return x; }
  static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
    return gl64::mul(a, b);
  }
  static __device__ __forceinline__ uint64_t absorb(uint64_t s, uint64_t e) {
    return gl64::add(s, e);
  }
};

// f62 in Montgomery form, state words in [0, 2p)
struct Field62M {
  static constexpr uint64_t P = f62m::P;
  static __device__ __forceinline__ uint64_t enter(uint64_t x) { return f62m::to_mont(x); }
  static __device__ __forceinline__ uint64_t leave(uint64_t x) { return f62m::from_mont(x); }
  static __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
    return f62m::mul(a, b);
  }
  static __device__ __forceinline__ uint64_t absorb(uint64_t s, uint64_t e) {
    return f62m::sub_if(s + f62m::to_mont(e), 2 * P);  // below 4p, then 2p
  }
};

template <int G>
__device__ __forceinline__ void copy_group(uint64_t (&d)[G], const uint64_t (&s)[G]) {
#pragma unroll
  for (int i = 0; i < G; ++i) d[i] = s[i];
}

// step K of an addition chain on G words: t[K] = t[A]^(2^N) * t[B] (no
// multiply for B < 0); the N squarings as a loop
template <class F, int G, int K, int A, int N, int B, int T>
__device__ __forceinline__ void chain_step(uint64_t (&t)[T][G]) {
  copy_group<G>(t[K], t[A]);
#pragma unroll 1
  for (int m = 0; m < N; ++m) {
#pragma unroll
    for (int i = 0; i < G; ++i) t[K][i] = F::mul(t[K][i], t[K][i]);
  }
  if constexpr (B >= 0) {
#pragma unroll
    for (int i = 0; i < G; ++i) t[K][i] = F::mul(t[K][i], t[B][i]);
  }
}

#define SPONGE_CHAIN_STEP(K, A, N, B) chain_step<F, G, K, A, N, B>(t);
// a chain as a type: run<F, G>(x) raises G words to the chain's exponent
#define SPONGE_CHAIN(NAME, STEPS, LEN)                                \
  struct NAME {                                                       \
    template <class F, int G>                                         \
    static __device__ __forceinline__ void run(uint64_t (&x)[G]) {   \
      uint64_t t[(LEN) + 1][G];                                       \
      copy_group<G>(t[0], x);                                         \
      STEPS(SPONGE_CHAIN_STEP)                                        \
      copy_group<G>(x, t[LEN]);                                       \
    }                                                                 \
  };

SPONGE_CHAIN(Rp64Alpha, RP64_ALPHA_CHAIN, RP64_ALPHA_CHAIN_LEN)
SPONGE_CHAIN(Rp64Inv, RP64_INV_CHAIN, RP64_INV_CHAIN_LEN)
SPONGE_CHAIN(Rp62Alpha, RP62_ALPHA_CHAIN, RP62_ALPHA_CHAIN_LEN)
SPONGE_CHAIN(Rp62Inv, RP62_INV_CHAIN, RP62_INV_CHAIN_LEN)

// s = MDS @ s + ark on Goldilocks words, W wide: the entries are below 32,
// so a row is the products of an entry and the 32-bit halves of each word,
// summed in two 64-bit words (below W * 2^37 each), combined and reduced once
template <int W>
__device__ __forceinline__ void gl_mds_ark(uint64_t (&s)[W], const uint64_t* mds,
                                           const uint64_t* ark) {
  uint64_t t[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint32_t m = (uint32_t)mds[i * W + j];
      lo += (uint64_t)(uint32_t)s[j] * m;
      hi += (uint64_t)(uint32_t)(s[j] >> 32) * m;
    }
    const uint64_t l = lo + (hi << 32);
    t[i] = gl64::reduce128(l, (hi >> 32) + (l < lo ? 1 : 0));
  }
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = gl64::add(t[i], ark[i]);
}

// the Goldilocks layouts: width, rate, tag (Jive: flag), digest and search
// places, rules and round kind (ops/rescue_sponge.py SpongeLayout)
template <int SLOT_, int W, int RS, int R, int TAG_, int DS, int SEED, int STAG, bool JIVE_,
          bool GRIFFIN_>
struct GoldilocksLayout {
  using Field = Goldilocks;
  using Alpha = Rp64Alpha;
  using Inv = Rp64Inv;
  static constexpr int SLOT = SLOT_, WIDTH = W;
  static constexpr int RATE_START = RS, RATE = R, TAG = TAG_, DIGEST_START = DS, DIGEST = 4;
  static constexpr int SEED_START = SEED, SEARCH_TAG = STAG;
  static constexpr bool PACKED31 = false, JIVE = JIVE_, GRIFFIN = GRIFFIN_;

  static __device__ __forceinline__ void mds_ark(uint64_t (&s)[W], const uint64_t* mds,
                                                 const uint64_t* ark) {
    gl_mds_ark<W>(s, mds, ark);
  }
};

// named structs, so each instantiation's symbol names its layout
// (chip_smoke.py reads ptxas's report by these names)
struct Rp64Layout : GoldilocksLayout<0, 12, 4, 8, 0, 4, 4, 0, false, false> {};
struct RpJiveLayout : GoldilocksLayout<2, 8, 4, 4, 0, 4, 0, 7, true, false> {};
struct GriffinLayout : GoldilocksLayout<3, 8, 0, 4, 4, 0, 0, 7, true, true> {};

struct Rp62Layout {
  using Field = Field62M;
  using Alpha = Rp62Alpha;
  using Inv = Rp62Inv;
  static constexpr int SLOT = 1, WIDTH = 12;
  static constexpr int RATE_START = 0, RATE = 8, TAG = 11, DIGEST_START = 0, DIGEST = 4;
  static constexpr int SEED_START = 0, SEARCH_TAG = 11;
  static constexpr bool PACKED31 = true, JIVE = false, GRIFFIN = false;

  // s = MDS @ s + ark in Montgomery form: the words made canonical, a row's
  // twelve 128-bit products summed unreduced (below 12 p^2) and reduced once
  // (below 4p), then to [0, 2p), plus ark (below 3p), then to [0, 2p)
  static __device__ __forceinline__ void mds_ark(uint64_t (&s)[WIDTH], const uint64_t* mds,
                                                 const uint64_t* ark) {
    using f62m::P;
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = f62m::sub_if(s[j], P);
    uint64_t t[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
      uint64_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < WIDTH; ++j) f62m::mul_acc(mds[i * WIDTH + j], s[j], lo, hi);
      t[i] = f62m::sub_if(f62m::redc(lo, hi), 2 * P);
    }
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = f62m::sub_if(t[i] + ark[i], P);
  }
};

// s[i] = s[i]^e for every word by the chain C, G = gcd(width, SBOX_GROUP)
// words at a time: each pass raises the first group and rotates the state by
// one group, so after width / G passes every word is raised and back in place
template <class L, class C>
__device__ __forceinline__ void sbox(uint64_t (&s)[L::WIDTH]) {
  constexpr int W = L::WIDTH, G = gcd_int(W, SBOX_GROUP);
#pragma unroll 1
  for (int g = 0; g < W / G; ++g) {
    uint64_t x[G];
#pragma unroll
    for (int i = 0; i < G; ++i) x[i] = s[i];
    C::template run<typename L::Field, G>(x);
#pragma unroll
    for (int i = 0; i < W - G; ++i) s[i] = s[i + G];
#pragma unroll
    for (int i = 0; i < G; ++i) s[W - G + i] = x[i];
  }
}

// Griffin's non-linear layer (Goldilocks): s0^(1/7), s1^7, then for i =
// 2..W-1 s_i * (l_i^2 + alpha_{i-2} l_i + beta_{i-2}), l_i = (i - 1) s0 + s1
// + s_{i-1} (already updated; none for i = 2); ab: alpha[W - 2], beta[W - 2]
template <class L>
__device__ __forceinline__ void griffin_layer(uint64_t (&s)[L::WIDTH], const uint64_t* ab) {
  constexpr int W = L::WIDTH;
  uint64_t x0[1] = {s[0]}, x1[1] = {s[1]};
  L::Inv::template run<typename L::Field, 1>(x0);
  L::Alpha::template run<typename L::Field, 1>(x1);
  s[0] = x0[0];
  s[1] = x1[0];
  uint64_t acc = s[0];  // (i - 1) * s0
#pragma unroll
  for (int i = 2; i < W; ++i) {
    if (i > 2) acc = gl64::add(acc, s[0]);
    uint64_t l = gl64::add(acc, s[1]);
    if (i > 2) l = gl64::add(l, s[i - 1]);
    const uint64_t q = gl64::add(gl64::add(gl64::mul(l, l), gl64::mul(ab[i - 2], l)),
                                 ab[W - 2 + i - 2]);
    s[i] = gl64::mul(s[i], q);
  }
}

// Rescue-Prime: the 7 rounds as 14 half-rounds, x^alpha, MDS, ARK1;
// x^(1/alpha), MDS, ARK2.  Griffin: 7 rounds of the non-linear layer, MDS
// and ARK (the last ARK row zero)
template <class L>
__device__ __forceinline__ void permute(uint64_t (&s)[L::WIDTH]) {
  constexpr int W = L::WIDTH;
  const SpongeConsts& c = kConsts[L::SLOT];
  if constexpr (L::GRIFFIN) {
#pragma unroll 1
    for (int r = 0; r < ROUNDS; ++r) {
      griffin_layer<L>(s, c.ark2);
      L::mds_ark(s, c.mds, c.ark1 + r * W);
    }
  } else {
#pragma unroll 1
    for (int h = 0; h < 2 * ROUNDS; ++h) {
      if (h & 1) sbox<L, typename L::Inv>(s);
      else sbox<L, typename L::Alpha>(s);
      L::mds_ark(s, c.mds, ((h & 1) ? c.ark2 : c.ark1) + (h >> 1) * W);
    }
  }
}

// four digest values of a row of 8 words (Rp62_248: unpacked, masked to 62
// bits)
template <class L>
__device__ __forceinline__ void load_digest(const uint64_t* row, uint64_t (&d)[4]) {
  uint64_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = row[2 * k] | (row[2 * k + 1] << 32);
  if (L::PACKED31) {
    constexpr uint64_t M62 = (1ULL << 62) - 1;
    d[0] = w[0] & M62;
    d[1] = ((w[0] >> 62) | (w[1] << 2)) & M62;
    d[2] = ((w[1] >> 60) | (w[2] << 4)) & M62;
    d[3] = ((w[2] >> 58) | (w[3] << 6)) & M62;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = w[k];
  }
}

template <class L, int MODE>
__global__ void __launch_bounds__(THREADS) rescue_sponge_kernel(const SpongeArgs a) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.rows) return;
  using F = typename L::Field;
  constexpr int W = L::WIDTH;
  uint64_t s[W];
  uint64_t init[L::JIVE ? W : 1];  // a Jive merge's or search's initial words
#pragma unroll
  for (int i = 0; i < W; ++i) s[i] = 0;
  if (MODE == MODE_MERGE) {
    uint64_t dl[4], dr[4];
    load_digest<L>(a.x + r * a.x_stride, dl);
    load_digest<L>(a.y + r * a.y_stride, dr);
    constexpr int at = L::JIVE ? 0 : L::RATE_START;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[at + k] = F::enter(dl[k]);
      s[at + 4 + k] = F::enter(dr[k]);
    }
    if constexpr (!L::JIVE) s[L::TAG] = F::enter(2 * L::DIGEST);
  } else if (MODE == MODE_SEARCH) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[L::SEED_START + k] = F::enter(a.seed[k]);
    s[L::SEED_START + L::DIGEST] = F::enter(a.start + (uint64_t)r);
    s[L::SEARCH_TAG] = F::enter(L::DIGEST + 1);
  } else {
    const uint64_t* row = a.x + r * a.x_stride;
    if constexpr (!L::JIVE) s[L::TAG] = F::enter((uint64_t)a.n_elems % F::P);
    else if (a.n_elems % L::RATE) s[L::TAG] = 1;
    for (int k0 = 0; k0 < a.n_elems; k0 += L::RATE) {
#pragma unroll
      for (int j = 0; j < L::RATE; ++j) {
        const int k = k0 + j;
        if (k < a.n_elems) {
          const uint64_t e = row[2 * k] | (row[2 * k + 1] << 32);
          s[L::RATE_START + j] = F::absorb(s[L::RATE_START + j], e);
        } else if (L::JIVE) {  // the last started block: 1, 0, ...
          s[L::RATE_START + j] = k == a.n_elems ? 1 : 0;
        }
      }
      permute<L>(s);
    }
  }
  if constexpr (L::JIVE && MODE != MODE_HASH) {
#pragma unroll
    for (int i = 0; i < W; ++i) init[i] = s[i];
  }
  if (MODE != MODE_HASH) permute<L>(s);
  uint64_t d[4];
  if constexpr (L::JIVE && MODE != MODE_HASH) {
    // the Jive sum (Jive layouts are Goldilocks: canonical words)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      d[k] = gl64::add(gl64::add(init[k], init[4 + k]), gl64::add(s[k], s[4 + k]));
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) d[k] = F::leave(s[L::DIGEST_START + k]);
  }
  if (L::PACKED31) {
    const uint64_t v1 = d[0], v2 = d[1], v3 = d[2], v4 = d[3];
    d[0] = v1 | (v2 << 62);
    d[1] = (v2 >> 2) | (v3 << 60);
    d[2] = (v3 >> 4) | (v4 << 58);
    d[3] = v4 >> 6;
  }
  if (MODE == MODE_SEARCH) {
    // the digest's first 8 bytes, little-endian
    if ((d[0] & ((1ULL << a.bits) - 1)) == 0)
      atomicMin(a.found, (unsigned long long)(a.start + (uint64_t)r));
    if (a.out == nullptr) return;
  }
  uint64_t* o = a.out + r * 8;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = d[k] & 0xFFFFFFFFULL;
    o[2 * k + 1] = d[k] >> 32;
  }
}

}  // namespace

template <class L>
static cudaError_t launch_layout(int mode, const SpongeArgs& a, unsigned grid, int threads,
                                 cudaStream_t st) {
  if (mode == MODE_HASH) rescue_sponge_kernel<L, MODE_HASH><<<grid, threads, 0, st>>>(a);
  else if (mode == MODE_MERGE) rescue_sponge_kernel<L, MODE_MERGE><<<grid, threads, 0, st>>>(a);
  else rescue_sponge_kernel<L, MODE_SEARCH><<<grid, threads, 0, st>>>(a);
  return cudaGetLastError();
}

// Plain C interfaces (loaded with ctypes).  The launchers launch on
// `stream`, do not synchronise and allocate nothing, and return the
// cudaError_t of the launch (0 = success).

extern "C" int rescue_sponge_init() { return (int)cudaSuccess; }

// Copies a layout's MDS (144), ARK1 (84) and ARK2 (84) words from the host
// into its constant table (slots as in rescue_sponge_launch; Rp62_248's in
// Montgomery form).  Called once per layout when the library loads.
extern "C" int rescue_sponge_set_constants(int slot, const void* host) {
  if (slot < 0 || slot >= SPONGE_SLOTS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyToSymbol(kConsts, host, sizeof(SpongeConsts),
                                 slot * sizeof(SpongeConsts));
}

static int launch(int slot, int mode, const SpongeArgs& a, int threads, void* stream) {
  if (a.rows <= 0 || threads < 32 || threads > THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  const long long grid = (a.rows + threads - 1) / threads;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned g = (unsigned)grid;
  switch (slot) {
    case 0: return (int)launch_layout<Rp64Layout>(mode, a, g, threads, st);
    case 1: return (int)launch_layout<Rp62Layout>(mode, a, g, threads, st);
    case 2: return (int)launch_layout<RpJiveLayout>(mode, a, g, threads, st);
    case 3: return (int)launch_layout<GriffinLayout>(mode, a, g, threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// slot: the layout (0 = Rp64_256, 1 = Rp62_248, 2 = RpJive64_256, 3 =
// GriffinJive64_256; ops/rescue_sponge.py SLOTS); merge: 0 = hash rows of x
// (n_elems elements a row), 1 = merge the digest rows of x and y.  Strides
// in words; threads: the block size, THREADS at most.
extern "C" int rescue_sponge_launch(int slot, int merge, const void* x, const void* y,
                                    void* out, long long x_stride, long long y_stride,
                                    long long rows, int n_elems, int threads,
                                    void* stream) {
  if (x_stride < 0 || y_stride < 0 || n_elems < 0 || (merge && y == nullptr))
    return (int)cudaErrorInvalidValue;
  SpongeArgs a{};
  a.x = (const uint64_t*)x;
  a.y = (const uint64_t*)y;
  a.out = (uint64_t*)out;
  a.x_stride = x_stride;
  a.y_stride = y_stride;
  a.rows = rows;
  a.n_elems = n_elems;
  return launch(slot, merge ? MODE_MERGE : MODE_HASH, a, threads, stream);
}

// The proof-of-work search over nonces [start, start + count): seed = the
// four digest elements of the seed (host array), *found (device) lowered
// to the lowest nonce whose digest has `bits` trailing zeros in its first 8
// bytes (left as it is when none has); digests (device, (count, 8) words)
// or null.
extern "C" int rescue_sponge_search(int slot, const void* seed, unsigned long long start,
                                    long long count, int bits, void* found, void* digests,
                                    int threads, void* stream) {
  if (seed == nullptr || found == nullptr || bits < 0 || bits > 63)
    return (int)cudaErrorInvalidValue;
  SpongeArgs a{};
  const uint64_t* s = (const uint64_t*)seed;
  for (int k = 0; k < 4; ++k) a.seed[k] = s[k];
  a.start = start;
  a.rows = count;
  a.bits = bits;
  a.found = (unsigned long long*)found;
  a.out = (uint64_t*)digests;
  return launch(slot, MODE_SEARCH, a, threads, stream);
}
