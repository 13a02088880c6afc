// Copy of starkpack_winterfell_tpu/native/rescue128.c; cut: nothing; added: r128_chain_trace.
// Native f128 Rescue128 sponge, the hash-chain trace builder and the
// Lamport+ wallet kernels.
//
// A Rescue128 hash chain, the Lamport+ keygen hashing and the signature
// trace are sequential scalar work over the 128-bit field
// (examples/src/utils/rescue.rs:14-118): one long dependency through
// x^{1/5}, a 128-bit exponentiation per element per round, which no
// accelerator width can hide.  These builders run it at native speed
// (OpenMP across independent digests and signature blocks where the
// compiler has it); the python builders of models/ give the same words.
//
// Field: P = 2^128 - 45*2^40 + 1 (math/src/field/f128/mod.rs), so
// 2^128 === 45*2^40 - 1 (mod P); elements are (lo, hi) u64 pairs.

#include <stddef.h>
#include <stdint.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;

static const u128 DELTA = ((u128)45 << 40) - 1;  // 2^128 mod P
#define P_LO 0xffffd30000000001ULL
#define P_HI 0xffffffffffffffffULL

static inline u128 make_p(void) { return ((u128)P_HI << 64) | P_LO; }

// (hi:lo) 256-bit -> mod P
static inline u128 reduce256(u128 hi, u128 lo) {
  const u128 P = make_p();
  // lo + hi*DELTA; hi*DELTA < 2^128 * 2^46 -> split hi into halves
  while (hi) {
    u64 h1 = (u64)(hi >> 64), h0 = (u64)hi;
    // hi*DELTA = h1*DELTA*2^64 + h0*DELTA
    u128 t0 = (u128)h0 * DELTA;              // < 2^110
    u128 t1 = (u128)h1 * DELTA;              // < 2^110
    // sum = t0 + (t1 << 64): low 128 bits + overflow
    u128 t1lo = t1 << 64;
    u128 nlo = t0 + t1lo;
    u128 nhi = (t1 >> 64) + (nlo < t1lo ? 1 : 0);
    u128 s = lo + nlo;
    nhi += (s < nlo) ? 1 : 0;
    lo = s;
    hi = nhi;
  }
  if (lo >= P) lo -= P;
  return lo;
}

static inline u128 mulmod(u128 a, u128 b) {
  u64 a0 = (u64)a, a1 = (u64)(a >> 64);
  u64 b0 = (u64)b, b1 = (u64)(b >> 64);
  u128 p00 = (u128)a0 * b0;
  u128 p01 = (u128)a0 * b1;
  u128 p10 = (u128)a1 * b0;
  u128 p11 = (u128)a1 * b1;
  // mid = p01 + p10 (may carry beyond 128)
  u128 mid = p01 + p10;
  u128 mid_carry = (mid < p01) ? ((u128)1 << 64) : 0;  // carry*2^128 -> hi += 2^64
  u128 lo = p00 + (mid << 64);
  u128 hi = p11 + (mid >> 64) + mid_carry + ((lo < p00) ? 1 : 0);
  return reduce256(hi, lo);
}

static inline u128 addmod(u128 a, u128 b) {
  const u128 P = make_p();
  u128 s = a + b;
  if (s < a) {  // wrapped past 2^128: add DELTA
    s += DELTA;
    // s was < P before adding DELTA (since a,b < P => a+b < 2P < 2^129)
  }
  if (s >= P) s -= P;
  return s;
}

static inline u128 expmod(u128 base, u64 e_lo, u64 e_hi) {
  u128 r = 1, b = base;
  for (int i = 0; i < 64; i++) {
    if ((e_lo >> i) & 1) r = mulmod(r, b);
    b = mulmod(b, b);
  }
  for (int i = 0; i < 64; i++) {
    if ((e_hi >> i) & 1) r = mulmod(r, b);
    b = mulmod(b, b);
  }
  return r;
}

// ---- Rescue128 permutation ------------------------------------------------

#define W 6
#define ROUNDS 7
#define CYCLE 8

static u128 g_mds[W * W];
static u128 g_ark[CYCLE][2 * W];
static u64 g_invalpha_lo, g_invalpha_hi;
static int g_ready = 0;

static inline u128 rd(const u64* p) { return ((u128)p[1] << 64) | p[0]; }
static inline void wr(u64* p, u128 v) { p[0] = (u64)v; p[1] = (u64)(v >> 64); }

void r128_init(const u64* mds, const u64* ark, const u64* inv_alpha) {
  for (int i = 0; i < W * W; i++) g_mds[i] = rd(mds + 2 * i);
  for (int r = 0; r < CYCLE; r++)
    for (int j = 0; j < 2 * W; j++) g_ark[r][j] = rd(ark + 2 * (r * 2 * W + j));
  g_invalpha_lo = inv_alpha[0];
  g_invalpha_hi = inv_alpha[1];
  g_ready = 1;
}

static inline void apply_mds(u128* s) {
  u128 t[W];
  for (int i = 0; i < W; i++) {
    u128 acc = 0;
    for (int j = 0; j < W; j++) acc = addmod(acc, mulmod(g_mds[i * W + j], s[j]));
    t[i] = acc;
  }
  for (int i = 0; i < W; i++) s[i] = t[i];
}

static inline void apply_round(u128* s, int step) {
  const u128* ark = g_ark[step % CYCLE];
  for (int i = 0; i < W; i++) {  // x^5
    u128 x = s[i], x2 = mulmod(x, x), x4 = mulmod(x2, x2);
    s[i] = mulmod(x4, x);
  }
  apply_mds(s);
  for (int i = 0; i < W; i++) s[i] = addmod(s[i], ark[i]);
  for (int i = 0; i < W; i++) s[i] = expmod(s[i], g_invalpha_lo, g_invalpha_hi);
  apply_mds(s);
  for (int i = 0; i < W; i++) s[i] = addmod(s[i], ark[W + i]);
}

static inline void permute(u128* s) {
  for (int r = 0; r < ROUNDS; r++) apply_round(s, r);
}

// Hash-chain trace (models/rescue128_chain.py build_rescue128_chain_trace):
// 6 columns x 8*m rows, column-major, out_lo/out_hi each 6*length u64.
// Rows 0..6 of a cycle apply one round each; the cycle boundary re-absorbs
// the digest into a fresh state [d0, d1, 0, 0, 0, 0].
void r128_chain_trace(const u64* seed, u64 m, u64* out_lo, u64* out_hi) {
  const u64 length = m * CYCLE;
  u128 state[W] = {rd(seed), rd(seed + 2), 0, 0, 0, 0};
  for (u64 c = 0; c < m; c++) {
    const u64 base = c * CYCLE;
    u128 cur[W];
    for (int i = 0; i < W; i++) cur[i] = state[i];
    for (int r = 0; r < CYCLE; r++) {
      for (int i = 0; i < W; i++) {
        out_lo[(u64)i * length + base + r] = (u64)cur[i];
        out_hi[(u64)i * length + base + r] = (u64)(cur[i] >> 64);
      }
      if (r < ROUNDS) apply_round(cur, r);
    }
    state[0] = cur[0];
    state[1] = cur[1];
    for (int i = 2; i < W; i++) state[i] = 0;
  }
}

// Merkle authentication-path traces (models/merkle128.py
// build_merkle128_trace), batched over n paths of one depth: 7 columns x
// 8*depth rows each, out_lo/out_hi each n*7*length u64 (path-major, then
// column-major).  leaves n*2*(lo,hi), sibs n*depth*2*(lo,hi), index n bit
// masks (bit l routes level l).  Level l hashes [digest, sibling] (bit 0) or
// [sibling, digest] (bit 1) with two zero capacity elements; column 6 holds
// the bit, and the absorb row of a level holds the next level's bit.
void r128_merkle_trace_batch(u64 n, u64 depth, const u64* leaves, const u64* sibs,
                             const u64* index, u64* out_lo, u64* out_hi) {
  const u64 length = depth * CYCLE;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n > 8)
#endif
  for (u64 b = 0; b < n; b++) {
    u64* lo = out_lo + b * (W + 1) * length;
    u64* hi = out_hi + b * (W + 1) * length;
    u128 digest[2] = {rd(leaves + 4 * b), rd(leaves + 4 * b + 2)};
    for (u64 lvl = 0; lvl < depth; lvl++) {
      const u64 bit = (index[b] >> lvl) & 1;
      const u64* sp = sibs + (b * depth + lvl) * 4;
      const u128 sib[2] = {rd(sp), rd(sp + 2)};
      u128 s[W] = {0, 0, 0, 0, 0, 0};
      for (int i = 0; i < 2; i++) {
        s[i] = bit ? sib[i] : digest[i];
        s[2 + i] = bit ? digest[i] : sib[i];
      }
      const u64 base = lvl * CYCLE;
      for (int r = 0; r < CYCLE; r++) {
        if (r > 0) apply_round(s, r - 1);
        for (int i = 0; i < W; i++) {
          lo[(u64)i * length + base + r] = (u64)s[i];
          hi[(u64)i * length + base + r] = (u64)(s[i] >> 64);
        }
        lo[(u64)W * length + base + r] = bit;
        hi[(u64)W * length + base + r] = 0;
      }
      digest[0] = s[0];
      digest[1] = s[1];
      if (lvl + 1 < depth) lo[(u64)W * length + base + CYCLE - 1] = (index[b] >> (lvl + 1)) & 1;
    }
  }
}

// digest of m elements (sponge rate 4, no padding — rescue.rs:96-117),
// batched over n inputs; inputs n*m*(lo,hi), out n*2*(lo,hi)
void r128_digest_batch(const u64* inputs, u64 m, u64 n, u64* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n > 64)
#endif
  for (u64 b = 0; b < n; b++) {
    const u64* in = inputs + b * m * 2;
    u128 state[W] = {0, 0, 0, 0, 0, 0};
    u64 i = 0;
    for (u64 e = 0; e < m; e++) {
      state[i] = addmod(state[i], rd(in + 2 * e));
      i++;
      if (i % 4 == 0) {
        permute(state);
        i = 0;
      }
    }
    if (i > 0) permute(state);
    wr(out + b * 4, state[0]);
    wr(out + b * 4 + 2, state[1]);
  }
}

// Lamport+ signature-verification trace (models/lamport128.py
// build_lamport128_trace): 14 columns x 8*(k+1) rows, column-major,
// out_lo/out_hi each 14*length u64.
static void lamport128_trace_block(u64 k, const u64* msg_bits,
                                   const u64* revealed, const u64* other,
                                   u64* out_lo, u64* out_hi, u64 col_stride,
                                   u64 row_base) {
  const int A0 = 0, B0 = 6, BIT = 12, MSG = 13, WIDTH = 14;
  u64 length = col_stride;
  out_lo += row_base;
  out_hi += row_base;
  u128 b_state[W] = {0, 0, 0, 0, 0, 0};
  u128 msg = 0;
  const u128 P = make_p();
  for (u64 c = 0; c <= k; c++) {
    u64 base = c * CYCLE;
    u64 bit = (c < k) ? msg_bits[c] : 0;
    u128 a_cur[W] = {0, 0, 0, 0, 0, 0};
    if (c < k) {
      a_cur[0] = rd(revealed + 4 * c);
      a_cur[1] = rd(revealed + 4 * c + 2);
    }
    u128 b_cur[W];
    for (int i = 0; i < W; i++) b_cur[i] = b_state[i];
    for (int r = 0; r < CYCLE; r++) {
      u64 row = base + r;
      for (int i = 0; i < W; i++) {
        out_lo[(u64)(A0 + i) * length + row] = (u64)a_cur[i];
        out_hi[(u64)(A0 + i) * length + row] = (u64)(a_cur[i] >> 64);
        out_lo[(u64)(B0 + i) * length + row] = (u64)b_cur[i];
        out_hi[(u64)(B0 + i) * length + row] = (u64)(b_cur[i] >> 64);
      }
      out_lo[(u64)BIT * length + row] = bit;
      out_hi[(u64)BIT * length + row] = 0;
      out_lo[(u64)MSG * length + row] = (u64)msg;
      out_hi[(u64)MSG * length + row] = (u64)(msg >> 64);
      if (r < ROUNDS) {
        apply_round(a_cur, r);
        if (c >= 1) apply_round(b_cur, r);
      }
    }
    if (c < k) {
      u128 h0 = a_cur[0], h1 = a_cur[1];
      u128 l0 = bit ? rd(other + 4 * c) : h0;
      u128 l1 = bit ? rd(other + 4 * c + 2) : h1;
      u128 r0 = bit ? h0 : rd(other + 4 * c);
      u128 r1 = bit ? h1 : rd(other + 4 * c + 2);
      b_state[0] = addmod(b_cur[0], l0);
      b_state[1] = addmod(b_cur[1], l1);
      b_state[2] = addmod(b_cur[2], r0);
      b_state[3] = addmod(b_cur[3], r1);
      b_state[4] = b_cur[4];
      b_state[5] = b_cur[5];
      msg = addmod(addmod(msg, msg), (u128)bit);
      (void)P;
    }
  }
}

void lamport128_trace(u64 k, const u64* msg_bits, const u64* revealed,
                      const u64* other, u64* out_lo, u64* out_hi) {
  lamport128_trace_block(k, msg_bits, revealed, other, out_lo, out_hi,
                         (k + 1) * CYCLE, 0);
}

// All n_sigs blocks of the aggregated trace in one call (blocks are
// independent — models/lamport128_agg.py build_lamport128_agg_trace):
// out planes are 14 x (n_sigs * (k+1) * CYCLE), block s at row offset
// s * (k+1) * CYCLE.
void lamport128_trace_batch(u64 n_sigs, u64 k, const u64* msg_bits,
                            const u64* revealed, const u64* other,
                            u64* out_lo, u64* out_hi) {
  u64 block = (k + 1) * CYCLE;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n_sigs > 4)
#endif
  for (u64 s = 0; s < n_sigs; s++)
    lamport128_trace_block(k, msg_bits + s * k, revealed + s * 4 * k,
                           other + s * 4 * k, out_lo, out_hi,
                           n_sigs * block, s * block);
}

int r128_is_ready(void) { return g_ready; }
