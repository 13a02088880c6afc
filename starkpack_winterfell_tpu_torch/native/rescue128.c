// Copy of starkpack_winterfell_tpu/native/rescue128.c; cut: r128_digest_batch and the Lamport+ trace builders; added: r128_chain_trace.
// Native f128 Rescue128 permutation and the hash-chain trace builder.
//
// A Rescue128 hash chain is sequential scalar work over the 128-bit field
// (examples/src/utils/rescue.rs:14-118): one long dependency through
// x^{1/5}, a 128-bit exponentiation per element per round, which no
// accelerator width can hide.  This builder runs it at native speed; the
// python builder of models/rescue128_chain.py gives the same words.
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

int r128_is_ready(void) { return g_ready; }
