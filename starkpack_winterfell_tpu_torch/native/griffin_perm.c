/* The Griffin permutation of GriffinJive64_256 over Goldilocks
 * (crypto/src/hash/griffin/griffin64_256_jive/mod.rs in the reference) and
 * its Jive sponge (native/sponge.h), for the host byte API, the random
 * coin, the nonce search on the CPU and the verifier's Merkle checks.
 *
 * The JAX package has no C path for this hasher: its permutation is python
 * ints (starkpack_winterfell_tpu/crypto/griffin.py:27 apply_permutation_ints),
 * which this file computes.  Width 8; 7 rounds: six of (non-linear layer,
 * MDS, round constants) and a last (non-linear layer, MDS).  The
 * non-linear layer: s0 <- s0^(1/7) (by an addition chain set with
 * gr_init), s1 <- s1^7, then for i = 2..7, l_i = (i-1) s0 + s1 + s_{i-1}
 * (s_{i-1} already updated, 0 for i = 2) and s_i <- s_i (l_i^2 + alpha_{i-2}
 * l_i + beta_{i-2}).  The MDS is a circulant with entries below 32: a row is
 * eight 64 x 32-bit products summed below 2^72 and reduced once. */

#include "sponge.h"

#define G_ROUNDS 7
#define G_MAX_CHAIN 32

typedef struct {
    u64 mds[JIVE_WIDTH * JIVE_WIDTH];
    u64 ark[(G_ROUNDS - 1) * JIVE_WIDTH];
    u64 alpha[JIVE_WIDTH - 2];
    u64 beta[JIVE_WIDTH - 2];
    /* x^(1/7) by an addition chain: step k appends t[a]^(2^n) * t[b] to t
     * (b < 0: no multiply), t[0] = x, the last t is the result */
    int chain_len;
    int chain[3 * G_MAX_CHAIN];
} GriffinCfg;

static GriffinCfg gcfg;

/* mds: 64 words row-major, ark: 6 x 8, alpha and beta: 6 each; chain: n
 * steps (a, n, b) of x^(1/7) (the caller checks its exponent). */
void gr_init(const u64 *mds, const u64 *ark, const u64 *alpha, const u64 *beta, int n,
             const int *chain) {
    for (int i = 0; i < JIVE_WIDTH * JIVE_WIDTH; i++) gcfg.mds[i] = mds[i];
    for (int i = 0; i < (G_ROUNDS - 1) * JIVE_WIDTH; i++) gcfg.ark[i] = ark[i];
    for (int i = 0; i < JIVE_WIDTH - 2; i++) {
        gcfg.alpha[i] = alpha[i];
        gcfg.beta[i] = beta[i];
    }
    for (int i = 0; i < 3 * n; i++) gcfg.chain[i] = chain[i];
    gcfg.chain_len = n;
}

static inline u64 inv_sbox(const GriffinCfg *c, u64 x) {
    u64 t[G_MAX_CHAIN + 1];
    t[0] = x;
    for (int k = 0; k < c->chain_len; k++) {
        const int *st = &c->chain[3 * k];
        u64 v = t[st[0]];
        for (int m = 0; m < st[1]; m++) v = gl_mulmod(v, v);
        t[k + 1] = st[2] >= 0 ? gl_mulmod(v, t[st[2]]) : v;
    }
    return t[c->chain_len];
}

static inline void non_linear(const GriffinCfg *c, u64 *s) {
    const u64 P = GOLDILOCKS;
    s[0] = inv_sbox(c, s[0]);
    const u64 x2 = gl_mulmod(s[1], s[1]), x4 = gl_mulmod(x2, x2);
    s[1] = gl_mulmod(gl_mulmod(x4, x2), s[1]);
    u64 acc = s[0]; /* (i - 1) * s0 */
    for (int i = 2; i < JIVE_WIDTH; i++) {
        if (i > 2) acc = addmod(acc, s[0], P);
        u64 l = addmod(acc, s[1], P);
        if (i > 2) l = addmod(l, s[i - 1], P);
        const u64 q = addmod(addmod(gl_mulmod(l, l), gl_mulmod(c->alpha[i - 2], l), P),
                             c->beta[i - 2], P);
        s[i] = gl_mulmod(s[i], q);
    }
}

/* s <- MDS s (+ ark when ark is not null) */
static inline void mds_ark(const GriffinCfg *c, u64 *s, const u64 *ark) {
    u64 t[JIVE_WIDTH];
    for (int i = 0; i < JIVE_WIDTH; i++) {
        u128 acc = 0;
        for (int j = 0; j < JIVE_WIDTH; j++) acc += (u128)c->mds[i * JIVE_WIDTH + j] * s[j];
        t[i] = gl_reduce(acc);
    }
    for (int i = 0; i < JIVE_WIDTH; i++) s[i] = ark ? addmod(t[i], ark[i], GOLDILOCKS) : t[i];
}

static void permute_one(const GriffinCfg *c, u64 *s) {
    for (int r = 0; r < G_ROUNDS; r++) {
        non_linear(c, s);
        mds_ark(c, s, r < G_ROUNDS - 1 ? &c->ark[r * JIVE_WIDTH] : 0);
    }
}

static void gr_perm_cb(const void *ctx, u64 *s) { permute_one((const GriffinCfg *)ctx, s); }

/* n states of 8 canonical words permuted in place */
void gr_permute_batch(u64 *states, u64 n) {
#pragma omp parallel for schedule(static) if (n > 64)
    for (u64 k = 0; k < n; k++) permute_one(&gcfg, states + k * JIVE_WIDTH);
}

/* Jive sponge hash: rate state[0..4), flag state[4], digest state[0..4) */
void gr_hash_batch(const u64 *elements, u64 n_rows, u64 row_len, u64 *out) {
    jive_hash_rows(gr_perm_cb, &gcfg, GOLDILOCKS, elements, n_rows, row_len, 0, JIVE_RATE, 0,
                   out);
}

void gr_merge_batch(const u64 *left, const u64 *right, u64 n, u64 *out) {
    jive_merge_rows(gr_perm_cb, &gcfg, GOLDILOCKS, left, right, n, out);
}

u64 gr_search(const u64 *seed, u64 start, u64 count, int bits) {
    return jive_search(gr_perm_cb, &gcfg, GOLDILOCKS, seed, start, count, bits);
}
