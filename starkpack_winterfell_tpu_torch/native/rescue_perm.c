// Copy of starkpack_winterfell_tpu/native/rescue_perm.c; cut: nothing; added: the Jive sponge of RpJive64_256 (rp_jive_*, on native/sponge.h, which also holds the Goldilocks reduction), rp_round_states_batch, x^(1/alpha) by an addition chain (rp_set_inv_chain), the S-boxes' words in lockstep, branch-free Goldilocks reduction, one reduction a row for a small MDS.
/* Generic Rescue-Prime permutation over a <= 64-bit prime field.
 *
 * Host-side transcript/Merkle hashing for the algebraic hashers
 * (Rp64_256: crypto/src/hash/rescue/rp64_256/mod.rs, Rp62_248:
 * rp62_248/mod.rs, RpJive64_256: rp_jive64_256/mod.rs in the reference)
 * is inherently sequential python-int math (~2.4 ms per permutation: the
 * inverse s-box is a ~62-bit modexp per element).  This kernel runs the
 * identical round function in C (~2000 u128 mulmods per permutation), a
 * ~100x host-path speedup; the python implementations remain as the
 * fallback when no C compiler is available.
 *
 * A "slot" holds one parameterization (modulus, width, rounds, alpha,
 * inv_alpha, MDS, ARK1, ARK2); each hasher registers its own slot once.
 */

#include "sponge.h"

#define MAX_WIDTH 16
#define MAX_ROUNDS 16
#define MAX_SLOTS 8
#define MAX_CHAIN 32

typedef struct {
    u64 P;
    int width;
    int rounds;
    u64 alpha;
    u64 inv_alpha;
    u64 mds[MAX_WIDTH * MAX_WIDTH];
    u64 ark1[MAX_ROUNDS * MAX_WIDTH];
    u64 ark2[MAX_ROUNDS * MAX_WIDTH];
    int mds_small; /* every MDS entry < 2^32 (Rp64_256's circulant) */
    /* x^inv_alpha by an addition chain when chain_len > 0: step k appends
     * t[a]^(2^n) * t[b] to t (b < 0: no multiply), t[0] = x, the last t is
     * the result (rp_set_inv_chain) */
    int chain_len;
    int chain[3 * MAX_CHAIN];
} PermCfg;

static PermCfg cfgs[MAX_SLOTS];

/* `gl` is a compile-time constant at every call site below (the permute
 * body is cloned for goldilocks/generic), so the branch vanishes. */
static inline u64 mulmod2(u64 a, u64 b, u64 P, const int gl) {
    return gl ? gl_mulmod(a, b) : (u64)(((u128)a * b) % P);
}

/* s[i] = s[i]^e for i < w (e >= 1), left to right, the w elements in
 * lockstep: each step's w products are independent, so they overlap in the
 * core's pipeline (one element's square-and-multiply chain alone is
 * latency-bound). */
static inline void pow_vec(u64 *s, int w, u64 e, u64 P, const int gl) {
    u64 b[MAX_WIDTH];
    for (int i = 0; i < w; i++) b[i] = s[i];
    for (int k = 62 - __builtin_clzll(e); k >= 0; k--) {
        for (int i = 0; i < w; i++) s[i] = mulmod2(s[i], s[i], P, gl);
        if ((e >> k) & 1)
            for (int i = 0; i < w; i++) s[i] = mulmod2(s[i], b[i], P, gl);
    }
}

void rp_init(int slot, u64 P, int width, int rounds, u64 alpha,
             u64 inv_alpha, const u64 *mds, const u64 *ark1,
             const u64 *ark2) {
    PermCfg *c = &cfgs[slot];
    c->P = P;
    c->width = width;
    c->rounds = rounds;
    c->alpha = alpha;
    c->inv_alpha = inv_alpha;
    c->chain_len = 0;
    c->mds_small = 1;
    for (int i = 0; i < width * width; i++) {
        c->mds[i] = mds[i];
        c->mds_small &= mds[i] < (1ULL << 32);
    }
    for (int i = 0; i < rounds * width; i++) {
        c->ark1[i] = ark1[i];
        c->ark2[i] = ark2[i];
    }
}

/* x^inv_alpha of a slot by an addition chain of n <= MAX_CHAIN steps (a, n,
 * b) (see PermCfg); the caller checks that the chain reaches inv_alpha. */
void rp_set_inv_chain(int slot, int n, const int *steps) {
    PermCfg *c = &cfgs[slot];
    for (int i = 0; i < 3 * n; i++) c->chain[i] = steps[i];
    c->chain_len = n;
}

/* s[i] = s[i]^inv_alpha for i < w by the slot's addition chain, the w
 * elements in lockstep as in pow_vec. */
static inline void chain_vec(const PermCfg *c, u64 *s, int w, const int gl) {
    u64 t[MAX_CHAIN + 1][MAX_WIDTH];
    u64 P = c->P;
    for (int i = 0; i < w; i++) t[0][i] = s[i];
    for (int k = 0; k < c->chain_len; k++) {
        const int *st = &c->chain[3 * k];
        u64 *o = t[k + 1];
        for (int i = 0; i < w; i++) o[i] = t[st[0]][i];
        for (int m = 0; m < st[1]; m++)
            for (int i = 0; i < w; i++) o[i] = mulmod2(o[i], o[i], P, gl);
        if (st[2] >= 0)
            for (int i = 0; i < w; i++) o[i] = mulmod2(o[i], t[st[2]][i], P, gl);
    }
    for (int i = 0; i < w; i++) s[i] = t[c->chain_len][i];
}

static inline void mds_apply(const PermCfg *c, const u64 *in, u64 *out,
                             const int gl, const int w) {
    u64 P = c->P;
    for (int i = 0; i < w; i++) {
        u128 acc = 0;
        const u64 *row = &c->mds[i * w];
        if (gl && c->mds_small) {
            /* w <= 16 products of 64 x 32 bits sum below 2^100: one
             * reduction a row */
            for (int j = 0; j < w; j++) acc += (u128)row[j] * in[j];
            out[i] = gl_reduce(acc);
            continue;
        }
        /* per-term reduction: a single product can be ~2^128 for a 64-bit
         * modulus, so products cannot be accumulated unreduced; the sum of
         * w <= 16 reduced terms stays < 2^68 */
        for (int j = 0; j < w; j++) acc += mulmod2(row[j], in[j], P, gl);
        out[i] = (u64)(acc % P);
    }
}

/* s <- MDS s + ark, element-wise mod P. */
static inline void mds_ark(const PermCfg *c, u64 *s, const u64 *ark,
                           const int gl, const int w) {
    u64 tmp[MAX_WIDTH];
    u64 P = c->P;
    mds_apply(c, s, tmp, gl, w);
    for (int i = 0; i < w; i++) {
        u64 v = tmp[i] + ark[i];
        /* v < 2P; a u64 wrap (P > 2^63) is detected by v < tmp[i] and
         * v - P is still correct mod 2^64 */
        s[i] = v - (P & -(u64)((v >= P) | (v < tmp[i])));
    }
}

/* Round r: x^alpha, MDS, ARK1, x^(1/alpha), MDS, ARK2.  `w` is the slot's
 * width, a compile-time constant at the call sites of the widths the
 * hashers use (8 and 12), so the loops over the state unroll. */
static inline __attribute__((always_inline)) void round_impl(const PermCfg *c, u64 *s, int r,
                                                             const int gl, const int w) {
    pow_vec(s, w, c->alpha, c->P, gl);
    mds_ark(c, s, &c->ark1[r * w], gl, w);
    if (c->chain_len)
        chain_vec(c, s, w, gl);
    else
        pow_vec(s, w, c->inv_alpha, c->P, gl);
    mds_ark(c, s, &c->ark2[r * w], gl, w);
}

static inline __attribute__((always_inline)) void permute_one_impl(const PermCfg *c, u64 *s,
                                                                   const int gl, const int w) {
    for (int r = 0; r < c->rounds; r++) round_impl(c, s, r, gl, w);
}

static void permute_gl8(const PermCfg *c, u64 *s) { permute_one_impl(c, s, 1, 8); }
static void permute_gl12(const PermCfg *c, u64 *s) { permute_one_impl(c, s, 1, 12); }

static void permute_one(const PermCfg *c, u64 *s) {
    if (c->P != GOLDILOCKS)
        permute_one_impl(c, s, 0, c->width);
    else if (c->width == 8)
        permute_gl8(c, s);
    else if (c->width == 12)
        permute_gl12(c, s);
    else
        permute_one_impl(c, s, 1, c->width);
}

void rp_permute_batch(int slot, u64 *states, u64 n) {
    const PermCfg *c = &cfgs[slot];
#pragma omp parallel for schedule(static) if (n > 64)
    for (u64 k = 0; k < n; k++) permute_one(c, states + k * c->width);
}

/* Sponge helpers: absorb pre-chunked field elements rate-wide and squeeze
 * the first digest_size elements.  `elements` is n_rows x row_len (same
 * layout for every row — the Merkle/words batch case); the count tag and
 * rate/digest geometry are passed in so one entry point serves both the
 * capacity-first (Rp64_256/Jive) and legacy rate-first (Rp62_248)
 * layouts (tag_index selects the tag position). */
void rp_hash_elements_batch(int slot, const u64 *elements, u64 n_rows,
                            u64 row_len, int rate_start, int rate,
                            int tag_index, int digest_start, int digest_size,
                            u64 *out) {
    const PermCfg *c = &cfgs[slot];
    u64 P = c->P;
#pragma omp parallel for schedule(static) if (n_rows > 64)
    for (u64 r = 0; r < n_rows; r++) {
        u64 s[MAX_WIDTH] = {0};
        s[tag_index] = row_len % P;
        const u64 *row = elements + r * row_len;
        int i = 0;
        for (u64 k = 0; k < row_len; k++) {
            u64 v = s[rate_start + i] + row[k];
            if (v >= P || v < row[k]) v -= P;
            s[rate_start + i] = v;
            if (++i == rate) {
                permute_one(c, s);
                i = 0;
            }
        }
        if (i > 0) permute_one(c, s);
        for (int d = 0; d < digest_size; d++)
            out[r * digest_size + d] = s[digest_start + d];
    }
}

/* Two-digest merge: state = left || right placed at rate_start, tag = 2 *
 * digest_size, one permutation.  Matches Rp64_256::merge / Rp62_248::merge. */
void rp_merge_batch(int slot, const u64 *left, const u64 *right, u64 n,
                    int rate_start, int tag_index, int digest_start,
                    int digest_size, u64 *out) {
    const PermCfg *c = &cfgs[slot];
#pragma omp parallel for schedule(static) if (n > 64)
    for (u64 k = 0; k < n; k++) {
        u64 s[MAX_WIDTH] = {0};
        for (int d = 0; d < digest_size; d++) {
            s[rate_start + d] = left[k * digest_size + d];
            s[rate_start + digest_size + d] = right[k * digest_size + d];
        }
        s[tag_index] = 2 * digest_size;
        permute_one(c, s);
        for (int d = 0; d < digest_size; d++)
            out[k * digest_size + d] = s[digest_start + d];
    }
}

/* Every round state of n permutations: out is n x (rounds + 1) x width,
 * the input state first, then the state after each round (the rows a
 * trace builder writes for one permutation). */
void rp_round_states_batch(int slot, const u64 *states, u64 n, u64 *out) {
    const PermCfg *c = &cfgs[slot];
    const int w = c->width;
#pragma omp parallel for schedule(static) if (n > 64)
    for (u64 k = 0; k < n; k++) {
        u64 s[MAX_WIDTH];
        u64 *o = out + k * (u64)(c->rounds + 1) * w;
        for (int i = 0; i < w; i++) o[i] = s[i] = states[k * w + i];
        for (int r = 0; r < c->rounds; r++) {
            if (c->P == GOLDILOCKS)
                round_impl(c, s, r, 1, w);
            else
                round_impl(c, s, r, 0, w);
            for (int i = 0; i < w; i++) o[(r + 1) * w + i] = s[i];
        }
    }
}

/* The Jive sponge of a width-8 slot (RpJive64_256; native/sponge.h). */
static void rp_perm_cb(const void *ctx, u64 *s) { permute_one((const PermCfg *)ctx, s); }

void rp_jive_hash_batch(int slot, const u64 *elements, u64 n_rows, u64 row_len,
                        int rate_start, int flag_index, int digest_start, u64 *out) {
    const PermCfg *c = &cfgs[slot];
    jive_hash_rows(rp_perm_cb, c, c->P, elements, n_rows, row_len, rate_start, flag_index,
                   digest_start, out);
}

void rp_jive_merge_batch(int slot, const u64 *left, const u64 *right, u64 n, u64 *out) {
    const PermCfg *c = &cfgs[slot];
    jive_merge_rows(rp_perm_cb, c, c->P, left, right, n, out);
}

u64 rp_jive_search(int slot, const u64 *seed, u64 start, u64 count, int bits) {
    const PermCfg *c = &cfgs[slot];
    return jive_search(rp_perm_cb, c, c->P, seed, start, count, bits);
}
