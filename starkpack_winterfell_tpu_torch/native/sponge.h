/* Shared by native/rescue_perm.c and native/griffin_perm.c: the branch-free
 * Goldilocks reduction and the Jive sponge of the width-8 hashers
 * (RpJive64_256: crypto/src/hash/rescue/rp64_256_jive/mod.rs,
 * GriffinJive64_256: crypto/src/hash/griffin/griffin64_256_jive/mod.rs),
 * over any permutation of 8 words given as a callback.
 *
 * Jive rules (JAX crypto/rescue_jive.py, crypto/griffin.py):
 *   hash   no count tag; the flag word is 1 iff the element count is not a
 *          multiple of the rate 4; elements absorb rate-wide at rate_start;
 *          the last partial block's next word is set to 1 and the rest of
 *          the rate to 0; the digest is 4 words at digest_start;
 *   merge  the two digests as state[0..8), one permutation, digest_i =
 *          init_i + init_{4+i} + final_i + final_{4+i};
 *   search merge_with_int(seed, nonce) for nonces below p: seed at
 *          state[0..4), nonce at state[4], state[7] = 5, the Jive sum. */
#pragma once

typedef unsigned long long u64;
typedef unsigned __int128 u128;

#define GOLDILOCKS 0xFFFFFFFF00000001ULL
#define JIVE_WIDTH 8
#define JIVE_RATE 4
#define JIVE_DIGEST 4

/* 128->64 reduction for P = 2^64 - 2^32 + 1 using 2^64 = 2^32 - 1 and
 * 2^96 = -1 (mod P), of any 128-bit value; returns a canonical (< P)
 * value.  Branch-free: the carries are data, not jumps (a jump on a random
 * carry costs a mispredicted branch every other product). */
static inline u64 gl_reduce(u128 xy) {
    const u64 eps = 0xFFFFFFFFULL; /* 2^64 mod P */
    u64 lo = (u64)xy, hi = (u64)(xy >> 64);
    u64 t0, t2;
    /* lo - hi_hi; a borrow adds 2^64 = eps, i.e. subtracts eps (no second
     * borrow: after one, t0 >= 2^64 - 2^32) */
    u64 borrow = __builtin_sub_overflow(lo, hi >> 32, &t0);
    t0 -= eps & -borrow;
    /* + hi_lo * (2^32 - 1); a carry adds eps (no second carry) */
    u64 carry = __builtin_add_overflow(t0, (hi & eps) * eps, &t2);
    t2 += eps & -carry;
    return t2 - (GOLDILOCKS & -(u64)(t2 >= GOLDILOCKS));
}

static inline u64 gl_mulmod(u64 x, u64 y) { return gl_reduce((u128)x * y); }

/* (a + b) mod P of canonical words, P < 2^64 (a wrap is caught) */
static inline u64 addmod(u64 a, u64 b, u64 P) {
    u64 v = a + b;
    return v - (P & -(u64)((v >= P) | (v < a)));
}

typedef void (*jive_perm_fn)(const void *ctx, u64 *s);

static inline void jive_sum(const u64 *init, const u64 *fin, u64 P, u64 *out) {
    for (int i = 0; i < JIVE_DIGEST; i++)
        out[i] = addmod(addmod(init[i], init[JIVE_DIGEST + i], P),
                        addmod(fin[i], fin[JIVE_DIGEST + i], P), P);
}

/* n_rows rows of row_len elements each -> n_rows x 4 digest words */
static void jive_hash_rows(jive_perm_fn perm, const void *ctx, u64 P, const u64 *elements,
                           u64 n_rows, u64 row_len, int rate_start, int flag_index,
                           int digest_start, u64 *out) {
#pragma omp parallel for schedule(static) if (n_rows > 64)
    for (u64 r = 0; r < n_rows; r++) {
        u64 s[JIVE_WIDTH] = {0};
        const u64 *row = elements + r * row_len;
        if (row_len % JIVE_RATE) s[flag_index] = 1;
        int i = 0;
        for (u64 k = 0; k < row_len; k++) {
            s[rate_start + i] = addmod(s[rate_start + i], row[k], P);
            if (++i == JIVE_RATE) {
                perm(ctx, s);
                i = 0;
            }
        }
        if (i > 0) {
            s[rate_start + i] = 1;
            for (int j = i + 1; j < JIVE_RATE; j++) s[rate_start + j] = 0;
            perm(ctx, s);
        }
        for (int d = 0; d < JIVE_DIGEST; d++) out[r * JIVE_DIGEST + d] = s[digest_start + d];
    }
}

/* n pairs of 4-word digests -> n Jive merges */
static void jive_merge_rows(jive_perm_fn perm, const void *ctx, u64 P, const u64 *left,
                            const u64 *right, u64 n, u64 *out) {
#pragma omp parallel for schedule(static) if (n > 64)
    for (u64 k = 0; k < n; k++) {
        u64 init[JIVE_WIDTH], s[JIVE_WIDTH];
        for (int d = 0; d < JIVE_DIGEST; d++) {
            init[d] = left[k * JIVE_DIGEST + d];
            init[JIVE_DIGEST + d] = right[k * JIVE_DIGEST + d];
        }
        for (int i = 0; i < JIVE_WIDTH; i++) s[i] = init[i];
        perm(ctx, s);
        jive_sum(init, s, P, out + k * JIVE_DIGEST);
    }
}

/* The lowest nonce in [start, start + count) (all below P) whose
 * merge_with_int(seed, nonce) digest has `bits` trailing zeros in its first
 * word, or ~0 when none has. */
static u64 jive_search(jive_perm_fn perm, const void *ctx, u64 P, const u64 *seed, u64 start,
                       u64 count, int bits) {
    const u64 mask = bits >= 64 ? ~0ULL : (1ULL << bits) - 1;
    u64 best = ~0ULL;
#pragma omp parallel for schedule(static) reduction(min : best) if (count > 64)
    for (u64 k = 0; k < count; k++) {
        u64 init[JIVE_WIDTH] = {0}, s[JIVE_WIDTH], d[JIVE_DIGEST];
        for (int i = 0; i < JIVE_DIGEST; i++) init[i] = seed[i];
        init[JIVE_DIGEST] = start + k;
        init[JIVE_WIDTH - 1] = JIVE_DIGEST + 1;
        for (int i = 0; i < JIVE_WIDTH; i++) s[i] = init[i];
        perm(ctx, s);
        jive_sum(init, s, P, d);
        if ((d[0] & mask) == 0 && start + k < best) best = start + k;
    }
    return best;
}
