/* Copy of starkpack_winterfell_tpu/native/verify_scalar.c; cut: nothing. */
/* verify_scalar.c — native scalar hot loops for the verifier.
 *
 * The verifier's remaining python cost (after the numpy/slab work of
 * rounds 3-4) is python-int mulmod in three places: the FRI layer fold
 * (fri/verifier.py FriVerifier.verify), the remainder evaluation, and the
 * DEEP composition at the query points (verifier/verifier.py DeepComposer)
 * for the limb fields.  Each is O(num_queries * folding_factor) scalar
 * field ops — tiny arrays where numpy limb kernels lose ~20x to dispatch
 * overhead and python ints pay ~0.5 us per 128-bit mulmod.  Here they run
 * as plain C Montgomery arithmetic over a generic <= 2^128 odd modulus
 * (2x u64 words, CIOS reduction), with quadratic/cubic field extensions
 * handled via caller-supplied reduction coefficients
 * (x^2 = q1*x + q0, x^3 = e2*x^2 + e1*x + e0 — math/fieldspec.py:23-25).
 *
 * Reference semantics mirrored: fri/src/verifier/mod.rs:204-330 (layer
 * folding via row interpolation + evaluation at alpha) and
 * verifier/src/composer.rs:55-217 (DEEP composition; the fork divides the
 * constraint-composition part by (x - z), verifier/verifier.py
 * compose_constraint_evaluations).
 *
 * Element I/O is either raw proof bytes (LE, elem_bytes each — already
 * validated by the python parse), u32 limb words (the Queries parse
 * layout: component-major, nl = elem_bytes/4 LE limbs per component), or
 * u64 word pairs (lo, hi) per component.
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

typedef unsigned __int128 u128;
typedef uint64_t u64;
typedef uint32_t u32;

#define MAX_Q 1024   /* query positions per layer (reference configs: <= 128) */
#define MAX_N 16     /* FRI folding factor */

/* ---------------- 2-word Montgomery field ---------------- */

typedef struct {
    u64 p[2];   /* modulus, little-endian words */
    u64 r2[2];  /* R^2 mod p, R = 2^128 (caller-computed) */
    u64 n0inv;  /* -p^{-1} mod 2^64 */
    u64 one[2]; /* R mod p (Montgomery form of 1) */
} Fld;

typedef struct { u64 w[2]; } Fe;

static inline int fe_ge(const Fe *a, const u64 b[2]) {
    if (a->w[1] != b[1]) return a->w[1] > b[1];
    return a->w[0] >= b[0];
}

static inline Fe fe_sub_raw(Fe a, const u64 b[2]) {
    Fe r;
    u64 borrow = a.w[0] < b[0];
    r.w[0] = a.w[0] - b[0];
    r.w[1] = a.w[1] - b[1] - borrow;
    return r;
}

static inline Fe f_add(const Fld *f, Fe a, Fe b) {
    Fe r;
    u128 s = (u128)a.w[0] + b.w[0];
    r.w[0] = (u64)s;
    u128 t = (u128)a.w[1] + b.w[1] + (u64)(s >> 64);
    r.w[1] = (u64)t;
    if ((t >> 64) || fe_ge(&r, f->p)) r = fe_sub_raw(r, f->p);
    return r;
}

static inline Fe f_sub(const Fld *f, Fe a, Fe b) {
    Fe r;
    u64 borrow = a.w[0] < b.w[0];
    r.w[0] = a.w[0] - b.w[0];
    u64 hi = a.w[1] - b.w[1];
    int under = (a.w[1] < b.w[1]) || (hi < borrow);
    r.w[1] = hi - borrow;
    if (under) { /* add p back; drop the carry out of 2^128 */
        u128 s = (u128)r.w[0] + f->p[0];
        r.w[0] = (u64)s;
        r.w[1] += f->p[1] + (u64)(s >> 64);
    }
    return r;
}

/* CIOS Montgomery multiply: a*b*R^{-1} mod p (inputs < p, output < p). */
static inline Fe f_mul(const Fld *f, Fe a, Fe b) {
    u64 t0 = 0, t1 = 0, t2 = 0, t3 = 0;
    for (int i = 0; i < 2; i++) {
        u128 c = (u128)a.w[i] * b.w[0] + t0;
        t0 = (u64)c;
        c = (u128)a.w[i] * b.w[1] + t1 + (u64)(c >> 64);
        t1 = (u64)c;
        c = (u128)t2 + (u64)(c >> 64);
        t2 = (u64)c;
        t3 = (u64)(c >> 64);
        u64 m = t0 * f->n0inv;
        c = (u128)m * f->p[0] + t0;
        u64 carry = (u64)(c >> 64);
        c = (u128)m * f->p[1] + t1 + carry;
        t0 = (u64)c;
        c = (u128)t2 + (u64)(c >> 64);
        t1 = (u64)c;
        t2 = t3 + (u64)(c >> 64);
        t3 = 0;
    }
    Fe r = { { t0, t1 } };
    if (t2 || fe_ge(&r, f->p)) r = fe_sub_raw(r, f->p);
    return r;
}

static Fe f_pow(const Fld *f, Fe base, u64 e_lo, u64 e_hi) {
    Fe acc = { { f->one[0], f->one[1] } };
    Fe b = base;
    while (e_lo | e_hi) {
        if (e_lo & 1) acc = f_mul(f, acc, b);
        b = f_mul(f, b, b);
        e_lo = (e_lo >> 1) | (e_hi << 63);
        e_hi >>= 1;
    }
    return acc;
}

/* a^{p-2}: Fermat inverse (p prime, a != 0). */
static Fe f_inv(const Fld *f, Fe a) {
    u64 e_lo = f->p[0] - 2;
    u64 e_hi = f->p[1] - (f->p[0] < 2 ? 1 : 0);
    return f_pow(f, a, e_lo, e_hi);
}

static void fld_init(Fld *f, const u64 p[2], const u64 r2[2]) {
    f->p[0] = p[0]; f->p[1] = p[1];
    f->r2[0] = r2[0]; f->r2[1] = r2[1];
    u64 inv = p[0]; /* Newton: correct to 64 bits in 5 steps for odd p */
    for (int i = 0; i < 5; i++) inv *= 2 - p[0] * inv;
    f->n0inv = (u64)(0 - inv);
    Fe plain_one = { { 1, 0 } };
    Fe r2e = { { r2[0], r2[1] } };
    Fe one = f_mul(f, r2e, plain_one);
    f->one[0] = one.w[0]; f->one[1] = one.w[1];
}

static inline Fe to_mont(const Fld *f, Fe a) {
    Fe r2e = { { f->r2[0], f->r2[1] } };
    return f_mul(f, a, r2e);
}

static inline Fe from_mont(const Fld *f, Fe a) {
    Fe one = { { 1, 0 } };
    return f_mul(f, a, one);
}

static inline Fe load_le(const uint8_t *src, int elem_bytes) {
    Fe r = { { 0, 0 } };
    uint8_t buf[16] = { 0 };
    memcpy(buf, src, (size_t)elem_bytes);
    memcpy(&r.w[0], buf, 8);
    memcpy(&r.w[1], buf + 8, 8);
    return r;
}

/* ---------------- extension elements (degree d <= 3) ---------------- */

typedef struct { Fe c[3]; } Ext;

typedef struct {
    Fld f;
    int d;
    Fe q[3]; /* Montgomery reduction coefficients (see header comment) */
} ExtFld;

static inline Ext e_zero(void) { Ext z; memset(&z, 0, sizeof z); return z; }

static inline Ext e_one(const ExtFld *ef) {
    Ext r = e_zero();
    r.c[0] = (Fe){ { ef->f.one[0], ef->f.one[1] } };
    return r;
}

static inline Ext e_add(const ExtFld *ef, Ext a, Ext b) {
    Ext r = e_zero();
    for (int i = 0; i < ef->d; i++) r.c[i] = f_add(&ef->f, a.c[i], b.c[i]);
    return r;
}

static inline Ext e_sub(const ExtFld *ef, Ext a, Ext b) {
    Ext r = e_zero();
    for (int i = 0; i < ef->d; i++) r.c[i] = f_sub(&ef->f, a.c[i], b.c[i]);
    return r;
}

static Ext e_mul(const ExtFld *ef, Ext a, Ext b) {
    const Fld *f = &ef->f;
    int d = ef->d;
    Ext r = e_zero();
    if (d == 1) {
        r.c[0] = f_mul(f, a.c[0], b.c[0]);
        return r;
    }
    Fe t[5];
    memset(t, 0, sizeof t);
    for (int i = 0; i < d; i++)
        for (int j = 0; j < d; j++)
            t[i + j] = f_add(f, t[i + j], f_mul(f, a.c[i], b.c[j]));
    if (d == 2) {
        r.c[0] = f_add(f, t[0], f_mul(f, t[2], ef->q[0]));
        r.c[1] = f_add(f, t[1], f_mul(f, t[2], ef->q[1]));
    } else {
        /* fold x^4 = e2 x^3 + e1 x^2 + e0 x, then x^3 (fieldspec._reduce_poly) */
        t[3] = f_add(f, t[3], f_mul(f, t[4], ef->q[2]));
        t[2] = f_add(f, t[2], f_mul(f, t[4], ef->q[1]));
        t[1] = f_add(f, t[1], f_mul(f, t[4], ef->q[0]));
        r.c[2] = f_add(f, t[2], f_mul(f, t[3], ef->q[2]));
        r.c[1] = f_add(f, t[1], f_mul(f, t[3], ef->q[1]));
        r.c[0] = f_add(f, t[0], f_mul(f, t[3], ef->q[0]));
    }
    return r;
}

static inline Ext e_mul_base(const ExtFld *ef, Ext a, Fe b) {
    Ext r = e_zero();
    for (int i = 0; i < ef->d; i++) r.c[i] = f_mul(&ef->f, a.c[i], b);
    return r;
}

/* inverse via solving M(a) b = 1 where M(a) is the multiplication matrix
 * (d <= 3; one base-field Fermat inverse per pivot). */
static Ext e_inv(const ExtFld *ef, Ext a) {
    const Fld *f = &ef->f;
    int d = ef->d;
    Ext r = e_zero();
    if (d == 1) {
        r.c[0] = f_inv(f, a.c[0]);
        return r;
    }
    Fe M[3][3];
    for (int j = 0; j < d; j++) {
        Ext basis = e_zero();
        basis.c[j] = (Fe){ { f->one[0], f->one[1] } };
        Ext col = e_mul(ef, a, basis);
        for (int i = 0; i < d; i++) M[i][j] = col.c[i];
    }
    Fe rhs[3];
    rhs[0] = (Fe){ { f->one[0], f->one[1] } };
    for (int i = 1; i < d; i++) rhs[i] = (Fe){ { 0, 0 } };
    for (int col = 0; col < d; col++) {
        int piv = -1;
        for (int i = col; i < d; i++)
            if (M[i][col].w[0] | M[i][col].w[1]) { piv = i; break; }
        if (piv < 0) return e_zero(); /* a == 0 */
        if (piv != col) {
            for (int j = 0; j < d; j++) { Fe t = M[col][j]; M[col][j] = M[piv][j]; M[piv][j] = t; }
            Fe t = rhs[col]; rhs[col] = rhs[piv]; rhs[piv] = t;
        }
        Fe pin = f_inv(f, M[col][col]);
        for (int j = col; j < d; j++) M[col][j] = f_mul(f, M[col][j], pin);
        rhs[col] = f_mul(f, rhs[col], pin);
        for (int i = 0; i < d; i++) {
            if (i == col) continue;
            Fe factor = M[i][col];
            if (!(factor.w[0] | factor.w[1])) continue;
            for (int j = col; j < d; j++)
                M[i][j] = f_sub(f, M[i][j], f_mul(f, factor, M[col][j]));
            rhs[i] = f_sub(f, rhs[i], f_mul(f, factor, rhs[col]));
        }
    }
    for (int i = 0; i < d; i++) r.c[i] = rhs[i];
    return r;
}

static inline Ext e_load(const ExtFld *ef, const uint8_t *src, int elem_bytes) {
    Ext r = e_zero();
    for (int i = 0; i < ef->d; i++)
        r.c[i] = to_mont(&ef->f, load_le(src + (size_t)i * elem_bytes, elem_bytes));
    return r;
}

static inline Ext e_load_words(const ExtFld *ef, const u64 *src) {
    Ext r = e_zero();
    for (int i = 0; i < ef->d; i++) {
        Fe t = { { src[2 * i], src[2 * i + 1] } };
        r.c[i] = to_mont(&ef->f, t);
    }
    return r;
}

static inline void e_store_words(const ExtFld *ef, Ext a, u64 *dst) {
    for (int i = 0; i < ef->d; i++) {
        Fe t = from_mont(&ef->f, a.c[i]);
        dst[2 * i] = t.w[0];
        dst[2 * i + 1] = t.w[1];
    }
}

/* load one ext element from the u32 limb-word layout (component-major,
 * nl LE u32 limbs per component) */
static inline Ext e_load_u32(const ExtFld *ef, const u32 *src, int nl,
                             int d_in) {
    /* the table stores d_in components per element; higher ext components
     * are implicitly zero */
    Ext r = e_zero();
    for (int t = 0; t < d_in; t++) {
        Fe fe = { { 0, 0 } };
        const u32 *cw = src + (size_t)t * nl;
        for (int li = 0; li < nl && li < 2; li++)
            fe.w[0] |= (u64)cw[li] << (32 * li);
        for (int li = 2; li < nl && li < 4; li++)
            fe.w[1] |= (u64)cw[li] << (32 * (li - 2));
        r.c[t] = to_mont(&ef->f, fe);
    }
    return r;
}

static void extfld_init(ExtFld *ef, const u64 *p, const u64 *r2, int d,
                        const u64 *qcoeffs) {
    fld_init(&ef->f, p, r2);
    ef->d = d;
    for (int i = 0; i < 3; i++) ef->q[i] = (Fe){ { 0, 0 } };
    if (d > 1 && qcoeffs)
        for (int i = 0; i < d; i++) {
            Fe t = { { qcoeffs[2 * i], qcoeffs[2 * i + 1] } };
            ef->q[i] = to_mont(&ef->f, t);
        }
}

/* ---------------- FRI layer fold (fri/verifier.py:131-184) ------------- */

/* One layer: parse the row values (raw proof bytes, nrows rows of N ext
 * elements), check the query-value consistency against the incoming
 * evaluations, and emit the folded evaluations for the next layer.
 * qmap_{row,col}[i] index the row table for current position i (computed
 * on the python side from fold_positions — trivial integer work).
 * Returns 0 ok, 1 query-value mismatch ("invalid layer folding"),
 * -1 parameter error. */
int vs_fold_layer(
    const u64 *p, const u64 *r2, int d, const u64 *qcoeffs,
    int elem_bytes, int N,
    const uint8_t *values_bytes, int64_t nrows,
    const u64 *evals_in, int64_t npos,
    const int64_t *qmap_row, const int64_t *qmap_col,
    const int64_t *folded_pos,
    const u64 *g, const u64 *offs, const u64 *alpha,
    const u64 *idft,
    u64 *out_evals)
{
    ExtFld EF;
    extfld_init(&EF, p, r2, d, qcoeffs);
    const Fld *f = &EF.f;
    if (nrows > MAX_Q || N > MAX_N || d < 1 || d > 3) return -1;
    size_t row_bytes = (size_t)N * (size_t)d * (size_t)elem_bytes;

    Ext *rows = (Ext *)malloc((size_t)nrows * N * sizeof(Ext));
    if (!rows) return -1;
    for (int64_t r = 0; r < nrows; r++)
        for (int i = 0; i < N; i++)
            rows[r * N + i] = e_load(&EF, values_bytes + (size_t)r * row_bytes
                                          + (size_t)i * d * elem_bytes,
                                     elem_bytes);

    for (int64_t i = 0; i < npos; i++) {
        Ext have = rows[qmap_row[i] * N + qmap_col[i]];
        Ext want = e_load_words(&EF, evals_in + (size_t)i * 2 * d);
        for (int t = 0; t < d; t++)
            if (have.c[t].w[0] != want.c[t].w[0] ||
                have.c[t].w[1] != want.c[t].w[1]) {
                free(rows);
                return 1;
            }
    }

    Fe gm = to_mont(f, (Fe){ { g[0], g[1] } });
    Fe om = to_mont(f, (Fe){ { offs[0], offs[1] } });
    Fe xe[MAX_Q], xinv[MAX_Q], pref[MAX_Q + 1];
    for (int64_t e = 0; e < nrows; e++)
        xe[e] = f_mul(f, f_pow(f, gm, (u64)folded_pos[e], 0), om);
    pref[0] = (Fe){ { f->one[0], f->one[1] } };
    for (int64_t i = 0; i < nrows; i++) pref[i + 1] = f_mul(f, pref[i], xe[i]);
    Fe inv = f_inv(f, pref[nrows]);
    for (int64_t i = nrows - 1; i >= 0; i--) {
        xinv[i] = f_mul(f, pref[i], inv);
        inv = f_mul(f, inv, xe[i]);
    }

    Fe M[MAX_N][MAX_N];
    for (int j = 0; j < N; j++)
        for (int i = 0; i < N; i++)
            M[j][i] = to_mont(f, (Fe){ { idft[(j * N + i) * 2],
                                         idft[(j * N + i) * 2 + 1] } });

    Ext alpham = e_load_words(&EF, alpha);

    for (int64_t e = 0; e < nrows; e++) {
        Ext beta = e_mul_base(&EF, alpham, xinv[e]);
        Ext acc = e_zero();
        for (int j = N - 1; j >= 0; j--) {
            Ext c = e_zero();
            for (int i = 0; i < N; i++)
                c = e_add(&EF, c, e_mul_base(&EF, rows[e * N + i], M[j][i]));
            acc = e_add(&EF, e_mul(&EF, acc, beta), c);
        }
        e_store_words(&EF, acc, out_evals + (size_t)e * 2 * d);
    }
    free(rows);
    return 0;
}

/* remainder check: evaluate the remainder polynomial (raw proof bytes) at
 * xs = offs * g^pos, compare with evals.  0 ok, 1 mismatch. */
int vs_remainder_check(
    const u64 *p, const u64 *r2, int d, const u64 *qcoeffs,
    int elem_bytes,
    const uint8_t *rem_bytes, int64_t nrem,
    const int64_t *positions, int64_t npos,
    const u64 *g, const u64 *offs,
    const u64 *evals)
{
    ExtFld EF;
    extfld_init(&EF, p, r2, d, qcoeffs);
    const Fld *f = &EF.f;
    if (nrem > 65536 || d < 1 || d > 3) return -1;
    Fe gm = to_mont(f, (Fe){ { g[0], g[1] } });
    Fe om = to_mont(f, (Fe){ { offs[0], offs[1] } });
    for (int64_t i = 0; i < npos; i++) {
        Fe x = f_mul(f, f_pow(f, gm, (u64)positions[i], 0), om);
        Ext acc = e_zero();
        for (int64_t c = nrem - 1; c >= 0; c--) {
            Ext coef = e_load(&EF, rem_bytes + (size_t)c * d * elem_bytes,
                              elem_bytes);
            acc = e_add(&EF, e_mul_base(&EF, acc, x), coef);
        }
        Ext want = e_load_words(&EF, evals + (size_t)i * 2 * d);
        for (int t = 0; t < d; t++)
            if (acc.c[t].w[0] != want.c[t].w[0] ||
                acc.c[t].w[1] != want.c[t].w[1])
                return 1;
    }
    return 0;
}

/* ---------------- DEEP composition (composer.rs:55-217) ---------------- */

/* Accumulate the per-query trace numerators over one table group:
 *   t1_num[q] += sum_n sum_col k[n,col] * (T[n,q,col] - ood_cur[n,col])
 *   t2_num[q] += ... against ood_nxt.
 * table_words: (n, q, w, d_in*nl) u32.  accumulate=0 zeroes first. */
int vs_deep_trace(
    const u64 *p, const u64 *r2, int d, const u64 *qcoeffs,
    int elem_bytes,
    const u32 *table_words, int64_t n, int64_t q, int64_t w, int d_in,
    const u64 *ood_cur, const u64 *ood_nxt, const u64 *cc,
    u64 *t1_num, u64 *t2_num, int accumulate)
{
    ExtFld EF;
    extfld_init(&EF, p, r2, d, qcoeffs);
    int nl = elem_bytes / 4;
    if (q > 4096 || d < 1 || d > 3 || d_in < 1 || d_in > 3) return -1;

    /* pre-convert OOD states and coefficients (n*w each) */
    Ext *oc = (Ext *)malloc((size_t)n * w * 3 * sizeof(Ext));
    if (!oc) return -1;
    Ext *on = oc + n * w, *kk = oc + 2 * n * w;
    for (int64_t i = 0; i < n * w; i++) {
        oc[i] = e_load_words(&EF, ood_cur + (size_t)i * 2 * d);
        on[i] = e_load_words(&EF, ood_nxt + (size_t)i * 2 * d);
        kk[i] = e_load_words(&EF, cc + (size_t)i * 2 * d);
    }

    for (int64_t qq = 0; qq < q; qq++) {
        Ext acc1 = e_zero(), acc2 = e_zero();
        if (accumulate) {
            acc1 = e_load_words(&EF, t1_num + (size_t)qq * 2 * d);
            acc2 = e_load_words(&EF, t2_num + (size_t)qq * 2 * d);
        }
        for (int64_t in = 0; in < n; in++) {
            const u32 *row = table_words
                + (((size_t)in * q + qq) * w) * (size_t)(d_in * nl);
            for (int64_t col = 0; col < w; col++) {
                Ext tv = e_load_u32(&EF, row + (size_t)col * d_in * nl, nl, d_in);
                size_t o = (size_t)in * w + col;
                acc1 = e_add(&EF, acc1, e_mul(&EF, e_sub(&EF, tv, oc[o]), kk[o]));
                acc2 = e_add(&EF, acc2, e_mul(&EF, e_sub(&EF, tv, on[o]), kk[o]));
            }
        }
        e_store_words(&EF, acc1, t1_num + (size_t)qq * 2 * d);
        e_store_words(&EF, acc2, t2_num + (size_t)qq * 2 * d);
    }
    free(oc);
    return 0;
}

/* Horner evaluation of a base-field-coefficient polynomial at an ext
 * point: out = sum_i coeffs[i] * x^i.  coeffs: n x 2 u64 plain words. */
int vs_poly_eval(
    const u64 *p, const u64 *r2, int d, const u64 *qcoeffs,
    const u64 *coeffs, int64_t n,
    const u64 *x /* d x 2 */, u64 *out /* d x 2 */)
{
    ExtFld EF;
    extfld_init(&EF, p, r2, d, qcoeffs);
    const Fld *f = &EF.f;
    if (d < 1 || d > 3) return -1;
    Ext xx = e_load_words(&EF, x);
    Ext acc = e_zero();
    for (int64_t i = n - 1; i >= 0; i--) {
        Fe c = to_mont(f, (Fe){ { coeffs[2 * i], coeffs[2 * i + 1] } });
        Ext ce = e_zero();
        ce.c[0] = c;
        acc = e_add(&EF, e_mul(&EF, acc, xx), ce);
    }
    e_store_words(&EF, acc, out);
    return 0;
}

/* Barycentric evaluation of the degree-(n-1) interpolant of base-field
 * values over the size-n subgroup <w> at an ext point x:
 *   p(x) = (x^n - 1)/n * sum_i v_i * w^i / (x - w^i)
 * (exact same field element as interpolate-then-Horner — the interpolant
 * is unique and the arithmetic is exact).  If x lands on a subgroup point
 * the corresponding value is returned directly.  values: n x 2 u64. */
int vs_barycentric_eval(
    const u64 *p, const u64 *r2, int d, const u64 *qcoeffs,
    const u64 *values, int64_t n,
    const u64 *w /* subgroup generator, 2 words */,
    const u64 *x /* d x 2 */, u64 *out /* d x 2 */)
{
    ExtFld EF;
    extfld_init(&EF, p, r2, d, qcoeffs);
    const Fld *f = &EF.f;
    if (d < 1 || d > 3 || n < 1 || n > (1 << 16)) return -1;
    Ext xx = e_load_words(&EF, x);
    Fe wm = to_mont(f, (Fe){ { w[0], w[1] } });

    Ext *den = (Ext *)malloc((size_t)(2 * n + 1) * sizeof(Ext));
    if (!den) return -1;
    Ext *pref = den + n;
    Fe wi = (Fe){ { f->one[0], f->one[1] } };
    for (int64_t i = 0; i < n; i++) {
        Ext wie = e_zero();
        wie.c[0] = wi;
        den[i] = e_sub(&EF, xx, wie);
        int zero = 1;
        for (int t = 0; t < EF.d; t++)
            if (den[i].c[t].w[0] | den[i].c[t].w[1]) zero = 0;
        if (zero) { /* x == w^i exactly */
            Ext v = e_zero();
            v.c[0] = to_mont(f, (Fe){ { values[2 * i], values[2 * i + 1] } });
            e_store_words(&EF, v, out);
            free(den);
            return 0;
        }
        wi = f_mul(f, wi, wm);
    }
    pref[0] = e_one(&EF);
    for (int64_t i = 0; i < n; i++) pref[i + 1] = e_mul(&EF, pref[i], den[i]);
    Ext inv = e_inv(&EF, pref[n]);
    /* accumulate sum_i v_i w^i inv(x - w^i) walking the inversion chain
     * backwards (inv(den[i]) = pref[i] * inv_suffix) */
    Ext s = e_zero();
    /* recompute w^i backwards: w^(n-1) = wi * w^{-1}... simpler: forward
     * array of v_i * w^i (base), then backward chain. */
    Fe *vw = (Fe *)malloc((size_t)n * sizeof(Fe));
    if (!vw) { free(den); return -1; }
    wi = (Fe){ { f->one[0], f->one[1] } };
    for (int64_t i = 0; i < n; i++) {
        Fe v = to_mont(f, (Fe){ { values[2 * i], values[2 * i + 1] } });
        vw[i] = f_mul(f, v, wi);
        wi = f_mul(f, wi, wm);
    }
    for (int64_t i = n - 1; i >= 0; i--) {
        Ext dinv = e_mul(&EF, pref[i], inv);
        inv = e_mul(&EF, inv, den[i]);
        s = e_add(&EF, s, e_mul_base(&EF, dinv, vw[i]));
    }
    /* (x^n - 1) / n */
    Ext xn = e_one(&EF);
    { /* x^n by square-and-multiply over ext */
        Ext base = xx;
        u64 e = (u64)n;
        while (e) {
            if (e & 1) xn = e_mul(&EF, xn, base);
            base = e_mul(&EF, base, base);
            e >>= 1;
        }
    }
    xn = e_sub(&EF, xn, e_one(&EF));
    Fe ninv = f_inv(f, to_mont(f, (Fe){ { (u64)n, 0 } }));
    Ext res = e_mul_base(&EF, e_mul(&EF, xn, s), ninv);
    e_store_words(&EF, res, out);
    free(vw);
    free(den);
    return 0;
}

/* test hook: differential-check the field core from python.
 * out: mul, add, sub, inv(a), pow(a, e) as plain word pairs. */
int vs_test_ops(
    const u64 *p, const u64 *r2, int d, const u64 *qcoeffs,
    const u64 *a, const u64 *b, u64 e_lo, u64 e_hi,
    u64 *out /* 5 x d x 2 */)
{
    ExtFld EF;
    extfld_init(&EF, p, r2, d, qcoeffs);
    if (d < 1 || d > 3) return -1;
    Ext ea = e_load_words(&EF, a), eb = e_load_words(&EF, b);
    e_store_words(&EF, e_mul(&EF, ea, eb), out);
    e_store_words(&EF, e_add(&EF, ea, eb), out + 2 * d);
    e_store_words(&EF, e_sub(&EF, ea, eb), out + 4 * d);
    e_store_words(&EF, e_inv(&EF, ea), out + 6 * d);
    Ext acc = e_one(&EF), base = ea;
    while (e_lo | e_hi) {
        if (e_lo & 1) acc = e_mul(&EF, acc, base);
        base = e_mul(&EF, base, base);
        e_lo = (e_lo >> 1) | (e_hi << 63);
        e_hi >>= 1;
    }
    e_store_words(&EF, acc, out + 8 * d);
    return 0;
}

/* Combine: out[q] = (t1n*(x-zg) + t2n*(x-z)) / ((x-z)(x-zg))
 *                 + [sum_col k2[col]*(C[q,col]-ood_c[col])] / (x-z)
 * cons_words: (q, m, d*nl) u32; x = offs * g_lde^pos. */
int vs_deep_combine(
    const u64 *p, const u64 *r2, int d, const u64 *qcoeffs,
    int elem_bytes,
    int64_t q,
    const int64_t *positions,
    const u64 *g_lde, const u64 *offs,
    const u64 *z, const u64 *zg,
    const u64 *t1_num, const u64 *t2_num,
    const u32 *cons_words, int64_t m,
    const u64 *ood_c, const u64 *cc2,
    u64 *out)
{
    ExtFld EF;
    extfld_init(&EF, p, r2, d, qcoeffs);
    const Fld *f = &EF.f;
    int nl = elem_bytes / 4;
    if (q > MAX_Q || d < 1 || d > 3) return -1;

    Fe gm = to_mont(f, (Fe){ { g_lde[0], g_lde[1] } });
    Fe om = to_mont(f, (Fe){ { offs[0], offs[1] } });
    Ext zz = e_load_words(&EF, z);
    Ext zzg = e_load_words(&EF, zg);

    Ext *oc2 = (Ext *)malloc((size_t)m * 2 * sizeof(Ext));
    if (!oc2) return -1;
    Ext *k2 = oc2 + m;
    for (int64_t i = 0; i < m; i++) {
        oc2[i] = e_load_words(&EF, ood_c + (size_t)i * 2 * d);
        k2[i] = e_load_words(&EF, cc2 + (size_t)i * 2 * d);
    }

    static _Thread_local Ext den0[MAX_Q], den1[MAX_Q], pref[2 * MAX_Q + 1];
    static _Thread_local Ext dinv0[MAX_Q], dinv1[MAX_Q];
    for (int64_t i = 0; i < q; i++) {
        Ext xe = e_zero();
        xe.c[0] = f_mul(f, f_pow(f, gm, (u64)positions[i], 0), om);
        den0[i] = e_sub(&EF, xe, zz);
        den1[i] = e_sub(&EF, xe, zzg);
    }
    pref[0] = e_one(&EF);
    for (int64_t i = 0; i < q; i++) pref[i + 1] = e_mul(&EF, pref[i], den0[i]);
    for (int64_t i = 0; i < q; i++)
        pref[q + i + 1] = e_mul(&EF, pref[q + i], den1[i]);
    Ext inv = e_inv(&EF, pref[2 * q]);
    for (int64_t i = q - 1; i >= 0; i--) {
        dinv1[i] = e_mul(&EF, pref[q + i], inv);
        inv = e_mul(&EF, inv, den1[i]);
    }
    for (int64_t i = q - 1; i >= 0; i--) {
        dinv0[i] = e_mul(&EF, pref[i], inv);
        inv = e_mul(&EF, inv, den0[i]);
    }

    for (int64_t i = 0; i < q; i++) {
        Ext t1 = e_load_words(&EF, t1_num + (size_t)i * 2 * d);
        Ext t2 = e_load_words(&EF, t2_num + (size_t)i * 2 * d);
        Ext num = e_add(&EF, e_mul(&EF, t1, den1[i]), e_mul(&EF, t2, den0[i]));
        Ext tpart = e_mul(&EF, num, e_mul(&EF, dinv0[i], dinv1[i]));
        Ext cnum = e_zero();
        const u32 *crow = cons_words + (size_t)i * m * (size_t)(d * nl);
        for (int64_t col = 0; col < m; col++) {
            Ext cv = e_load_u32(&EF, crow + (size_t)col * d * nl, nl, d);
            cnum = e_add(&EF, cnum, e_mul(&EF, e_sub(&EF, cv, oc2[col]), k2[col]));
        }
        Ext cpart = e_mul(&EF, cnum, dinv0[i]);
        e_store_words(&EF, e_add(&EF, tpart, cpart), out + (size_t)i * 2 * d);
    }
    free(oc2);
    return 0;
}
