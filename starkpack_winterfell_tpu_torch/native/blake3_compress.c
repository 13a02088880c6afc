/* Copy of starkpack_winterfell_tpu/native/blake3_compress.c; cut: nothing. */
/* Batched BLAKE3 compression over contiguous u32 rows.
 *
 * The host Fiat-Shamir / Merkle-verification paths issue thousands of small
 * compressions; the numpy formulation in ops/blake3.py pays ~450 array-op
 * dispatches per call regardless of batch width.  This kernel is the native
 * tier for that hot path (the reference consumes the upstream `blake3`
 * Rust crate — crypto/src/hash/blake/mod.rs; there is no code to port, this
 * is written from the public spec).
 *
 * Build: cc -O3 -shared -fPIC blake3_compress.c -o libstarkb3.so
 */

#include <stddef.h>
#include <stdint.h>

static inline uint32_t rotr32(uint32_t x, int r) {
    return (x >> r) | (x << (32 - r));
}

#define G(a, b, c, d, mx, my)                                                  \
    do {                                                                       \
        v[a] = v[a] + v[b] + (mx);                                             \
        v[d] = rotr32(v[d] ^ v[a], 16);                                        \
        v[c] = v[c] + v[d];                                                    \
        v[b] = rotr32(v[b] ^ v[c], 12);                                        \
        v[a] = v[a] + v[b] + (my);                                             \
        v[d] = rotr32(v[d] ^ v[a], 8);                                         \
        v[c] = v[c] + v[d];                                                    \
        v[b] = rotr32(v[b] ^ v[c], 7);                                         \
    } while (0)

#define ROUND(m)                                                               \
    do {                                                                       \
        G(0, 4, 8, 12, m[0], m[1]);                                            \
        G(1, 5, 9, 13, m[2], m[3]);                                            \
        G(2, 6, 10, 14, m[4], m[5]);                                           \
        G(3, 7, 11, 15, m[6], m[7]);                                           \
        G(0, 5, 10, 15, m[8], m[9]);                                           \
        G(1, 6, 11, 12, m[10], m[11]);                                         \
        G(2, 7, 8, 13, m[12], m[13]);                                          \
        G(3, 4, 9, 14, m[14], m[15]);                                          \
    } while (0)

static const uint8_t PERM[16] = {2, 6,  3, 10, 7, 0,  4,  13,
                                 1, 11, 12, 5, 9, 14, 15, 8};

static const uint32_t IV[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                               0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                               0x1F83D9ABu, 0x5BE0CD19u};

/* cv: k x 8 rows, blocks: k x 16 rows, out: k x 8 rows (may alias cv). */
void b3_compress_batch(const uint32_t *cv, const uint32_t *blocks,
                       uint64_t counter, uint32_t block_len, uint32_t flags,
                       size_t k, uint32_t *out) {
#pragma omp parallel for schedule(static) if (k >= 1024)
    for (size_t row = 0; row < k; ++row) {
        const uint32_t *c = cv + row * 8;
        const uint32_t *b = blocks + row * 16;
        uint32_t v[16];
        uint32_t m[16], mp[16];
        for (int i = 0; i < 8; ++i) v[i] = c[i];
        v[8] = IV[0];
        v[9] = IV[1];
        v[10] = IV[2];
        v[11] = IV[3];
        v[12] = (uint32_t)(counter & 0xFFFFFFFFu);
        v[13] = (uint32_t)(counter >> 32);
        v[14] = block_len;
        v[15] = flags;
        for (int i = 0; i < 16; ++i) m[i] = b[i];
        for (int r = 0; r < 7; ++r) {
            ROUND(m);
            if (r < 6) {
                for (int i = 0; i < 16; ++i) mp[i] = m[PERM[i]];
                for (int i = 0; i < 16; ++i) m[i] = mp[i];
            }
        }
        uint32_t *o = out + row * 8;
        for (int i = 0; i < 8; ++i) o[i] = v[i] ^ v[i + 8];
    }
}

/* ---- one-shot full BLAKE3 hash (chunking + parent tree) ----------------- */

static void compress_one(const uint32_t *cv, const uint32_t *block,
                         uint64_t counter, uint32_t block_len, uint32_t flags,
                         uint32_t *out) {
    b3_compress_batch(cv, block, counter, block_len, flags, 1, out);
}

#define B3_CHUNK_START (1u << 0)
#define B3_CHUNK_END (1u << 1)
#define B3_PARENT (1u << 2)
#define B3_ROOT (1u << 3)

/* hash one <=1024-byte chunk into an 8-word CV */
static void chunk_cv(const uint8_t *data, size_t len, uint64_t counter,
                     int root_if_single, uint32_t *out) {
    uint32_t cv[8];
    for (int i = 0; i < 8; ++i) cv[i] = IV[i];
    size_t nblocks = (len + 63) / 64;
    if (nblocks == 0) nblocks = 1;
    for (size_t b = 0; b < nblocks; ++b) {
        uint32_t block[16];
        uint8_t buf[64];
        size_t off = b * 64;
        size_t blen = len > off ? (len - off > 64 ? 64 : len - off) : 0;
        for (size_t i = 0; i < 64; ++i) buf[i] = i < blen ? data[off + i] : 0;
        for (int i = 0; i < 16; ++i)
            block[i] = (uint32_t)buf[4 * i] | ((uint32_t)buf[4 * i + 1] << 8) |
                       ((uint32_t)buf[4 * i + 2] << 16) |
                       ((uint32_t)buf[4 * i + 3] << 24);
        uint32_t flags = 0;
        if (b == 0) flags |= B3_CHUNK_START;
        if (b == nblocks - 1) {
            flags |= B3_CHUNK_END;
            if (root_if_single) flags |= B3_ROOT;
        }
        compress_one(cv, block, counter, (uint32_t)blen, flags, cv);
    }
    for (int i = 0; i < 8; ++i) out[i] = cv[i];
}

/* subtree CV per the spec: left child spans the largest power-of-two
   number of chunks strictly less than the total. */
static void subtree_cv(const uint8_t *data, uint64_t len, uint64_t counter,
                       uint32_t *out) {
    if (len <= 1024) {
        chunk_cv(data, (size_t)len, counter, 0, out);
        return;
    }
    uint64_t nchunks = (len + 1023) / 1024;
    uint64_t left_chunks = 1;
    while (left_chunks * 2 < nchunks) left_chunks *= 2;
    uint64_t left_len = left_chunks * 1024;
    uint32_t l[8], r[8], block[16], pc[8];
    subtree_cv(data, left_len, counter, l);
    subtree_cv(data + left_len, len - left_len, counter + left_chunks, r);
    for (int i = 0; i < 8; ++i) block[i] = l[i];
    for (int i = 0; i < 8; ++i) block[8 + i] = r[i];
    for (int i = 0; i < 8; ++i) pc[i] = IV[i];
    compress_one(pc, block, 0, 64, B3_PARENT, out);
}

/* Full BLAKE3-256 of data[0..len) -> out (8 u32 words). */
void b3_hash_bytes(const uint8_t *data, uint64_t len, uint32_t *out) {
    if (len <= 1024) {
        chunk_cv(data, (size_t)len, 0, 1, out);
        return;
    }
    uint64_t nchunks = (len + 1023) / 1024;
    uint64_t left_chunks = 1;
    while (left_chunks * 2 < nchunks) left_chunks *= 2;
    uint64_t left_len = left_chunks * 1024;
    uint32_t l[8], r[8], block[16], pc[8];
    subtree_cv(data, left_len, 0, l);
    subtree_cv(data + left_len, len - left_len, left_chunks, r);
    for (int i = 0; i < 8; ++i) block[i] = l[i];
    for (int i = 0; i < 8; ++i) block[8 + i] = r[i];
    for (int i = 0; i < 8; ++i) pc[i] = IV[i];
    compress_one(pc, block, 0, 64, B3_PARENT | B3_ROOT, out);
}

/* k equal-length messages, rows of n bytes -> k x 8 u32 digests */
void b3_hash_bytes_many(const uint8_t *data, uint64_t n, uint64_t k,
                        uint32_t *out) {
#pragma omp parallel for schedule(static) if (k >= 1024)
    for (uint64_t i = 0; i < k; ++i)
        b3_hash_bytes(data + i * n, n, out + i * 8);
}

/* rows with a stride (bytes) larger than the hashed length: lets callers
 * hash u32-word rows in place without materializing a packed copy */
void b3_hash_rows_strided(const uint8_t *data, uint64_t stride, uint64_t n,
                          uint64_t k, uint32_t *out) {
#pragma omp parallel for schedule(static) if (k >= 1024)
    for (uint64_t i = 0; i < k; ++i)
        b3_hash_bytes(data + i * stride, n, out + i * 8);
}

/* ---- batch Merkle-proof root (Octopus aggregated paths) ------------------ */
/* Native tier for crypto/merkle.py BatchMerkleProof.get_root — bit-for-bit
 * the same bookkeeping as the python (itself mirroring the reference's
 * proofs.rs:135-268), with merges done inline.  Digest = first D bytes of
 * BLAKE3-256 (D = 32 or 24).  Returns 0 and writes out_root on success;
 * nonzero on any structural invalidity (caller maps to "invalid proof").
 *
 * leaves:      n_leaves x D bytes, ordered like the original indexes
 * indexes:     n_idx original query leaf positions
 * node_data:   concatenated node digests across vectors (D bytes each)
 * node_counts: digests per vector (n_vec entries)
 */
#define B3_MAX_BATCH 4096

static void b3_merge_digests(const uint8_t *a, const uint8_t *b, int D,
                             uint8_t *out) {
    uint8_t buf[64];
    uint32_t o[8];
    for (int i = 0; i < D; ++i) buf[i] = a[i];
    for (int i = 0; i < D; ++i) buf[D + i] = b[i];
    b3_hash_bytes(buf, (uint64_t)(2 * D), o);
    for (int i = 0; i < D; ++i) out[i] = ((uint8_t *)o)[i];
}

int b3_batch_root(const uint8_t *leaves, int64_t n_leaves,
                  const uint64_t *indexes, int64_t n_idx,
                  const uint8_t *node_data, const int32_t *node_counts,
                  int64_t n_vec, int32_t depth, int32_t D,
                  uint8_t *out_root) {
    if (n_idx <= 0 || n_idx > B3_MAX_BATCH || n_vec > B3_MAX_BATCH ||
        depth <= 0 || depth >= 63 || (D != 32 && D != 24))
        return 1;
    uint64_t num_leaves = 1ull << depth;

    /* index_map: sorted (index, slot) pairs, rejecting dups/out-of-range */
    uint64_t map_idx[B3_MAX_BATCH];
    int32_t map_slot[B3_MAX_BATCH];
    int64_t map_n = 0;
    for (int64_t i = 0; i < n_idx; ++i) {
        uint64_t idx = indexes[i];
        if (idx >= num_leaves) return 2;
        int64_t lo = 0, hi = map_n;
        while (lo < hi) {
            int64_t mid = (lo + hi) / 2;
            if (map_idx[mid] < idx) lo = mid + 1; else hi = mid;
        }
        if (lo < map_n && map_idx[lo] == idx) return 3; /* duplicate */
        for (int64_t j = map_n; j > lo; --j) {
            map_idx[j] = map_idx[j - 1];
            map_slot[j] = map_slot[j - 1];
        }
        map_idx[lo] = idx;
        map_slot[lo] = (int32_t)i;
        map_n++;
    }
    if (map_n != n_leaves) return 4;

    /* norm: sorted unique (idx & ~1) — map_idx is sorted already */
    uint64_t norm[B3_MAX_BATCH];
    int64_t norm_n = 0;
    for (int64_t i = 0; i < map_n; ++i) {
        uint64_t e = map_idx[i] & ~1ull;
        if (norm_n == 0 || norm[norm_n - 1] != e) norm[norm_n++] = e;
    }
    if (norm_n != n_vec) return 5;

    /* node vector offsets (in digests) */
    int64_t node_off[B3_MAX_BATCH + 1];
    node_off[0] = 0;
    for (int64_t i = 0; i < n_vec; ++i) {
        if (node_counts[i] < 0) return 6;
        node_off[i + 1] = node_off[i] + node_counts[i];
    }

    int32_t proof_ptr[B3_MAX_BATCH];
    uint64_t cur_idx[B3_MAX_BATCH];
    uint8_t cur_dig[B3_MAX_BATCH * 32];
    uint64_t nxt_idx[B3_MAX_BATCH];
    uint8_t nxt_dig[B3_MAX_BATCH * 32];

    /* level 0: resolve leaf pairs */
    uint64_t offset = 1ull << depth;
    for (int64_t i = 0; i < norm_n; ++i) {
        uint64_t index = norm[i];
        const uint8_t *buf0, *buf1;
        /* lookup helpers */
        int64_t s0 = -1, s1 = -1;
        {
            int64_t lo = 0, hi = map_n;
            while (lo < hi) { int64_t mid = (lo + hi) / 2;
                if (map_idx[mid] < index) lo = mid + 1; else hi = mid; }
            if (lo < map_n && map_idx[lo] == index) s0 = map_slot[lo];
            if (lo < map_n && map_idx[lo] == index + 1) s1 = map_slot[lo];
            else if (lo + 1 < map_n && map_idx[lo + 1] == index + 1)
                s1 = map_slot[lo + 1];
        }
        if (s0 >= 0) {
            buf0 = leaves + (int64_t)s0 * D;
            if (s1 >= 0) {
                buf1 = leaves + (int64_t)s1 * D;
                proof_ptr[i] = 0;
            } else {
                if (node_counts[i] < 1) return 7;
                buf1 = node_data + node_off[i] * D;
                proof_ptr[i] = 1;
            }
        } else {
            if (node_counts[i] < 1) return 8;
            buf0 = node_data + node_off[i] * D;
            if (s1 < 0) return 9;
            buf1 = leaves + (int64_t)s1 * D;
            proof_ptr[i] = 1;
        }
        b3_merge_digests(buf0, buf1, D, cur_dig + i * 32);
        cur_idx[i] = (offset + index) >> 1;
    }
    int64_t cur_n = norm_n;

    /* upper levels */
    for (int32_t lvl = 1; lvl < depth; ++lvl) {
        int64_t out_n = 0;
        int64_t i = 0;
        while (i < cur_n) {
            uint64_t node_index = cur_idx[i];
            uint64_t sibling_index = node_index ^ 1ull;
            const uint8_t *sibling;
            const uint8_t *node = cur_dig + i * 32;
            if (i + 1 < cur_n && cur_idx[i + 1] == sibling_index) {
                sibling = cur_dig + (i + 1) * 32;
                /* order: python merges (node, sibling) with node even */
                b3_merge_digests(node, sibling, D, nxt_dig + out_n * 32);
                i += 2;
            } else {
                int32_t ptr = proof_ptr[i];
                if (i >= n_vec || ptr >= node_counts[i]) return 10;
                sibling = node_data + (node_off[i] + ptr) * D;
                proof_ptr[i] = ptr + 1;
                if (node_index & 1ull)
                    b3_merge_digests(sibling, node, D, nxt_dig + out_n * 32);
                else
                    b3_merge_digests(node, sibling, D, nxt_dig + out_n * 32);
                i += 1;
            }
            nxt_idx[out_n] = node_index >> 1;
            out_n++;
        }
        for (int64_t j = 0; j < out_n; ++j) {
            cur_idx[j] = nxt_idx[j];
            for (int k = 0; k < 32; ++k) cur_dig[j * 32 + k] = nxt_dig[j * 32 + k];
        }
        cur_n = out_n;
    }

    if (cur_n != 1 || cur_idx[0] != 1ull) return 11;
    for (int i = 0; i < D; ++i) out_root[i] = cur_dig[i];
    return 0;
}
