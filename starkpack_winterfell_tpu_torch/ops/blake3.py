"""BLAKE3 implemented from the public spec, vectorized over rows of words.

Counterpart of starkpack_winterfell_tpu/ops/blake3.py.  One compression
function serves two array types:

* ``torch.int64`` tensors holding u32 values (CPU or CUDA) — Merkle leaf and
  node hashing and the proof-of-work batch on the device.  torch has no
  usable ``uint32`` arithmetic on the CPU, so words are kept in int64 and
  masked to 32 bits after every add and rotate.
* ``numpy.uint32`` arrays — the plain version (``hash_bytes_plain``,
  ``hash_bytes_many_plain``, ``hash_words_plain``) of the host C tier
  (native/blake3_compress.c), where the wrapping arithmetic is native and
  the masks are no-ops.

The host byte API of the Fiat-Shamir transcript and the verifier
(``hash_bytes``, ``hash_bytes_many``) and ``hash_words`` of numpy rows go
through the C library, one call a batch; only the tests call the plain
versions.  All digests are 8 u32 words (= 32 bytes, little-endian words).
"""

from __future__ import annotations

import numpy as np
import torch

from ..native import get_blake3

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)

CHUNK_START = 1
CHUNK_END = 2
PARENT = 4
ROOT = 8

CHUNK_LEN = 1024
BLOCK_LEN = 64

_M = 0xFFFFFFFF


def _rotr(x, r):
    return ((x >> r) | (x << (32 - r))) & _M


def _g(state, a, b, c, d, mx, my):
    state[a] = (state[a] + state[b] + mx) & _M
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _M
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & _M
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _M
    state[b] = _rotr(state[b] ^ state[c], 7)


def _round(state, m):
    _g(state, 0, 4, 8, 12, m[0], m[1])
    _g(state, 1, 5, 9, 13, m[2], m[3])
    _g(state, 2, 6, 10, 14, m[4], m[5])
    _g(state, 3, 7, 11, 15, m[6], m[7])
    _g(state, 0, 5, 10, 15, m[8], m[9])
    _g(state, 1, 6, 11, 12, m[10], m[11])
    _g(state, 2, 7, 8, 13, m[12], m[13])
    _g(state, 3, 4, 9, 14, m[14], m[15])


def _zeros_like_batch(x):
    """Zero word array with x's batch shape (x minus its last axis)."""
    if isinstance(x, np.ndarray):
        return np.zeros(x.shape[:-1], dtype=np.uint32)
    return torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)


def _stack(xs):
    if isinstance(xs[0], np.ndarray):
        return np.stack(xs, axis=-1)
    return torch.stack(xs, dim=-1)


def compress(cv, block_words, counter: int, block_len: int, flags: int):
    """One BLAKE3 compression.  ``cv`` is a list of 8 word arrays,
    ``block_words`` of 16; all arrays share a batch shape.  Returns the
    8-word output CV (truncated output)."""
    z = cv[0] * 0
    state = list(cv) + [
        z + IV[0], z + IV[1], z + IV[2], z + IV[3],
        z + (counter & _M), z + ((counter >> 32) & _M),
        z + block_len, z + flags,
    ]
    m = list(block_words)
    for rnd in range(7):
        _round(state, m)
        if rnd < 6:
            m = [m[MSG_PERMUTATION[i]] for i in range(16)]
    return [state[i] ^ state[i + 8] for i in range(8)]


# ---------------------------------------------------------------------------
# vectorized row hashing
# ---------------------------------------------------------------------------


def hash_words(words, byte_len: int):
    """Hash rows given as a (..., W) word array holding ``byte_len`` bytes of
    little-endian words (W >= ceil(byte_len/4), zero-padded).  Returns
    (..., 8) digests.  Tensors (the prover's leaves, on the device) go
    through the vectorized compression; numpy rows (the verifier's parsed
    queries) through one C call that hashes each row in place."""
    if not isinstance(words, np.ndarray):
        return hash_words_plain(words, byte_len)
    if words.shape[-1] * 4 < byte_len:
        raise ValueError(f"rows of {words.shape[-1]} words hold no {byte_len} bytes")
    raw = np.ascontiguousarray(words, dtype="<u4")
    k = int(np.prod(raw.shape[:-1]))
    out = np.empty((k, 8), dtype=np.uint32)
    get_blake3().b3_hash_rows_strided(raw.ctypes.data, raw.shape[-1] * 4, byte_len, k,
                                      out.ctypes.data)
    return out.reshape(raw.shape[:-1] + (8,))


def hash_words_plain(words, byte_len: int):
    """The vectorized compression over rows of ``hash_words``' layout, for
    tensors and numpy arrays alike: the torch path of ``hash_words`` and the
    plain version of its C path.  Handles multi-chunk inputs (byte_len >
    1024) with the static BLAKE3 chunk tree."""
    assert words.shape[-1] >= (byte_len + 3) // 4
    n_chunks = max(1, (byte_len + CHUNK_LEN - 1) // CHUNK_LEN)
    if n_chunks == 1:
        return _stack(_chunk_cv(words, 0, byte_len, 0, root=True))
    cvs = []
    for ci in range(n_chunks):
        start = ci * CHUNK_LEN
        clen = min(CHUNK_LEN, byte_len - start)
        cvs.append(_chunk_cv(words, start, clen, ci, root=False))
    return _stack(_parent_tree(cvs))


def _chunk_cv(words, start_byte: int, chunk_len: int, counter: int, root: bool):
    n_blocks = max(1, (chunk_len + BLOCK_LEN - 1) // BLOCK_LEN)
    z = _zeros_like_batch(words)
    cv = [z + v for v in IV]
    w0 = start_byte // 4
    total_words = words.shape[-1]
    for b in range(n_blocks):
        blk_start = w0 + b * 16
        blen = min(BLOCK_LEN, chunk_len - b * BLOCK_LEN)
        # caller contract: words beyond byte_len are zero, so any available
        # word may be used verbatim and missing words are zero
        blk = [
            words[..., blk_start + i] if blk_start + i < total_words else z
            for i in range(16)
        ]
        flags = 0
        if b == 0:
            flags |= CHUNK_START
        if b == n_blocks - 1:
            flags |= CHUNK_END
            if root:
                flags |= ROOT
        cv = compress(cv, blk, counter, blen, flags)
    return cv


def _parent_tree(cvs):
    """Fold chunk CVs with the spec's left-largest-power-of-two tree."""

    def build(nodes, root):
        if len(nodes) == 1:
            return nodes[0]
        left_n = 1 << (len(nodes) - 1).bit_length() - 1
        if left_n == len(nodes):
            left_n //= 2
        left = build(nodes[:left_n], False)
        right = build(nodes[left_n:], False)
        z = left[0] * 0
        cv = [z + v for v in IV]
        return compress(cv, list(left) + list(right), 0, BLOCK_LEN,
                        PARENT | (ROOT if root else 0))

    return build(cvs, True)


def merge(l, r):
    """Merkle 2-to-1 merge = blake3 of the 64 concatenated digest bytes (a
    plain hash, NOT a parent node).  l, r: (..., 8) word arrays."""
    z = _zeros_like_batch(l)
    cv = [z + v for v in IV]
    blk = [l[..., i] for i in range(8)] + [r[..., i] for i in range(8)]
    return _stack(compress(cv, blk, 0, BLOCK_LEN, CHUNK_START | CHUNK_END | ROOT))


def merge_with_int(seed, value):
    """hash(seed_32_bytes || value_u64_le) — 40-byte single block.  ``value``
    is a python int, or a word-pair ``(lo, hi)`` of arrays with seed's batch
    shape (the batched proof-of-work search)."""
    z = _zeros_like_batch(seed)
    cv = [z + v for v in IV]
    blk = [seed[..., i] for i in range(8)]
    if isinstance(value, tuple):
        blk += [value[0], value[1]]
    else:
        blk += [z + (value & _M), z + ((value >> 32) & _M)]
    blk += [z] * 6
    return _stack(compress(cv, blk, 0, 40, CHUNK_START | CHUNK_END | ROOT))


# ---------------------------------------------------------------------------
# host byte-oriented API
# ---------------------------------------------------------------------------


def hash_bytes(data: bytes, out_len: int = 32) -> bytes:
    """Full BLAKE3 of arbitrary-length input (host C, one call)."""
    out = np.empty(8, dtype=np.uint32)
    get_blake3().b3_hash_bytes(data, len(data), out.ctypes.data)
    return out.tobytes()[:out_len]


def hash_bytes_many(datas, out_len: int = 32):
    """BLAKE3 of many EQUAL-LENGTH byte strings in one C call."""
    k = len(datas)
    n = len(datas[0])
    buf = b"".join(datas)
    if len(buf) != n * k:
        raise ValueError("hash_bytes_many takes byte strings of one length")
    out = np.empty((k, 8), dtype=np.uint32)
    get_blake3().b3_hash_bytes_many(buf, n, k, out.ctypes.data)
    raw = out.tobytes()
    return [raw[i * 32 : i * 32 + out_len] for i in range(k)]


def hash_bytes_many_plain(datas, out_len: int = 32):
    """The plain version of ``hash_bytes_many``: numpy words through the
    vectorized compression."""
    k = len(datas)
    n = len(datas[0])
    pad = (-n) % 4
    need = max(16, ((n + 3) // 4 + 15) // 16 * 16)
    tail = b"\x00" * (pad + 4 * (need - (n + pad) // 4))
    buf = b"".join(d + tail for d in datas)
    words = np.frombuffer(buf, dtype="<u4").astype(np.uint32).reshape(k, need)
    digests = hash_words_plain(words, n)  # (k, 8)
    raw = digests.astype("<u4").tobytes()
    return [raw[i * 32 : i * 32 + out_len] for i in range(k)]


def hash_bytes_plain(data: bytes, out_len: int = 32) -> bytes:
    """The plain version of ``hash_bytes``."""
    return hash_bytes_many_plain([data], out_len)[0]


def digest_to_bytes(d) -> bytes:
    if isinstance(d, torch.Tensor):
        d = d.detach().cpu().numpy()
    return np.asarray(d).astype("<u4").tobytes()


def digest_from_bytes(b: bytes) -> np.ndarray:
    assert len(b) == 32
    return np.frombuffer(b, dtype="<u4").astype(np.uint32)
