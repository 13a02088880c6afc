"""Keccak-f[1600] and SHA3-256 vectorized over rows, on 64-bit lanes.

Counterpart of starkpack_winterfell_tpu/ops/keccak.py, the words path of the
reference's Sha3_256 hasher (crypto/src/hash/sha/mod.rs).  There a 64-bit
lane is a (lo, hi) pair of u32 arrays; a GPU has 64-bit integers, so here a
lane is ONE ``torch.int64`` tensor holding its u64 bit pattern, and every
round is XOR, AND, NOT and rotations on whole lanes.  ``>>`` on int64 is
arithmetic, so a rotation masks the bits its right shift brings in
(the convention of ops/gl64.py).  The JAX package has no Pallas Keccak: this
is eager tensor code, not a kernel.

The words API keeps the BLAKE3 convention of the port: a row of message
words, and a digest, are u32 values in int64 tensors (little-endian words:
lane i is words 2i | 2i+1 << 32).  Numpy word arrays (the verifier's side)
are hashed row by row with hashlib.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .gl64 import _wrap

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y]
ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

RATE_BYTES = 136  # SHA3-256
RATE_LANES = RATE_BYTES // 8
_M32 = 0xFFFFFFFF


def _rotl(lane, r: int):
    """Rotate the u64 bit patterns of an int64 tensor left by r."""
    r %= 64
    if r == 0:
        return lane
    return (lane << r) | ((lane >> (64 - r)) & ((1 << r) - 1))


def _keccak_round(A, rc: int):
    """One keccak-f round on a 5x5 list of int64 lane tensors."""
    # theta
    C = [A[x][0] ^ A[x][1] ^ A[x][2] ^ A[x][3] ^ A[x][4] for x in range(5)]
    D = [C[(x - 1) % 5] ^ _rotl(C[(x + 1) % 5], 1) for x in range(5)]
    # rho + pi
    B = [[None] * 5 for _ in range(5)]
    for x in range(5):
        for y in range(5):
            B[y][(2 * x + 3 * y) % 5] = _rotl(A[x][y] ^ D[x], ROT[x][y])
    # chi
    out = [[B[x][y] ^ (~B[(x + 1) % 5][y] & B[(x + 2) % 5][y]) for y in range(5)]
           for x in range(5)]
    # iota
    out[0][0] = out[0][0] ^ _wrap(rc)
    return out


def keccak_f(lanes):
    """lanes: 5x5 list (indexed [x][y]) of int64 tensors of one shape;
    returns the permuted 5x5 list."""
    A = [[lanes[x][y] for y in range(5)] for x in range(5)]
    for rc in RC:
        A = _keccak_round(A, rc)
    return A


def _sha3_rows_host(words: np.ndarray, byte_len: int) -> np.ndarray:
    """hashlib SHA3-256 of each row's first byte_len bytes (LE u32 words)."""
    flat = np.ascontiguousarray(words.reshape(-1, words.shape[-1]).astype("<u4"))
    n_words = byte_len // 4
    out = np.empty((flat.shape[0], 8), dtype=np.uint32)
    for i in range(flat.shape[0]):
        out[i] = np.frombuffer(hashlib.sha3_256(flat[i, :n_words].tobytes()).digest(),
                               dtype="<u4")
    return out.reshape(words.shape[:-1] + (8,))


def sha3_256_words(words, byte_len: int):
    """SHA3-256 of rows of little-endian u32 words (byte_len a multiple of 8,
    as field-element rows always are).  Returns (..., 8) digest words."""
    if isinstance(words, np.ndarray):
        return _sha3_rows_host(words, byte_len)
    assert byte_len % 8 == 0
    n_msg = byte_len // 8
    msg = [words[..., 2 * i] | (words[..., 2 * i + 1] << 32) for i in range(n_msg)]
    # keccak padding: 0x06 after the message, 0x80 in the last byte of the
    # last rate block
    n_blocks = n_msg // RATE_LANES + 1
    total = n_blocks * RATE_LANES
    pad = [0] * (total - n_msg)
    pad[0] ^= 0x06
    pad[-1] ^= _wrap(0x80 << 56)
    zero = torch.zeros(words.shape[:-1], dtype=torch.int64, device=words.device)
    lanes = [[zero] * 5 for _ in range(5)]
    for b in range(n_blocks):
        for i in range(RATE_LANES):
            j = b * RATE_LANES + i
            x, y = i % 5, i // 5
            lanes[x][y] = lanes[x][y] ^ (msg[j] if j < n_msg else pad[j - n_msg])
        lanes = keccak_f(lanes)
    out = []
    for i in range(4):  # 4 lanes = 32 bytes
        lane = lanes[i % 5][i // 5]
        out += [lane & _M32, (lane >> 32) & _M32]
    return torch.stack(out, dim=-1)


def sha3_merge_words(l, r):
    """SHA3-256 of two concatenated 32-byte digests (8 lanes)."""
    if isinstance(l, np.ndarray):
        return sha3_256_words(np.concatenate([l, r], axis=-1), 64)
    return sha3_256_words(torch.cat([l, r], dim=-1), 64)
