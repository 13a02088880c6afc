"""BLAKE3 in plain Python (the BLAKE3 specification, sections 2.1-2.6):
the hash of a byte string with a 32-byte output, or its first 24 bytes,
which is the 192-bit digest of the STARK hashers."""

from __future__ import annotations

import struct

IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
MSG_PERMUTATION = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START, CHUNK_END, PARENT, ROOT = 1, 2, 4, 8
BLOCK_LEN, CHUNK_LEN = 64, 1024
M32 = 0xFFFFFFFF


def _schedules():
    """The message word order of each of the seven rounds."""
    order = list(range(16))
    out = []
    for _ in range(7):
        out.append(tuple(order))
        order = [order[i] for i in MSG_PERMUTATION]
    return out


SCHEDULES = _schedules()


def compress(cv, block_words, counter: int, block_len: int, flags: int):
    """The compression function: returns the 16 output words."""
    v = list(cv) + list(IV[:4]) + [counter & M32, (counter >> 32) & M32, block_len, flags]
    for s in SCHEDULES:
        m = [block_words[i] for i in s]
        for (a, b, c, d), (x, y) in (((0, 4, 8, 12), (0, 1)), ((1, 5, 9, 13), (2, 3)),
                                     ((2, 6, 10, 14), (4, 5)), ((3, 7, 11, 15), (6, 7)),
                                     ((0, 5, 10, 15), (8, 9)), ((1, 6, 11, 12), (10, 11)),
                                     ((2, 7, 8, 13), (12, 13)), ((3, 4, 9, 14), (14, 15))):
            va, vb, vc, vd = v[a], v[b], v[c], v[d]
            va = (va + vb + m[x]) & M32
            vd ^= va
            vd = ((vd >> 16) | (vd << 16)) & M32
            vc = (vc + vd) & M32
            vb ^= vc
            vb = ((vb >> 12) | (vb << 20)) & M32
            va = (va + vb + m[y]) & M32
            vd ^= va
            vd = ((vd >> 8) | (vd << 24)) & M32
            vc = (vc + vd) & M32
            vb ^= vc
            vb = ((vb >> 7) | (vb << 25)) & M32
            v[a], v[b], v[c], v[d] = va, vb, vc, vd
    return [v[i] ^ v[i + 8] for i in range(8)] + [v[i + 8] ^ cv[i] for i in range(8)]


def _words(block: bytes):
    return struct.unpack("<16I", block.ljust(BLOCK_LEN, b"\0"))


def _chunk_output(chunk: bytes, counter: int):
    """(chaining value before the last block, last block's words, its length,
    its flags) of one chunk: the last compression is left to the caller, as
    it may be the root."""
    cv = IV
    blocks = [chunk[i:i + BLOCK_LEN] for i in range(0, max(len(chunk), 1), BLOCK_LEN)]
    for i, block in enumerate(blocks[:-1]):
        cv = compress(cv, _words(block), counter, BLOCK_LEN, CHUNK_START if i == 0 else 0)[:8]
    last = blocks[-1]
    flags = CHUNK_END | (CHUNK_START if len(blocks) == 1 else 0)
    return cv, _words(last), counter, len(last), flags


def hash_bytes(data: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 of ``data``: the first ``out_len`` (at most 32) bytes of the
    root output."""
    chunks = [data[i:i + CHUNK_LEN] for i in range(0, max(len(data), 1), CHUNK_LEN)]
    if len(chunks) == 1:
        cv, words, counter, block_len, flags = _chunk_output(chunks[0], 0)
        out = compress(cv, words, counter, block_len, flags | ROOT)
    else:
        stack = []
        for index, chunk in enumerate(chunks):
            cv, words, counter, block_len, flags = _chunk_output(chunk, index)
            node = compress(cv, words, counter, block_len, flags)[:8]
            if index == len(chunks) - 1:
                break
            # merge completed subtrees: one merge per trailing zero of the
            # count of chunks done so far
            total = index + 1
            while total & 1 == 0:
                node = compress(IV, stack.pop() + node, 0, BLOCK_LEN, PARENT)[:8]
                total >>= 1
            stack.append(node)
        while len(stack) > 1:
            node = compress(IV, stack.pop() + node, 0, BLOCK_LEN, PARENT)[:8]
        out = compress(IV, stack.pop() + node, 0, BLOCK_LEN, PARENT | ROOT)
    return struct.pack("<8I", *out[:8])[:out_len]
