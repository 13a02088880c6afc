# Copy of starkpack_winterfell_tpu/crypto/rescue62.py; cut: the vectorized limb permutation and its digest packing on limb pairs (the words API runs on ops/rescue_sponge.py), the python-int fallbacks of the native sponge.
"""Rp62_248 — Rescue-Prime over the f62 field
(crypto/src/hash/rescue/rp62_248/mod.rs): state 12, **rate = state[0..8]**,
digest = state[0..4], element-count tag in state[11] (the legacy layout —
unlike Rp64_256's capacity-first layout), 7 rounds with S-box x^3 / x^{1/3}
(ALPHA=3, INV_ALPHA=3074416663688030891).  Digests serialize as 31 bytes of
bit-packed 62-bit values (digest.rs:34-60).

The host byte API runs on the C sponge of native/rescue_perm.c; the words
API on tensors (the limb path's Merkle leaves and levels) on the kernel of
ops/rescue_sponge.py, numpy words (the verifier's query rows) on the C
sponge.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import rescue_sponge as rsp
from ..ops.limb_field import F62
from ._native_perm import make_native_permute, make_native_sponge, u64_to_words
from .rescue62_constants import ARK1_62, ARK2_62, MDS62

P62 = F62.P
STATE_WIDTH = 12
RATE = 8
DIGEST_SIZE = 4
NUM_ROUNDS = 7
ALPHA = 3
INV_ALPHA = 3074416663688030891
MASK62 = (1 << 62) - 1
MASK64 = (1 << 64) - 1

_NATIVE: dict = {}


def _native():
    """{"permute": one permutation of python ints, "sponge": the
    ``NativeSponge``} on the C sponge, in the rate-first layout: absorb at
    state[0..8), count tag in state[11], digest = state[0..4)."""
    if not _NATIVE:
        args = ("rp62_248", P62, STATE_WIDTH, NUM_ROUNDS, ALPHA, INV_ALPHA, MDS62,
                ARK1_62, ARK2_62)
        _NATIVE["permute"] = make_native_permute(*args, inv_chain=rsp.RP62_248.inv_chain)
        _NATIVE["sponge"] = make_native_sponge(*args, 0, RATE, STATE_WIDTH - 1, 0,
                                               DIGEST_SIZE, inv_chain=rsp.RP62_248.inv_chain)
    return _NATIVE


def apply_permutation_ints(state):
    """The permutation of a list of 12 python ints, on the C sponge."""
    return _native()["permute"](state)


def digest_to_bytes31(elements) -> bytes:
    """Bit-pack 4 x 62-bit canonical values into the 31-byte serialized form
    (digest.rs:34-47: 32-byte as_bytes whose final byte is always zero,
    written as 31 bytes)."""
    v1, v2, v3, v4 = elements
    out = b""
    out += ((v1 | (v2 << 62)) & MASK64).to_bytes(8, "little")
    out += (((v2 >> 2) | (v3 << 60)) & MASK64).to_bytes(8, "little")
    out += (((v3 >> 4) | (v4 << 58)) & MASK64).to_bytes(8, "little")
    out += (v4 >> 6).to_bytes(8, "little")
    return out[:31]


def digest_from_bytes31(b: bytes):
    """Inverse of the packing (digest.rs:63-79)."""
    assert len(b) == 31
    w = int.from_bytes(b, "little")
    return [(w >> (62 * i)) & MASK62 for i in range(DIGEST_SIZE)]


def _pack_digests_words(dig):
    """(n, 4) u64 digest elements -> (n, 8) u32 packed 31-byte digest words
    (vectorized digest_to_bytes31 + zero pad byte)."""
    v1, v2, v3, v4 = (dig[:, i] for i in range(4))
    s = np.uint64
    w0 = v1 | (v2 << s(62))
    w1 = (v2 >> s(2)) | (v3 << s(60))
    w2 = (v3 >> s(4)) | (v4 << s(58))
    w3 = v4 >> s(6)  # < 2^56: byte 31 of the packed form is always zero
    return u64_to_words(np.stack([w0, w1, w2, w3], axis=-1))


def _unpack_digests_words(words):
    """(n, 8) u32 packed digest words -> (n, 4) u64 digest elements
    (vectorized digest_from_bytes31: masked to 62 bits, not reduced)."""
    u = words.astype(np.uint64)
    w = u[:, 0::2] | (u[:, 1::2] << np.uint64(32))  # (n, 4) packed u64
    s = np.uint64
    M = s(MASK62)
    v1 = w[:, 0] & M
    v2 = ((w[:, 0] >> s(62)) | (w[:, 1] << s(2))) & M
    v3 = ((w[:, 1] >> s(60)) | (w[:, 2] << s(4))) & M
    v4 = ((w[:, 2] >> s(58)) | (w[:, 3] << s(6))) & M
    return np.stack([v1, v2, v3, v4], axis=-1)


class Rp62_248:
    NAME = "rp62_248"
    DIGEST_BYTES = 31
    COLLISION_RESISTANCE = 124
    LAYOUT = rsp.RP62_248

    # -- host byte api ------------------------------------------------------

    @staticmethod
    def hash(data: bytes) -> bytes:
        """7-byte chunks -> elements, last chunk padded with a 1 byte,
        element count in state[11] (mod.rs:97-153)."""
        num_elements = len(data) // 7 + (1 if len(data) % 7 else 0)
        state = [0] * STATE_WIDTH
        state[STATE_WIDTH - 1] = num_elements % P62
        i = 0
        chunks = [data[k: k + 7] for k in range(0, len(data), 7)] or [b""]
        for idx, chunk in enumerate(chunks):
            if idx < num_elements - 1:
                buf = chunk + b"\x00"
            else:
                buf = chunk + b"\x01" + b"\x00" * (7 - len(chunk))
            state[i] = (state[i] + int.from_bytes(buf, "little")) % P62
            i += 1
            if i % RATE == 0:
                state = apply_permutation_ints(state)
                i = 0
        if i > 0:
            state = apply_permutation_ints(state)
        return digest_to_bytes31(state[:DIGEST_SIZE])

    @classmethod
    def merge(cls, a: bytes, b: bytes) -> bytes:
        """Digest elements fill the whole rate, tag = 8 (mod.rs:155-166)."""
        state = digest_from_bytes31(a[:31]) + digest_from_bytes31(b[:31])
        state += [0] * (STATE_WIDTH - RATE)
        state[STATE_WIDTH - 1] = RATE
        state = apply_permutation_ints(state)
        return digest_to_bytes31(state[:DIGEST_SIZE])

    @classmethod
    def merge_with_int(cls, seed: bytes, value: int) -> bytes:
        """mod.rs:168-190 — value (and its overflow) after the seed."""
        value &= MASK64
        state = digest_from_bytes31(seed[:31]) + [0] * (STATE_WIDTH - DIGEST_SIZE)
        state[DIGEST_SIZE] = value % P62
        if value < P62:
            state[STATE_WIDTH - 1] = DIGEST_SIZE + 1
        else:
            state[DIGEST_SIZE + 1] = value // P62
            state[STATE_WIDTH - 1] = DIGEST_SIZE + 2
        state = apply_permutation_ints(state)
        return digest_to_bytes31(state[:DIGEST_SIZE])

    @staticmethod
    def seed_elements(seed: bytes):
        """The four digest values of a 31-byte seed (masked to 62 bits, not
        reduced), as ``merge_with_int`` places them."""
        return digest_from_bytes31(seed[:31])

    @classmethod
    def first_merge_with_int(cls, seed: bytes, start: int, count: int, bits: int,
                             device="cpu"):
        """The lowest nonce in [start, start + count) whose
        ``merge_with_int(seed, nonce)`` has ``bits`` trailing zero bits in
        its first 8 bytes read little-endian (the packed word v1 | v2 << 62),
        or None: one C sponge batch, or on a CUDA ``device`` one launch of
        the sponge kernel's search (ops/rescue_sponge.py)."""
        if torch.device(device).type == "cuda":
            return rsp.first_merge_with_int(cls.LAYOUT, cls.seed_elements(seed), start, count,
                                            bits, device)[0]
        return _native()["sponge"].first_merge_with_int(
            cls.seed_elements(seed), start, count, bits,
            head=lambda d: d[:, 0] | (d[:, 1] << np.uint64(62)))

    @classmethod
    def hash_elements_many(cls, element_lists, elem_bytes: int = 8):
        return [cls.hash_elements(e, elem_bytes) for e in element_lists]

    @classmethod
    def merge_many(cls, pairs):
        """Batched 2-to-1 merges in one native call (Merkle verification)."""
        if not pairs:
            return []
        l = np.frombuffer(b"".join(a[:31] + b"\x00" for a, _ in pairs), dtype="<u4")
        r = np.frombuffer(b"".join(b[:31] + b"\x00" for _, b in pairs), dtype="<u4")
        out = _pack_digests_words(_native()["sponge"].merge_rows(
            _unpack_digests_words(l.reshape(-1, 8)), _unpack_digests_words(r.reshape(-1, 8))))
        ob = out.tobytes()
        return [ob[i * 32: i * 32 + 31] for i in range(len(pairs))]

    @classmethod
    def hash_elements(cls, elements, elem_bytes: int = 8) -> bytes:
        """mod.rs:195-230 — rate-first absorption, count tag in state[11]."""
        assert elem_bytes == 8, "Rp62_248 is native to f62 (8-byte elements)"
        flat = []
        for e in elements:
            if isinstance(e, tuple):
                flat.extend(e)
            else:
                flat.append(e)
        state = [0] * STATE_WIDTH
        state[STATE_WIDTH - 1] = len(flat) % P62
        i = 0
        for e in flat:
            state[i] = (state[i] + e) % P62
            i += 1
            if i % RATE == 0:
                state = apply_permutation_ints(state)
                i = 0
        if i > 0:
            state = apply_permutation_ints(state)
        return digest_to_bytes31(state[:DIGEST_SIZE])

    # -- words api ------------------------------------------------------------

    @classmethod
    def hash_words(cls, words, byte_len: int):
        """words: (..., W*2) u32 words of W f62 elements -> packed 31-byte
        digests as (..., 8) u32 words (mod.rs:195-230 semantics): tensors
        through ops/rescue_sponge.py, numpy through the C sponge."""
        n_elems = byte_len // 8
        assert words.shape[-1] == 2 * n_elems
        shape = tuple(words.shape[:-1])
        if isinstance(words, np.ndarray):
            u64 = words.reshape(math.prod(shape), words.shape[-1]).astype(np.uint64)
            vals = u64[:, 0::2] | (u64[:, 1::2] << np.uint64(32))
            return _pack_digests_words(_native()["sponge"].hash_rows(vals)).reshape(shape + (8,))
        out = rsp.rescue_sponge(cls.LAYOUT, words.reshape(math.prod(shape), words.shape[-1]), n_elems)
        return out.reshape(shape + (8,))

    @classmethod
    def merge_words(cls, l, r):
        shape = tuple(l.shape)
        if isinstance(l, np.ndarray):
            out = _pack_digests_words(_native()["sponge"].merge_rows(
                _unpack_digests_words(l.reshape(-1, 8)), _unpack_digests_words(r.reshape(-1, 8))))
            return out.reshape(shape)
        return rsp.rescue_sponge(cls.LAYOUT, l.reshape(-1, 8), y=r.reshape(-1, 8)).reshape(shape)

    @staticmethod
    def digest_to_bytes(d) -> bytes:
        if not isinstance(d, np.ndarray):
            d = d.detach().cpu().numpy()
        return np.asarray(d).astype("<u4").tobytes()[:31]

    @staticmethod
    def digest_from_bytes(b: bytes):
        assert len(b) == 31
        return np.frombuffer(b + b"\x00", dtype="<u4").astype(np.uint32)
