# Copy of starkpack_winterfell_tpu/crypto/hashers.py; cut: nothing; every hasher of the JAX package is registered.
"""Hash function registry — equivalent of crypto/src/hash/mod.rs.

Each hasher exposes a host byte API (for the Fiat-Shamir channel and proof
(de)serialization) and a vectorized words API (for device-side row/Merkle
hashing).  Digests on the host are ``bytes``; on device they are (..., 8)
uint32 arrays (32-byte digests) — ``Blake3_192`` truncates only at the byte
boundary, mirroring ByteDigest<24> (crypto/src/hash/blake/mod.rs:70-116).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..ops import blake3 as b3
from ..ops import keccak
from ..utils.serde import ByteWriter
from .griffin import GriffinJive64_256
from .rescue import Rp64_256
from .rescue62 import Rp62_248
from .rescue_jive import RpJive64_256


class Blake3_256:
    """crypto/src/hash/blake/mod.rs:18-60."""

    NAME = "blake3_256"
    DIGEST_BYTES = 32
    COLLISION_RESISTANCE = 128

    # -- host byte api ------------------------------------------------------

    @staticmethod
    def hash(data: bytes) -> bytes:
        return b3.hash_bytes(data)

    @staticmethod
    def merge(a: bytes, b: bytes) -> bytes:
        return b3.hash_bytes(a + b)

    @staticmethod
    def merge_with_int(seed: bytes, value: int) -> bytes:
        return b3.hash_bytes(seed + (value & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"))

    @classmethod
    def hash_elements(cls, elements, elem_bytes: int = 8) -> bytes:
        """elements: iterable of ints (base) or tuples (ext components).
        Canonical little-endian bytes, matching hash_elements for
        non-canonical fields (blake/mod.rs:46-59).  ``elem_bytes`` selects
        the component width (8 for f64/f62, 16 for f128)."""
        w = ByteWriter()
        w.write_felts(elements, elem_bytes)
        return cls.hash(w.to_bytes())

    # -- batched host api (one vectorized call instead of k scalar calls) ----

    @staticmethod
    def merge_many(pairs):
        return b3.hash_bytes_many([a + b for a, b in pairs])

    @staticmethod
    def merge_with_int_many(seed: bytes, values):
        return b3.hash_bytes_many(
            [seed + (v & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little") for v in values]
        )

    @classmethod
    def hash_elements_many(cls, element_lists, elem_bytes: int = 8):
        """One batched call for k independent hash_elements inputs (the
        verifier's per-instance OOD-frame reseeds)."""
        bufs = []
        for elements in element_lists:
            w = ByteWriter()
            w.write_felts(elements, elem_bytes)
            bufs.append(w.to_bytes())
        return b3.hash_bytes_many(bufs, out_len=cls.DIGEST_BYTES)

    # -- device words api ---------------------------------------------------

    @staticmethod
    def hash_words(words, byte_len: int):
        return b3.hash_words(words, byte_len)

    @staticmethod
    def merge_words(l, r):
        return b3.merge(l, r)

    @staticmethod
    def digest_to_bytes(d) -> bytes:
        return b3.digest_to_bytes(d)

    @staticmethod
    def digest_from_bytes(b: bytes):
        return b3.digest_from_bytes(b)


class Blake3_192(Blake3_256):
    """24-byte truncated BLAKE3 (blake/mod.rs:66-116).

    Device digests remain 8 words; truncation to 24 bytes happens at every
    byte boundary (merge inputs, serialization), exactly like ByteDigest<24>.
    """

    NAME = "blake3_192"
    DIGEST_BYTES = 24

    @staticmethod
    def hash(data: bytes) -> bytes:
        return b3.hash_bytes(data, out_len=24)

    @staticmethod
    def merge(a: bytes, b: bytes) -> bytes:
        return b3.hash_bytes(a + b, out_len=24)

    @staticmethod
    def merge_with_int(seed: bytes, value: int) -> bytes:
        return b3.hash_bytes(
            seed + (value & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"), out_len=24)

    @staticmethod
    def merge_many(pairs):
        return b3.hash_bytes_many([a + b for a, b in pairs], out_len=24)

    @staticmethod
    def merge_with_int_many(seed: bytes, values):
        return b3.hash_bytes_many(
            [seed + (v & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little") for v in values],
            out_len=24,
        )

    @staticmethod
    def hash_words(words, byte_len: int):
        return _truncate_words(b3.hash_words(words, byte_len), 24)

    @staticmethod
    def merge_words(l, r):
        # merge() hashes the 2 x 24 truncated bytes of the two digests
        full = _cat([l[..., :6], r[..., :6], _zeros_like(l, 4)])
        return _truncate_words(b3.hash_words(full, 48), 24)

    @staticmethod
    def digest_to_bytes(d) -> bytes:
        return b3.digest_to_bytes(d)[:24]

    @staticmethod
    def digest_from_bytes(b: bytes):
        assert len(b) == 24
        return np.frombuffer(b + b"\x00" * 8, dtype="<u4").astype(np.uint32)


def _truncate_words(d, nbytes: int):
    """Zero out words beyond nbytes so device digests carry exactly the
    truncated bytes (word-aligned: 24 bytes = 6 words)."""
    assert nbytes % 4 == 0
    nw = nbytes // 4
    return _cat([d[..., :nw], _zeros_like(d, 8 - nw)])


def _cat(parts):
    """Join word arrays (tensors on the prover's side, numpy on the
    verifier's) along the last axis."""
    if isinstance(parts[0], np.ndarray):
        return np.concatenate(parts, axis=-1)
    return torch.cat(parts, dim=-1)


def _zeros_like(d, words: int):
    shape = d.shape[:-1] + (words,)
    if isinstance(d, np.ndarray):
        return np.zeros(shape, dtype=d.dtype)
    return torch.zeros(shape, dtype=d.dtype, device=d.device)


class Sha3_256:
    """crypto/src/hash/sha/mod.rs: the host byte API through hashlib, the
    words API through the vectorized Keccak of ops/keccak.py."""

    NAME = "sha3_256"
    DIGEST_BYTES = 32
    COLLISION_RESISTANCE = 128

    @staticmethod
    def hash(data: bytes) -> bytes:
        return hashlib.sha3_256(data).digest()

    @staticmethod
    def merge(a: bytes, b: bytes) -> bytes:
        return hashlib.sha3_256(a + b).digest()

    @staticmethod
    def merge_with_int(seed: bytes, value: int) -> bytes:
        return hashlib.sha3_256(
            seed + (value & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little")).digest()

    @staticmethod
    def merge_many(pairs):
        return [hashlib.sha3_256(a + b).digest() for a, b in pairs]

    @staticmethod
    def merge_with_int_many(seed: bytes, values):
        return [Sha3_256.merge_with_int(seed, v) for v in values]

    @classmethod
    def hash_elements(cls, elements, elem_bytes: int = 8) -> bytes:
        w = ByteWriter()
        w.write_felts(elements, elem_bytes)
        return cls.hash(w.to_bytes())

    @classmethod
    def hash_elements_many(cls, element_lists, elem_bytes: int = 8):
        return [cls.hash_elements(e, elem_bytes) for e in element_lists]

    @staticmethod
    def hash_words(words, byte_len: int):
        return keccak.sha3_256_words(words, byte_len)

    @staticmethod
    def merge_words(l, r):
        return keccak.sha3_merge_words(l, r)

    @staticmethod
    def digest_to_bytes(d) -> bytes:
        return b3.digest_to_bytes(d)

    @staticmethod
    def digest_from_bytes(b: bytes):
        return b3.digest_from_bytes(b)


HASHERS = {h.NAME: h for h in (Blake3_256, Blake3_192, Sha3_256, Rp64_256, Rp62_248,
                                RpJive64_256, GriffinJive64_256)}


def get_hasher(name: str):
    if name not in HASHERS:
        raise NotImplementedError(
            f"hasher {name!r} is not ported yet (ported: {', '.join(sorted(HASHERS))})"
        )
    return HASHERS[name]
