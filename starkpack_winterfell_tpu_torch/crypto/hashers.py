# Copy of starkpack_winterfell_tpu/crypto/hashers.py; cut: Blake3_192, Sha3_256 and the algebraic hashers (Rp64_256, RpJive64_256, GriffinJive64_256, Rp62_248); only Blake3_256 is registered.
"""Hash function registry — equivalent of crypto/src/hash/mod.rs.

Each hasher exposes a host byte API (for the Fiat-Shamir channel and proof
(de)serialization) and a vectorized words API (for device-side row/Merkle
hashing).  Digests on the host are ``bytes``; on device they are (..., 8)
uint32 arrays (32-byte digests) — ``Blake3_192`` truncates only at the byte
boundary, mirroring ByteDigest<24> (crypto/src/hash/blake/mod.rs:70-116).
"""

from __future__ import annotations

from ..ops import blake3 as b3
from ..utils.serde import ByteWriter


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
        return b3.hash_bytes_many(bufs)

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


HASHERS = {Blake3_256.NAME: Blake3_256}


def get_hasher(name: str):
    if name not in HASHERS:
        raise NotImplementedError(
            f"hasher {name!r} is not ported yet (only blake3_256 is)"
        )
    return HASHERS[name]
