# Copy of starkpack_winterfell_tpu/crypto/rescue_jive.py; cut: the python-int and vectorized limb permutations (the byte API runs on the C sponge of native/rescue_perm.c, the words API on ops/rescue_sponge.py); added: JiveHasher, the byte and words API both Jive hashers share, with the batched host calls and the proof-of-work search.
"""RpJive64_256 — Rescue-Prime in Jive 2-to-1 compression mode
(crypto/src/hash/rescue/rp64_256_jive/mod.rs): state width 8, rate 4,
digest 4 elements; merge/merge_with_int apply the permutation to the raw
8-element input and output the Jive summation
  digest_i = init_i + init_{4+i} + final_i + final_{4+i}.

``JiveHasher`` holds what RpJive64_256 and GriffinJive64_256
(crypto/griffin.py) share: the host byte API (the transcript, the coin, the
nonce search and the verifier's Merkle checks) on a C Jive sponge, the
words API on tensors (Merkle leaves and levels) on the kernel of
ops/rescue_sponge.py, numpy words (the verifier's query rows) on the C
sponge.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..math import scalar as fs
from ..ops import rescue_sponge as rsp
from ._native_perm import make_native_permute, make_native_sponge, u64_to_words, words_to_u64
from .rescue import INV_ALPHA, _bytes_to_elems
from .rescue_jive_constants import ARK1_8, ARK2_8, MDS8

P = fs.P
STATE_WIDTH = 8
RATE = 4
DIGEST_SIZE = 4
NUM_ROUNDS = 7


def _jive_sum(initial, final):
    return [
        (initial[i] + initial[DIGEST_SIZE + i] + final[i] + final[DIGEST_SIZE + i]) % P
        for i in range(DIGEST_SIZE)
    ]


def _chunk_elements(data: bytes):
    """7-byte chunks as elements, the last one closed by a 1 byte
    (rp64_256_jive/mod.rs:119-180)."""
    n = len(data)
    num_elements = n // 7 if n % 7 == 0 else n // 7 + 1
    out = []
    for k in range(num_elements):
        chunk = data[k * 7: (k + 1) * 7]
        buf = chunk + b"\x00" if k < num_elements - 1 else chunk + b"\x01" + b"\x00" * (7 - len(chunk))
        out.append(int.from_bytes(buf, "little"))
    return out


def _elems_bytes(elems) -> bytes:
    return b"".join(int(e).to_bytes(8, "little") for e in elems)


class JiveHasher:
    """A Jive hasher of width 8 over Goldilocks: ``LAYOUT`` (the sponge
    kernel's layout) and ``_native()`` ({"permute": one permutation of a
    list of 8 ints, "sponge": the C ``NativeSponge``}) come from the
    subclass."""

    DIGEST_BYTES = 32
    COLLISION_RESISTANCE = 128
    LAYOUT: rsp.SpongeLayout

    @classmethod
    def _native(cls) -> dict:
        raise NotImplementedError

    @classmethod
    def apply_permutation_ints(cls, state):
        """The permutation of a list of 8 python ints, on the C sponge."""
        return cls._native()["permute"](state)

    # -- host byte/element api ----------------------------------------------

    @classmethod
    def hash(cls, data: bytes) -> bytes:
        """The sponge of the 7-byte chunks: the same absorption, flag and
        padding as ``hash_elements``."""
        return cls._hash_flat(_chunk_elements(data))

    @classmethod
    def hash_elements(cls, elements, elem_bytes: int = 8) -> bytes:
        """The flag 1 iff the element count is not a multiple of the rate,
        the [1, 0, ...] padding of the last partial rate block
        (rp64_256_jive/mod.rs:227-264)."""
        assert elem_bytes == 8, "algebraic hashers are native to f64"
        flat = []
        for e in elements:
            flat.extend(fs.components(e))
        return cls._hash_flat(flat)

    @classmethod
    def _hash_flat(cls, flat) -> bytes:
        vals = np.array([flat], dtype=np.uint64).reshape(1, len(flat))
        return _elems_bytes(cls._native()["sponge"].hash_rows(vals)[0])

    @classmethod
    def merge(cls, a: bytes, b: bytes) -> bytes:
        initial = _bytes_to_elems(a) + _bytes_to_elems(b)
        final = cls.apply_permutation_ints(list(initial))
        return _elems_bytes(_jive_sum(initial, final))

    @classmethod
    def merge_with_int(cls, seed: bytes, value: int) -> bytes:
        """The seed in state[0..4), the value as one element (two from p
        up) after it, state[7] = 5 (6), the Jive sum."""
        state = [0] * STATE_WIDTH
        for i, e in enumerate(_bytes_to_elems(seed)):
            state[i] = e
        state[RATE] = value % P
        if value < P:
            state[STATE_WIDTH - 1] = DIGEST_SIZE + 1
        else:
            state[RATE + 1] = value // P
            state[STATE_WIDTH - 1] = DIGEST_SIZE + 2
        return _elems_bytes(_jive_sum(state, cls.apply_permutation_ints(list(state))))

    @staticmethod
    def seed_elements(seed: bytes):
        """The four digest elements of a 32-byte seed, as ``merge_with_int``
        places them."""
        return _bytes_to_elems(seed)

    @classmethod
    def first_merge_with_int(cls, seed: bytes, start: int, count: int, bits: int,
                             device="cpu"):
        """The lowest nonce in [start, start + count) whose
        ``merge_with_int(seed, nonce)`` has ``bits`` trailing zero bits in
        its first 8 bytes read little-endian, or None: one C search, or on a
        CUDA ``device`` one launch of the sponge kernel's search
        (ops/rescue_sponge.py)."""
        if torch.device(device).type == "cuda":
            return rsp.first_merge_with_int(cls.LAYOUT, cls.seed_elements(seed), start, count,
                                            bits, device)[0]
        return cls._native()["sponge"].first_merge_with_int(cls.seed_elements(seed), start,
                                                             count, bits)

    @classmethod
    def hash_elements_many(cls, element_lists, elem_bytes: int = 8):
        return [cls.hash_elements(e, elem_bytes) for e in element_lists]

    @classmethod
    def merge_many(cls, pairs):
        """Batched 2-to-1 merges in one native call (Merkle verification)."""
        if not pairs:
            return []
        l = np.frombuffer(b"".join(a for a, _ in pairs), dtype="<u8")
        r = np.frombuffer(b"".join(b for _, b in pairs), dtype="<u8")
        out = cls._native()["sponge"].merge_rows(l.reshape(-1, 4), r.reshape(-1, 4))
        ob = out.astype("<u8").tobytes()
        return [ob[i * 32: (i + 1) * 32] for i in range(len(pairs))]

    # -- words api ------------------------------------------------------------

    @classmethod
    def hash_words(cls, words, byte_len: int):
        """Rows of field elements in canonical LE word layout ->
        hash_elements digests as (..., 8) u32 words: tensors through
        ops/rescue_sponge.py, numpy (the verifier's query rows) through the
        C sponge."""
        assert byte_len % 8 == 0
        n_elems = byte_len // 8
        shape = tuple(words.shape[:-1])
        if isinstance(words, np.ndarray):
            vals = words_to_u64(words.reshape(math.prod(shape), words.shape[-1]), n_elems)
            return u64_to_words(cls._native()["sponge"].hash_rows(vals)).reshape(shape + (8,))
        out = rsp.rescue_sponge(cls.LAYOUT, words.reshape(math.prod(shape), words.shape[-1]),
                                n_elems)
        return out.reshape(shape + (8,))

    @classmethod
    def merge_words(cls, l, r):
        shape = tuple(l.shape)
        if isinstance(l, np.ndarray):
            lv = words_to_u64(l.reshape(-1, 8), DIGEST_SIZE)
            rv = words_to_u64(r.reshape(-1, 8), DIGEST_SIZE)
            return u64_to_words(cls._native()["sponge"].merge_rows(lv, rv)).reshape(shape)
        return rsp.rescue_sponge(cls.LAYOUT, l.reshape(-1, 8), y=r.reshape(-1, 8)).reshape(shape)

    @staticmethod
    def digest_to_bytes(d) -> bytes:
        if not isinstance(d, np.ndarray):
            d = d.detach().cpu().numpy()
        return np.asarray(d).astype("<u4").tobytes()

    @staticmethod
    def digest_from_bytes(b: bytes):
        assert len(b) == 32
        return np.frombuffer(b, dtype="<u4").astype(np.uint32)


_NATIVE: dict = {}


class RpJive64_256(JiveHasher):
    NAME = "rp_jive64_256"
    LAYOUT = rsp.RPJIVE64_256

    @classmethod
    def _native(cls) -> dict:
        """The C sponge of native/rescue_perm.c at width 8: flag state[0],
        rate and digest state[4..8)."""
        if not _NATIVE:
            args = ("rp_jive64_256", P, STATE_WIDTH, NUM_ROUNDS, 7, INV_ALPHA, MDS8, ARK1_8,
                    ARK2_8)
            _NATIVE["permute"] = make_native_permute(*args, inv_chain=cls.LAYOUT.inv_chain)
            _NATIVE["sponge"] = make_native_sponge(*args, RATE, RATE, 0, RATE, DIGEST_SIZE,
                                                   inv_chain=cls.LAYOUT.inv_chain, jive=True)
        return _NATIVE
