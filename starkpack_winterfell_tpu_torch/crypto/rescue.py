# Copy of starkpack_winterfell_tpu/crypto/rescue.py; cut: the vectorized limb permutation (the words API runs on ops/rescue_sponge.py) and the python-int fallbacks of the native sponge.
"""Rescue-Prime Rp64_256 — equivalent of crypto/src/hash/rescue/rp64_256/.

Field-native arithmetization-friendly sponge over Goldilocks: state 12,
rate 8, capacity 4, digest 4 elements, 7 rounds of
(x^7 -> MDS -> ARK1 -> x^{1/7} -> MDS -> ARK2)  [rp64_256/mod.rs:296-360].

Digests are 32 bytes = 4 canonical LE u64 (digest.rs:27-38), so they slot
into the same byte/word digest interfaces as BLAKE3.  The host byte API (the
transcript, the coin, the nonce search, the verifier's Merkle checks) runs
on the C sponge of native/rescue_perm.c; the words API on tensors (Merkle
leaves and levels) on the kernel of ops/rescue_sponge.py.  ``round_ints``
(python ints) serves the short chains of the trace builders.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..math import scalar as fs
from ..ops import rescue_sponge as rsp
from ._native_perm import make_native_permute, make_native_sponge, u64_to_words, words_to_u64
from .rescue_constants import ARK1, ARK2, INV_MDS, MDS  # noqa: F401

P = fs.P
STATE_WIDTH = 12
RATE = 8
CAPACITY = 4
DIGEST_SIZE = 4
NUM_ROUNDS = 7
ALPHA = 7
INV_ALPHA = 10540996611094048183


def round_ints(state, r: int):
    """One Rescue round on a list of python ints."""
    state = [pow(x, ALPHA, P) for x in state]
    state = _mds_ints(state)
    state = [(x + c) % P for x, c in zip(state, ARK1[r])]
    state = [pow(x, INV_ALPHA, P) for x in state]
    state = _mds_ints(state)
    return [(x + c) % P for x, c in zip(state, ARK2[r])]


_NATIVE: dict = {}


def _native():
    """{"permute": one permutation of python ints, "sponge": the
    ``NativeSponge``} on the C sponge, built on first use."""
    if not _NATIVE:
        args = ("rp64_256", P, STATE_WIDTH, NUM_ROUNDS, ALPHA, INV_ALPHA, MDS, ARK1, ARK2)
        _NATIVE["permute"] = make_native_permute(*args, inv_chain=rsp.RP64_256.inv_chain)
        _NATIVE["sponge"] = make_native_sponge(*args, CAPACITY, RATE, 0, CAPACITY,
                                               DIGEST_SIZE, inv_chain=rsp.RP64_256.inv_chain)
    return _NATIVE


def apply_permutation_ints(state):
    """The permutation of a list of 12 python ints, on the C sponge."""
    return _native()["permute"](state)


def round_states(states):
    """(n, 12) u64 states -> (n, NUM_ROUNDS + 1, 12): each state and the
    state after each round (``round_ints``), on the C permutation."""
    return _native()["sponge"].round_states(states)


def _mds_ints(state):
    return [
        sum(MDS[i][j] * state[j] for j in range(STATE_WIDTH)) % P
        for i in range(STATE_WIDTH)
    ]


# ---------------------------------------------------------------------------
# hasher interface
# ---------------------------------------------------------------------------


class Rp64_256:
    NAME = "rp64_256"
    DIGEST_BYTES = 32
    COLLISION_RESISTANCE = 128
    LAYOUT = rsp.RP64_256

    # -- host byte/element api ----------------------------------------------

    @staticmethod
    def hash(data: bytes) -> bytes:
        """7-byte-chunk absorption (rp64_256/mod.rs:125-180)."""
        n = len(data)
        num_elements = n // 7 if n % 7 == 0 else n // 7 + 1
        state = [0] * STATE_WIDTH
        state[0] = num_elements % P
        i = 0
        for k in range(num_elements):
            chunk = data[k * 7: (k + 1) * 7]
            if k < num_elements - 1:
                buf = chunk + b"\x00"
            else:
                buf = chunk + b"\x01" + b"\x00" * (7 - len(chunk))
            state[CAPACITY + i] = (state[CAPACITY + i] + int.from_bytes(buf, "little")) % P
            i += 1
            if i % RATE == 0:
                state = apply_permutation_ints(state)
                i = 0
        if i > 0:
            state = apply_permutation_ints(state)
        return _digest_bytes(state)

    @classmethod
    def hash_elements(cls, elements, elem_bytes: int = 8) -> bytes:
        """rp64_256/mod.rs:222-259 — capacity[0] = element count, absorb 8
        base elements per permutation."""
        assert elem_bytes == 8, "algebraic hashers are native to f64"
        flat = []
        for e in elements:
            flat.extend(fs.components(e))
        state = [0] * STATE_WIDTH
        state[0] = len(flat) % P
        i = 0
        for e in flat:
            state[CAPACITY + i] = (state[CAPACITY + i] + e) % P
            i += 1
            if i % RATE == 0:
                state = apply_permutation_ints(state)
                i = 0
        if i > 0:
            state = apply_permutation_ints(state)
        return _digest_bytes(state)

    @staticmethod
    def merge(a: bytes, b: bytes) -> bytes:
        """rp64_256/mod.rs:182-193."""
        state = [0] * STATE_WIDTH
        state[0] = RATE
        for i, e in enumerate(_bytes_to_elems(a) + _bytes_to_elems(b)):
            state[CAPACITY + i] = e
        return _digest_bytes(apply_permutation_ints(state))

    @staticmethod
    def merge_with_int(seed: bytes, value: int) -> bytes:
        """rp64_256/mod.rs:195-219: the value as one element, or as two
        (value mod p, value div p) from p up."""
        state = [0] * STATE_WIDTH
        for i, e in enumerate(_bytes_to_elems(seed)):
            state[CAPACITY + i] = e
        state[CAPACITY + DIGEST_SIZE] = value % P
        if value < P:
            state[0] = DIGEST_SIZE + 1
        else:
            state[CAPACITY + DIGEST_SIZE + 1] = value // P
            state[0] = DIGEST_SIZE + 2
        return _digest_bytes(apply_permutation_ints(state))

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
        its first 8 bytes read little-endian, or None: one C sponge batch,
        or on a CUDA ``device`` one launch of the sponge kernel's search
        (ops/rescue_sponge.py)."""
        if torch.device(device).type == "cuda":
            return rsp.first_merge_with_int(cls.LAYOUT, cls.seed_elements(seed), start, count,
                                            bits, device)[0]
        return _native()["sponge"].first_merge_with_int(cls.seed_elements(seed), start, count,
                                                        bits)

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
        out = _native()["sponge"].merge_rows(l.reshape(-1, 4), r.reshape(-1, 4))
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
            return u64_to_words(_native()["sponge"].hash_rows(vals)).reshape(shape + (8,))
        out = rsp.rescue_sponge(cls.LAYOUT, words.reshape(math.prod(shape), words.shape[-1]), n_elems)
        return out.reshape(shape + (8,))

    @classmethod
    def merge_words(cls, l, r):
        shape = tuple(l.shape)
        if isinstance(l, np.ndarray):
            lv = words_to_u64(l.reshape(-1, 8), DIGEST_SIZE)
            rv = words_to_u64(r.reshape(-1, 8), DIGEST_SIZE)
            return u64_to_words(_native()["sponge"].merge_rows(lv, rv)).reshape(shape)
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


def _digest_bytes(state) -> bytes:
    return b"".join(int(state[i]).to_bytes(8, "little")
                    for i in range(CAPACITY, CAPACITY + DIGEST_SIZE))


def _bytes_to_elems(b: bytes):
    assert len(b) == 32
    return [int.from_bytes(b[i * 8: (i + 1) * 8], "little") for i in range(4)]
