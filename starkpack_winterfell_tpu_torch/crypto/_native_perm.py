# Copy of starkpack_winterfell_tpu/crypto/_native_perm.py; cut: the None returns (a failed build raises); added: the batched permutation, the proof-of-work search (first_merge_with_int), the round states (trace builders), the Jive sponge of RpJive64_256 and the host sponge of GriffinJive64_256 (make_native_griffin).
"""The host sponges of the algebraic hashers: Rescue-Prime (Rp64_256,
Rp62_248, RpJive64_256) on the C permutation of native/rescue_perm.c,
Griffin (GriffinJive64_256) on native/griffin_perm.c.  The byte API, the
random coin, the nonce search and the verifier's Merkle checks run here.
The words API on tensors is ops/rescue_sponge.py."""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import numpy as np


def words_to_u64(arr, n_elems):
    """(n, >=2*n_elems) u32 LE word rows -> (n, n_elems) u64 values."""
    a = arr.astype(np.uint64)
    return np.ascontiguousarray(
        a[:, 0 : 2 * n_elems : 2] | (a[:, 1 : 2 * n_elems : 2] << np.uint64(32))
    )


def u64_to_words(vals):
    """(n, d) u64 -> (n, 2d) u32 LE words."""
    n, d = vals.shape
    out = np.empty((n, 2 * d), dtype=np.uint32)
    out[:, 0::2] = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 1::2] = (vals >> np.uint64(32)).astype(np.uint32)
    return out


class NativeSponge(NamedTuple):
    hash_rows: Callable
    merge_rows: Callable
    permute_rows: Callable
    round_states: Callable
    first_merge_with_int: Callable


def make_native_sponge(name, P, width, rounds, alpha, inv_alpha, mds, ark1,
                       ark2, rate_start, rate, tag_index, digest_start,
                       digest_size, inv_chain=(), jive=False):
    """A ``NativeSponge`` on u64 element arrays through the C sponge.  hash_rows: (n, row_len) -> (n,
    digest_size); merge_rows: two (n, digest_size) -> (n, digest_size);
    permute_rows: (n, width) states permuted in place; round_states: (n,
    width) -> (n, rounds + 1, width), each state and the state after each
    round; first_merge_with_int: the proof-of-work search below.
    ``inv_chain``: an addition chain for x^inv_alpha (ops/rescue_sponge.py).
    ``jive``: the Jive sponge of native/sponge.h (width 8, rate 4; the flag
    at ``tag_index``), as RpJive64_256 hashes, merges and searches.
    Raises if the library cannot be built."""
    from ..native import get_rescue_perm

    lib, slot = get_rescue_perm(name, P, width, rounds, alpha, inv_alpha, mds,
                                ark1, ark2, inv_chain)
    vp = ctypes.c_void_p
    if jive:
        return _jive_sponge(
            lambda vals, n, row_len, out: lib.rp_jive_hash_batch(
                slot, vals, n, row_len, rate_start, tag_index, digest_start, out),
            lambda l, r, n, out: lib.rp_jive_merge_batch(slot, l, r, n, out),
            lambda states, n: lib.rp_permute_batch(slot, states, n),
            lambda seed, start, count, bits: lib.rp_jive_search(slot, seed, start, count, bits),
            P)

    def hash_rows(vals):
        vals = np.ascontiguousarray(vals, dtype=np.uint64)
        n, row_len = vals.shape
        out = np.empty((n, digest_size), dtype=np.uint64)
        lib.rp_hash_elements_batch(
            slot, vals.ctypes.data_as(vp), n, row_len, rate_start, rate,
            tag_index, digest_start, digest_size, out.ctypes.data_as(vp),
        )
        return out

    def merge_rows(l, r):
        l = np.ascontiguousarray(l, dtype=np.uint64)
        r = np.ascontiguousarray(r, dtype=np.uint64)
        n = l.shape[0]
        out = np.empty((n, digest_size), dtype=np.uint64)
        lib.rp_merge_batch(
            slot, l.ctypes.data_as(vp), r.ctypes.data_as(vp), n, rate_start,
            tag_index, digest_start, digest_size, out.ctypes.data_as(vp),
        )
        return out

    def permute_rows(states):
        assert states.dtype == np.uint64 and states.flags.c_contiguous
        assert states.shape[-1] == width
        lib.rp_permute_batch(slot, states.ctypes.data_as(vp), states.shape[0])
        return states

    def round_states(states):
        states = np.ascontiguousarray(states, dtype=np.uint64)
        out = np.empty((states.shape[0], rounds + 1, width), dtype=np.uint64)
        lib.rp_round_states_batch(slot, states.ctypes.data_as(vp), states.shape[0],
                                  out.ctypes.data_as(vp))
        return out

    def first_merge_with_int(seed_elems, start, count, bits, head=lambda d: d[:, 0]):
        """The lowest nonce in [start, start + count) whose
        ``merge_with_int(seed, nonce)`` digest has ``bits`` trailing zero
        bits in the u64 ``head(digest)`` (its first 8 bytes read
        little-endian), or None: one batch of states (the seed's digest
        elements, the nonce after them, the tag ``digest_size + 1``) through
        the C permutation.  Nonces below p, so one element each."""
        assert 0 < start and start + count <= P
        states = np.zeros((count, width), dtype=np.uint64)
        states[:, digest_start: digest_start + digest_size] = np.asarray(seed_elems, dtype=np.uint64)
        states[:, digest_start + digest_size] = np.arange(start, start + count, dtype=np.uint64)
        states[:, tag_index] = digest_size + 1
        permute_rows(states)
        h = head(states[:, digest_start: digest_start + digest_size])
        ok = np.flatnonzero((h & np.uint64((1 << bits) - 1)) == 0)
        return int(start + ok[0]) if ok.size else None

    return NativeSponge(hash_rows, merge_rows, permute_rows, round_states,
                        first_merge_with_int)


def _jive_sponge(hash_fn, merge_fn, permute_fn, search_fn, P) -> NativeSponge:
    """A ``NativeSponge`` (no round states) on the C Jive sponge functions of
    one hasher: each takes u64 arrays as pointers."""
    vp = ctypes.c_void_p

    def hash_rows(vals):
        vals = np.ascontiguousarray(vals, dtype=np.uint64)
        n, row_len = vals.shape
        out = np.empty((n, 4), dtype=np.uint64)
        hash_fn(vals.ctypes.data_as(vp), n, row_len, out.ctypes.data_as(vp))
        return out

    def merge_rows(l, r):
        l = np.ascontiguousarray(l, dtype=np.uint64)
        r = np.ascontiguousarray(r, dtype=np.uint64)
        out = np.empty((l.shape[0], 4), dtype=np.uint64)
        merge_fn(l.ctypes.data_as(vp), r.ctypes.data_as(vp), l.shape[0], out.ctypes.data_as(vp))
        return out

    def permute_rows(states):
        assert states.dtype == np.uint64 and states.flags.c_contiguous
        assert states.shape[-1] == 8
        permute_fn(states.ctypes.data_as(vp), states.shape[0])
        return states

    def first_merge_with_int(seed_elems, start, count, bits):
        """The lowest nonce in [start, start + count) whose Jive
        ``merge_with_int(seed, nonce)`` digest has ``bits`` trailing zero
        bits in its first element, or None (nonces below p)."""
        assert 0 < start and start + count <= P
        seed = np.asarray(seed_elems, dtype=np.uint64)
        v = search_fn(seed.ctypes.data_as(vp), start, count, bits)
        return None if v == (1 << 64) - 1 else int(v)

    return NativeSponge(hash_rows, merge_rows, permute_rows, None, first_merge_with_int)


def make_native_griffin() -> NativeSponge:
    """The ``NativeSponge`` of GriffinJive64_256 on native/griffin_perm.c
    (Goldilocks; rate state[0..4), flag state[4], digest state[0..4))."""
    from ..native import get_griffin_perm

    lib = get_griffin_perm()
    return _jive_sponge(lib.gr_hash_batch, lib.gr_merge_batch, lib.gr_permute_batch,
                        lib.gr_search, 0xFFFFFFFF00000001)


def make_native_permute(name, P, width, rounds, alpha, inv_alpha, mds, ark1,
                        ark2, inv_chain=()):
    """A ``permute(list[int]) -> list[int]`` bound to a registered config
    slot.  Raises if the library cannot be built."""
    from ..native import get_rescue_perm

    lib, slot = get_rescue_perm(name, P, width, rounds, alpha, inv_alpha, mds,
                                ark1, ark2, inv_chain)
    vp = ctypes.c_void_p

    def permute(state):
        arr = np.array(state, dtype=np.uint64)
        lib.rp_permute_batch(slot, arr.ctypes.data_as(vp), 1)
        return arr.tolist()

    return permute
