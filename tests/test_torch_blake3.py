"""PyTorch port, hashing: ops/blake3.py, the Merkle levels of
prover/device_big.py and crypto/merkle.py of starkpack_winterfell_tpu_torch
against the JAX package under numpy.  Digests are compared word for word
and batch proofs byte for byte."""

import numpy as np
import pytest
import torch

from starkpack_winterfell_tpu import Blake3_256 as JBlake3
from starkpack_winterfell_tpu.crypto.merkle import MerkleTree as JMerkleTree, verify_batch as jverify_batch
from starkpack_winterfell_tpu.ops import blake3 as jb3, gl64 as jgl
from starkpack_winterfell_tpu.prover import device_big as jbig

from starkpack_winterfell_tpu_torch import Blake3_256 as TBlake3
from starkpack_winterfell_tpu_torch.crypto.merkle import MerkleTree as TMerkleTree, verify_batch as tverify_batch
from starkpack_winterfell_tpu_torch.ops import blake3 as tb3, gl64 as tgl
from starkpack_winterfell_tpu_torch.prover import device_big as tbig

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

P = tgl.P


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 32, size=shape, dtype=np.uint32)


def _t(words):
    return torch.from_numpy(words.astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("byte_len", [8, 64, 96, 128, 40, 1100])
def test_hash_words_matches_reference(byte_len):
    """Row lengths: one block, a full block, the 12-column trace row (two
    blocks), two full blocks, a ragged block, and a two-chunk input."""
    n_words = (byte_len + 3) // 4
    words = _words((33, n_words), byte_len)
    if byte_len % 4:
        words[:, -1] &= (1 << (8 * (byte_len % 4))) - 1
    want = jb3.hash_words(words, byte_len, xp=np)
    got = tb3.hash_words(_t(words), byte_len)
    assert got.dtype == torch.int64 and np.array_equal(_np(got), want)
    # the host byte api agrees with the words api
    row0 = words[0].astype("<u4").tobytes()[:byte_len]
    assert tb3.hash_bytes(row0) == jb3.hash_bytes(row0) == tb3.digest_to_bytes(got[0])


def test_merge_and_merge_with_int_match_reference():
    l, r = _words((17, 8), 1), _words((17, 8), 2)
    assert np.array_equal(_np(tb3.merge(_t(l), _t(r))), jb3.merge(l, r, xp=np))
    for value in (0, 1, (1 << 32) + 5, (1 << 63) - 1):
        want = jb3.merge_with_int(l, value, xp=np)
        assert np.array_equal(_np(tb3.merge_with_int(_t(l), value)), want)
    # the batched proof-of-work form: one nonce per row
    nonces = np.arange(1000, 1017, dtype=np.int64)
    lo, hi = torch.from_numpy(nonces & 0xFFFFFFFF), torch.from_numpy(nonces >> 32)
    seeds = _t(np.broadcast_to(l[0], (17, 8)).copy())
    got = _np(tb3.merge_with_int(seeds, (lo, hi)))
    for i, v in enumerate(nonces):
        assert np.array_equal(got[i], jb3.merge_with_int(l[0], int(v), xp=np))


@pytest.mark.parametrize("data", [b"", b"abc", bytes(range(200)), b"x" * 2049],
                         ids=["empty", "3B", "200B", "2049B"])
def test_hash_bytes_matches_reference(data):
    assert tb3.hash_bytes(data) == jb3.hash_bytes(data)
    assert TBlake3.hash(data) == JBlake3.hash(data)


def test_hasher_host_api_matches_reference():
    elems = [0, 1, P - 1, 123456789012345]
    assert TBlake3.hash_elements(elems) == JBlake3.hash_elements(elems)
    a, b = TBlake3.hash(b"a"), TBlake3.hash(b"b")
    assert TBlake3.merge(a, b) == JBlake3.merge(a, b)
    assert TBlake3.merge_with_int(a, 77) == JBlake3.merge_with_int(a, 77)
    assert TBlake3.merge_many([(a, b), (b, a)]) == [JBlake3.merge(a, b), JBlake3.merge(b, a)]


@pytest.fixture(scope="module")
def trees():
    """Merkle levels over 256 rows of 12 field elements, built by each
    package's ``_merkle_levels`` from the same numpy rows."""
    rows = np.random.default_rng(3).integers(0, P, size=(256, 12), dtype=np.uint64)
    jlevels = jbig._merkle_levels((jgl.from_u64(rows),), JBlake3, 12, 1)
    tlevels = tbig._merkle_levels((tgl.from_u64(rows),), TBlake3, 12, 1)
    return jlevels, tlevels


def test_merkle_levels_match_reference(trees):
    jlevels, tlevels = trees
    assert len(jlevels) == len(tlevels) == 9
    for jl, tl in zip(jlevels, tlevels):
        assert np.array_equal(_np(tl), np.asarray(jl))


@pytest.mark.parametrize("indexes", [[5], [0, 1], [3, 200, 77, 76, 255], list(range(0, 64, 3))],
                         ids=["one", "siblings", "scattered", "strided"])
def test_merkle_root_and_batch_proofs_match_reference(trees, indexes):
    jlevels, tlevels = trees
    jtree, ttree = JMerkleTree(jlevels, JBlake3), TMerkleTree(tlevels, TBlake3)
    assert ttree.root() == jtree.root()
    jp, tp = jtree.prove_batch(indexes), ttree.prove_batch(indexes)
    assert tp.leaves == jp.leaves
    assert tp.serialize_nodes() == jp.serialize_nodes()
    assert tverify_batch(ttree.root(), indexes, tp)
    assert jverify_batch(jtree.root(), indexes, tp)
    assert not tverify_batch(TBlake3.hash(b"other root"), indexes, tp)
