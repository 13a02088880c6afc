"""PyTorch port, SHA3-256 on tensors (ops/keccak.py, crypto/hashers.py
Sha3_256): keccak-f[1600] on 64-bit lanes against the JAX package's lane-pair
keccak, and the words API against hashlib and the JAX package's
sha3_256_words, on inputs made from a numpy seed across the rate boundary.
Tolerance zero."""

import hashlib

import numpy as np
import pytest
import torch

from starkpack_winterfell_tpu.ops import keccak as jk

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.ops import keccak as tk

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)


def _words(rows: int, byte_len: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(rows, byte_len // 4), dtype=np.uint64).astype(np.uint32)


def test_keccak_f_matches_the_lane_pair_permutation():
    rng = np.random.default_rng(3)
    lanes = rng.integers(0, 1 << 64, size=(5, 5, 6), dtype=np.uint64)
    lo = (lanes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (lanes >> np.uint64(32)).astype(np.uint32)
    want = jk.keccak_f([[(lo[x, y], hi[x, y]) for y in range(5)] for x in range(5)])
    got = tk.keccak_f([[torch.from_numpy(lanes[x, y].view(np.int64)) for y in range(5)]
                       for x in range(5)])
    for x in range(5):
        for y in range(5):
            g = got[x][y].numpy().view(np.uint64)
            w = want[x][y][0].astype(np.uint64) | (want[x][y][1].astype(np.uint64) << np.uint64(32))
            assert np.array_equal(g, w), (x, y)


@pytest.mark.parametrize("byte_len", [0, 136, 272, 8, 128, 144, 224])
def test_sha3_256_words_match_hashlib_and_the_jax_package(byte_len):
    """0, 136 and 272 bytes sit on the rate boundary (one more padding
    block); field-element rows are whole 8-byte lanes, so 135 and 137 are
    taken by the byte API below."""
    words = _words(5, max(byte_len, 8), byte_len)
    got = tk.sha3_256_words(torch.from_numpy(words.astype(np.int64)), byte_len)
    want = np.stack([np.frombuffer(hashlib.sha3_256(r[: byte_len // 4].astype("<u4").tobytes())
                                   .digest(), dtype="<u4") for r in words])
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(np.asarray(jk.sha3_256_words(words, byte_len)), want)
    # the numpy rows (the verifier's side) take hashlib and give the same words
    assert np.array_equal(tk.sha3_256_words(words, byte_len), want)


@pytest.mark.parametrize("nbytes", [0, 135, 136, 137, 272])
def test_byte_api_is_sha3_256(nbytes):
    data = np.random.default_rng(nbytes).bytes(nbytes)
    assert T.Sha3_256.hash(data) == hashlib.sha3_256(data).digest()
    assert T.Sha3_256.merge(data[:7], data[7:]) == hashlib.sha3_256(data).digest()
    assert T.Sha3_256.merge_with_int(data, 5) == hashlib.sha3_256(
        data + (5).to_bytes(8, "little")).digest()


def test_sha3_merge_words_hashes_two_digests():
    l, r = _words(9, 32, 11), _words(9, 32, 12)
    got = T.Sha3_256.merge_words(torch.from_numpy(l.astype(np.int64)),
                                 torch.from_numpy(r.astype(np.int64)))
    want = np.asarray(jk.sha3_merge_words(l, r))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    for i in range(9):
        assert T.Sha3_256.digest_to_bytes(got[i]) == T.Sha3_256.merge(
            T.Sha3_256.digest_to_bytes(l[i]), T.Sha3_256.digest_to_bytes(r[i]))
