"""PyTorch port, the host C tier of BLAKE3 (native/blake3_compress.c):
``hash_bytes``, ``hash_bytes_many`` and numpy ``hash_words`` of
ops/blake3.py, and the BLAKE3 hashers' batch Merkle root
(crypto/merkle.py ``_native_root``), each held against its plain version
in the port (the numpy compression, the python ``get_root_plain``) and
against the JAX package's ``ops/blake3.py``, byte for byte.  A failing C
library raises: no route falls back to the numpy compression."""

import numpy as np
import pytest
import torch

from starkpack_winterfell_tpu.ops import blake3 as jb3

from starkpack_winterfell_tpu_torch.crypto import merkle
from starkpack_winterfell_tpu_torch.crypto.hashers import Blake3_192, Blake3_256, Sha3_256
from starkpack_winterfell_tpu_torch.ops import blake3 as b3
from starkpack_winterfell_tpu_torch.utils.serde import SliceReader

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

# around the block (64) and chunk (1024) edges, and the ~48 KB Fiat-Shamir
# seed of 1024 Lamport+ signatures (many chunks, a deep parent tree)
LENGTHS = [0, 1, 63, 64, 65, 1023, 1024, 1025, 49152]


@pytest.mark.parametrize("n", LENGTHS)
def test_hash_bytes_equals_the_plain_version_and_the_jax_package(n):
    rng = np.random.default_rng(n)
    data = rng.bytes(n)
    want = jb3.hash_bytes(data)
    assert b3.hash_bytes(data) == want
    assert b3.hash_bytes(data, 24) == want[:24]
    assert b3.hash_bytes_plain(data) == want
    datas = [rng.bytes(n) for _ in range(3)]
    many = b3.hash_bytes_many(datas)
    assert many == [jb3.hash_bytes(d) for d in datas] == jb3.hash_bytes_many(datas)
    assert b3.hash_bytes_many(datas, 24) == [d[:24] for d in many]
    assert b3.hash_bytes_many_plain(datas) == many


def test_hash_bytes_many_refuses_unequal_lengths():
    with pytest.raises(ValueError, match="one length"):
        b3.hash_bytes_many([b"ab", b"abc"])


@pytest.mark.parametrize("byte_len,width", [(24, 6), (48, 16), (96, 30), (1100, 300)])
def test_hash_words_rows_in_place(byte_len, width):
    """Rows of ``width`` u32 words of which the first byte_len bytes are
    hashed (b3_hash_rows_strided reads each row in place): C against the
    numpy and tensor compression and the JAX package, in two and three
    dimensions."""
    rng = np.random.default_rng(byte_len)
    words = np.zeros((2, 5, width), dtype=np.uint32)
    words[..., : byte_len // 4] = rng.integers(0, 1 << 32, size=(2, 5, byte_len // 4),
                                               dtype=np.uint32)
    got = b3.hash_words(words, byte_len)
    assert got.shape == (2, 5, 8) and got.dtype == np.uint32
    assert np.array_equal(got, b3.hash_words_plain(words, byte_len))
    assert np.array_equal(got[1], b3.hash_words(words[1], byte_len))
    assert np.array_equal(got[1], jb3.hash_words(words[1], byte_len))
    on_tensor = b3.hash_words(torch.from_numpy(words.astype(np.int64)), byte_len)
    assert np.array_equal(on_tensor.numpy(), got.astype(np.int64))


@pytest.mark.parametrize("hasher", [Blake3_256, Blake3_192], ids=lambda h: h.NAME)
@pytest.mark.parametrize("indexes", [[5], [0, 1], [3, 200, 77, 76, 255],
                                     list(range(0, 256, 3))],
                         ids=["one", "siblings", "scattered", "strided"])
def test_native_root_equals_the_python_root(hasher, indexes):
    """A batch proof over 256 leaves: the C root equals the python root and
    the tree's, as built and after a serialization round trip (the
    contiguous node form); a wrong leaf changes both roots alike."""
    rows = np.random.default_rng(11).integers(0, 1 << 32, size=(256, 8), dtype=np.uint32)
    leaves = hasher.hash_words(torch.from_numpy(rows.astype(np.int64)), 32)
    tree = merkle.MerkleTree.from_leaves(leaves, hasher)
    proof = tree.prove_batch(indexes)
    assert proof._native_root(indexes) == proof.get_root_plain(indexes) == tree.root()
    parsed = merkle.BatchMerkleProof.deserialize(
        SliceReader(proof.serialize_nodes()), proof.leaves, tree.depth, hasher)
    assert parsed._node_blob is not None
    assert parsed.get_root(indexes) == tree.root()
    assert merkle.verify_batch(tree.root(), indexes, parsed)
    bad = list(proof.leaves)
    bad[0] = bytes([bad[0][0] ^ 1]) + bad[0][1:]
    forged = merkle.BatchMerkleProof(bad, proof.nodes, proof.depth, hasher)
    assert forged.get_root(indexes) == forged.get_root_plain(indexes) != tree.root()
    assert not merkle.verify_batch(tree.root(), indexes, forged)


def test_native_root_rejects_a_short_node_vector():
    indexes = [3, 200]
    leaves = Blake3_256.hash_words(torch.arange(256 * 8).reshape(256, 8) % 997, 32)
    tree = merkle.MerkleTree.from_leaves(leaves, Blake3_256)
    proof = tree.prove_batch(indexes)
    nodes = [list(v) for v in proof.nodes]
    nodes[-1] = nodes[-1][:-1]
    short = merkle.BatchMerkleProof(proof.leaves, nodes, proof.depth, Blake3_256)
    with pytest.raises(ValueError, match="invalid proof"):
        short.get_root(indexes)
    with pytest.raises(ValueError, match="invalid proof"):
        short.get_root_plain(indexes)
    assert not merkle.verify_batch(tree.root(), indexes, short)


def test_other_hashers_keep_the_python_root(monkeypatch):
    monkeypatch.setattr(merkle.BatchMerkleProof, "_native_root",
                        lambda self, idx: pytest.fail("a SHA3 root went through BLAKE3"))
    rows = torch.arange(64 * 8).reshape(64, 8) % 1013
    tree = merkle.MerkleTree.from_leaves(Sha3_256.hash_words(rows, 32), Sha3_256)
    assert merkle.verify_batch(tree.root(), [1, 7, 40], tree.prove_batch([1, 7, 40]))


def test_a_failing_library_raises(monkeypatch):
    def broken():
        raise RuntimeError("host build of blake3_compress.c failed")

    monkeypatch.setattr(b3, "get_blake3", broken)
    for call in (lambda: b3.hash_bytes(b"abc"), lambda: b3.hash_bytes_many([b"abc"]),
                 lambda: b3.hash_words(np.zeros((2, 16), dtype=np.uint32), 64)):
        with pytest.raises(RuntimeError, match="blake3_compress.c"):
            call()
