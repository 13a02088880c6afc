# Copy of starkpack_winterfell_tpu/crypto/merkle.py; cut: the jitted bucketed multi-level gathers (one index_select + one host copy per tree instead); added: the tree split across ranks (ShardedMerkleTree).
"""Merkle tree with batched Octopus-style proofs.

Equivalent of crypto/src/merkle/{mod.rs, proofs.rs}.  The tree *build* is a
pure vectorized function (``build_levels``) — log2(n) full-width merge calls
on the device; the irregular batch-proof extraction/verification
(prove_batch / get_root — merkle/mod.rs:222-284, proofs.rs:135-268) is tiny
and host-side, operating on materialized levels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch


def build_levels(leaves, hasher):
    """leaves: (n, 8) digest word tensor.  Returns list of
    levels: [leaves (n,8), parents (n/2,8), ..., root (1,8)].

    Equivalent to build_merkle_nodes (merkle/mod.rs:350-374) but bottom-up
    vectorized: level k+1 = merge(level k even rows, level k odd rows).
    """
    n = leaves.shape[0]
    assert n >= 2 and n & (n - 1) == 0, "number of leaves must be a power of two >= 2"
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        cur = hasher.merge_words(cur[0::2], cur[1::2])
        levels.append(cur)
    return levels


class MerkleTree:
    """Host-side tree view over levels that may live on an accelerator.

    Only the root is materialized eagerly; ``prove_batch`` gathers exactly
    the leaf/sibling digests it needs (one batched gather per level), so
    committing never transfers the full tree off-device.
    """

    def __init__(self, levels, hasher):
        self.levels = list(levels)
        self.h = hasher
        self.n = self.levels[0].shape[0]
        self._root_bytes = hasher.digest_to_bytes(self.levels[-1][0])
        self._fetch_cache = {}

    @classmethod
    def from_leaves(cls, leaves, hasher) -> "MerkleTree":
        return cls(build_levels(leaves, hasher), hasher)

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    def root(self) -> bytes:
        return self._root_bytes

    def leaf_bytes(self, i: int) -> bytes:
        return self._fetch(0, i)

    def _node_bytes(self, j: int) -> bytes:
        """Reference flat node indexing: root at 1; node j in [1, n) at depth
        k (2^k <= j < 2^(k+1)) is levels[depth-k][j - 2^k]."""
        k = j.bit_length() - 1
        return self._fetch(self.depth - k, j - (1 << k))

    def _fetch(self, level: int, idx: int) -> bytes:
        key = (level, idx)
        if key not in self._fetch_cache:
            self._fetch_cache[key] = self.h.digest_to_bytes(
                self.levels[level][idx]
            )
        return self._fetch_cache[key]

    def prefetch_batch(self, indexes):
        """Gather every digest ``prove_batch(indexes)`` will touch, one
        batched device gather per level (keeps device->host traffic at
        O(q log n) digests instead of the whole tree)."""
        per_level = self._prefetch_plan(indexes)
        return self._prefetch_finish(per_level)

    def _prefetch_plan(self, indexes):
        """Per-level digest indexes prove_batch(indexes) will touch and
        that are not yet in the fetch cache."""
        need = [set() for _ in range(len(self.levels))]
        norm = _normalize_indexes(indexes)
        for index in norm:
            need[0].add(index)
            need[0].add(index + 1)
        cur = [(index + self.n) >> 1 for index in norm]
        for _ in range(1, self.depth):
            nxt = []
            i = 0
            while i < len(cur):
                sibling = cur[i] ^ 1
                if i + 1 < len(cur) and cur[i + 1] == sibling:
                    i += 1
                else:
                    k = sibling.bit_length() - 1
                    need[self.depth - k].add(sibling - (1 << k))
                nxt.append(sibling >> 1)
                i += 1
            cur = nxt
        per_level = []
        for level, idxs in enumerate(need):
            idxs = sorted(i for i in idxs if (level, i) not in self._fetch_cache)
            per_level.append(idxs)
        return per_level

    def _fill_fetch_cache(self, per_level, rows_per_level):
        for level, (idxs, rows) in enumerate(zip(per_level, rows_per_level)):
            for i, row in zip(idxs, rows):
                self._fetch_cache[(level, i)] = self.h.digest_to_bytes(row)

    def _prefetch_finish(self, per_level):
        """One index_select per touched level + one host copy for the whole
        tree."""
        total = sum(len(i) for i in per_level)
        if not total:
            return
        device = self.levels[0].device
        rows = torch.cat([
            lvl.index_select(0, torch.as_tensor(idxs, dtype=torch.int64, device=device))
            for lvl, idxs in zip(self.levels, per_level) if idxs
        ]).cpu().numpy()
        o = 0
        rows_per_level = []
        for idxs in per_level:
            rows_per_level.append(rows[o : o + len(idxs)])
            o += len(idxs)
        self._fill_fetch_cache(per_level, rows_per_level)

    # -- batched proofs (merkle/mod.rs:222-284) -----------------------------

    @staticmethod
    def prefetch_trees(tree_indexes):
        """[(tree, indexes), ...] — every tree's prove_batch prefetch (one
        gather + one host copy per tree)."""
        for t, idx in tree_indexes:
            t.prefetch_batch(idx)

    def prove_batch(self, indexes) -> "BatchMerkleProof":
        assert indexes, "at least one index required"
        assert len(indexes) <= 255, "too many paths"
        self.prefetch_batch(indexes)
        index_map = _map_indexes(indexes, self.depth)
        norm = _normalize_indexes(indexes)
        leaves = [b""] * len(index_map)
        nodes = []

        next_indexes = []
        for index in norm:
            missing = []
            for i in (index, index + 1):
                v = self.leaf_bytes(i)
                if i in index_map:
                    leaves[index_map[i]] = v
                else:
                    missing.append(v)
            nodes.append(missing)
            next_indexes.append((index + self.n) >> 1)

        for _ in range(1, self.depth):
            indexes_lvl = next_indexes
            next_indexes = []
            i = 0
            while i < len(indexes_lvl):
                sibling_index = indexes_lvl[i] ^ 1
                if i + 1 < len(indexes_lvl) and indexes_lvl[i + 1] == sibling_index:
                    i += 1
                else:
                    nodes[i].append(self._node_bytes(sibling_index))
                next_indexes.append(sibling_index >> 1)
                i += 1

        return BatchMerkleProof(leaves, nodes, self.depth, self.h)


def sharded_levels(leaves, hasher, mesh):
    """This rank's block of leaves -> (its subtree's levels, leaves first,
    ending at its subtree root; the levels above the ranks' subtree roots,
    the same on every rank): the subtree roots are all-gathered and merged
    on every rank (JAX ``sharded_segment_commit`` :118, ``assemble_levels``
    :173)."""
    sub = build_levels(leaves, hasher) if leaves.shape[0] > 1 else [leaves]
    return sub, build_levels(mesh.all_gather(sub[-1][0]), hasher)


class ShardedMerkleTree(MerkleTree):
    """A Merkle tree whose lower levels stay split across the ranks of a
    mesh (parallel/mesh.py): of every level up to the subtree roots, rank r
    holds the nodes above its block of leaves; the levels from the subtree
    roots up are on every rank (``sharded_levels``).  ``root()`` and
    ``prove_batch()`` are MerkleTree's; a batch proof fetches only the nodes
    it touches, each from the rank that holds it, in one all_gather of
    those nodes for the whole tree (JAX: the lazy ``MerkleTree`` gathers of
    sharded levels, :176-180).  Every rank must make the same calls in the
    same order, as it does in an SPMD prove."""

    def __init__(self, sub_levels, top_levels, hasher, mesh):
        self.mesh = mesh
        # levels below the subtree roots, each split across the ranks
        self.split = len(sub_levels) - 1
        super().__init__(list(sub_levels[:-1]) + list(top_levels), hasher)
        self.n = sub_levels[0].shape[0] * mesh.size

    def _fetch(self, level: int, idx: int) -> bytes:
        # prove_batch prefetches every digest it reads
        return self._fetch_cache[(level, idx)]

    def _prefetch_finish(self, per_level):
        if not sum(len(i) for i in per_level):
            return
        mesh = self.mesh
        device = self.levels[0].device
        parts, owners = [], []
        for level, idxs in enumerate(per_level[: self.split]):
            if not idxs:
                continue
            lvl = self.levels[level]
            pos = torch.as_tensor(idxs, dtype=torch.int64, device=device)
            owner = pos // lvl.shape[0]
            local = pos - owner * lvl.shape[0]
            mine = owner == mesh.rank
            sel = torch.zeros((len(idxs), lvl.shape[1]), dtype=lvl.dtype, device=device)
            sel[mine] = lvl.index_select(0, local[mine])
            parts.append(sel)
            owners.append(owner)
        rows = []
        if parts:
            owner = torch.cat(owners)
            gathered = mesh.all_gather(torch.cat(parts))  # (size, T, words)
            rows.append(gathered[owner, torch.arange(owner.numel(), device=device)])
        rows += [self.levels[level].index_select(
                     0, torch.as_tensor(idxs, dtype=torch.int64, device=device))
                 for level, idxs in enumerate(per_level) if level >= self.split and idxs]
        rows = torch.cat(rows).cpu().numpy()
        o = 0
        rows_per_level = []
        for idxs in per_level:
            rows_per_level.append(rows[o : o + len(idxs)])
            o += len(idxs)
        self._fill_fetch_cache(per_level, rows_per_level)


class BatchMerkleProof:
    """proofs.rs:31 — {leaves, nodes, depth}; all digests host bytes."""

    def __init__(self, leaves, nodes, depth: int, hasher):
        self.leaves = leaves
        self._nodes = nodes
        self.depth = depth
        self.h = hasher
        # contiguous serialized form kept by deserialize; sliced lazily
        self._node_blob = None
        self._node_counts = None

    @property
    def nodes(self):
        if self._nodes is None:
            D = self.h.DIGEST_BYTES
            blob, counts = self._node_blob, self._node_counts
            out, off = [], 0
            for c in counts:
                out.append(
                    [blob[off + i * D : off + (i + 1) * D] for i in range(c)]
                )
                off += c * D
            self._nodes = out
        return self._nodes

    @nodes.setter
    def nodes(self, v):
        self._nodes = v

    def get_root(self, indexes) -> bytes:
        """proofs.rs:135-268 — resolves the aggregated paths to a root: for
        the BLAKE3 hashers in one C call (``_native_root``) up to the C
        library's 4096 indexes and node vectors, else in python
        (``get_root_plain``)."""
        if not indexes:
            raise ValueError("too few indexes")
        if getattr(self.h, "NAME", None) in ("blake3_256", "blake3_192"):
            n_vec = (
                len(self._node_counts)
                if self._nodes is None and self._node_counts is not None
                else len(self.nodes)
            )
            if len(indexes) <= 4096 and n_vec <= 4096:  # B3_MAX_BATCH
                return self._native_root(indexes)
        return self.get_root_plain(indexes)

    def _native_root(self, indexes) -> bytes:
        """The BLAKE3 hashers' root in one C call (native/blake3_compress.c
        b3_batch_root, the same bookkeeping as ``get_root_plain``)."""
        from ..native import get_blake3

        D = self.h.DIGEST_BYTES
        leaves = b"".join(self.leaves)
        if len(leaves) != D * len(self.leaves):
            raise ValueError("invalid proof: bad leaf digest size")
        idx = np.asarray(list(indexes), dtype=np.uint64)
        if self._nodes is None and self._node_blob is not None:
            # deserialize kept the contiguous form: reuse it (lengths are
            # guaranteed by construction — read_bytes enforced count * D)
            node_data = self._node_blob
            counts = np.asarray(self._node_counts, dtype=np.int32)
        else:
            node_data = b"".join(d for vec in self.nodes for d in vec)
            counts = np.asarray([len(v) for v in self.nodes], dtype=np.int32)
            if any(len(d) != D for vec in self.nodes for d in vec):
                raise ValueError("invalid proof: bad node digest size")
        out = ctypes.create_string_buffer(D)
        rc = get_blake3().b3_batch_root(
            leaves, len(self.leaves), idx.ctypes.data, len(idx), node_data,
            counts.ctypes.data, len(counts), self.depth, D, out,
        )
        if rc != 0:
            raise ValueError(f"invalid proof (native check {rc})")
        return out.raw

    def get_root_plain(self, indexes) -> bytes:
        """``get_root`` in python: the path of the other hashers, and the
        plain version of ``_native_root``."""
        if not indexes:
            raise ValueError("too few indexes")
        index_map = _map_indexes(indexes, self.depth)
        norm = _normalize_indexes(indexes)
        if len(norm) != len(self.nodes):
            raise ValueError("invalid proof: node vector count mismatch")

        # merges within a tree level are independent — collect each level's
        # (left, right) pairs and hash them in ONE vectorized call (the
        # reference's per-node loop costs a full scalar hash dispatch per
        # node; proofs.rs:135-268 semantics are unchanged)
        v = {}
        offset = 1 << self.depth
        next_indexes = []
        proof_pointers = []
        pairs = []
        parent_indexes = []
        for i, index in enumerate(norm):
            if index in index_map:
                buf0 = self.leaves[index_map[index]]
                if (index + 1) in index_map:
                    buf1 = self.leaves[index_map[index + 1]]
                    proof_pointers.append(0)
                else:
                    if not self.nodes[i]:
                        raise ValueError("invalid proof")
                    buf1 = self.nodes[i][0]
                    proof_pointers.append(1)
            else:
                if not self.nodes[i]:
                    raise ValueError("invalid proof")
                buf0 = self.nodes[i][0]
                if (index + 1) in index_map:
                    buf1 = self.leaves[index_map[index + 1]]
                else:
                    raise ValueError("invalid proof")
                proof_pointers.append(1)

            pairs.append((buf0, buf1))
            parent_index = (offset + index) >> 1
            parent_indexes.append(parent_index)
            next_indexes.append(parent_index)
        for parent_index, parent in zip(parent_indexes, _merge_many(self.h, pairs)):
            v[parent_index] = parent

        for _ in range(1, self.depth):
            indexes_lvl = next_indexes
            next_indexes = []
            pairs = []
            parent_indexes = []
            i = 0
            while i < len(indexes_lvl):
                node_index = indexes_lvl[i]
                sibling_index = node_index ^ 1
                if i + 1 < len(indexes_lvl) and indexes_lvl[i + 1] == sibling_index:
                    sibling = v.get(sibling_index)
                    if sibling is None:
                        raise ValueError("invalid proof")
                    i += 1
                else:
                    ptr = proof_pointers[i]
                    if len(self.nodes[i]) <= ptr:
                        raise ValueError("invalid proof")
                    sibling = self.nodes[i][ptr]
                    proof_pointers[i] += 1

                node = v.get(node_index)
                if node is None:
                    raise ValueError("invalid proof")
                pairs.append((sibling, node) if node_index & 1 else (node, sibling))
                parent_indexes.append(node_index >> 1)
                next_indexes.append(node_index >> 1)
                i += 1
            for parent_index, parent in zip(parent_indexes, _merge_many(self.h, pairs)):
                v[parent_index] = parent

        root = v.get(1)
        if root is None:
            raise ValueError("invalid proof")
        return root

    # -- serialization (proofs.rs:425-500) ----------------------------------

    def serialize_nodes(self) -> bytes:
        out = bytearray()
        assert len(self.nodes) <= 255, "too many paths"
        out.append(len(self.nodes))
        for nodes in self.nodes:
            assert len(nodes) <= 255, "too many nodes"
            out.append(len(nodes))
            for node in nodes:
                out += node
        return bytes(out)

    @classmethod
    def deserialize(cls, reader, leaves, depth: int, hasher) -> "BatchMerkleProof":
        if depth == 0:
            raise ValueError("tree depth must be greater than zero")
        if not leaves or len(leaves) > 255:
            raise ValueError("invalid number of leaves")
        num_node_vectors = reader.read_u8()
        D = hasher.DIGEST_BYTES
        parts = []
        counts = []
        for _ in range(num_node_vectors):
            num_digests = reader.read_u8()
            parts.append(reader.read_bytes(num_digests * D))
            counts.append(num_digests)
        proof = cls(leaves, None, depth, hasher)
        proof._node_blob = b"".join(parts)
        proof._node_counts = counts
        return proof


def _merge_many(h, pairs):
    """Batched 2-to-1 merges (one vectorized hash call when supported)."""
    if not pairs:
        return []
    f = getattr(h, "merge_many", None)
    if f is not None:
        return f(pairs)
    return [h.merge(a, b) for a, b in pairs]


def verify_batch(root: bytes, indexes, proof: BatchMerkleProof) -> bool:
    # A malformed (attacker-supplied) proof with fewer leaves/node vectors
    # than positions raises IndexError/KeyError from the leaf/pointer lookups
    # below — treat any structural failure as a clean rejection.  Extra
    # unverified leaf rows are also rejected (malleability).
    try:
        if len(proof.leaves) != len(_map_indexes(indexes, proof.depth)):
            return False
        return proof.get_root(indexes) == root
    except (ValueError, IndexError, KeyError):
        return False


def _map_indexes(indexes, depth: int) -> dict:
    num_leaves = 1 << depth
    m = {}
    for i, index in enumerate(indexes):
        if index >= num_leaves:
            raise ValueError("leaf index out of bounds")
        m[index] = i
    if len(m) != len(indexes):
        raise ValueError("duplicate leaf index")
    return m


def _normalize_indexes(indexes):
    return sorted({i - (i & 1) for i in indexes})
