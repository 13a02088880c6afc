"""Winterfell's proof bytes, as the StarkPack fork writes them, parsed in
plain Python: the proof's contexts, commitments, queried rows with their
batch Merkle proofs, out-of-domain frames, FRI layers and remainder, and the
proof-of-work nonce; and the BLAKE3 hashers that commit to them."""

from __future__ import annotations

from .blake3 import hash_bytes


class Rejected(Exception):
    """The proof is not a proof of the statement under the configuration."""


class Blake3Hasher:
    """BLAKE3 with a ``digest_bytes``-byte output (32: BLAKE3-256, 24:
    BLAKE3-192).  Field elements are hashed as their canonical
    little-endian bytes, ``element_bytes`` each."""

    def __init__(self, digest_bytes: int):
        self.DIGEST_BYTES = digest_bytes

    def hash(self, data: bytes) -> bytes:
        return hash_bytes(data, self.DIGEST_BYTES)

    def merge(self, a: bytes, b: bytes) -> bytes:
        return self.hash(a + b)

    def merge_with_int(self, seed: bytes, value: int) -> bytes:
        return self.hash(seed + (value & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"))

    def hash_elements(self, elements, element_bytes: int) -> bytes:
        """``element_bytes`` a base-field component; an extension element is
        hashed as its components in turn."""
        return self.hash(b"".join(int(c).to_bytes(element_bytes, "little") for e in elements
                                  for c in (e.components() if hasattr(e, "components") else (e,))))


HASHERS = {"blake3_256": Blake3Hasher(32), "blake3_192": Blake3Hasher(24)}


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise Rejected(f"proof ends early: {n} bytes wanted at {self.pos}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return int.from_bytes(self.take(2), "little")

    def u32(self) -> int:
        return int.from_bytes(self.take(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def sized(self, width) -> bytes:
        return self.take(width())

    def done(self) -> bool:
        return self.pos == len(self.data)


def elements(data: bytes, field) -> list:
    """Canonical little-endian field elements of ``data``: of a prime field,
    or of a ``field.ExtensionField``, each element its components in turn."""
    eb = field.ELEMENT_BYTES
    if len(data) % eb:
        raise Rejected("element bytes are not a whole number of elements")
    base = getattr(field, "base", field)
    cb = base.ELEMENT_BYTES
    out = [int.from_bytes(data[i:i + cb], "little") for i in range(0, len(data), cb)]
    if any(v >= field.P for v in out):
        raise Rejected("a field element is not canonical")
    d = getattr(field, "DEGREE", 1)
    return out if d == 1 else [field.element(out[i:i + d]) for i in range(0, len(out), d)]


class Options:
    """The six proof options, in the order the proof writes them."""

    FIELDS = ("num_queries", "blowup_factor", "grinding_factor", "field_extension",
              "fri_folding_factor", "fri_remainder_max_degree")

    def __init__(self, values):
        for name, v in zip(self.FIELDS, values):
            setattr(self, name, int(v))

    def as_tuple(self):
        return tuple(getattr(self, name) for name in self.FIELDS)

    def to_elements(self):
        packed = (self.field_extension << 16) | (self.fri_folding_factor << 8) \
            | self.fri_remainder_max_degree
        return [packed, self.grinding_factor, self.blowup_factor, self.num_queries]


class Context:
    def __init__(self, r: Reader):
        self.main_width = r.u8()
        self.aux_width = r.u8()
        self.aux_rands = r.u8()
        log_len = r.u8()
        if not 3 <= log_len <= 32:
            raise Rejected("invalid trace length exponent")
        self.trace_length = 1 << log_len
        self.meta = r.take(r.u16())
        self.modulus_bytes = r.take(r.u8())
        self.options = Options(r.take(6))

    def key(self):
        return (self.main_width, self.aux_width, self.aux_rands, self.trace_length,
                self.meta, self.modulus_bytes, self.options.as_tuple())

    def to_elements(self, field):
        """The context's part of the Fiat-Shamir seed."""
        half = len(self.modulus_bytes) // 2
        out = [self.main_width << 8]  # no auxiliary segment
        out += [int.from_bytes(self.modulus_bytes[:half], "little"),
                int.from_bytes(self.modulus_bytes[half:], "little")]
        out += self.options.to_elements()
        out.append(self.trace_length)
        chunk = field.ELEMENT_BYTES - 1
        out += [int.from_bytes(self.meta[i:i + chunk], "little")
                for i in range(0, len(self.meta), chunk)]
        return out


class StarkProof:
    """One aggregated proof of ``n`` instances."""

    def __init__(self, data: bytes, n: int):
        r = Reader(data)
        self.contexts = [Context(r) for _ in range(n)]
        self.commitments = r.take(r.u16())
        if self.contexts[0].aux_width:
            raise Rejected("the configuration's AIR has no auxiliary segment")
        self.trace_values = r.take(r.u32())
        self.trace_paths = r.take(r.u32())
        self.constraint_values = r.take(r.u32())
        self.constraint_paths = r.take(r.u32())
        self.ood = [(r.take(r.u16()), r.take(r.u16())) for _ in range(n)]
        self.fri_layers = []
        for _ in range(r.u8()):
            values = r.take(r.u32())
            if not values:
                raise Rejected("an empty FRI layer")
            self.fri_layers.append((values, r.take(r.u32())))
        self.fri_remainder = r.take(r.u16())
        self.fri_partitions_log = r.u8()
        self.pow_nonce = r.u64()
        if not r.done():
            raise Rejected("bytes left after the proof")


def merkle_root(hasher, leaves, indexes, paths: bytes, depth: int) -> bytes:
    """The root that a batch Merkle proof (Winterfell's BatchMerkleProof:
    node vectors of the normalised leaf pairs) gives for ``leaves`` at
    ``indexes``; raises Rejected for a malformed proof."""
    r = Reader(paths)
    D = hasher.DIGEST_BYTES
    nodes = [[r.take(D) for _ in range(r.u8())] for _ in range(r.u8())]
    if not r.done():
        raise Rejected("bytes left after a Merkle proof")
    if depth == 0 or not leaves or len(leaves) != len(indexes):
        raise Rejected("malformed Merkle proof")
    index_map = {}
    for i, index in enumerate(indexes):
        if index >= 1 << depth or index in index_map:
            raise Rejected("a Merkle leaf index is out of range or repeated")
        index_map[index] = i
    norm = sorted({i - (i & 1) for i in indexes})
    if len(norm) != len(nodes):
        raise Rejected("Merkle node vector count mismatch")
    v = {}
    pointers = []
    level = []
    for i, index in enumerate(norm):
        try:
            if index in index_map:
                left = leaves[index_map[index]]
                if index + 1 in index_map:
                    right = leaves[index_map[index + 1]]
                    pointers.append(0)
                else:
                    right = nodes[i][0]
                    pointers.append(1)
            else:
                left = nodes[i][0]
                right = leaves[index_map[index + 1]]
                pointers.append(1)
        except (IndexError, KeyError):
            raise Rejected("malformed Merkle proof") from None
        parent = ((1 << depth) + index) >> 1
        v[parent] = hasher.merge(left, right)
        level.append(parent)
    for _ in range(1, depth):
        nxt = []
        i = 0
        while i < len(level):
            node_index = level[i]
            sibling_index = node_index ^ 1
            if i + 1 < len(level) and level[i + 1] == sibling_index:
                sibling = v[sibling_index]
                i += 1
            else:
                if len(nodes[i]) <= pointers[i]:
                    raise Rejected("malformed Merkle proof")
                sibling = nodes[i][pointers[i]]
                pointers[i] += 1
            node = v[node_index]
            pair = (sibling, node) if node_index & 1 else (node, sibling)
            v[node_index >> 1] = hasher.merge(*pair)
            nxt.append(node_index >> 1)
            i += 1
        level = nxt
    if 1 not in v:
        raise Rejected("malformed Merkle proof")
    return v[1]
