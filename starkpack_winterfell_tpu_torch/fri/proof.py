# Copy of starkpack_winterfell_tpu/fri/proof.py; cut: the non-BLAKE3 leaf hashing branches of FriProofLayer.parse.
"""FriProof / FriProofLayer — equivalent of fri/src/proof.rs.

Field-parameterized: pass a FieldSpec to use f62/f128 element widths; the
default is the f64 Goldilocks layout."""

from __future__ import annotations

from ..utils.serde import ByteWriter, SliceReader


def _field(field):
    if field is None:
        from ..math.fieldspec import GL64_SPEC as field
    return field


class FriProofLayer:
    """fri/src/proof.rs:232 — {values, paths} byte vectors."""

    def __init__(self, values: bytes, paths: bytes):
        self.values = values
        self.paths = paths

    @classmethod
    def new(cls, query_values, merkle_proof, ext_deg: int, field=None) -> "FriProofLayer":
        """query_values: list (per folded position) of N-element rows."""
        field = _field(field)
        assert query_values
        w = ByteWriter()
        for row in query_values:
            w.write_felts(row, field.ELEMENT_BYTES)
        return cls(w.to_bytes(), merkle_proof.serialize_nodes())

    def parse(self, hasher, domain_size: int, folding_factor: int, ext_deg: int,
              field=None):
        """proof.rs:281-334 — returns (flat query values, BatchMerkleProof)."""
        from ..crypto.merkle import BatchMerkleProof

        field = _field(field)
        elem_bytes = field.ELEMENT_BYTES * ext_deg
        num_query_bytes = elem_bytes * folding_factor
        if len(self.values) % num_query_bytes != 0:
            raise ValueError("invalid FRI layer value byte count")
        num_queries = len(self.values) // num_query_bytes
        if num_queries == 0:
            raise ValueError("a FRI layer must contain at least one query")
        r = SliceReader(self.values)
        # one slab decode for all queries (canonicity checked inside), then
        # regroup into per-position rows
        flat = r.read_felts(
            num_queries * folding_factor, ext_deg, field.P, field.ELEMENT_BYTES
        )
        rows = [
            flat[i * folding_factor : (i + 1) * folding_factor]
            for i in range(num_queries)
        ]
        # hash_elements of canonical elements == BLAKE3 of their LE bytes,
        # which is exactly this layer's value-byte rows
        from ..ops import blake3 as b3

        hashed = b3.hash_bytes_many(
            [
                self.values[i * num_query_bytes : (i + 1) * num_query_bytes]
                for i in range(num_queries)
            ],
            out_len=hasher.DIGEST_BYTES,
        )
        query_values = [e for row in rows for e in row]
        pr = SliceReader(self.paths)
        depth = domain_size.bit_length() - 1
        proof = BatchMerkleProof.deserialize(pr, hashed, depth, hasher)
        if pr.has_more():
            raise ValueError("unconsumed FRI path bytes")
        return query_values, proof

    def write_into(self, w: ByteWriter):
        w.write_u32(len(self.values))
        w.write_bytes(self.values)
        w.write_u32(len(self.paths))
        w.write_bytes(self.paths)

    @classmethod
    def read_from(cls, r: SliceReader) -> "FriProofLayer":
        nv = r.read_u32()
        if nv == 0:
            raise ValueError("a FRI proof layer must contain at least one evaluation")
        values = r.read_bytes(nv)
        np_ = r.read_u32()
        paths = r.read_bytes(np_)
        return cls(values, paths)


class FriProof:
    """fri/src/proof.rs:32 — num_partitions stored as a power of two."""

    def __init__(self, layers, remainder: bytes, num_partitions_log: int):
        self.layers = layers
        self.remainder = remainder
        self.num_partitions_log = num_partitions_log

    @classmethod
    def new(cls, layers, remainder_elements, num_partitions: int, field=None) -> "FriProof":
        field = _field(field)
        assert remainder_elements
        n = len(remainder_elements)
        assert n & (n - 1) == 0, "remainder size must be a power of two"
        assert num_partitions > 0 and num_partitions & (num_partitions - 1) == 0
        w = ByteWriter()
        w.write_felts(remainder_elements, field.ELEMENT_BYTES)
        return cls(layers, w.to_bytes(), (num_partitions.bit_length() - 1))

    def num_layers(self) -> int:
        return len(self.layers)

    def num_partitions(self) -> int:
        return 1 << self.num_partitions_log

    def num_remainder_elements(self, ext_deg: int, field=None) -> int:
        field = _field(field)
        return len(self.remainder) // (field.ELEMENT_BYTES * ext_deg)

    def parse_remainder(self, ext_deg: int, field=None):
        field = _field(field)
        n = self.num_remainder_elements(ext_deg, field)
        if n & (n - 1) != 0:
            raise ValueError("number of remainder values must be a power of two")
        r = SliceReader(self.remainder)
        out = r.read_felts(n, ext_deg, field.P, field.ELEMENT_BYTES)
        if r.has_more():
            raise ValueError("unconsumed remainder bytes")
        return out

    def parse_layers(self, hasher, domain_size: int, folding_factor: int, ext_deg: int,
                     field=None):
        layer_queries = []
        layer_proofs = []
        for layer in self.layers:
            domain_size //= folding_factor
            qv, mp = layer.parse(hasher, domain_size, folding_factor, ext_deg, field)
            layer_queries.append(qv)
            layer_proofs.append(mp)
        return layer_queries, layer_proofs

    def write_into(self, w: ByteWriter):
        w.write_u8(len(self.layers))
        for layer in self.layers:
            layer.write_into(w)
        w.write_u16(len(self.remainder))
        w.write_bytes(self.remainder)
        w.write_u8(self.num_partitions_log)

    @classmethod
    def read_from(cls, r: SliceReader) -> "FriProof":
        num_layers = r.read_u8()
        layers = [FriProofLayer.read_from(r) for _ in range(num_layers)]
        nr = r.read_u16()
        remainder = r.read_bytes(nr)
        num_partitions_log = r.read_u8()
        return cls(layers, remainder, num_partitions_log)

    def __eq__(self, other):
        if not isinstance(other, FriProof):
            return NotImplemented
        w1, w2 = ByteWriter(), ByteWriter()
        self.write_into(w1)
        other.write_into(w2)
        return w1.to_bytes() == w2.to_bytes()
