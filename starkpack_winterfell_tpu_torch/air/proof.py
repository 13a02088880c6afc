# Copy of starkpack_winterfell_tpu/air/proof.py; cut: nothing.
"""Proof structures with byte-exact serialization — equivalent of
air/src/proof/{mod,context,commitments,queries,ood_frame,table}.rs.

All field elements are host ints (base) / tuples (extension components), and
are serialized as canonical 8-byte little-endian words per component.
"""

from __future__ import annotations

from ..errors import DeserializationError
from ..utils.serde import ByteWriter, SliceReader
from .options import ProofOptions
from .trace_info import TraceInfo, TraceLayout

MODULUS_BYTES = (0xFFFFFFFF00000001).to_bytes(8, "little")


def _field(field):
    if field is None:
        from ..math.fieldspec import GL64_SPEC as field
    return field


def _parse_felt_words(values: bytes, num_rows: int, row_width: int, ext_deg: int,
                      spec):
    """Decode serialized query values into a (num_rows, row_width,
    ext_deg*limbs) u32 word array in one numpy pass, with a vectorized
    canonicity check (every component < modulus) — the bulk equivalent of
    SliceReader.read_felt's per-element validation."""
    import numpy as np

    nl = spec.ELEMENT_BYTES // 4
    words = np.frombuffer(values, dtype="<u4").astype(np.uint32)
    comps = words.reshape(-1, nl)
    p_limbs = [(spec.P >> (32 * i)) & 0xFFFFFFFF for i in range(nl)]
    lt = None  # component < P, built top limb down
    for li in range(nl - 1, -1, -1):
        c = comps[:, li]
        pl = np.uint32(p_limbs[li])
        if lt is None:
            lt = c < pl
            eq = c == pl
        else:
            lt = lt | (eq & (c < pl))
            eq = eq & (c == pl)
    if not bool(lt.all()):
        raise ValueError("invalid field element >= modulus")
    return words.reshape(num_rows, row_width, ext_deg * nl)


class Context:
    """air/src/proof/context.rs:17."""

    def __init__(self, trace_layout: TraceLayout, trace_length: int, trace_meta: bytes,
                 field_modulus_bytes: bytes, options: ProofOptions):
        self.trace_layout = trace_layout
        self.trace_length = trace_length
        self.trace_meta = trace_meta
        self.field_modulus_bytes = field_modulus_bytes
        self.options = options

    @classmethod
    def new(cls, trace_info: TraceInfo, options: ProofOptions, field=None) -> "Context":
        return cls(
            trace_info.layout, trace_info.length, trace_info.meta,
            _field(field).get_modulus_le_bytes(), options,
        )

    def get_trace_info(self) -> TraceInfo:
        return TraceInfo.new_multi_segment(
            self.trace_layout, self.trace_length, self.trace_meta
        )

    def lde_domain_size(self) -> int:
        return self.trace_length * self.options.blowup_factor

    def num_modulus_bits(self) -> int:
        v = int.from_bytes(self.field_modulus_bytes, "little")
        return v.bit_length()

    def to_elements(self):
        """context.rs:97-134 — transcript seed elements."""
        result = list(self.trace_layout.to_elements())
        nb = len(self.field_modulus_bytes)
        m1 = self.field_modulus_bytes[: nb // 2]
        m2 = self.field_modulus_bytes[nb // 2 :]
        result.append(_bytes_to_element(m1))
        result.append(_bytes_to_element(m2))
        result.extend(self.options.to_elements())
        result.append(self.trace_length)
        if self.trace_meta:
            chunk = len(self.field_modulus_bytes) - 1  # ELEMENT_BYTES - 1
            for i in range(0, len(self.trace_meta), chunk):
                result.append(_bytes_to_element(self.trace_meta[i : i + chunk]))
        return result

    def write_into(self, w: ByteWriter):
        self.trace_layout.write_into(w)
        w.write_u8(self.trace_length.bit_length() - 1)
        w.write_u16(len(self.trace_meta))
        w.write_bytes(self.trace_meta)
        w.write_u8(len(self.field_modulus_bytes))
        w.write_bytes(self.field_modulus_bytes)
        self.options.write_into(w)

    @classmethod
    def read_from(cls, r: SliceReader) -> "Context":
        layout = TraceLayout.read_from(r)
        log_len = r.read_u8()
        # proof-derived values: explicit raises (not asserts) so hostile
        # inputs are rejected deterministically even under python -O
        if not 3 <= log_len <= 32:
            raise DeserializationError("invalid trace length exponent")
        trace_length = 1 << log_len
        num_meta = r.read_u16()
        meta = r.read_bytes(num_meta) if num_meta else b""
        num_mod = r.read_u8()
        if num_mod == 0:
            raise DeserializationError("field modulus cannot be empty")
        modulus = r.read_bytes(num_mod)
        options = ProofOptions.read_from(r)
        return cls(layout, trace_length, meta, modulus, options)

    def __eq__(self, other):
        return isinstance(other, Context) and (
            self.trace_layout,
            self.trace_length,
            self.trace_meta,
            self.field_modulus_bytes,
        ) == (
            other.trace_layout,
            other.trace_length,
            other.trace_meta,
            other.field_modulus_bytes,
        ) and self.options == other.options


def _bytes_to_element(b: bytes) -> int:
    """Interpret bytes as a LE integer; always fits the field since callers
    pass at most ELEMENT_BYTES/2 (modulus halves) or ELEMENT_BYTES-1 bytes
    (context.rs:117-131)."""
    return int.from_bytes(b, "little")


class Commitments:
    """air/src/proof/commitments.rs:25 — all roots in one byte vector."""

    def __init__(self, data: bytes = b""):
        self.data = bytearray(data)

    def add(self, commitment: bytes):
        self.data += commitment

    def parse(self, digest_bytes: int, num_trace_segments: int, num_fri_layers: int):
        r = SliceReader(bytes(self.data))
        trace = [r.read_bytes(digest_bytes) for _ in range(num_trace_segments)]
        constraint = r.read_bytes(digest_bytes)
        fri = [r.read_bytes(digest_bytes) for _ in range(num_fri_layers + 1)]
        if r.has_more():
            raise ValueError("unconsumed commitment bytes")
        return trace, constraint, fri

    def write_into(self, w: ByteWriter):
        assert len(self.data) < 65535
        w.write_u16(len(self.data))
        w.write_bytes(bytes(self.data))

    @classmethod
    def read_from(cls, r: SliceReader) -> "Commitments":
        n = r.read_u16()
        return cls(r.read_bytes(n))

    def __eq__(self, other):
        return isinstance(other, Commitments) and self.data == other.data


class Table:
    """air/src/proof/table.rs:25 — row-major element table.

    Parsed query tables are backed by a u32 word array (``words``, shape
    (rows, cols, ext_deg * limbs)); python-int rows materialize lazily so
    the verifier's bulk consumers (DeepComposer) can read limb planes
    directly without a per-element int round trip."""

    def __init__(self, rows):
        """rows: list of lists of elements (ints/tuples)."""
        self._data = [list(row) for row in rows]
        self.words = None
        self._ext_deg = 1

    @classmethod
    def from_words(cls, words, ext_deg: int):
        t = cls.__new__(cls)
        t._data = None
        t.words = words
        t._ext_deg = ext_deg
        return t

    @property
    def data(self):
        if self._data is None:
            q, w, k = self.words.shape
            nl = k // self._ext_deg
            flat = self.words.reshape(q * w * self._ext_deg, nl)
            vals = [0] * flat.shape[0]
            cols = [flat[:, li].tolist() for li in range(nl)]
            for li in range(nl):
                shift = 32 * li
                col = cols[li]
                if li == 0:
                    vals = list(col)
                else:
                    vals = [v | (c << shift) for v, c in zip(vals, col)]
            if self._ext_deg > 1:
                d = self._ext_deg
                vals = [
                    tuple(vals[i * d + c] for c in range(d))
                    for i in range(q * w)
                ]
            self._data = [vals[r * w : (r + 1) * w] for r in range(q)]
        return self._data

    def num_rows(self) -> int:
        return self.words.shape[0] if self.words is not None else len(self._data)

    def num_columns(self) -> int:
        if self.words is not None:
            return self.words.shape[1]
        return len(self._data[0]) if self._data else 0

    def rows(self):
        return iter(self.data)

    def row(self, i):
        return self.data[i]


class Queries:
    """air/src/proof/queries.rs:31 — single-matrix decommitments."""

    def __init__(self, paths: bytes, values: bytes):
        self.paths = paths
        self.values = values

    @classmethod
    def new(cls, merkle_proof, query_values, ext_deg: int, field=None) -> "Queries":
        """query_values: list (per query) of lists of elements."""
        assert query_values, "query values cannot be empty"
        epq = len(query_values[0])
        assert epq > 0
        eb = _field(field).ELEMENT_BYTES
        w = ByteWriter()
        for elements in query_values:
            assert len(elements) == epq
            w.write_felts(elements, eb)
        return cls(merkle_proof.serialize_nodes(), w.to_bytes())

    def parse(self, hasher, domain_size: int, num_queries: int, values_per_query: int,
              ext_deg: int, field=None):
        from ..crypto.merkle import BatchMerkleProof

        spec = _field(field)
        elem_bytes = spec.ELEMENT_BYTES * ext_deg
        expected = num_queries * values_per_query * elem_bytes
        if len(self.values) != expected:
            raise ValueError(
                f"expected {expected} query value bytes, but was {len(self.values)}"
            )
        words = _parse_felt_words(
            self.values, num_queries, values_per_query, ext_deg, spec
        )
        table = Table.from_words(words, ext_deg)
        digests = hasher.hash_words(
            words.reshape(num_queries, -1),
            values_per_query * ext_deg * spec.ELEMENT_BYTES,
        )
        hashed = [hasher.digest_to_bytes(digests[i]) for i in range(num_queries)]
        pr = SliceReader(self.paths)
        depth = domain_size.bit_length() - 1
        proof = BatchMerkleProof.deserialize(pr, hashed, depth, hasher)
        if pr.has_more():
            raise ValueError("unconsumed path bytes")
        return proof, table

    def write_into(self, w: ByteWriter):
        w.write_u32(len(self.values))
        w.write_bytes(self.values)
        w.write_u32(len(self.paths))
        w.write_bytes(self.paths)

    @classmethod
    def read_from(cls, r: SliceReader) -> "Queries":
        nv = r.read_u32()
        values = r.read_bytes(nv)
        np_ = r.read_u32()
        paths = r.read_bytes(np_)
        return cls(paths, values)

    def __eq__(self, other):
        return (
            isinstance(other, Queries)
            and self.paths == other.paths
            and self.values == other.values
        )


class JointTraceQueries:
    """air/src/proof/queries.rs:173 — StarkPack joint rows.  Serialization
    writes only values+paths; value_vec is dropped (queries.rs:327-359)."""

    def __init__(self, paths: bytes, values: bytes, value_vec=None):
        self.paths = paths
        self.values = values
        self.value_vec = value_vec if value_vec is not None else [b""]

    @classmethod
    def new(cls, merkle_proof, query_values, query_value_vec, field=None) -> "JointTraceQueries":
        assert query_values
        epq = len(query_values[0])
        eb = _field(field).ELEMENT_BYTES
        w = ByteWriter()
        for elements in query_values:
            assert len(elements) == epq
            w.write_felts(elements, eb)
        value_vec = []
        for per_trace in query_value_vec:
            wv = ByteWriter()
            for elements in per_trace:
                wv.write_felts(elements, eb)
            value_vec.append(wv.to_bytes())
        return cls(merkle_proof.serialize_nodes(), w.to_bytes(), value_vec)

    def parse(self, hasher, domain_size: int, num_queries: int, values_per_query_vec,
              ext_deg: int, field=None):
        """Returns (BatchMerkleProof, joint Table, [per-trace Table]).
        Joint rows are re-split by widths (queries.rs:263-324); element type
        for the main segment is the base field (ext_deg=1)."""
        from ..crypto.merkle import BatchMerkleProof

        spec = _field(field)
        total = sum(values_per_query_vec)
        elem_bytes = spec.ELEMENT_BYTES * ext_deg
        expected = num_queries * total * elem_bytes
        if len(self.values) != expected:
            raise ValueError(
                f"expected {expected} query value bytes, but was {len(self.values)}"
            )
        words = _parse_felt_words(self.values, num_queries, total, ext_deg, spec)
        joint = Table.from_words(words, ext_deg)
        digests = hasher.hash_words(
            words.reshape(num_queries, -1), total * ext_deg * spec.ELEMENT_BYTES
        )
        hashed = [hasher.digest_to_bytes(digests[i]) for i in range(num_queries)]
        pr = SliceReader(self.paths)
        depth = domain_size.bit_length() - 1
        proof = BatchMerkleProof.deserialize(pr, hashed, depth, hasher)
        if pr.has_more():
            raise ValueError("unconsumed path bytes")
        # re-split joint rows into per-trace tables (column slices of the
        # shared word array — no element copies)
        tables = []
        off = 0
        for width in values_per_query_vec:
            tables.append(
                Table.from_words(words[:, off : off + width], ext_deg)
            )
            off += width
        return proof, joint, tables

    def write_into(self, w: ByteWriter):
        w.write_u32(len(self.values))
        w.write_bytes(self.values)
        w.write_u32(len(self.paths))
        w.write_bytes(self.paths)

    @classmethod
    def read_from(cls, r: SliceReader) -> "JointTraceQueries":
        nv = r.read_u32()
        values = r.read_bytes(nv)
        np_ = r.read_u32()
        paths = r.read_bytes(np_)
        return cls(paths, values, [b""])

    def __eq__(self, other):
        return (
            isinstance(other, JointTraceQueries)
            and self.paths == other.paths
            and self.values == other.values
        )


class OodFrame:
    """air/src/proof/ood_frame.rs:31."""

    def __init__(self, trace_states: bytes = b"", evaluations: bytes = b""):
        self.trace_states = trace_states
        self.evaluations = evaluations

    def set_trace_states(self, trace_states, field=None):
        """trace_states: [current_row, next_row], each a list of elements.
        Returns the interleaved element vector used to reseed the coin once
        (ood_frame.rs:46-67)."""
        assert not self.trace_states, "trace states have already been set"
        frame_size = len(trace_states)
        width = len(trace_states[0])
        result = []
        for i in range(width):
            for row in trace_states:
                result.append(row[i])
        w = ByteWriter()
        w.write_u8(frame_size)
        w.write_felts(result, _field(field).ELEMENT_BYTES)
        self.trace_states = w.to_bytes()
        return result

    def set_constraint_evaluations(self, evaluations, field=None):
        assert not self.evaluations, "constraint evaluations have already been set"
        assert evaluations
        w = ByteWriter()
        w.write_felts(evaluations, _field(field).ELEMENT_BYTES)
        self.evaluations = w.to_bytes()

    def parse(self, main_trace_width: int, aux_trace_width: int, num_evaluations: int,
              ext_deg: int, field=None):
        """Returns (interleaved trace element vector, evaluations vector)."""
        spec = _field(field)
        r = SliceReader(self.trace_states)
        frame_size = r.read_u8()
        trace = r.read_felts(
            (main_trace_width + aux_trace_width) * frame_size, ext_deg,
            spec.P, spec.ELEMENT_BYTES,
        )
        if r.has_more():
            raise ValueError("unconsumed ood trace bytes")
        r = SliceReader(self.evaluations)
        evaluations = r.read_felts(num_evaluations, ext_deg, spec.P, spec.ELEMENT_BYTES)
        if r.has_more():
            raise ValueError("unconsumed ood evaluation bytes")
        return trace, evaluations

    def write_into(self, w: ByteWriter):
        w.write_u16(len(self.trace_states))
        w.write_bytes(self.trace_states)
        w.write_u16(len(self.evaluations))
        w.write_bytes(self.evaluations)

    @classmethod
    def read_from(cls, r: SliceReader) -> "OodFrame":
        nt = r.read_u16()
        trace_states = r.read_bytes(nt)
        ne = r.read_u16()
        evaluations = r.read_bytes(ne)
        return cls(trace_states, evaluations)

    def __eq__(self, other):
        return (
            isinstance(other, OodFrame)
            and self.trace_states == other.trace_states
            and self.evaluations == other.evaluations
        )


class StarkProof:
    """air/src/proof/mod.rs:52 — the StarkPack-shaped aggregated proof."""

    def __init__(self, contexts, commitments, trace_queries, constraint_queries,
                 ood_frames, fri_proof, pow_nonce: int):
        self.contexts = contexts
        self.commitments = commitments
        self.trace_queries = trace_queries
        self.constraint_queries = constraint_queries
        self.ood_frames = ood_frames
        self.fri_proof = fri_proof
        self.pow_nonce = pow_nonce

    def options(self, i: int = 0) -> ProofOptions:
        return self.contexts[i].options

    def trace_length(self, i: int = 0) -> int:
        return self.contexts[i].trace_length

    def lde_domain_size(self, i: int = 0) -> int:
        return self.contexts[i].lde_domain_size()

    def to_bytes(self) -> bytes:
        """mod.rs:133-147 — contexts, commitments, trace_queries,
        constraint_queries, ood_frames, fri, nonce-LE."""
        w = ByteWriter()
        for context in self.contexts:
            context.write_into(w)
        self.commitments.write_into(w)
        for tq in self.trace_queries:
            tq.write_into(w)
        self.constraint_queries.write_into(w)
        for ood in self.ood_frames:
            ood.write_into(w)
        self.fri_proof.write_into(w)
        w.write_bytes(self.pow_nonce.to_bytes(8, "little"))
        return w.to_bytes()

    def from_bytes(self, source: bytes) -> "StarkProof":
        """Instance method needing `self` for the vector counts
        (mod.rs:153-195 — a fork wart kept for parity)."""
        from ..fri.proof import FriProof

        r = SliceReader(source)
        contexts = [Context.read_from(r) for _ in self.contexts]
        commitments = Commitments.read_from(r)
        num_trace_segments = contexts[0].trace_layout.num_segments()
        trace_queries = [JointTraceQueries.read_from(r) for _ in range(num_trace_segments)]
        constraint_queries = Queries.read_from(r)
        ood_frames = [OodFrame.read_from(r) for _ in self.ood_frames]
        fri_proof = FriProof.read_from(r)
        pow_nonce = r.read_u64()
        if r.has_more():
            raise ValueError("unconsumed proof bytes")
        return StarkProof(
            contexts, commitments, trace_queries, constraint_queries, ood_frames,
            fri_proof, pow_nonce,
        )

    def security_level_conjectured(self, hash_collision_resistance: int = 128) -> int:
        """Conjectured security estimate (proof/mod.rs:202-225)."""
        options = self.contexts[0].options
        base_field_bits = self.contexts[0].num_modulus_bits()
        field_size = base_field_bits * options.field_extension
        trace_length = self.trace_length(0)
        field_security = field_size - (trace_length.bit_length() - 1)
        query_security = options.num_queries * (options.blowup_factor.bit_length() - 1)
        if query_security >= 80:  # GRINDING_CONTRIBUTION_FLOOR (proof/mod.rs:35)
            query_security += options.grinding_factor
        return min(min(field_security, query_security) - 1, hash_collision_resistance)

    def security_level_proven(self, hash_collision_resistance: int = 128) -> int:
        """Proven security per eprint 2021/582 + 2022/1216
        (proof/mod.rs:227-284)."""
        import math

        options = self.contexts[0].options
        base_field_bits = self.contexts[0].num_modulus_bits()
        trace_domain_size = self.trace_length(0)
        lde_domain_size = self.lde_domain_size(0)

        ext_bits = float(base_field_bits * options.field_extension)
        blowup_bits = float(options.blowup_factor.bit_length() - 1)
        num_queries = float(options.num_queries)
        lde_size_bits = float(lde_domain_size.bit_length() - 1)
        blowup_plus_bits = math.log2(lde_domain_size / (trace_domain_size + 2.0))

        m = ext_bits + 1.0
        m -= options.grinding_factor
        m -= 1.5 * blowup_bits
        m -= 0.5 * num_queries * blowup_plus_bits
        m -= 2.0 * lde_size_bits
        m /= 7.0
        m = 2.0**m
        m -= 0.5
        m = max(m, 3.0)

        pre_query_security = int(
            ext_bits + 1.0 - 1.5 * blowup_bits - 2.0 * lde_size_bits
            - 7.0 * math.log2(m + 0.5)
        )
        security_per_query = 0.5 * blowup_plus_bits - math.log2(1.0 + 1.0 / (2.0 * m))
        query_security = int(security_per_query * num_queries) + options.grinding_factor
        return min(min(pre_query_security, query_security) - 1, hash_collision_resistance)

    def __eq__(self, other):
        return isinstance(other, StarkProof) and self.to_bytes() == other.to_bytes()
