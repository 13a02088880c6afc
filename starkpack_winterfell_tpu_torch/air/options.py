# Copy of starkpack_winterfell_tpu/air/options.py; cut: nothing.
"""ProofOptions / FieldExtension — equivalent of air/src/options.rs."""

from __future__ import annotations

from ..errors import DeserializationError
from ..utils.serde import ByteWriter, SliceReader


class FieldExtension:
    NONE = 1
    QUADRATIC = 2
    CUBIC = 3


class ProofOptions:
    """air/src/options.rs:78 — validation bounds at options.rs:17-27."""

    MIN_BLOWUP_FACTOR = 2

    def __init__(
        self,
        num_queries: int,
        blowup_factor: int,
        grinding_factor: int,
        field_extension: int = FieldExtension.NONE,
        fri_folding_factor: int = 8,
        fri_remainder_max_degree: int = 255,
    ):
        # explicit raises (not asserts): ProofOptions is also built from
        # untrusted proof bytes via read_from, and asserts vanish under -O.
        # DeserializationError subclasses ValueError so from_bytes/verify
        # rejection paths catch it.
        if not 0 < num_queries <= 255:
            raise DeserializationError("number of queries must be in (0, 255]")
        if blowup_factor & (blowup_factor - 1) != 0 or not 2 <= blowup_factor <= 128:
            raise DeserializationError(
                "blowup factor must be a power of two in [2, 128]"
            )
        if not 0 <= grinding_factor <= 32:
            raise DeserializationError("grinding factor must be in [0, 32]")
        if field_extension not in (1, 2, 3):
            raise DeserializationError("invalid field extension")
        if fri_folding_factor not in (2, 4, 8, 16):
            raise DeserializationError("FRI folding factor must be 2, 4, 8 or 16")
        if (
            fri_remainder_max_degree + 1
        ) & fri_remainder_max_degree != 0 or fri_remainder_max_degree > 255:
            raise DeserializationError(
                "FRI remainder max degree must be one less than a power of two, <= 255"
            )
        self.num_queries = num_queries
        self.blowup_factor = blowup_factor
        self.grinding_factor = grinding_factor
        self.field_extension = field_extension
        self.fri_folding_factor = fri_folding_factor
        self.fri_remainder_max_degree = fri_remainder_max_degree

    @property
    def extension_degree(self) -> int:
        return self.field_extension

    def domain_offset(self, field=None) -> int:
        """The field's primitive element (options.rs:199-201)."""
        if field is None:
            return 7  # GENERATOR of f64
        return field.GENERATOR

    def to_fri_options(self, field=None):
        from ..fri.options import FriOptions

        return FriOptions(
            self.blowup_factor, self.fri_folding_factor,
            self.fri_remainder_max_degree, field=field,
        )

    def to_elements(self):
        """options.rs:211-225 — ext/folding/remainder packed into one element."""
        buf = self.field_extension
        buf = (buf << 8) | self.fri_folding_factor
        buf = (buf << 8) | self.fri_remainder_max_degree
        return [buf, self.grinding_factor, self.blowup_factor, self.num_queries]

    def write_into(self, w: ByteWriter):
        w.write_u8(self.num_queries)
        w.write_u8(self.blowup_factor)
        w.write_u8(self.grinding_factor)
        w.write_u8(self.field_extension)
        w.write_u8(self.fri_folding_factor)
        w.write_u8(self.fri_remainder_max_degree)

    @classmethod
    def read_from(cls, r: SliceReader) -> "ProofOptions":
        return cls(
            r.read_u8(), r.read_u8(), r.read_u8(), r.read_u8(), r.read_u8(), r.read_u8()
        )

    def __eq__(self, other):
        return isinstance(other, ProofOptions) and self.__dict__ == other.__dict__
