# Copy of starkpack_winterfell_tpu/fri/options.py; cut: nothing.
"""FRI options — equivalent of fri/src/options.rs."""

from __future__ import annotations


class FriOptions:
    def __init__(self, blowup_factor: int, folding_factor: int, remainder_max_degree: int,
                 field=None):
        assert blowup_factor & (blowup_factor - 1) == 0
        assert folding_factor in (2, 4, 8, 16)
        self.blowup_factor = blowup_factor
        self.folding_factor = folding_factor
        self.remainder_max_degree = remainder_max_degree
        self.field = field  # FieldSpec; None = f64

    def domain_offset(self) -> int:
        """The field's GENERATOR (options.rs:50-54) — parameterized by the
        field spec so f62/f128 callers fold over the right coset (their
        generator is 3, not 7)."""
        if self.field is None:
            return 7  # GENERATOR of f64
        return self.field.GENERATOR

    def num_fri_layers(self, domain_size: int) -> int:
        """options.rs:85-93."""
        result = 0
        max_remainder_size = (self.remainder_max_degree + 1) * self.blowup_factor
        while domain_size > max_remainder_size:
            domain_size //= self.folding_factor
            result += 1
        return result
