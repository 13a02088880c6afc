# Copy of starkpack_winterfell_tpu/air/assertions.py; cut: nothing.
"""Assertions against execution traces — equivalent of
air/src/air/assertions/mod.rs."""

from __future__ import annotations

import functools

NO_STRIDE = 0


@functools.total_ordering
class Assertion:
    """Ordering: (stride, first_step, column) — assertions/mod.rs Ord impl."""

    def __init__(self, column: int, first_step: int, stride: int, values):
        self.column = column
        self.first_step = first_step
        self.stride = stride
        self.values = list(values)

    # -- constructors (assertions/mod.rs:63,82,103) -------------------------

    @classmethod
    def single(cls, column: int, step: int, value) -> "Assertion":
        return cls(column, step, NO_STRIDE, [value])

    @classmethod
    def periodic(cls, column: int, first_step: int, stride: int, value) -> "Assertion":
        _validate_stride(stride, first_step)
        return cls(column, first_step, stride, [value])

    @classmethod
    def sequence(cls, column: int, first_step: int, stride: int, values) -> "Assertion":
        _validate_stride(stride, first_step)
        values = list(values)
        assert len(values) > 0, "invalid assertion: no values provided"
        assert len(values) & (len(values) - 1) == 0, (
            "number of asserted values must be a power of two"
        )
        return cls(column, first_step, NO_STRIDE if len(values) == 1 else stride, values)

    # -- accessors ----------------------------------------------------------

    def is_single(self) -> bool:
        return self.stride == NO_STRIDE

    def is_periodic(self) -> bool:
        return self.stride != NO_STRIDE and len(self.values) == 1

    def is_sequence(self) -> bool:
        return len(self.values) > 1

    def get_num_steps(self, trace_length: int) -> int:
        """assertions/mod.rs — 1 for single, trace_length/stride otherwise;
        panics (raises) on an invalid trace length like the reference
        (air/src/air/assertions/tests.rs periodic_assertion_get_num_steps_error)."""
        self.validate_trace_length(trace_length)
        return 1 if self.is_single() else trace_length // self.stride

    # -- validation ---------------------------------------------------------

    def validate_trace_width(self, trace_width: int):
        if self.column >= trace_width:
            raise ValueError(
                f"expected column to be in [0, {trace_width}), but was {self.column}"
            )

    def validate_trace_length(self, trace_length: int):
        if self.is_single():
            if self.first_step >= trace_length:
                raise ValueError("assertion step out of trace")
        elif self.is_periodic():
            if self.stride > trace_length:
                raise ValueError("stride longer than trace")
        else:
            if len(self.values) * self.stride != trace_length:
                raise ValueError(
                    f"expected trace length {len(self.values) * self.stride}, "
                    f"but was {trace_length}"
                )

    def overlaps_with(self, other: "Assertion") -> bool:
        if self.column != other.column:
            return False
        if self.first_step == other.first_step:
            return True
        if self.stride == other.stride:
            return False
        if self.first_step < other.first_step:
            if self.is_single():
                return False
            if other.is_single() or self.stride < other.stride:
                return (other.first_step - self.first_step) % self.stride == 0
            return False
        else:
            if other.is_single():
                return False
            if self.is_single() or other.stride < self.stride:
                return (self.first_step - other.first_step) % other.stride == 0
            return False

    def _key(self):
        return (self.stride, self.first_step, self.column)

    def __lt__(self, other):
        return self._key() < other._key()

    def __eq__(self, other):
        return (
            isinstance(other, Assertion)
            and self._key() == other._key()
            and self.values == other.values
        )

    def __repr__(self):
        return f"Assertion(col={self.column}, step={self.first_step}, stride={self.stride})"


def _validate_stride(stride: int, first_step: int):
    assert stride & (stride - 1) == 0 and stride >= 2, (
        "stride must be a power of two >= 2"
    )
    assert first_step < stride, "first step must be smaller than stride"
