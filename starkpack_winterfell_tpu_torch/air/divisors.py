# Copy of starkpack_winterfell_tpu/air/divisors.py; cut: nothing.
"""Constraint divisors — equivalent of air/src/air/divisor.rs.

A divisor has the form  z(x) = prod (x^a_i - b_i) / prod (x - e_j)  with,
currently, a single numerator term (divisor.rs:26).
"""

from __future__ import annotations

from ..math import scalar as fs


def _spec(field):
    if field is None:
        from ..math.fieldspec import GL64_SPEC as field
    return field


def _evaluate_at_cached(field, numerator, exemptions, x, _cache={}):
    key = (field.name, numerator, exemptions, x)
    hit = _cache.get(key)
    if hit is None:
        hit = _cache[key] = ConstraintDivisor(
            list(numerator), list(exemptions), field
        )._evaluate_at(x)
        if len(_cache) > 4096:  # z changes per proof; keep the map bounded
            _cache.clear()
            _cache[key] = hit
    return hit


def _inverse_at_cached(field, numerator, exemptions, x, _cache={}):
    # every instance of a batch divides by the SAME divisor value at z, and
    # a division is a full Fermat inverse — cache the inverse itself so a
    # 32-instance verify pays one finv per distinct divisor, not 32
    key = (field.name, numerator, exemptions, x)
    hit = _cache.get(key)
    if hit is None:
        hit = _cache[key] = field.finv(
            _evaluate_at_cached(field, numerator, exemptions, x)
        )
        if len(_cache) > 4096:
            _cache.clear()
            _cache[key] = hit
    return hit


class ConstraintDivisor:
    def __init__(self, numerator, exemptions, field=None):
        self.numerator = list(numerator)  # [(degree, constant int)]
        self.exemptions = list(exemptions)  # [int]
        self.field = _spec(field)

    @classmethod
    def from_transition(cls, trace_length: int, num_exemptions: int,
                        field=None) -> "ConstraintDivisor":
        """z(x) = (x^n - 1) / prod_{i} (x - g^{n-i}) (divisor.rs:56-65)."""
        assert num_exemptions > 0
        exemptions = [
            _trace_domain_value_at(trace_length, step, field)
            for step in range(trace_length - num_exemptions, trace_length)
        ]
        return cls([(trace_length, 1)], exemptions, field)

    @classmethod
    def from_assertion(cls, assertion, trace_length: int,
                       field=None) -> "ConstraintDivisor":
        """z(x) = x^k - g^{a*k} (divisor.rs:90-102)."""
        num_steps = assertion.get_num_steps(trace_length)
        if assertion.first_step == 0:
            return cls([(num_steps, 1)], [], field)
        trace_offset = num_steps * assertion.first_step
        offset = _trace_domain_value_at(trace_length, trace_offset, field)
        return cls([(num_steps, offset)], [], field)

    def degree(self) -> int:
        return sum(d for d, _ in self.numerator) - len(self.exemptions)

    def evaluate_at(self, x):
        o = self.field
        if isinstance(x, (int, tuple)):
            # the verifier evaluates every instance's divisors at the SAME
            # z; same-shape instances share divisors, so memoize (the fdiv
            # is a full Fermat inverse per call otherwise)
            return _evaluate_at_cached(
                o, tuple(self.numerator), tuple(self.exemptions), x
            )
        return self._evaluate_at(x)

    def inverse_at(self, x):
        """Memoized 1 / evaluate_at(x) for the verifier's scalar path."""
        o = self.field
        if isinstance(x, (int, tuple)):
            return _inverse_at_cached(
                o, tuple(self.numerator), tuple(self.exemptions), x
            )
        return o.finv(self._evaluate_at(x))

    def _evaluate_at(self, x):
        o = self.field
        num = o.one(o.deg_of(x)) if not isinstance(x, int) else 1
        for degree, constant in self.numerator:
            num = o.fmul(num, o.fsub(o.fexp(x, degree), constant))
        den = self.evaluate_exemptions_at(x)
        return o.fdiv(num, den)

    def evaluate_exemptions_at(self, x):
        o = self.field
        result = o.one(o.deg_of(x)) if not isinstance(x, int) else 1
        for e in self.exemptions:
            result = o.fmul(result, o.fsub(x, e))
        return result

    def __eq__(self, other):
        return (
            isinstance(other, ConstraintDivisor)
            and self.numerator == other.numerator
            and self.exemptions == other.exemptions
        )


def _trace_domain_value_at(trace_length: int, step: int, field=None) -> int:
    o = _spec(field)
    g = o.get_root_of_unity(trace_length.bit_length() - 1)
    return pow(g, step, o.P)
