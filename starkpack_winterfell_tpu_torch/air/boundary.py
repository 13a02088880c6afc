# Copy of starkpack_winterfell_tpu/air/boundary.py; cut: the FieldBackend interpolation and the native barycentric tier; sequences interpolate, and evaluate at a point, on python ints of their field.
"""Boundary constraints — equivalent of air/src/air/boundary/.

Assertions are sorted by (stride, first_step, column), paired with
composition coefficients in that order, and grouped by divisor key
(stride, first_step) (boundary/mod.rs:96-151).
"""

from __future__ import annotations

from ..math import polynom, scalar as fs
from .divisors import ConstraintDivisor


def _inv_g_cached(field, g: int, _cache={}):
    # one Fermat inverse per (field, generator), not one per instance of a
    # batched verify
    key = (field.name, g)
    hit = _cache.get(key)
    if hit is None:
        hit = _cache[key] = pow(g, field.P - 2, field.P)
    return hit


class BoundaryConstraint:
    """boundary/constraint.rs:31 — single-column constraint with value poly."""

    def __init__(self, assertion, inv_g: int, composition_coefficient, field=None):
        if field is None:
            from ..math.fieldspec import GL64_SPEC as field
        self.field = field
        self.column = assertion.column
        poly = list(assertion.values)
        self.poly_offset = (0, 1)
        self._values = poly if len(poly) > 1 else None  # raw sequence values
        self._poly = poly if len(poly) == 1 else None   # interpolated, lazy
        if len(poly) > 1 and assertion.first_step != 0:
            x_offset = pow(inv_g, assertion.first_step, field.P)
            self.poly_offset = (assertion.first_step, x_offset)
        self.cc = composition_coefficient

    @property
    def poly(self):
        """Single-value assertions carry their value as a degree-0 poly;
        sequence assertions interpolate on first access."""
        if self._poly is None:
            self._poly = _interpolate_subgroup(self._values, self.field)
        return self._poly

    def evaluate_at(self, x, trace_value):
        """constraint.rs:104-112 — host scalar."""
        o = self.field
        if self._values is None:
            assertion_value = self._poly[0]
        else:
            xx = o.fmul(x, self.poly_offset[1])
            assertion_value = polynom.eval_at(self.poly, xx, None if o.name == "f64" else o)
        return o.fsub(trace_value, assertion_value)


class BoundaryConstraintGroup:
    """boundary/constraint_group.rs — constraints sharing one divisor."""

    def __init__(self, divisor: ConstraintDivisor):
        self.divisor = divisor
        self.constraints = []

    def add(self, assertion, inv_g, cc, field=None):
        self.constraints.append(BoundaryConstraint(assertion, inv_g, cc, field))

    def evaluate_at(self, state, x):
        """constraint_group.rs evaluate_at — host scalar (verifier)."""
        o = self.divisor.field
        numerator = o.zero()
        for c in self.constraints:
            evaluation = c.evaluate_at(x, state[c.column])
            numerator = o.fadd(numerator, o.fmul(evaluation, c.cc))
        return o.fmul(numerator, self.divisor.inverse_at(x))


class BoundaryConstraints:
    """boundary/mod.rs:37 — main + aux constraint groups."""

    def __init__(self, context, main_assertions, aux_assertions, composition_coefficients):
        assert len(main_assertions) == context.num_main_assertions
        assert len(aux_assertions) == context.num_aux_assertions
        assert context.num_assertions() == len(composition_coefficients)

        trace_length = context.trace_info.length
        main_width = context.trace_info.layout.main_trace_width()
        aux_width = context.trace_info.layout.aux_trace_width()

        main_sorted = _prepare_assertions(main_assertions, main_width, trace_length)
        aux_sorted = _prepare_assertions(aux_assertions, aux_width, trace_length)

        inv_g = _inv_g_cached(context.field, context.trace_domain_generator)

        main_ccs = composition_coefficients[: len(main_sorted)]
        aux_ccs = composition_coefficients[len(main_sorted) :]

        self.main_constraints = _group_constraints(main_sorted, context, main_ccs, inv_g)
        self.aux_constraints = _group_constraints(aux_sorted, context, aux_ccs, inv_g)


def _prepare_assertions(assertions, trace_width, trace_length):
    result = []
    for assertion in assertions:
        assertion.validate_trace_width(trace_width)
        assertion.validate_trace_length(trace_length)
        for a in result:
            if a.column == assertion.column:
                assert not a.overlaps_with(assertion), (
                    f"assertion {assertion} overlaps with {a}"
                )
        result.append(assertion)
    return sorted(result)


def _group_constraints(assertions, context, ccs, inv_g):
    groups = {}
    order = []
    for assertion, cc in zip(assertions, ccs):
        key = (assertion.stride, assertion.first_step)
        if key not in groups:
            groups[key] = BoundaryConstraintGroup(
                ConstraintDivisor.from_assertion(
                    assertion, context.trace_len(), context.field
                )
            )
            order.append(key)
        groups[key].add(assertion, inv_g, cc, context.field)
    # BTreeMap iteration order = sorted by key
    return [groups[k] for k in sorted(groups.keys())]


def _interpolate_subgroup(values, field=None):
    """Inverse DFT of sequence/periodic values over the subgroup of size
    len(values) -> coefficients.  Host python ints (radix-2 recursion); the
    inputs are short (periodic cycles, assertion sequences)."""
    if field is None:
        from ..math.fieldspec import GL64_SPEC as field
    n = len(values)
    assert n & (n - 1) == 0, "number of values must be a power of two"
    if not all(isinstance(v, int) for v in values):
        raise NotImplementedError("extension-field sequences are not ported yet")
    P = field.P
    if n == 1:
        return [values[0] % P]
    w_inv = pow(field.get_root_of_unity(n.bit_length() - 1), P - 2, P)

    def dft(vals, w):
        m = len(vals)
        if m == 1:
            return list(vals)
        even = dft(vals[0::2], w * w % P)
        odd = dft(vals[1::2], w * w % P)
        out = [0] * m
        t = 1
        for k in range(m // 2):
            o = odd[k] * t % P
            out[k] = (even[k] + o) % P
            out[k + m // 2] = (even[k] - o) % P
            t = t * w % P
        return out

    n_inv = pow(n, P - 2, P)
    return [v * n_inv % P for v in dft([v % P for v in values], w_inv)]
