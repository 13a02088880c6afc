# Copy of starkpack_winterfell_tpu/air/transition.py; cut: nothing.
"""Transition constraint metadata — equivalent of air/src/air/transition/.

``EvaluationFrame`` is the array-first departure from the reference: instead of
a 2-row scalar window (transition/frame.rs), it holds per-column ``Felt``
*arrays*, so a single call to the user's ``evaluate_transition`` evaluates the
constraint at every point of the constraint-evaluation domain at once (and at
a single OOD point when the arrays have shape (1,)).
"""

from __future__ import annotations

from ..math import scalar as fs


class TransitionConstraintDegree:
    """transition/degree.rs:126."""

    MIN_CYCLE_LENGTH = 2

    def __init__(self, base: int, cycles=()):
        assert base > 0, "transition constraint degree must be at least one"
        for c in cycles:
            assert c >= self.MIN_CYCLE_LENGTH and c & (c - 1) == 0
        self.base = base
        self.cycles = list(cycles)

    @classmethod
    def new(cls, degree: int) -> "TransitionConstraintDegree":
        return cls(degree)

    @classmethod
    def with_cycles(cls, base_degree: int, cycles) -> "TransitionConstraintDegree":
        return cls(base_degree, cycles)

    def get_evaluation_degree(self, trace_length: int) -> int:
        result = self.base * (trace_length - 1)
        for cycle_length in self.cycles:
            result += (trace_length // cycle_length) * (cycle_length - 1)
        return result

    def min_blowup_factor(self) -> int:
        degree_bound = self.base + len(self.cycles) - 1
        return max(_next_pow2(degree_bound), 2)


def _next_pow2(v: int) -> int:
    return 1 if v <= 1 else 1 << (v - 1).bit_length()


class EvaluationFrame:
    """Pair of trace rows (current, next); each a list of per-column values
    (Felt arrays on device, scalars on host)."""

    def __init__(self, current, next_):
        self._current = current
        self._next = next_

    def current(self):
        return self._current

    def next(self):
        return self._next


class TransitionConstraints:
    """air/src/air/transition/mod.rs:29-173 — coefficients split into
    main/aux, one shared transition divisor."""

    def __init__(self, context, composition_coefficients):
        assert len(composition_coefficients) >= context.num_transition_constraints()
        num_main = context.num_main_transition_constraints()
        self.main_constraint_degrees = context.main_transition_constraint_degrees
        self.aux_constraint_degrees = context.aux_transition_constraint_degrees
        self.main_constraint_coef = composition_coefficients[:num_main]
        self.aux_constraint_coef = composition_coefficients[
            num_main : context.num_transition_constraints()
        ]
        from .divisors import ConstraintDivisor

        self.field = context.field
        self.divisor = ConstraintDivisor.from_transition(
            context.trace_len(), context.num_transition_exemptions, context.field
        )

    def num_main_constraints(self) -> int:
        return len(self.main_constraint_degrees)

    def num_aux_constraints(self) -> int:
        return len(self.aux_constraint_degrees)

    def combine_evaluations(self, main_evaluations, aux_evaluations, x):
        """Host scalar combination for the verifier OOD check
        (transition/mod.rs combine_evaluations)."""
        o = self.field
        result = o.zero()
        for ev, coef in zip(main_evaluations, self.main_constraint_coef):
            result = o.fadd(result, o.fmul(coef, ev))
        for ev, coef in zip(aux_evaluations, self.aux_constraint_coef):
            result = o.fadd(result, o.fmul(coef, ev))
        return o.fmul(result, self.divisor.inverse_at(x))
