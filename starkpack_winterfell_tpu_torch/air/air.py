# Copy of starkpack_winterfell_tpu/air/air.py; cut: nothing (periodic columns interpolate through boundary._interpolate_subgroup, here on python ints).
"""The Air base class + AirContext — equivalent of air/src/air/{mod,context}.rs.

AIR authors subclass ``Air`` and implement ``evaluate_transition`` (and the
aux variants for multi-segment traces) in terms of ``Felt`` arrays — the same
code evaluates whole constraint-evaluation domains on the device and single OOD
points on the host.
"""

from __future__ import annotations

from ..math import scalar as fs
from .boundary import BoundaryConstraints
from .options import ProofOptions
from .trace_info import TraceInfo
from .transition import TransitionConstraintDegree, TransitionConstraints


class AirContext:
    """air/src/air/context.rs:15."""

    def __init__(
        self,
        trace_info: TraceInfo,
        transition_constraint_degrees,
        num_assertions: int,
        options: ProofOptions,
        aux_transition_constraint_degrees=(),
        num_aux_assertions: int = 0,
        field=None,
    ):
        assert len(transition_constraint_degrees) > 0
        assert num_assertions > 0
        if trace_info.is_multi_segment():
            assert len(aux_transition_constraint_degrees) > 0
            assert num_aux_assertions > 0
        else:
            assert len(aux_transition_constraint_degrees) == 0
            assert num_aux_assertions == 0

        ce_blowup_factor = 0
        for degree in list(transition_constraint_degrees) + list(
            aux_transition_constraint_degrees
        ):
            ce_blowup_factor = max(ce_blowup_factor, degree.min_blowup_factor())
        assert options.blowup_factor >= ce_blowup_factor, (
            f"blowup factor too small; expected at least {ce_blowup_factor}"
        )

        if field is None:
            from ..math.fieldspec import GL64_SPEC as field
        self.field = field
        self.options = options
        self.trace_info = trace_info
        self.main_transition_constraint_degrees = list(transition_constraint_degrees)
        self.aux_transition_constraint_degrees = list(aux_transition_constraint_degrees)
        self.num_main_assertions = num_assertions
        self.num_aux_assertions = num_aux_assertions
        self.ce_blowup_factor = ce_blowup_factor
        trace_length = trace_info.length
        self.trace_domain_generator = self.field.get_root_of_unity(
            trace_length.bit_length() - 1
        )
        self.lde_domain_generator = self.field.get_root_of_unity(
            (trace_length * options.blowup_factor).bit_length() - 1
        )
        self.num_transition_exemptions = 1

    def trace_len(self) -> int:
        return self.trace_info.length

    def trace_poly_degree(self) -> int:
        return self.trace_info.length - 1

    def ce_domain_size(self) -> int:
        return self.trace_info.length * self.ce_blowup_factor

    def lde_domain_size(self) -> int:
        return self.trace_info.length * self.options.blowup_factor

    def num_transition_constraints(self) -> int:
        return len(self.main_transition_constraint_degrees) + len(
            self.aux_transition_constraint_degrees
        )

    def num_main_transition_constraints(self) -> int:
        return len(self.main_transition_constraint_degrees)

    def num_aux_transition_constraints(self) -> int:
        return len(self.aux_transition_constraint_degrees)

    def num_assertions(self) -> int:
        return self.num_main_assertions + self.num_aux_assertions

    def num_constraint_composition_columns(self) -> int:
        """context.rs:254-275."""
        highest = 0
        for degree in (
            self.main_transition_constraint_degrees + self.aux_transition_constraint_degrees
        ):
            highest = max(highest, degree.get_evaluation_degree(self.trace_len()))
        trace_length = self.trace_len()
        transition_divisor_degree = trace_length - self.num_transition_exemptions
        num = (highest - transition_divisor_degree + trace_length - 1) // trace_length
        return max(num, 1)

    def set_num_transition_exemptions(self, n: int):
        assert n > 0
        assert n <= self.trace_len() // 2 + 1
        self.num_transition_exemptions = n
        return self


class Air:
    """Base AIR class (air/src/air/mod.rs:175).  Subclasses must set
    ``self.context`` in __init__ and implement ``evaluate_transition`` and
    ``get_assertions``."""

    def __init__(self, trace_info: TraceInfo, pub_inputs, options: ProofOptions):
        raise NotImplementedError

    # -- required ------------------------------------------------------------

    def evaluate_transition(self, frame, periodic_values, result):
        raise NotImplementedError

    def get_assertions(self):
        raise NotImplementedError

    # -- aux-segment hooks (mod.rs:225-298) ----------------------------------

    def evaluate_aux_transition(
        self, main_frame, aux_frame, periodic_values, aux_rand_elements, result
    ):
        raise NotImplementedError(
            "evaluation of auxiliary transition constraints has not been implemented"
        )

    def get_aux_assertions(self, aux_rand_elements):
        return []

    def get_periodic_column_values(self):
        return []

    # -- provided accessors --------------------------------------------------

    # periodic columns are structural per AIR type + trace length (the
    # reference's trait derives them from the AIR shape, never from public
    # inputs — air/src/air/mod.rs:292), so their interpolations are cached
    # process-wide; an AIR whose columns depend on anything else MUST extend
    # the key via periodic_cache_key (e.g. the aggregated Lamport block size)
    _periodic_polys_cache: dict = {}

    def periodic_cache_key(self):
        """Extra key material for the periodic-poly cache — override when
        get_periodic_column_values() depends on more than (type, length)."""
        return ()

    def get_periodic_column_polys(self):
        """Interpolate each periodic column into coefficient form (cached)."""
        key = (type(self), self.trace_length(), self.context.field.name,
               self.periodic_cache_key())
        cached = Air._periodic_polys_cache.get(key)
        if cached is not None:
            return cached
        from .boundary import _interpolate_subgroup

        cols = self.get_periodic_column_values()
        for col in cols:
            # air/src/air/mod.rs get_periodic_column_polys validation
            assert len(col) >= 2, (
                "number of values in a periodic column must be at least 2, "
                f"but was {len(col)}"
            )
            assert len(col) & (len(col) - 1) == 0, (
                "number of values in a periodic column must be a power of "
                f"two, but was {len(col)}"
            )
        polys = [_interpolate_subgroup(col, self.context.field) for col in cols]
        Air._periodic_polys_cache[key] = polys
        return polys

    def trace_info(self) -> TraceInfo:
        return self.context.trace_info

    def trace_length(self) -> int:
        return self.context.trace_info.length

    def options(self) -> ProofOptions:
        return self.context.options

    def ce_blowup_factor(self) -> int:
        return self.context.ce_blowup_factor

    def ce_domain_size(self) -> int:
        return self.context.ce_domain_size()

    def lde_domain_size(self) -> int:
        return self.context.lde_domain_size()

    def trace_domain_generator(self) -> int:
        return self.context.trace_domain_generator

    def lde_domain_generator(self) -> int:
        return self.context.lde_domain_generator

    def domain_offset(self) -> int:
        return self.context.options.domain_offset(self.context.field)

    def field_spec(self):
        return self.context.field

    def trace_poly_degree(self) -> int:
        return self.context.trace_poly_degree()

    def get_transition_constraints(self, composition_coefficients) -> TransitionConstraints:
        return TransitionConstraints(self.context, composition_coefficients)

    def get_boundary_constraints(
        self, aux_rand_elements, composition_coefficients
    ) -> BoundaryConstraints:
        return BoundaryConstraints(
            self.context,
            self.get_assertions(),
            self.get_aux_assertions(aux_rand_elements) if aux_rand_elements else [],
            composition_coefficients,
        )

    # -- transcript draws (mod.rs:470-547) -----------------------------------

    def get_aux_trace_segment_random_elements(self, aux_segment_idx: int, coin, ext_deg: int):
        n = self.context.trace_info.layout.get_aux_segment_rand_elements(aux_segment_idx)
        return [coin.draw(ext_deg) for _ in range(n)]

    def get_constraint_composition_coefficients(self, coin, ext_deg: int):
        nt = self.context.num_transition_constraints()
        nb = self.context.num_assertions()
        vals = coin.draw_many(nt + nb, ext_deg)
        return ConstraintCompositionCoefficients(vals[:nt], vals[nt:])

    def get_deep_composition_coefficients(self, airs, coin, ext_deg: int):
        """StarkPack per-trace coefficient vectors (mod.rs:521-547)."""
        widths = [air.trace_info().width() for air in airs]
        nc = self.context.num_constraint_composition_columns()
        vals = coin.draw_many(sum(widths) + nc, ext_deg)
        traces, at = [], 0
        for w in widths:
            traces.append(vals[at : at + w])
            at += w
        return DeepCompositionCoefficients(traces, vals[at:])


class ConstraintCompositionCoefficients:
    """air/src/air/coefficients.rs:66."""

    def __init__(self, transition, boundary):
        self.transition = transition
        self.boundary = boundary


class DeepCompositionCoefficients:
    """air/src/air/coefficients.rs:111 — StarkPack per-trace vectors."""

    def __init__(self, traces, constraints):
        self.traces = traces
        self.constraints = constraints


class AuxTraceRandElements:
    """air/src/air/coefficients.rs:20."""

    def __init__(self):
        self.segments = []

    def add_segment_elements(self, elements):
        self.segments.append(elements)

    def get_segment_elements(self, i: int):
        return self.segments[i]

    def is_empty(self) -> bool:
        return len(self.segments) == 0
