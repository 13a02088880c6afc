"""Randomized-AIR (auxiliary trace segment) example: a grand-product
permutation check.

Counterpart of starkpack_winterfell_tpu/models/permutation.py.  Exercises
the multi-segment machinery the reference exposes through
build_aux_segment / evaluate_aux_transition / get_aux_assertions
(prover/src/trace/mod.rs:41-77, air/src/air/mod.rs:225-298): column b of the
main trace is a (fixed rotation) permutation of column a; an auxiliary
column p accumulates prod (a_i + g) / (b_i + g) with g drawn from the
transcript after the main-trace commitment.  If the multisets match, the
product telescopes to 1 at the last step.

Aux transition (degree 2):  p' * (b' + g)  -  p * (a' + g)  ==  0

The JAX model builds the aux column in a host loop with one extension
division a row; here ``build_aux_segment`` builds it on the device of the
prove (the sums elementwise, one batch inversion, a prefix product).
Inverses are unique, so the columns are the same.
"""

from __future__ import annotations

import numpy as np

from ..air import Air, AirContext, Assertion, TransitionConstraintDegree
from ..air.trace_info import TraceInfo, TraceLayout
from ..math import scalar as fs
from ..prover.pipeline import Prover
from ..prover.trace import TraceTable


class PermInputs:
    def __init__(self, a0: int, b0: int):
        self.a0 = a0
        self.b0 = b0

    def to_elements(self):
        return [self.a0, self.b0]


class PermAir(Air):
    def __init__(self, trace_info, pub_inputs, options):
        main_degrees = [TransitionConstraintDegree(1)]
        aux_degrees = [TransitionConstraintDegree(2)]
        self.context = AirContext(
            trace_info,
            main_degrees,
            2,
            options,
            aux_transition_constraint_degrees=aux_degrees,
            num_aux_assertions=2,
        )
        self.a0 = pub_inputs.a0
        self.b0 = pub_inputs.b0

    # -- main ---------------------------------------------------------------

    def evaluate_transition(self, frame, periodic_values, result):
        # b is a rotation of a by one row: b' == a  (wrap handled by exemption)
        result[0] = frame.next()[1] - frame.current()[0]

    def get_assertions(self):
        return [
            Assertion.single(0, 0, self.a0),
            Assertion.single(1, 0, self.b0),
        ]

    # -- aux ----------------------------------------------------------------

    def evaluate_aux_transition(
        self, main_frame, aux_frame, periodic_values, aux_rand_elements, result
    ):
        # gamma: (n, 1) Felts in the prover's instance-batched phase
        # (parallel/full_pipeline.py BatchedAuxRand), a python int or tuple
        # in the verifier, whose ScalarFelt takes it as it is
        g = aux_rand_elements.get_segment_elements(0)[0]
        a_next = main_frame.next()[0]
        b_next = main_frame.next()[1]
        p = aux_frame.current()[0]
        p_next = aux_frame.next()[0]
        result[0] = p_next * (b_next + g) - p * (a_next + g)

    def get_aux_assertions(self, aux_rand_elements):
        gamma = aux_rand_elements.get_segment_elements(0)[0]
        first = fs.fdiv(fs.fadd(self.a0, gamma), fs.fadd(self.b0, gamma))
        last = self.trace_length() - 1
        return [
            Assertion.single(0, 0, first),
            Assertion.single(0, last, fs.one(fs.deg_of(gamma)) if not isinstance(gamma, int) else 1),
        ]


class PermTraceTable(TraceTable):
    """Main trace (2 cols) + one aux segment (1 col, 1 rand element)."""

    def get_info(self) -> TraceInfo:
        layout = TraceLayout(2, (1,), (1,))
        return TraceInfo.new_multi_segment(layout, self.length, self.meta)

    def num_aux_segments(self) -> int:
        return 1

    def build_aux_segment(self, seg_idx: int, rand_elements, backend, device):
        """p_i = prod_{j <= i} (a_j + g) / (b_j + g) as comps shaped
        (1, length) on ``device``: (a + g) and (b + g) elementwise, one batch
        inversion of (b + g), then an inclusive prefix product in
        log2(length) steps (``FieldBackend.prefix_products``)."""
        assert seg_idx == 0
        B = backend
        gamma = rand_elements[0]
        g = B.scalar_to_limbs(gamma, fs.deg_of(gamma), device=device)
        (cols,) = self.main_segment_limbs(B, device)
        a = (B.cmap(lambda l: l[0], cols),)
        b = (B.cmap(lambda l: l[1], cols),)
        ratio = B.vmul(B.vadd(a, g), B.vinv(B.vadd(b, g)))
        return B.emap(lambda l: l.reshape(1, self.length), B.prefix_products(ratio))


def build_perm_trace(start: int, length: int) -> PermTraceTable:
    """a = chain of squares+start; b = a rotated by one (so b' == a)."""
    a = np.empty(length, dtype=np.uint64)
    x = start % fs.P
    for i in range(length):
        a[i] = x
        x = (x * x + 1) % fs.P
    b = np.roll(a, 1)
    return PermTraceTable.from_u64_columns(np.stack([a, b]))


class PermProver(Prover):
    air_class = PermAir

    def __init__(self, options, hasher):
        self._options = options
        self.hasher = hasher

    def get_pub_inputs(self, trace) -> PermInputs:
        return PermInputs(trace.get(0, 0), trace.get(1, 0))

    def options(self):
        return self._options
