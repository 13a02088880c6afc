# Copy of starkpack_winterfell_tpu/models/fib_multifield.py; cut: nothing.
"""Field-parameterized Fibonacci family — the multi-field smoke workload.

The reference instantiates its examples per base field through the generic
``Example<E: StarkField>`` machinery (examples/src/fibonacci); here a small
class factory bakes the FieldSpec into the AIR so the same two-register
fib2 constraints (prover/src/tests/mod.rs:17-29) prove over f64, f62 or
f128 through the FieldBackend-generic pipeline.
"""

from __future__ import annotations

from ..air import Air, AirContext, Assertion, TransitionConstraintDegree
from ..math.fieldspec import FIELDS
from ..prover.pipeline import Prover
from ..prover.trace import TraceTable

_FAMILIES = {}


def get_fib_family(field_name: str):
    """Returns (AirClass, build_trace, ProverClass) for the given field."""
    if field_name in _FAMILIES:
        return _FAMILIES[field_name]
    spec = FIELDS[field_name]

    class FibAirF(Air):
        field_name_ = field_name

        def __init__(self, trace_info, pub_inputs, options):
            degrees = [TransitionConstraintDegree(1), TransitionConstraintDegree(1)]
            self.context = AirContext(trace_info, degrees, 3, options, field=spec)
            self.result = pub_inputs.result

        def evaluate_transition(self, frame, periodic_values, result):
            cur0, cur1 = frame.current()[0], frame.current()[1]
            result[0] = frame.next()[0] - (cur0 + cur1)
            result[1] = frame.next()[1] - (cur0 + cur1 + cur1)

        def get_assertions(self):
            last = self.trace_length() - 1
            return [
                Assertion.single(0, 0, 1),
                Assertion.single(1, 0, 1),
                Assertion.single(1, last, self.result),
            ]

    class FibInputsF:
        def __init__(self, result: int):
            self.result = result

        def to_elements(self):
            return [self.result]

    def build_trace(length: int) -> TraceTable:
        assert length & (length - 1) == 0
        reg1, reg2 = [], []
        a, b = 1, 1
        for _ in range(length):
            reg1.append(a)
            reg2.append(b)
            a, b = (a + b) % spec.P, (a + 2 * b) % spec.P
        return TraceTable.init([reg1, reg2], field=field_name)

    class FibProverF(Prover):
        air_class = FibAirF

        def __init__(self, options, hasher):
            self._options = options
            self.hasher = hasher

        def get_pub_inputs(self, trace: TraceTable) -> FibInputsF:
            return FibInputsF(trace.get(1, trace.length - 1))

        def options(self):
            return self._options

    _FAMILIES[field_name] = (FibAirF, build_trace, FibProverF, FibInputsF)
    return _FAMILIES[field_name]
