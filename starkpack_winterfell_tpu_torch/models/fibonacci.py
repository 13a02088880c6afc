"""Fibonacci AIR — re-creation of the upstream Winterfell fib2 example
(removed from the fork's examples crate; trace fixture preserved at
prover/src/tests/mod.rs:17-29).  Two terms per row:
  next[0] = cur[0] + cur[1]
  next[1] = cur[0] + 2*cur[1]

Counterpart of starkpack_winterfell_tpu/models/fibonacci.py.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..air import Air, AirContext, Assertion, TransitionConstraintDegree
from ..prover.pipeline import Prover
from ..prover.trace import TraceTable


class FibInputs:
    def __init__(self, result: int):
        self.result = result

    def to_elements(self):
        return [self.result]


class FibAir(Air):
    def __init__(self, trace_info, pub_inputs, options):
        degrees = [TransitionConstraintDegree(1), TransitionConstraintDegree(1)]
        self.context = AirContext(trace_info, degrees, 3, options)
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


def build_fib_trace(length: int) -> TraceTable:
    """Sequential build on the host (native/builders.cpp fib_trace;
    prover/src/tests/mod.rs:17-29): each row holds two consecutive terms;
    ``length`` is the number of trace rows."""
    from ..native import get_builders

    assert length & (length - 1) == 0
    out = np.empty((2, length), dtype=np.uint64)
    get_builders().fib_trace(length, out.ctypes.data_as(ctypes.c_void_p))
    return TraceTable.from_u64_columns(out)


class FibProver(Prover):
    air_class = FibAir

    def __init__(self, options, hasher):
        self._options = options
        self.hasher = hasher

    def get_pub_inputs(self, trace: TraceTable) -> FibInputs:
        return FibInputs(trace.get(1, trace.length - 1))

    def options(self):
        return self._options
