"""do_work example — the reference's shipped batched workload
(examples/src/do_work/{air,prover}.rs): chains of x <- x^3 + 42, width-10
trace with only column 0 meaningful.

Counterpart of starkpack_winterfell_tpu/models/do_work.py."""

from __future__ import annotations

import ctypes

import numpy as np

from ..air import Air, AirContext, Assertion, TransitionConstraintDegree
from ..math import scalar as fs
from ..prover.pipeline import Prover
from ..prover.trace import TraceTable


class PublicInputs:
    def __init__(self, start: int, result: int):
        self.start = start
        self.result = result

    def to_elements(self):
        return [self.start, self.result]


class DoWorkAir(Air):
    """examples/src/do_work/air.rs:28-66."""

    def __init__(self, trace_info, pub_inputs, options):
        degrees = [TransitionConstraintDegree(3)]
        self.context = AirContext(trace_info, degrees, 2, options)
        self.start = pub_inputs.start
        self.result = pub_inputs.result

    def evaluate_transition(self, frame, periodic_values, result):
        current = frame.current()[0]
        nxt = current**3 + 42
        result[0] = frame.next()[0] - nxt

    def get_assertions(self):
        last_step = self.trace_length() - 1
        return [
            Assertion.single(0, 0, self.start),
            Assertion.single(0, last_step, self.result),
        ]


def build_do_work_trace(start: int, trace_length: int) -> TraceTable:
    """examples/src/do_work/prover.rs:62-79 — width 10, column 0 is the
    chain (native/builders.cpp do_work_chain), the other columns replicate
    the start value."""
    from ..native import get_builders

    width = 10
    col = np.empty(trace_length, dtype=np.uint64)
    get_builders().do_work_chain(
        start % fs.P, trace_length, col.ctypes.data_as(ctypes.c_void_p)
    )
    columns = np.broadcast_to(
        np.uint64(start % fs.P), (width, trace_length)
    ).copy()
    columns[0] = col
    return TraceTable.from_u64_columns(columns)


class DoWorkProver(Prover):
    """examples/src/do_work/prover.rs:37-59."""

    air_class = DoWorkAir

    def __init__(self, options, hasher):
        self._options = options
        self.hasher = hasher

    def get_pub_inputs(self, trace: TraceTable) -> PublicInputs:
        last_step = trace.length - 1
        return PublicInputs(trace.get(0, 0), trace.get(0, last_step))

    def options(self):
        return self._options
