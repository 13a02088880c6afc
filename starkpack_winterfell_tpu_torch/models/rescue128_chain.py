"""Rescue128 hash-chain AIR over f128.

Counterpart of starkpack_winterfell_tpu/models/rescue128_chain.py.
Statement: "result = H^m(seed)" for the 2-element Rescue128 digest H.

Trace (6 columns = the sponge state, cycles of 8 rows, m cycles):
rows 0..6 of each cycle apply one Rescue round each (7 rounds total); the
cycle boundary re-absorbs the digest into a fresh state
([d0, d1, 0, 0, 0, 0]), exactly Rescue128.digest([d0, d1]).

Added to the counterpart: long chains are built by the native builder
(native/rescue128.c ``r128_chain_trace``, compiled on first use; the python
loop pays a 128-bit exponentiation per cell in python ints).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..air import Air, AirContext, Assertion, TransitionConstraintDegree
from ..crypto import rescue128 as r128
from ..crypto.rescue128 import CYCLE_LENGTH, NUM_ROUNDS, STATE_WIDTH
from ..math.fieldspec import F128_SPEC
from ..prover.pipeline import Prover
from ..prover.trace import TraceTable

P = F128_SPEC.P
NATIVE_MIN_CHAIN = 1 << 10  # shorter chains take the python loop


class Rescue128ChainInputs:
    def __init__(self, seed, result):
        self.seed = list(seed)  # 2 elements
        self.result = list(result)  # 2 elements

    def to_elements(self):
        return self.seed + self.result


class Rescue128ChainAir(Air):
    def __init__(self, trace_info, pub_inputs, options):
        degrees = [
            TransitionConstraintDegree.with_cycles(5, [CYCLE_LENGTH])
            for _ in range(STATE_WIDTH)
        ]
        self.context = AirContext(trace_info, degrees, 8, options, field=F128_SPEC)
        self.seed = pub_inputs.seed
        self.result = pub_inputs.result

    def evaluate_transition(self, frame, periodic_values, result):
        cur = frame.current()
        nxt = frame.next()
        flag = periodic_values[0]
        ark = periodic_values[1 : 1 + 2 * STATE_WIDTH]
        one = 1

        rounds = [None] * STATE_WIDTH
        r128.enforce_round(rounds, cur, nxt, ark, one)

        # cycle boundary: digest carries to slots 0/1, the rest resets to 0
        absorb = [nxt[0] - cur[0], nxt[1] - cur[1]] + [
            nxt[i] for i in range(2, STATE_WIDTH)
        ]
        for i in range(STATE_WIDTH):
            result[i] = flag * rounds[i] + (one - flag) * absorb[i]

    def get_assertions(self):
        last = self.trace_length() - 1
        assertions = [
            Assertion.single(0, 0, self.seed[0]),
            Assertion.single(1, 0, self.seed[1]),
        ]
        for i in range(2, STATE_WIDTH):
            assertions.append(Assertion.single(i, 0, 0))
        assertions.append(Assertion.single(0, last, self.result[0]))
        assertions.append(Assertion.single(1, last, self.result[1]))
        return assertions

    def get_periodic_column_values(self):
        flag = [1] * NUM_ROUNDS + [0] * (CYCLE_LENGTH - NUM_ROUNDS)
        return [flag] + r128.get_round_constants()


def chain_digest(seed, m: int):
    """Host reference: m chained Rescue128 digests of the 2-element state."""
    d = [seed[0] % P, seed[1] % P]
    for _ in range(m):
        d = r128.digest(d)
    return d


def build_rescue128_chain_trace(seed, m: int) -> TraceTable:
    """Chain of m hashes -> 6 x 8m trace.  The chain is one long scalar
    dependency, so it is built by a sequential scan on the host: the native
    builder for long chains, the python loop for short ones (word-identical)."""
    assert m & (m - 1) == 0, "chain length must be a power of two"
    if m >= NATIVE_MIN_CHAIN:
        return _build_chain_trace_native(seed, m)
    return _build_chain_trace_python(seed, m)


def _build_chain_trace_python(seed, m: int) -> TraceTable:
    length = CYCLE_LENGTH * m
    cols = [[0] * length for _ in range(STATE_WIDTH)]
    state = [seed[0] % P, seed[1] % P, 0, 0, 0, 0]
    for c in range(m):
        base = c * CYCLE_LENGTH
        cur = list(state)
        for r in range(CYCLE_LENGTH):
            for i in range(STATE_WIDTH):
                cols[i][base + r] = cur[i]
            if r < NUM_ROUNDS:
                cur = r128.apply_round(cur, r)
        state = [cur[0], cur[1], 0, 0, 0, 0]
    # final digest stays on the last row (cols 0/1 of row length-1)
    return TraceTable.init(cols, field="f128")


def _build_chain_trace_native(seed, m: int) -> TraceTable:
    """Native sequential builder (native/rescue128.c r128_chain_trace);
    raises if the host compiler is missing or the build fails."""
    from ..native import get_rescue128

    lib = get_rescue128()
    length = CYCLE_LENGTH * m
    mask = 0xFFFFFFFFFFFFFFFF
    s = [v % P for v in seed[:2]]
    seed_words = np.array([s[0] & mask, s[0] >> 64, s[1] & mask, s[1] >> 64],
                          dtype=np.uint64)
    lo = np.empty((STATE_WIDTH, length), dtype=np.uint64)
    hi = np.empty((STATE_WIDTH, length), dtype=np.uint64)
    vp = ctypes.c_void_p
    lib.r128_chain_trace(seed_words.ctypes.data_as(vp), m,
                         lo.ctypes.data_as(vp), hi.ctypes.data_as(vp))
    return TraceTable.from_u64_pairs(lo, hi, "f128")


class Rescue128ChainProver(Prover):
    air_class = Rescue128ChainAir

    def __init__(self, options, hasher):
        self._options = options
        self.hasher = hasher

    def get_pub_inputs(self, trace: TraceTable) -> Rescue128ChainInputs:
        last = trace.length - 1
        return Rescue128ChainInputs(
            [trace.get(0, 0), trace.get(1, 0)],
            [trace.get(0, last), trace.get(1, last)],
        )

    def options(self):
        return self._options
