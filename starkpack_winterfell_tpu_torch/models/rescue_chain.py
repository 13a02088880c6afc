"""Rescue-Prime hash-chain / VDF AIR over f64.

Counterpart of starkpack_winterfell_tpu/models/rescue_chain.py.  The trace
iterates the Rescue-XLIX permutation, one round per row, in cycles of 8 rows
(7 rounds + 1 copy row).  Periodic columns carry the round constants and the
round/copy mask; transition constraints use the half-forward / half-backward
formulation so the degree stays at 7:

  round rows:  MDS(cur^7) + ARK1[r]  ==  (INV_MDS(next - ARK2[r]))^7
  copy rows:   next == cur

Not ported: the accelerator scan builder and the device expander (both were
ways around a slow host link); the trace is built on the host and goes to
the card with one copy.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..air import Air, AirContext, Assertion, TransitionConstraintDegree
from ..crypto.rescue import (
    ARK1,
    ARK2,
    INV_ALPHA,
    INV_MDS,
    MDS,
    NUM_ROUNDS,
    STATE_WIDTH,
    round_ints,
)
from ..math import scalar as fs
from ..ops.felt import mds_apply
from ..prover.pipeline import Prover
from ..prover.trace import TraceTable

CYCLE_LENGTH = 8  # 7 rounds + 1 copy row
NATIVE_MIN_PERMUTATIONS = 1 << 10  # shorter chains take the python loop


class ChainInputs:
    def __init__(self, seed, result):
        """seed: 8 rate elements; result: 4 digest elements."""
        self.seed = list(seed)
        self.result = list(result)

    def to_elements(self):
        return self.seed + self.result


class RescueChainAir(Air):
    def __init__(self, trace_info, pub_inputs, options):
        degrees = [
            TransitionConstraintDegree.with_cycles(7, [CYCLE_LENGTH])
            for _ in range(STATE_WIDTH)
        ]
        self.context = AirContext(trace_info, degrees, 16, options)
        self.seed = pub_inputs.seed
        self.result = pub_inputs.result

    def evaluate_transition(self, frame, periodic_values, result):
        cur = frame.current()
        nxt = frame.next()
        flag = periodic_values[0]
        ark1 = periodic_values[1 : 1 + STATE_WIDTH]
        ark2 = periodic_values[1 + STATE_WIDTH : 1 + 2 * STATE_WIDTH]

        # forward half: MDS(cur^7) + ark1
        cur7 = [c**7 for c in cur]
        fwd = mds_apply(cur7, MDS)
        fwd = [f + ark1[i] for i, f in enumerate(fwd)]

        # backward half: (INV_MDS(next - ark2))^7
        diff = [nxt[i] - ark2[i] for i in range(STATE_WIDTH)]
        bwd = [b**7 for b in mds_apply(diff, INV_MDS)]

        one = 1
        for i in range(STATE_WIDTH):
            round_c = fwd[i] - bwd[i]
            copy_c = nxt[i] - cur[i]
            result[i] = flag * round_c + (one - flag) * copy_c

    def get_assertions(self):
        last = self.trace_length() - 1
        assertions = []
        for i in range(4):
            assertions.append(Assertion.single(i, 0, 0))  # capacity zeros
        for i, v in enumerate(self.seed):
            assertions.append(Assertion.single(4 + i, 0, v))
        for i, v in enumerate(self.result):
            assertions.append(Assertion.single(4 + i, last, v))
        return assertions

    def get_periodic_column_values(self):
        flag = [1] * NUM_ROUNDS + [0] * (CYCLE_LENGTH - NUM_ROUNDS)
        cols = [flag]
        for i in range(STATE_WIDTH):
            cols.append([ARK1[r][i] for r in range(NUM_ROUNDS)] + [0])
        for i in range(STATE_WIDTH):
            cols.append([ARK2[r][i] for r in range(NUM_ROUNDS)] + [0])
        return cols


def build_chain_trace(seed, num_permutations: int) -> TraceTable:
    """Trace rows: row 8c+k = state after k rounds of permutation c; row
    8c+7 holds the permutation output, copied into row 8(c+1).

    The chain is one long scalar dependency (x^(1/7) is ~98 serial multiplies
    per round), so no accelerator width can hide the latency: it is built
    with a sequential row scan on the host.  Long chains use the native
    builder (native/builders.cpp, compiled on first use, word-identical);
    short ones the python loop."""
    if num_permutations >= NATIVE_MIN_PERMUTATIONS:
        return _build_chain_trace_native(seed, num_permutations)
    return _build_chain_trace_python(seed, num_permutations)


def _build_chain_trace_python(seed, num_permutations: int) -> TraceTable:
    length = CYCLE_LENGTH * num_permutations
    cols = np.zeros((STATE_WIDTH, length), dtype=np.uint64)
    state = [0, 0, 0, 0] + [s % fs.P for s in seed]
    for c in range(num_permutations):
        base = c * CYCLE_LENGTH
        cols[:, base] = state
        for r in range(NUM_ROUNDS):
            state = round_ints(state, r)
            cols[:, base + r + 1] = state
        # row base+7 is the output; the copy constraint carries it to the
        # next cycle's row 0 (or it is the final row)
    return TraceTable.from_u64_columns(cols)


def _build_chain_trace_native(seed, num_permutations: int) -> TraceTable:
    """Native sequential builder (native/builders.cpp rescue_chain_trace);
    raises if the host compiler is missing or the build fails."""
    from ..native import get_builders

    lib = get_builders()
    length = CYCLE_LENGTH * num_permutations
    seed8 = np.asarray([s % fs.P for s in seed], dtype=np.uint64)
    mds = np.asarray(MDS, dtype=np.uint64)
    ark1 = np.asarray(ARK1, dtype=np.uint64)
    ark2 = np.asarray(ARK2, dtype=np.uint64)
    out = np.empty((STATE_WIDTH, length), dtype=np.uint64)
    vp = ctypes.c_void_p
    lib.rescue_chain_trace(
        seed8.ctypes.data_as(vp), num_permutations,
        mds.ctypes.data_as(vp), ark1.ctypes.data_as(vp),
        ark2.ctypes.data_as(vp), INV_ALPHA,
        out.ctypes.data_as(vp),
    )
    return TraceTable.from_u64_columns(out)


class RescueChainProver(Prover):
    air_class = RescueChainAir

    def __init__(self, options, hasher):
        self._options = options
        self.hasher = hasher

    def get_pub_inputs(self, trace: TraceTable) -> ChainInputs:
        last = trace.length - 1
        seed = [trace.get(4 + i, 0) for i in range(8)]
        result = [trace.get(4 + i, last) for i in range(4)]
        return ChainInputs(seed, result)

    def options(self):
        return self._options
