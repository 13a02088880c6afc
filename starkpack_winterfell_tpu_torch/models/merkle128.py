# Copy of starkpack_winterfell_tpu/models/merkle128.py; cut: nothing.
"""Merkle authentication-path AIR over f128/Rescue128 — the upstream
Winterfell `merkle` example on its original field (the hash survives at
examples/src/utils/rescue.rs; the example itself was removed from the fork).

Each tree level is one Rescue128 merge = 8 trace rows (7 rounds + 1 absorb
row).  Trace (7 columns): the 6-element sponge state + the index bit that
routes the accumulated digest left/right into the next merge's rate block.

Added to the counterpart: ``build_merkle128_traces`` builds many paths of one
depth at once with the native builder (native/rescue128.c
``r128_merkle_trace_batch``; the python loop pays a 128-bit exponentiation
per cell in python ints), word-identical to ``build_merkle128_trace``.
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
BIT = STATE_WIDTH  # col 6
TRACE_WIDTH = STATE_WIDTH + 1


class Merkle128Inputs:
    def __init__(self, root):
        self.root = list(root)  # 2 digest elements

    def to_elements(self):
        return list(self.root)


class Merkle128Air(Air):
    def __init__(self, trace_info, pub_inputs, options):
        degrees = [
            TransitionConstraintDegree.with_cycles(5, [CYCLE_LENGTH])
            for _ in range(STATE_WIDTH)
        ] + [TransitionConstraintDegree.with_cycles(3, [CYCLE_LENGTH])]
        self.context = AirContext(trace_info, degrees, 4, options, field=F128_SPEC)
        self.root = pub_inputs.root

    def evaluate_transition(self, frame, periodic_values, result):
        cur = frame.current()
        nxt = frame.next()
        flag = periodic_values[0]
        ark = periodic_values[1 : 1 + 2 * STATE_WIDTH]
        b = cur[BIT]
        one = 1

        rounds = [None] * STATE_WIDTH
        r128.enforce_round(
            rounds, [cur[i] for i in range(STATE_WIDTH)],
            [nxt[i] for i in range(STATE_WIDTH)], ark, one,
        )

        # absorb row: digest (cur[0..2]) enters rate slots 0..2 when the next
        # level's bit is 0, slots 2..4 when it is 1; sibling slots are free
        # witnesses; capacity resets to zero
        absorb = [None] * STATE_WIDTH
        for i in range(2):
            absorb[i] = (one - b) * (nxt[i] - cur[i])
            absorb[2 + i] = b * (nxt[2 + i] - cur[i])
        for i in range(4, STATE_WIDTH):
            absorb[i] = nxt[i]

        for i in range(STATE_WIDTH):
            result[i] = flag * rounds[i] + (one - flag) * absorb[i]
        result[BIT] = (one - flag) * b * (one - b)

    def get_assertions(self):
        last = self.trace_length() - 1
        assertions = [
            Assertion.single(4, 0, 0),
            Assertion.single(5, 0, 0),
        ]
        for i, v in enumerate(self.root):
            assertions.append(Assertion.single(i, last, v))
        return assertions

    def get_periodic_column_values(self):
        flag = [1] * NUM_ROUNDS + [0] * (CYCLE_LENGTH - NUM_ROUNDS)
        return [flag] + r128.get_round_constants()


def build_merkle128_trace(leaf, siblings, index: int) -> TraceTable:
    """leaf: 2 elements (level-0 digest); siblings: list of 2-element
    digests per level; index: leaf position (bit i routes level i)."""
    depth = len(siblings)
    length = CYCLE_LENGTH * depth
    cols = [[0] * length for _ in range(TRACE_WIDTH)]
    digest = [v % P for v in leaf]
    for lvl in range(depth):
        bit = (index >> lvl) & 1
        sib = [v % P for v in siblings[lvl]]
        rate = sib + digest if bit else digest + sib
        state = rate + [0, 0]
        base = lvl * CYCLE_LENGTH
        for i in range(STATE_WIDTH):
            cols[i][base] = state[i]
        for r in range(CYCLE_LENGTH):
            cols[BIT][base + r] = bit
        for r in range(NUM_ROUNDS):
            state = r128.apply_round(state, r)
            for i in range(STATE_WIDTH):
                cols[i][base + r + 1] = state[i]
        digest = state[:2]
        # the absorb transition into the next cycle is routed by the NEXT
        # level's bit, stored on this cycle's absorb row
        if lvl + 1 < depth:
            cols[BIT][base + CYCLE_LENGTH - 1] = (index >> (lvl + 1)) & 1
    return TraceTable.init(cols, field="f128")


def build_merkle128_traces(paths):
    """``build_merkle128_trace`` of each (leaf, siblings, index) in
    ``paths``, all of one depth, in one native call (OpenMP over the paths);
    raises if the host compiler is missing or the build fails."""
    from ..native import get_rescue128

    lib = get_rescue128()
    n, depth = len(paths), len(paths[0][1])
    assert all(len(sibs) == depth for _, sibs, _ in paths) and depth <= 64
    length = CYCLE_LENGTH * depth
    mask = 0xFFFFFFFFFFFFFFFF

    def words(vals):
        out = []
        for v in vals:
            v %= P
            out += [v & mask, v >> 64]
        return np.array(out, dtype=np.uint64)

    leaves = words([v for leaf, _, _ in paths for v in leaf])
    sibs = words([v for _, s, _ in paths for pair in s for v in pair])
    index = np.array([idx for _, _, idx in paths], dtype=np.uint64)
    lo = np.empty((n, TRACE_WIDTH, length), dtype=np.uint64)
    hi = np.empty((n, TRACE_WIDTH, length), dtype=np.uint64)
    vp = ctypes.c_void_p
    lib.r128_merkle_trace_batch(n, depth, *(a.ctypes.data_as(vp)
                                            for a in (leaves, sibs, index, lo, hi)))
    return [TraceTable.from_u64_pairs(lo[b], hi[b], "f128") for b in range(n)]


def compute_root128(leaf, siblings, index: int):
    """Host oracle: fold the path with Rescue128 merges."""
    digest = [v % P for v in leaf]
    for lvl, sib in enumerate(siblings):
        s = [v % P for v in sib]
        bit = (index >> lvl) & 1
        digest = r128.merge(s, digest) if bit else r128.merge(digest, s)
    return digest


class Merkle128Prover(Prover):
    air_class = Merkle128Air

    def __init__(self, options, hasher):
        self._options = options
        self.hasher = hasher

    def get_pub_inputs(self, trace: TraceTable) -> Merkle128Inputs:
        last = trace.length - 1
        return Merkle128Inputs([trace.get(i, last) for i in range(2)])

    def options(self):
        return self._options
