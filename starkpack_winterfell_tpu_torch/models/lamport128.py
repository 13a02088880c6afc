# Copy of starkpack_winterfell_tpu/models/lamport128.py; cut: the python-int fallbacks of the wallet digests and the trace builder (the native builders of native/rescue128.c run them, and raise if they cannot be built).
"""Lamport+ one-time-signature verification AIR over f128 — the reference's
headline Lamport configuration (SURVEY.md §2.8: f128 base field + SHA3
transcript), built on the legacy Rescue128 sponge the fork keeps at
examples/src/utils/rescue.rs.

Statement: "I know preimages s_i with Rescue128(s_i) = pk_{i,b_i} for every
bit b_i of the public message m, where the pk-hash pairs absorb to PK".

Trace (14 columns, cycles of 8 rows, k message bits, k+1 cycles):
  A (cols 0..5):  per-cycle Rescue128 hash of the revealed secret s_i
                  (state reset each cycle to [s0, s1, 0, 0, 0, 0])
  B (cols 6..11): running sponge absorbing one rate block (h_left ‖ h_right,
                  2+2 elements) per cycle boundary; the revealed-side hash is
                  A's digest, routed left/right by the message bit, the other
                  side is a signature witness
  b (col 12):     message bit for the cycle (boolean at absorb rows)
  m (col 13):     message accumulator m' = 2m + b at absorb rows

PK equals Rescue128.digest(h_00 ‖ h_01 ‖ ... ‖ h_{k-1}1) — exactly the
final B digest, since each pk pair is one rate-4 block.
"""

from __future__ import annotations

import ctypes
import random

import numpy as np

from ..air import Air, AirContext, Assertion, TransitionConstraintDegree
from ..crypto import rescue128 as r128
from ..crypto.rescue128 import (
    CYCLE_LENGTH,
    NUM_ROUNDS,
    STATE_WIDTH,
)
from ..math.fieldspec import F128_SPEC
from ..native import get_rescue128
from ..prover.pipeline import Prover
from ..prover.trace import TraceTable

P = F128_SPEC.P
A0 = 0
B0 = STATE_WIDTH  # 6
BIT = 2 * STATE_WIDTH  # 12
MSG = BIT + 1  # 13
TRACE_WIDTH = MSG + 1  # 14


class Lamport128Inputs:
    def __init__(self, message: int, pub_key):
        self.message = message
        self.pub_key = list(pub_key)  # 2 f128 elements

    def to_elements(self):
        return [self.message] + self.pub_key


class Lamport128Air(Air):
    def __init__(self, trace_info, pub_inputs, options):
        L = trace_info.length
        degrees = (
            [TransitionConstraintDegree.with_cycles(5, [CYCLE_LENGTH])
             for _ in range(STATE_WIDTH)]
            + [TransitionConstraintDegree.with_cycles(5, [CYCLE_LENGTH, L])
               for _ in range(STATE_WIDTH)]
            + [TransitionConstraintDegree.with_cycles(2, [CYCLE_LENGTH])]
            + [TransitionConstraintDegree.with_cycles(1, [CYCLE_LENGTH])]
        )
        self.context = AirContext(trace_info, degrees, 14, options,
                                  field=F128_SPEC)
        self.message = pub_inputs.message
        self.pub_key = pub_inputs.pub_key

    def evaluate_transition(self, frame, periodic_values, result):
        cur = frame.current()
        nxt = frame.next()
        flag = periodic_values[0]
        ark = periodic_values[1 : 1 + 2 * STATE_WIDTH]
        first7 = periodic_values[1 + 2 * STATE_WIDTH]
        one = 1
        b = cur[BIT]

        round_a = [None] * STATE_WIDTH
        r128.enforce_round(
            round_a, [cur[A0 + i] for i in range(STATE_WIDTH)],
            [nxt[A0 + i] for i in range(STATE_WIDTH)], ark, one,
        )
        round_b = [None] * STATE_WIDTH
        r128.enforce_round(
            round_b, [cur[B0 + i] for i in range(STATE_WIDTH)],
            [nxt[B0 + i] for i in range(STATE_WIDTH)], ark, one,
        )

        # A absorb: next_A = [free, free, 0, 0, 0, 0]
        absorb_a = [None] * STATE_WIDTH
        absorb_a[0] = cur[BIT] - cur[BIT]  # identically zero (free slot)
        absorb_a[1] = absorb_a[0]
        for i in range(2, STATE_WIDTH):
            absorb_a[i] = nxt[A0 + i]

        # B absorb: capacity carries; A's digest (cur A[0..2]) is added to
        # rate slots 0..2 when b == 0 and to slots 2..4 when b == 1; the
        # other pair of slots takes a free signature witness
        absorb_b = [None] * STATE_WIDTH
        for i in range(2):
            absorb_b[i] = (one - b) * (
                nxt[B0 + i] - cur[B0 + i] - cur[A0 + i]
            )
            absorb_b[2 + i] = b * (
                nxt[B0 + 2 + i] - cur[B0 + 2 + i] - cur[A0 + i]
            )
        for i in range(4, STATE_WIDTH):
            absorb_b[i] = nxt[B0 + i] - cur[B0 + i]

        copy_b = [nxt[B0 + i] - cur[B0 + i] for i in range(STATE_WIDTH)]

        for i in range(STATE_WIDTH):
            result[i] = flag * round_a[i] + (one - flag) * absorb_a[i]
        for i in range(STATE_WIDTH):
            regular = flag * round_b[i] + (one - flag) * absorb_b[i]
            result[STATE_WIDTH + i] = first7 * copy_b[i] + (one - first7) * regular
        result[BIT] = (one - flag) * b * (one - b)
        result[MSG] = flag * (nxt[MSG] - cur[MSG]) + (one - flag) * (
            nxt[MSG] - cur[MSG] - cur[MSG] - b
        )

    def get_assertions(self):
        last = self.trace_length() - 1
        assertions = []
        for i in range(2, STATE_WIDTH):
            assertions.append(Assertion.single(A0 + i, 0, 0))
        for i in range(STATE_WIDTH):
            assertions.append(Assertion.single(B0 + i, 0, 0))
        assertions.append(Assertion.single(MSG, 0, 0))
        for i, v in enumerate(self.pub_key):
            assertions.append(Assertion.single(B0 + i, last, v))
        assertions.append(Assertion.single(MSG, last, self.message))
        return assertions

    def get_periodic_column_values(self):
        L = self.trace_length()
        flag = [1] * NUM_ROUNDS + [0] * (CYCLE_LENGTH - NUM_ROUNDS)
        cols = [flag]
        cols.extend(r128.get_round_constants())
        first7 = [1] * NUM_ROUNDS + [0] * (L - NUM_ROUNDS)
        cols.append(first7)
        return cols


# ---------------------------------------------------------------------------
# key generation / signing / trace building (host-side "wallet")
# ---------------------------------------------------------------------------


def keygen(k: int, seed: int = 0):
    """k message bits -> secrets[bit][side] (2 f128 elements each) + pk-hash
    pairs + public key (2 elements)."""
    rng = random.Random(seed)
    secrets = [
        [[rng.randrange(P), rng.randrange(P)] for _ in range(2)]
        for _ in range(k)
    ]
    pk_hashes = _digest_pairs_batch(secrets, k)
    flat = []
    for h0, h1 in pk_hashes:
        flat.extend(h0)
        flat.extend(h1)
    pub_key = _digest_native(flat)
    return secrets, pk_hashes, pub_key


def _digest_native(elements):
    """One sponge digest by the native kernel (bit-identical to
    crypto/rescue128.py digest)."""
    lib = get_rescue128()
    inp = np.array(
        [x for e in elements for x in (e & 0xFFFFFFFFFFFFFFFF, e >> 64)],
        dtype=np.uint64,
    )
    out = np.zeros(4, dtype=np.uint64)
    vp = ctypes.c_void_p
    lib.r128_digest_batch(inp.ctypes.data_as(vp), len(elements), 1,
                          out.ctypes.data_as(vp))
    return [int(out[0]) | (int(out[1]) << 64), int(out[2]) | (int(out[3]) << 64)]


def _digest_pairs_batch(secrets, k):
    """pk hashes for all 2k secret pairs in one native call."""
    lib = get_rescue128()
    elems = []
    for i in range(k):
        for side in range(2):
            for e in secrets[i][side]:
                elems.append(e & 0xFFFFFFFFFFFFFFFF)
                elems.append(e >> 64)
    inp = np.array(elems, dtype=np.uint64)
    out = np.zeros(2 * k * 4, dtype=np.uint64)
    vp = ctypes.c_void_p
    lib.r128_digest_batch(inp.ctypes.data_as(vp), 2, 2 * k,
                          out.ctypes.data_as(vp))
    hashes = []
    for i in range(2 * k):
        o = out[4 * i : 4 * i + 4]
        hashes.append([int(o[0]) | (int(o[1]) << 64),
                       int(o[2]) | (int(o[3]) << 64)])
    return [[hashes[2 * i], hashes[2 * i + 1]] for i in range(k)]


def sign(secrets, pk_hashes, message: int, k: int):
    """Returns per-bit (revealed secret, other-side hash)."""
    sig = []
    for i in range(k):
        bit = (message >> (k - 1 - i)) & 1
        sig.append((secrets[i][bit], pk_hashes[i][1 - bit]))
    return sig


def build_lamport128_trace(message: int, sig, k: int) -> TraceTable:
    """The 14 x 8*(k+1) signature trace, built by the native builder
    (native/rescue128.c lamport128_trace): the wallet-side scalar Rescue
    chain the accelerator cannot help with."""
    lib = get_rescue128()
    length = CYCLE_LENGTH * (k + 1)
    bits = np.array([(message >> (k - 1 - c)) & 1 for c in range(k)],
                    dtype=np.uint64)
    rev = np.zeros(4 * k, dtype=np.uint64)
    oth = np.zeros(4 * k, dtype=np.uint64)
    mask = 0xFFFFFFFFFFFFFFFF
    for c in range(k):
        revealed, other = sig[c]
        rev[4 * c + 0] = revealed[0] & mask
        rev[4 * c + 1] = revealed[0] >> 64
        rev[4 * c + 2] = revealed[1] & mask
        rev[4 * c + 3] = revealed[1] >> 64
        oth[4 * c + 0] = other[0] & mask
        oth[4 * c + 1] = other[0] >> 64
        oth[4 * c + 2] = other[1] & mask
        oth[4 * c + 3] = other[1] >> 64
    lo = np.zeros((TRACE_WIDTH, length), dtype=np.uint64)
    hi = np.zeros((TRACE_WIDTH, length), dtype=np.uint64)
    vp = ctypes.c_void_p
    lib.lamport128_trace(
        k, bits.ctypes.data_as(vp), rev.ctypes.data_as(vp),
        oth.ctypes.data_as(vp), lo.ctypes.data_as(vp), hi.ctypes.data_as(vp),
    )
    return TraceTable.from_u64_pairs(lo, hi, "f128")


class Lamport128Prover(Prover):
    air_class = Lamport128Air

    def __init__(self, options, hasher):
        self._options = options
        self.hasher = hasher

    def get_pub_inputs(self, trace: TraceTable) -> Lamport128Inputs:
        last = trace.length - 1
        pub_key = [trace.get(B0 + i, last) for i in range(2)]
        return Lamport128Inputs(trace.get(MSG, last), pub_key)

    def options(self):
        return self._options
