# Copy of starkpack_winterfell_tpu/models/lamport128_agg.py; cut: the device trace builder (_exp_scan, _dev_round, _dev_build_kernel, attach_device_builder: the trace goes to the card with one copy) and the python fallbacks of the wallet and the trace builder (the native builders of native/rescue128.c run them).
"""Aggregated Lamport+ signature verification over f128 — MANY signatures in
ONE execution trace (the shape of the reference README's Lamport benchmark
table, README.md:417-442: trace/prover time linear in #sigs, proof size and
verifier time logarithmic).

Unlike `models/lamport128.py` (one signature per StarkPack instance, proof
size O(n)), this AIR stacks n signatures as consecutive 8*(k+1)-row blocks of
a single trace, so the whole aggregate shares one commitment, one composition
polynomial and one FRI proof: proof size grows only with log(trace length).

Trace layout (14 columns, identical per-block semantics to lamport128.py):
  block s = rows [s*B, (s+1)*B) with B = 8*(k+1), k = message bits
  A (0..5):  per-cycle Rescue128 hash of the revealed secret
  B (6..11): running sponge absorbing one (h_left ‖ h_right) rate block per
             cycle boundary, routed by the message bit
  b (12):    message bit for the cycle
  m (13):    message accumulator m' = 2m + b

Block boundaries (row s*B - 1 -> s*B) switch the transition constraints to a
RESET: next B state = 0, next m = 0, next A capacity = 0 — so every block
starts a fresh sponge.  Per-block outputs are bound with SEQUENCE assertions
(air/src/air/assertions/mod.rs:103 semantics): columns B0/B1 and m at steps
{B-1 + s*B} must equal the s-th public key / message.

The per-signature row count (1024 rows at k=127) matches the reference
benchmark's SIG_CYCLE_LENGTH so trace sizes are directly comparable.
"""

from __future__ import annotations

import ctypes
import random

import numpy as np

from ..air import Air, AirContext, Assertion, TransitionConstraintDegree
from ..crypto import rescue128 as r128
from ..crypto.rescue128 import CYCLE_LENGTH, NUM_ROUNDS, STATE_WIDTH
from ..math.fieldspec import F128_SPEC
from ..native import get_rescue128
from ..prover.pipeline import Prover
from ..prover.trace import TraceTable
from .lamport128 import (
    A0,
    B0,
    BIT,
    MSG,
    TRACE_WIDTH,
    keygen,
    sign,
)

P = F128_SPEC.P


class LamportAggInputs:
    """Per-signature (message, pub_key) pairs; to_elements flattens all of
    them into the Fiat-Shamir seed."""

    def __init__(self, messages, pub_keys):
        assert len(messages) == len(pub_keys)
        self.messages = list(messages)
        self.pub_keys = [list(pk) for pk in pub_keys]

    def to_elements(self):
        out = []
        for m, pk in zip(self.messages, self.pub_keys):
            out.append(m)
            out.extend(pk)
        return out


class Lamport128AggAir(Air):
    def __init__(self, trace_info, pub_inputs, options):
        L = trace_info.length
        n = len(pub_inputs.messages)
        assert L % (CYCLE_LENGTH * n) == 0, "trace/blocks mismatch"
        block = L // n
        self.block_length = block
        self.num_bits = block // CYCLE_LENGTH - 1
        degrees = (
            [TransitionConstraintDegree.with_cycles(5, [CYCLE_LENGTH])
             for _ in range(STATE_WIDTH)]
            + [TransitionConstraintDegree.with_cycles(5, [CYCLE_LENGTH, block,
                                                          block])
               for _ in range(STATE_WIDTH)]
            + [TransitionConstraintDegree.with_cycles(2, [CYCLE_LENGTH])]
            + [TransitionConstraintDegree.with_cycles(1, [CYCLE_LENGTH,
                                                          block])]
        )
        num_assertions = STATE_WIDTH - 2 + STATE_WIDTH + 1 + 3
        self.context = AirContext(trace_info, degrees, num_assertions,
                                  options, field=F128_SPEC)
        self.pub_inputs = pub_inputs

    def evaluate_transition(self, frame, periodic_values, result):
        cur = frame.current()
        nxt = frame.next()
        flag = periodic_values[0]
        ark = periodic_values[1 : 1 + 2 * STATE_WIDTH]
        first7 = periodic_values[1 + 2 * STATE_WIDTH]
        reset = periodic_values[2 + 2 * STATE_WIDTH]
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

        # A absorb: next_A = [free, free, 0, 0, 0, 0] — also exactly what the
        # next block's first cycle needs, so no special-casing at resets
        absorb_a = [None] * STATE_WIDTH
        absorb_a[0] = cur[BIT] - cur[BIT]  # identically zero (free slot)
        absorb_a[1] = absorb_a[0]
        for i in range(2, STATE_WIDTH):
            absorb_a[i] = nxt[A0 + i]

        # B absorb (within a block): capacity carries; A's digest is added to
        # rate slots 0..1 when b == 0 and to slots 2..3 when b == 1
        absorb_b = [None] * STATE_WIDTH
        for i in range(2):
            absorb_b[i] = (one - b) * (nxt[B0 + i] - cur[B0 + i] - cur[A0 + i])
            absorb_b[2 + i] = b * (nxt[B0 + 2 + i] - cur[B0 + 2 + i]
                                   - cur[A0 + i])
        for i in range(4, STATE_WIDTH):
            absorb_b[i] = nxt[B0 + i] - cur[B0 + i]

        copy_b = [nxt[B0 + i] - cur[B0 + i] for i in range(STATE_WIDTH)]

        for i in range(STATE_WIDTH):
            result[i] = flag * round_a[i] + (one - flag) * absorb_a[i]
        # B: last row of a block resets the sponge (next_B = 0); first cycle
        # of a block copies; otherwise rounds/absorbs as in lamport128.py
        for i in range(STATE_WIDTH):
            regular = flag * round_b[i] + (one - flag) * absorb_b[i]
            in_block = first7 * copy_b[i] + (one - first7) * regular
            result[STATE_WIDTH + i] = (
                reset * nxt[B0 + i] + (one - reset) * in_block
            )
        result[BIT] = (one - flag) * b * (one - b)
        accumulate = nxt[MSG] - cur[MSG] - cur[MSG] - b
        in_block_m = flag * (nxt[MSG] - cur[MSG]) + (one - flag) * accumulate
        result[MSG] = reset * nxt[MSG] + (one - reset) * in_block_m

    def get_assertions(self):
        block = self.block_length
        n = len(self.pub_inputs.messages)
        last = block - 1
        assertions = []
        for i in range(2, STATE_WIDTH):
            assertions.append(Assertion.single(A0 + i, 0, 0))
        for i in range(STATE_WIDTH):
            assertions.append(Assertion.single(B0 + i, 0, 0))
        assertions.append(Assertion.single(MSG, 0, 0))
        pk0 = [pk[0] for pk in self.pub_inputs.pub_keys]
        pk1 = [pk[1] for pk in self.pub_inputs.pub_keys]
        if n == 1:
            assertions.append(Assertion.single(B0, last, pk0[0]))
            assertions.append(Assertion.single(B0 + 1, last, pk1[0]))
            assertions.append(
                Assertion.single(MSG, last, self.pub_inputs.messages[0]))
        else:
            assertions.append(Assertion.sequence(B0, last, block, pk0))
            assertions.append(Assertion.sequence(B0 + 1, last, block, pk1))
            assertions.append(
                Assertion.sequence(MSG, last, block, self.pub_inputs.messages))
        return assertions

    def periodic_cache_key(self):
        # first7/reset have period block_length, which depends on the
        # signature count, not just the trace length
        return (self.block_length,)

    def get_periodic_column_values(self):
        block = self.block_length
        flag = [1] * NUM_ROUNDS + [0] * (CYCLE_LENGTH - NUM_ROUNDS)
        cols = [flag]
        cols.extend(r128.get_round_constants())
        first7 = [0] * block
        for r in range(NUM_ROUNDS):
            first7[r] = 1
        cols.append(first7)
        reset = [0] * block
        reset[block - 1] = 1
        cols.append(reset)
        return cols


# ---------------------------------------------------------------------------
# wallet + trace building
# ---------------------------------------------------------------------------


def make_wallet(n_sigs: int, k: int = 127, seed: int = 0):
    """n independent keypairs + random k-bit messages + signatures.
    Returns (messages, pub_keys, sigs).  Bit-identical to looping
    lamport128.keygen per signature, but all 2*n*k pk-hash digests and all
    n pub-key sponges run as two batched native calls (OpenMP-parallel)."""
    rng = random.Random(seed ^ 0xA55)
    all_secrets = []
    for s in range(n_sigs):
        srng = random.Random(seed + 1000003 * s)
        all_secrets.append(
            [[[srng.randrange(P), srng.randrange(P)] for _ in range(2)]
             for _ in range(k)]
        )
    messages = [rng.getrandbits(k) | (1 << (k - 1)) for _ in range(n_sigs)]

    lib = get_rescue128()
    mask = 0xFFFFFFFFFFFFFFFF
    flat = np.empty(n_sigs * k * 2 * 2 * 2, dtype=np.uint64)
    i = 0
    for sec in all_secrets:
        for pair in sec:
            for side in pair:
                for e in side:
                    flat[i] = e & mask
                    flat[i + 1] = e >> 64
                    i += 2
    vp = ctypes.c_void_p
    # one digest per (sig, bit, side): m=2 elements each
    hashes = np.zeros(n_sigs * k * 2 * 4, dtype=np.uint64)
    lib.r128_digest_batch(flat.ctypes.data_as(vp), 2, n_sigs * k * 2,
                          hashes.ctypes.data_as(vp))
    h = hashes.reshape(n_sigs, k, 2, 2, 2)  # (sig, bit, side, elem, limb)
    # pub key per sig = digest of all 4k pk-hash elements in order
    pk_in = np.ascontiguousarray(
        h.reshape(n_sigs, k * 2 * 2, 2))  # (sig, 4k elems, limbs)
    pk_out = np.zeros(n_sigs * 4, dtype=np.uint64)
    lib.r128_digest_batch(pk_in.ctypes.data_as(vp), 4 * k, n_sigs,
                          pk_out.ctypes.data_as(vp))
    pk_hashes_all = [
        [[[int(h[s, i_, sd, 0, 0]) | (int(h[s, i_, sd, 0, 1]) << 64),
           int(h[s, i_, sd, 1, 0]) | (int(h[s, i_, sd, 1, 1]) << 64)]
          for sd in range(2)]
         for i_ in range(k)]
        for s in range(n_sigs)
    ]
    pub_keys = [
        [int(pk_out[4 * s]) | (int(pk_out[4 * s + 1]) << 64),
         int(pk_out[4 * s + 2]) | (int(pk_out[4 * s + 3]) << 64)]
        for s in range(n_sigs)
    ]

    sigs = [sign(all_secrets[s], pk_hashes_all[s], messages[s], k)
            for s in range(n_sigs)]
    return messages, pub_keys, sigs


_PAD_WALLET_CACHE: dict = {}


def pad_wallet(messages, pub_keys, sigs, bucket: int, k: int = 127):
    """Extend a wallet to `bucket` signatures with deterministic dummy
    keypairs signing fixed messages: canonical-size padding, so that one
    prove configuration (its cached plan tables and constraint kernel)
    serves any n <= bucket.

    The proof attests the PADDED statement (bucket signatures, the first n
    of them the caller's; the verifier checks the padded pub-key list).
    Dummy keypairs are deterministic per (k, index) and cached in-process,
    so repeated pads cost one native digest batch the first time only."""
    n = len(messages)
    assert bucket >= n and bucket & (bucket - 1) == 0
    m2, p2, s2 = list(messages), list(pub_keys), list(sigs)
    for i in range(bucket - n):
        key = (k, i)
        if key not in _PAD_WALLET_CACHE:
            secrets, pk_hashes, pub_key = keygen(k, seed=0x9AD0000 + i)
            msg = (1 << (k - 1)) | (i + 1)  # top bit set (valid k-bit msg)
            _PAD_WALLET_CACHE[key] = (
                msg, pub_key, sign(secrets, pk_hashes, msg, k)
            )
        msg, pub_key, sig = _PAD_WALLET_CACHE[key]
        m2.append(msg)
        p2.append(pub_key)
        s2.append(sig)
    return m2, p2, s2


def build_lamport128_agg_trace(messages, sigs, k: int = 127) -> TraceTable:
    """One trace of n_sigs consecutive blocks; each block is bit-identical to
    the single-signature trace (fresh sponge per block).  Blocks are
    independent (the reference README highlights exactly this parallelism,
    README.md:432), so the native builder runs them OpenMP-parallel."""
    assert (k + 1) & k == 0, "k + 1 must be a power of two (block alignment)"
    return _build_agg_native(messages, sigs, k)


def _build_agg_native(messages, sigs, k: int):
    lib = get_rescue128()
    n = len(messages)
    block = CYCLE_LENGTH * (k + 1)
    mask = 0xFFFFFFFFFFFFFFFF
    bits = np.empty(n * k, dtype=np.uint64)
    rev = np.empty(n * 4 * k, dtype=np.uint64)
    oth = np.empty(n * 4 * k, dtype=np.uint64)
    for s in range(n):
        m = messages[s]
        sig = sigs[s]
        for c in range(k):
            bits[s * k + c] = (m >> (k - 1 - c)) & 1
            revealed, other = sig[c]
            o = s * 4 * k + 4 * c
            rev[o] = revealed[0] & mask
            rev[o + 1] = revealed[0] >> 64
            rev[o + 2] = revealed[1] & mask
            rev[o + 3] = revealed[1] >> 64
            oth[o] = other[0] & mask
            oth[o + 1] = other[0] >> 64
            oth[o + 2] = other[1] & mask
            oth[o + 3] = other[1] >> 64
    lo = np.zeros((TRACE_WIDTH, n * block), dtype=np.uint64)
    hi = np.zeros((TRACE_WIDTH, n * block), dtype=np.uint64)
    vp = ctypes.c_void_p
    lib.lamport128_trace_batch(
        n, k, bits.ctypes.data_as(vp), rev.ctypes.data_as(vp),
        oth.ctypes.data_as(vp), lo.ctypes.data_as(vp), hi.ctypes.data_as(vp),
    )
    meta = n.to_bytes(4, "little")
    return TraceTable.from_u64_pairs(lo, hi, "f128", meta=meta)


def _u64_planes(trace: TraceTable):
    """(lo, hi) u64 planes of a trace regardless of its internal staging."""
    lo, hi = trace._planes
    return lo, hi


class Lamport128AggProver(Prover):
    air_class = Lamport128AggAir

    def __init__(self, options, hasher, num_sigs: int | None = None):
        self._options = options
        self.hasher = hasher
        self.num_sigs = num_sigs

    def get_pub_inputs(self, trace: TraceTable) -> LamportAggInputs:
        n = self.num_sigs
        if n is None:  # sig count rides the trace meta bytes
            n = int.from_bytes(trace.meta[:4], "little")
        block = trace.length // n
        ends = [s * block + block - 1 for s in range(n)]
        messages = [trace.get(MSG, e) for e in ends]
        pub_keys = [[trace.get(B0, e), trace.get(B0 + 1, e)] for e in ends]
        return LamportAggInputs(messages, pub_keys)

    def options(self):
        return self._options
