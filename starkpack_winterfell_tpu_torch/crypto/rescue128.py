# Copy of starkpack_winterfell_tpu/crypto/rescue128.py; cut: _felt_mds's own tiers (it calls ops/felt.mds_apply: raw-int row dots for the verifier's ScalarFelt, per-term field math for tensor Felts).
"""Rescue128 — the legacy f128 Rescue-XLIX sponge kept by the fork for its
example AIRs (examples/src/utils/rescue.rs:14-118: state 6, rate 4, digest 2,
7 rounds padded to an 8-step cycle, alpha = 5).

Host path: python-int scalar permutation (used by signers / trace builders).
Circuit path: ``enforce_round`` mirrors rescue.rs:210-240 on Felt arrays —
both halves of the round are expressed forward (S-box on ``current``,
inverse-MDS + S-box on ``next``) so the constraint degree stays 5.
"""

from __future__ import annotations

from ..math.fieldspec import F128_SPEC
from .rescue128_constants import (
    ALPHA,
    ARK,
    CYCLE_LENGTH,
    DIGEST_SIZE,
    INV_ALPHA,
    INV_MDS,
    MDS,
    NUM_ROUNDS,
    RATE_WIDTH,
    STATE_WIDTH,
)

P = F128_SPEC.P


# -- host scalar permutation --------------------------------------------------

def _apply_sbox(state):
    return [pow(x, ALPHA, P) for x in state]


def _apply_inv_sbox(state):
    return [pow(x, INV_ALPHA, P) for x in state]


def _apply_mds(state, m):
    return [sum(m[i][j] * state[j] for j in range(STATE_WIDTH)) % P
            for i in range(STATE_WIDTH)]


def apply_round(state, step: int):
    """rescue.rs:186-206."""
    ark = ARK[step % CYCLE_LENGTH]
    state = _apply_mds(_apply_sbox(state), MDS)
    state = [(x + k) % P for x, k in zip(state, ark[:STATE_WIDTH])]
    state = _apply_mds(_apply_inv_sbox(state), MDS)
    state = [(x + k) % P for x, k in zip(state, ark[STATE_WIDTH:])]
    return state


def apply_permutation(state):
    """rescue.rs:178-183."""
    for i in range(NUM_ROUNDS):
        state = apply_round(state, i)
    return state


def digest(elements):
    """Sponge over rate-4 blocks (rescue.rs:96-117); returns a 2-element
    digest.  No padding — matches the reference's behavior exactly."""
    state = [0] * STATE_WIDTH
    i = 0
    for e in elements:
        state[i] = (state[i] + e) % P
        i += 1
        if i % RATE_WIDTH == 0:
            state = apply_permutation(state)
            i = 0
    if i > 0:
        state = apply_permutation(state)
    return [state[0], state[1]]


def merge(a, b):
    """rescue.rs:131-133 — digest of the concatenated digest elements."""
    return digest(list(a) + list(b))


def get_round_constants():
    """Column-major ARK as 12 periodic columns of length 8
    (rescue.rs:247-261)."""
    return [[ARK[i][j] for i in range(CYCLE_LENGTH)]
            for j in range(STATE_WIDTH * 2)]


# -- circuit helpers ----------------------------------------------------------

def enforce_round(result, current, next_, ark, flag):
    """When flag == 1 enforce one Rescue round between ``current`` and
    ``next_`` (lists of 6 Felts); ark: 12 Felts (rescue.rs:210-240).
    Accumulates flag * (step2_i - step1_i) into result[i]."""
    step1 = [c ** ALPHA for c in current]
    step1 = _felt_mds(step1, MDS)
    step1 = [s + ark[i] for i, s in enumerate(step1)]

    step2 = [next_[i] - ark[STATE_WIDTH + i] for i in range(STATE_WIDTH)]
    step2 = _felt_mds(step2, INV_MDS)
    step2 = [s ** ALPHA for s in step2]

    for i in range(STATE_WIDTH):
        delta = flag * (step2[i] - step1[i])
        result[i] = delta if result[i] is None else result[i] + delta


def _felt_mds(state, m):
    from ..ops.felt import mds_apply

    return mds_apply(list(state), m)
