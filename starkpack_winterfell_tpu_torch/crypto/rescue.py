# Copy of starkpack_winterfell_tpu/crypto/rescue.py; cut: the Rp64_256 hasher class, the vectorized limb permutation and the native permutation tier; the constants and the python-int permutation stay.
"""Rescue-Prime Rp64_256 permutation — equivalent of
crypto/src/hash/rescue/rp64_256/.

State 12, rate 8, capacity 4, digest 4 elements, 7 rounds of
(x^7 -> MDS -> ARK1 -> x^{1/7} -> MDS -> ARK2)  [rp64_256/mod.rs:296-360].
Only what the Rescue hash-chain AIR needs is here: the protocol constants
and the host permutation on python ints.
"""

from __future__ import annotations

from ..math import scalar as fs
from .rescue_constants import ARK1, ARK2, INV_MDS, MDS  # noqa: F401

P = fs.P
STATE_WIDTH = 12
RATE = 8
CAPACITY = 4
DIGEST_SIZE = 4
NUM_ROUNDS = 7
ALPHA = 7
INV_ALPHA = 10540996611094048183


def round_ints(state, r: int):
    """One Rescue round on a list of python ints."""
    state = [pow(x, ALPHA, P) for x in state]
    state = _mds_ints(state)
    state = [(x + c) % P for x, c in zip(state, ARK1[r])]
    state = [pow(x, INV_ALPHA, P) for x in state]
    state = _mds_ints(state)
    return [(x + c) % P for x, c in zip(state, ARK2[r])]


def apply_permutation_ints(state):
    for r in range(NUM_ROUNDS):
        state = round_ints(state, r)
    return state


def _mds_ints(state):
    return [
        sum(MDS[i][j] * state[j] for j in range(STATE_WIDTH)) % P
        for i in range(STATE_WIDTH)
    ]
