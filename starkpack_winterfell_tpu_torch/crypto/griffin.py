# Copy of starkpack_winterfell_tpu/crypto/griffin.py; cut: the python-int and vectorized limb permutations (the byte API runs on the C permutation of native/griffin_perm.c, the words API on ops/rescue_sponge.py) and what crypto/rescue_jive.py:JiveHasher holds for both Jive hashers.
"""GriffinJive64_256 — the Griffin permutation in Jive compression mode
(crypto/src/hash/griffin/griffin64_256_jive/mod.rs): state width 8, rate
0..4, capacity 4..8, digest = state[0..4]; 7 "rounds" = 6 rounds with
constants + a final non-linear+linear pass.

Non-linear layer: s0 <- s0^{1/7}, s1 <- s1^7, then for i = 2..7:
  l_i = (i-1)*s0 + s1 + s_{i-1}   (s_{i-1} already updated)
  s_i <- s_i * (l_i^2 + ALPHA[i-2]*l_i + BETA[i-2])
"""

from __future__ import annotations

import numpy as np

from ..ops import rescue_sponge as rsp
from ._native_perm import make_native_griffin
from .rescue_jive import JiveHasher

_NATIVE: dict = {}


class GriffinJive64_256(JiveHasher):
    NAME = "griffin_jive64_256"
    LAYOUT = rsp.GRIFFIN64_256

    @classmethod
    def _native(cls) -> dict:
        """The C permutation and Jive sponge of native/griffin_perm.c."""
        if not _NATIVE:
            sponge = make_native_griffin()

            def permute(state):
                arr = np.array([state], dtype=np.uint64)
                return sponge.permute_rows(arr)[0].tolist()

            _NATIVE.update(permute=permute, sponge=sponge)
        return _NATIVE
