"""Constraint-evaluation helpers of the big-trace path.

Counterpart of starkpack_winterfell_tpu/prover/constraints.py cut to
``_inv_divisor_numerator`` (:214); the host ``ConstraintEvaluator`` and
``apply_divisors`` are not ported.
"""

from __future__ import annotations

import numpy as np


def _inv_divisor_numerator(divisor, domain) -> np.ndarray:
    """Inverted evaluations of (x^a - b) over its period on the ce domain,
    as a (ce/a,) numpy uint64 array.  Only called for short periods (host
    tables tiled over a chunk), so python ints with one Montgomery batch
    inversion do."""
    P = domain.field.P
    a, b = divisor.numerator[0]
    n = domain.ce_size // a
    # x^a over the ce domain has period n: (offset*g^i)^a = offset^a * g^(ia)
    g_a = pow(domain.ce_domain_generator(), a, P)
    x = pow(domain.domain_offset, a, P)
    vals = []
    for _ in range(n):
        vals.append((x - b) % P)
        x = x * g_a % P
    pref = [1] * (n + 1)
    for i, v in enumerate(vals):
        pref[i + 1] = pref[i] * v % P
    inv = pow(pref[n], P - 2, P)
    out = np.empty(n, dtype=np.uint64)
    for i in range(n - 1, -1, -1):
        out[i] = pref[i] * inv % P
        inv = inv * vals[i] % P
    return out
