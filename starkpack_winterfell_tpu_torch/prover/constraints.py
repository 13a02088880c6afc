"""Constraint-evaluation helpers of the f64 device paths.

Counterpart of starkpack_winterfell_tpu/prover/constraints.py cut to
``PeriodicValueTable`` (:21), ``_inv_divisor_numerator`` (:214) and
``_exemptions_eval`` (:230), for f64 on tensors; the host
``ConstraintEvaluator`` and ``apply_divisors`` are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gl64 as gl, ntt


def tile_period(x, length: int):
    """(m,) table -> (length,) by repetition (m divides length)."""
    m = x.shape[0]
    return x.unsqueeze(0).expand(length // m, m).reshape(length)


class PeriodicValueTable:
    """prover/src/constraints/periodic_table.rs — per-column ce-domain values
    on ``device``: column j's value at ce step i is evals_j[i % len_j], held
    as a (ce,) tensor (one period repeated).  Columns of one cycle length are
    evaluated in one batched transform."""

    def __init__(self, air, device="cpu"):
        polys = air.get_periodic_column_polys()
        self.columns = [None] * len(polys)
        ce = air.ce_domain_size()
        by_len = {}
        for j, poly in enumerate(polys):
            by_len.setdefault(len(poly), []).append(j)
        for poly_size, js in by_len.items():
            num_cycles = air.trace_length() // poly_size
            offset = pow(air.domain_offset(), num_cycles, gl.P)
            coeffs = gl.from_u64(np.array([polys[j] for j in js], dtype=np.uint64), device)
            evals = ntt.evaluate_poly_with_offset(
                (coeffs,), offset, air.ce_blowup_factor())[0]  # (len(js), period)
            for row, j in enumerate(js):
                self.columns[j] = tile_period(evals[row], ce)


def _exemptions_eval(divisor, domain, device="cpu") -> torch.Tensor:
    """prod (x - e_j) over the ce domain, a (ce,) tensor on ``device``."""
    x = gl.mul(ntt.power_series(domain.ce_domain_generator(), domain.ce_size, device),
               gl.from_int(domain.domain_offset, (), device))
    result = gl.ones(x.shape, device)
    for e in divisor.exemptions:
        result = gl.mul(result, gl.sub(x, gl.from_int(e, (), device)))
    return result


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
