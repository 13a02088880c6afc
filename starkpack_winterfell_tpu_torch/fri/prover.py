"""FRI prover pieces of the big-trace path.

Counterpart of starkpack_winterfell_tpu/fri/prover.py cut to the three
functions prover/device.py borrows: ``drp_inv_offsets`` (:146),
``apply_drp_limbs`` (:160) and ``fold_positions`` (:311).  The host
``FriProver`` / ``LimbFriProver`` classes are not ported.
"""

from __future__ import annotations

from ..math import scalar as fs
from ..ops import gl64 as gl, ntt, vec


def drp_inv_offsets(m: int, N: int, domain_offset: int, device="cpu"):
    """(c * w^i)^{-1} for i in 0..m — the per-row evaluation-point scale of
    the degree-respecting projection (w = root of the m*N source domain)."""
    src_size = m * N
    g = fs.get_root_of_unity(src_size.bit_length() - 1)
    inv_g = pow(g, fs.P - 2, fs.P)
    inv_c = pow(domain_offset, fs.P - 2, fs.P)
    inv_offs = ntt.power_series(inv_g, m, device)
    return gl.mul(inv_offs, gl.from_int(inv_c, (1,), device))  # (m,)


def apply_drp_limbs(transposed, domain_offset: int, alpha_l, ext_deg: int,
                    inv_offs=None):
    """Degree-respecting projection (fri/src/folding/mod.rs:85-117).

    transposed: tuple of tensors shaped (m, N) — row i holds f at the N
    source positions folding to position i.  Row i's micro-coset has offset
    c * w^i; interpolation + evaluation at alpha collapses to Horner at
    (c * w^i)^{-1} * alpha over the row's iNTT.  alpha_l: ext element as
    (1,)-shaped tensors."""
    m, N = transposed[0].shape
    coeffs = ntt.interpolate_poly(transposed)  # per-row iNTT incl. 1/N scale
    if inv_offs is None:
        inv_offs = drp_inv_offsets(m, N, domain_offset, transposed[0].device)
    x = vec.vmul(vec.vbroadcast(alpha_l, (m,)), (inv_offs,))
    return vec.horner(coeffs, x, axis=-1)


def fold_positions(positions, source_domain_size: int, folding_factor: int):
    """fri/src/folding/mod.rs:158-175 — mod + dedup preserving order."""
    target = source_domain_size // folding_factor
    result = []
    for p in positions:
        p = p % target
        if p not in result:
            result.append(p)
    return result
