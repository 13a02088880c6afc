"""Vectorized element operations on component tuples.

Counterpart of starkpack_winterfell_tpu/ops/vec.py.  An element array is a
tuple of ``deg`` int64 tensors (see ops/gl64.py), deg = 1, 2 or 3; the
quadratic and cubic products are those of ops/gl64_ext.py.
"""

from __future__ import annotations

import torch

from . import gl64 as gl
from . import gl64_ext as ext


def deg(a) -> int:
    return len(a)


def promote(a, target_deg: int):
    if len(a) == target_deg:
        return a
    assert len(a) == 1, "can only promote base elements"
    return a + (torch.zeros_like(a[0]),) * (target_deg - 1)


def vadd(a, b):
    d = max(len(a), len(b))
    a, b = promote(a, d), promote(b, d)
    return tuple(gl.add(x, y) for x, y in zip(a, b))


def vsub(a, b):
    d = max(len(a), len(b))
    a, b = promote(a, d), promote(b, d)
    return tuple(gl.sub(x, y) for x, y in zip(a, b))


def vneg(a):
    return tuple(gl.neg(x) for x in a)


def vmul(a, b):
    """Full product with base-mul shortcut when either side is base."""
    if len(a) == 1 and len(b) == 1:
        return (gl.mul(a[0], b[0]),)
    if len(b) == 1:
        return tuple(gl.mul(x, b[0]) for x in a)
    if len(a) == 1:
        return tuple(gl.mul(a[0], y) for y in b)
    if len(a) == 2:
        return ext.mul2(a, b)
    return ext.mul3(a, b)


def vsquare(a):
    if len(a) == 1:
        return (gl.square(a[0]),)
    return ext.square2(a) if len(a) == 2 else ext.square3(a)


def vinv(a):
    if len(a) == 1:
        return (gl.inv(a[0]),)
    return ext.inv2(a) if len(a) == 2 else ext.inv3(a)


def vzeros(shape, d: int = 1, device="cpu"):
    return tuple(gl.zeros(shape, device) for _ in range(d))


def vones(shape, d: int = 1, device="cpu"):
    return (gl.ones(shape, device),) + tuple(
        gl.zeros(shape, device) for _ in range(d - 1)
    )


def vwhere(cond, a, b):
    d = max(len(a), len(b))
    a, b = promote(a, d), promote(b, d)
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def vbroadcast(a, shape):
    return tuple(c.broadcast_to(shape) for c in a)


def vsum(a, axis=-1):
    """Modular sum along an axis via log-halving tree reduction (a plain
    ``sum`` would overflow the 64-bit words)."""
    comps = a
    nd = comps[0].ndim
    axis = axis % nd
    n = comps[0].shape[axis]
    while n > 1:
        half = n // 2
        new_comps = []
        for c in comps:
            s = gl.add(c.narrow(axis, 0, half), c.narrow(axis, half, half))
            if n % 2:
                s = torch.cat([s, c.narrow(axis, 2 * half, 1)], dim=axis)
            new_comps.append(s)
        comps = tuple(new_comps)
        n = comps[0].shape[axis]
    return tuple(c.select(axis, 0) for c in comps)


def horner(coeffs, x, axis=-1):
    """Evaluate polynomials along ``axis`` at point-array x (same shape as
    the remaining axes)."""
    n = coeffs[0].shape[axis]

    def take(j):
        return tuple(c.select(axis, j) for c in coeffs)

    acc = take(n - 1)
    for j in range(n - 2, -1, -1):
        acc = vadd(vmul(acc, x), take(j))
    return acc


def suffix_sums(a, axis=-1):
    """Inclusive suffix sums along ``axis`` via Hillis-Steele doubling —
    log2(n) full-width modular adds."""
    n = a[0].shape[axis]
    axis = axis % a[0].ndim
    comps = a
    shift = 1
    while shift < n:
        # c + shift_left(c), where shifted-out positions add zero
        comps = tuple(
            gl.add(c, torch.cat([c.narrow(axis, shift, n - shift),
                                 torch.zeros_like(c.narrow(axis, 0, shift))], dim=axis))
            for c in comps
        )
        shift *= 2
    return comps


def syn_div_tables(z, nn: int):
    """The two series ``syn_div_binomial`` needs for the point z and length
    nn: (z^j, z^{-(j+1)}), each shaped (nn,).  One pair serves every
    polynomial divided by (x - z)."""
    z_inv = vinv(z)
    zi = vmul(power_series_elem(z_inv, nn), vbroadcast(z_inv, (nn,)))
    return power_series_elem(z, nn), zi


def syn_div_binomial(p, z, tables=None):
    """Divide polynomial p (coefficient component tuple, shape (..., n)) by
    (x - z) where z is a nonzero element (shape-(1,) component tuple) and
    p(z) == 0.

    Uses q_i = z^{-(i+1)} * sum_{j>i} p_j z^j — exact in field arithmetic and
    fully parallel (one power series + suffix scan + two multiplies), in
    place of the reference's sequential synthetic division
    (polynom/mod.rs:524).  Returns the quotient's coefficients, padded with a
    zero in the top slot (same length as p).  ``tables``: the point's
    ``syn_div_tables``, when the caller divides several polynomials by the
    same binomial."""
    nn = p[0].shape[-1]
    d = max(len(p), len(z))
    zp, zi = tables if tables is not None else syn_div_tables(z, nn)
    suf = suffix_sums(vmul(promote(p, d), zp), axis=-1)  # S_i = sum_{j>=i} p_j z^j
    # exclusive suffix: S_{i+1} = shift left by one, zero-fill at the top
    excl = tuple(
        torch.cat([c[..., 1:], torch.zeros_like(c[..., :1])], dim=-1) for c in suf
    )
    return vmul(excl, zi)


def power_series_elem(x, n: int):
    """[1, x, x^2, ..., x^(n-1)] for an element array x of shape (1,) ->
    tuple of tensors shaped (n,).  Log-doubling."""
    d = len(x)
    out = vones((1,), d, x[0].device)
    length = 1
    cur_pow = x  # x^(length)
    while length < n:
        nxt = vmul(out, vbroadcast(cur_pow, out[0].shape))
        out = tuple(torch.cat([a, b]) for a, b in zip(out, nxt))
        length *= 2
        if length < n:
            cur_pow = vsquare(cur_pow)
    return tuple(c[:n] for c in out)
