"""Extension fields of Goldilocks on one-word component tensors.

Counterpart of starkpack_winterfell_tpu/ops/gl64_ext.py, whole, on the
one-word representation of ops/gl64.py (an extension element is a tuple of
int64 tensors, one per component) in place of u32 pairs.

Quadratic extension over x^2 - x + 2 and cubic extension over x^3 - x - 1,
with the reference's multiplication formulas (math/src/field/f64/mod.rs:
397-437 quad, 440-510 cubic).  The inverse of zero is zero, as ``gl.inv``
makes it.
"""

from __future__ import annotations

from . import gl64 as gl

# frobenius coefficients for the cubic extension (f64/mod.rs:495-509)
_FROB3_C1 = (10615703402128488253, 6700183068485440220)
_FROB3_C2 = (10050274602728160328, 14531223735771536287)
_FROB3_C3 = (11746561000929144102, 8396469466686423992)


def _const(v: int, like):
    return gl.from_int(v, (), like.device)


# ---------------------------------------------------------------------------
# quadratic extension: a = (a0, a1) ~ a0 + a1*phi, phi^2 = phi - 2
# ---------------------------------------------------------------------------


def mul2(a, b):
    a0, a1 = a
    b0, b1 = b
    a0b0 = gl.mul(a0, b0)
    r0 = gl.sub(a0b0, gl.double(gl.mul(a1, b1)))
    r1 = gl.sub(gl.mul(gl.add(a0, a1), gl.add(b0, b1)), a0b0)
    return (r0, r1)


def square2(a):
    a0, a1 = a
    a1_sq = gl.square(a1)
    out0 = gl.sub(gl.square(a0), gl.double(a1_sq))
    out1 = gl.add(gl.double(gl.mul(a0, a1)), a1_sq)
    return (out0, out1)


def mul_base2(a, b):
    return (gl.mul(a[0], b), gl.mul(a[1], b))


def frob2(a):
    return (gl.add(a[0], a[1]), gl.neg(a[1]))


def inv2(a, base_inv=gl.inv):
    """Inverse via the norm: (u + v*phi)^-1 = conj / (u^2 + u*v + 2*v^2).
    ``base_inv`` inverts the norm, a base-field word array."""
    u, v = a
    norm = gl.add(gl.add(gl.square(u), gl.mul(u, v)), gl.double(gl.square(v)))
    return mul_base2(frob2(a), base_inv(norm))


# ---------------------------------------------------------------------------
# cubic extension: a = (a0, a1, a2) ~ a0 + a1*phi + a2*phi^2, phi^3 = phi + 1
# ---------------------------------------------------------------------------


def mul3(a, b):
    a0b0 = gl.mul(a[0], b[0])
    a1b1 = gl.mul(a[1], b[1])
    a2b2 = gl.mul(a[2], b[2])

    s01 = gl.mul(gl.add(a[0], a[1]), gl.add(b[0], b[1]))
    s02 = gl.mul(gl.add(a[0], a[2]), gl.add(b[0], b[2]))
    s12 = gl.mul(gl.add(a[1], a[2]), gl.add(b[1], b[2]))

    a0b0_minus_a1b1 = gl.sub(a0b0, a1b1)

    r0 = gl.sub(gl.add(s12, a0b0_minus_a1b1), a2b2)
    r1 = gl.sub(gl.sub(gl.add(s01, s12), gl.double(a1b1)), a0b0)
    r2 = gl.sub(s02, a0b0_minus_a1b1)
    return (r0, r1, r2)


def square3(a):
    a0, a1, a2 = a
    a2_sq = gl.square(a2)
    a1_a2 = gl.mul(a1, a2)
    out0 = gl.add(gl.square(a0), gl.double(a1_a2))
    out1 = gl.add(gl.double(gl.add(gl.mul(a0, a1), a1_a2)), a2_sq)
    out2 = gl.add(gl.add(gl.double(gl.mul(a0, a2)), gl.square(a1)), a2_sq)
    return (out0, out1, out2)


def mul_base3(a, b):
    return (gl.mul(a[0], b), gl.mul(a[1], b), gl.mul(a[2], b))


def frob3(a):
    c1a, c1b = (_const(v, a[1]) for v in _FROB3_C1)
    c2a, c2b = (_const(v, a[1]) for v in _FROB3_C2)
    c3a, c3b = (_const(v, a[1]) for v in _FROB3_C3)
    r0 = gl.add(gl.add(a[0], gl.mul(c1a, a[1])), gl.mul(c1b, a[2]))
    r1 = gl.add(gl.mul(c2a, a[1]), gl.mul(c2b, a[2]))
    r2 = gl.add(gl.mul(c3a, a[1]), gl.mul(c3b, a[2]))
    return (r0, r1, r2)


def inv3(a, base_inv=gl.inv):
    """Inverse via the norm N(a) = a * a^f * a^{f^2}, which lies in the base
    field; so a^-1 = (a^f * a^{f^2}) * N(a)^-1, ``base_inv`` inverting the
    norm."""
    af = frob3(a)
    aff = frob3(af)
    conj_prod = mul3(af, aff)
    norm = mul3(a, conj_prod)  # components 1,2 are zero by theory
    return mul_base3(conj_prod, base_inv(norm[0]))
