# Copy of starkpack_winterfell_tpu/math/scalar.py; cut: nothing.
"""Host-side scalar field arithmetic on python ints / tuples.

Base Goldilocks elements are ints in [0, p); quadratic/cubic extension
elements are 2-/3-tuples of ints.  Used by the strictly-sequential transcript
logic and the (tiny) verifier-side computations; all bulk math runs on the
limb-array ops in ``ops/``.

Extension multiplication uses the reference's irreducible polynomials:
quad x^2 - x + 2, cubic x^3 - x - 1 (math/src/field/f64/mod.rs:397,440).
"""

from __future__ import annotations

P = 0xFFFFFFFF00000001
GENERATOR = 7
TWO_ADICITY = 32
TWO_ADIC_ROOT_OF_UNITY = 7277203076849721926


def deg_of(a) -> int:
    return 1 if isinstance(a, int) else len(a)


def embed(a, deg: int):
    """Embed a base element (or lower-degree element) into degree ``deg``."""
    if deg == 1:
        assert isinstance(a, int)
        return a
    if isinstance(a, int):
        return (a,) + (0,) * (deg - 1)
    assert len(a) == deg
    return a


def zero(deg: int = 1):
    return 0 if deg == 1 else (0,) * deg


def one(deg: int = 1):
    return 1 if deg == 1 else (1,) + (0,) * (deg - 1)


def fadd(a, b):
    if isinstance(a, int) and isinstance(b, int):
        return (a + b) % P
    deg = max(deg_of(a), deg_of(b))
    a, b = embed(a, deg), embed(b, deg)
    return tuple((x + y) % P for x, y in zip(a, b))


def fsub(a, b):
    if isinstance(a, int) and isinstance(b, int):
        return (a - b) % P
    deg = max(deg_of(a), deg_of(b))
    a, b = embed(a, deg), embed(b, deg)
    return tuple((x - y) % P for x, y in zip(a, b))


def fneg(a):
    if isinstance(a, int):
        return (-a) % P
    return tuple((-x) % P for x in a)


def fmul(a, b):
    if isinstance(a, int) and isinstance(b, int):
        return (a * b) % P
    deg = max(deg_of(a), deg_of(b))
    a, b = embed(a, deg), embed(b, deg)
    if deg == 2:
        # x^2 = x - 2
        c0 = a[0] * b[0]
        c1 = a[0] * b[1] + a[1] * b[0]
        c2 = a[1] * b[1]
        return ((c0 - 2 * c2) % P, (c1 + c2) % P)
    # deg == 3: x^3 = x + 1, x^4 = x^2 + x
    c = [0] * 5
    for i in range(3):
        for j in range(3):
            c[i + j] += a[i] * b[j]
    return ((c[0] + c[3]) % P, (c[1] + c[3] + c[4]) % P, (c[2] + c[4]) % P)


def fexp(a, e: int):
    e = int(e)
    if isinstance(a, int):
        return pow(a, e, P)
    result = one(deg_of(a))
    base = a
    while e:
        if e & 1:
            result = fmul(result, base)
        e >>= 1
        base = fmul(base, base)
    return result


def finv(a):
    if isinstance(a, int):
        return pow(a, P - 2, P)
    if deg_of(a) == 2:
        u, v = a
        norm = (u * u + u * v + 2 * v * v) % P
        ninv = pow(norm, P - 2, P)
        # conjugate = (u+v) - v*x
        return ((u + v) * ninv % P, (-v) % P * ninv % P)
    # cubic: norm = a * a^f * a^f^2 in base field
    af = frob3(a)
    aff = frob3(af)
    conj = fmul(af, aff)
    norm = fmul(a, conj)[0]
    ninv = pow(norm, P - 2, P)
    return tuple(c * ninv % P for c in conj)


def fdiv(a, b):
    return fmul(a, finv(b))


_FROB3 = (
    (10615703402128488253, 6700183068485440220),
    (10050274602728160328, 14531223735771536287),
    (11746561000929144102, 8396469466686423992),
)


def frob3(a):
    """Frobenius for the cubic extension (f64/mod.rs:495-509)."""
    return (
        (a[0] + _FROB3[0][0] * a[1] + _FROB3[0][1] * a[2]) % P,
        (_FROB3[1][0] * a[1] + _FROB3[1][1] * a[2]) % P,
        (_FROB3[2][0] * a[1] + _FROB3[2][1] * a[2]) % P,
    )


def mul_base(a, b: int):
    """Multiply an element of any degree by a base element."""
    if isinstance(a, int):
        return a * b % P
    return tuple(x * b % P for x in a)


def get_root_of_unity(log_n: int) -> int:
    assert 0 < log_n <= TWO_ADICITY
    return pow(TWO_ADIC_ROOT_OF_UNITY, 1 << (TWO_ADICITY - log_n), P)


def is_zero(a) -> bool:
    return a == 0 if isinstance(a, int) else all(c == 0 for c in a)


def components(a):
    """Element -> tuple of base components (len == degree)."""
    return (a,) if isinstance(a, int) else tuple(a)


def from_components(comps):
    return comps[0] if len(comps) == 1 else tuple(comps)
