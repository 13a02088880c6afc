# Copy of starkpack_winterfell_tpu/math/fieldspec.py; cut: nothing.
"""Field specifications — the multi-field abstraction the reference expresses
through the StarkField/ExtensibleField traits (math/src/field/traits.rs).

A FieldSpec carries the host-side scalar arithmetic (python ints / tuples)
for a base field and its supported extensions, plus serialization widths.
Extension multiplication uses the reference's irreducible polynomials:

  f64  (2^64 - 2^32 + 1):     quad x^2 - x + 2,  cubic x^3 - x - 1
  f62  (2^62 - 111*2^39 + 1): quad x^2 - x - 1,  cubic x^3 + 2x + 2
  f128 (2^128 - 45*2^40 + 1): quad x^2 - x - 1,  cubic unsupported
                               (f128/mod.rs:295-298 — is_supported() = false)

Inversion of extension elements is the generic polynomial xgcd, which agrees
with the reference's norm-based formulas (inverses are unique).
"""

from __future__ import annotations


class FieldSpec:
    def __init__(self, name: str, modulus: int, elem_bytes: int, generator: int,
                 two_adicity: int, two_adic_root: int,
                 quad_reduce=None, cubic_reduce=None):
        """quad_reduce: (q1, q0) with x^2 = q1*x + q0;
        cubic_reduce: (e2, e1, e0) with x^3 = e2*x^2 + e1*x + e0."""
        self.name = name
        self.P = modulus
        self.ELEMENT_BYTES = elem_bytes
        self.GENERATOR = generator
        self.TWO_ADICITY = two_adicity
        self.TWO_ADIC_ROOT_OF_UNITY = two_adic_root
        self.quad_reduce = quad_reduce
        self.cubic_reduce = cubic_reduce

    # -- degree helpers ------------------------------------------------------

    def supports_extension(self, deg: int) -> bool:
        if deg == 1:
            return True
        if deg == 2:
            return self.quad_reduce is not None
        if deg == 3:
            return self.cubic_reduce is not None
        return False

    def deg_of(self, a) -> int:
        return 1 if isinstance(a, int) else len(a)

    def embed(self, a, deg: int):
        if deg == 1:
            assert isinstance(a, int)
            return a
        if isinstance(a, int):
            return (a,) + (0,) * (deg - 1)
        assert len(a) == deg
        return a

    def components(self, a):
        return (a,) if isinstance(a, int) else tuple(a)

    def zero(self, deg: int = 1):
        return 0 if deg == 1 else (0,) * deg

    def one(self, deg: int = 1):
        return 1 if deg == 1 else (1,) + (0,) * (deg - 1)

    # -- arithmetic ----------------------------------------------------------

    def fadd(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return (a + b) % self.P
        d = max(self.deg_of(a), self.deg_of(b))
        a, b = self.embed(a, d), self.embed(b, d)
        return tuple((x + y) % self.P for x, y in zip(a, b))

    def fsub(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return (a - b) % self.P
        d = max(self.deg_of(a), self.deg_of(b))
        a, b = self.embed(a, d), self.embed(b, d)
        return tuple((x - y) % self.P for x, y in zip(a, b))

    def fneg(self, a):
        if isinstance(a, int):
            return (-a) % self.P
        return tuple((-x) % self.P for x in a)

    def _reduce_poly(self, c, deg: int):
        """Reduce convolution coefficients c (len 2*deg-1) mod the extension
        polynomial."""
        P = self.P
        c = list(c)
        if deg == 2:
            q1, q0 = self.quad_reduce
            # c2*x^2 -> c2*(q1 x + q0)
            return ((c[0] + q0 * c[2]) % P, (c[1] + q1 * c[2]) % P)
        e2, e1, e0 = self.cubic_reduce
        # reduce x^4 then x^3 (substitute from the top down)
        # x^4 = e2*x^3 + e1*x^2 + e0*x
        c[3] = (c[3] + e2 * c[4]) % P
        c[2] = (c[2] + e1 * c[4]) % P
        c[1] = (c[1] + e0 * c[4]) % P
        c[2] = (c[2] + e2 * c[3]) % P
        c[1] = (c[1] + e1 * c[3]) % P
        c[0] = (c[0] + e0 * c[3]) % P
        return (c[0] % P, c[1] % P, c[2] % P)

    def fmul(self, a, b):
        if isinstance(a, int) and isinstance(b, int):
            return (a * b) % self.P
        d = max(self.deg_of(a), self.deg_of(b))
        assert self.supports_extension(d), f"{self.name} does not support degree {d}"
        a, b = self.embed(a, d), self.embed(b, d)
        c = [0] * (2 * d - 1)
        for i in range(d):
            for j in range(d):
                c[i + j] += a[i] * b[j]
        return self._reduce_poly(c, d)

    def fexp(self, a, e: int):
        e = int(e)
        if isinstance(a, int):
            return pow(a, e, self.P)
        result = self.one(self.deg_of(a))
        base = a
        while e:
            if e & 1:
                result = self.fmul(result, base)
            e >>= 1
            base = self.fmul(base, base)
        return result

    def finv(self, a):
        if isinstance(a, int):
            return pow(a, self.P - 2, self.P)
        d = self.deg_of(a)
        # polynomial xgcd of a against the extension modulus
        mod = self._modulus_poly(d)
        inv = _poly_xgcd_inverse(list(a), mod, self.P)
        inv = inv + [0] * (d - len(inv))
        return tuple(v % self.P for v in inv[:d])

    def fdiv(self, a, b):
        return self.fmul(a, self.finv(b))

    def mul_base(self, a, b: int):
        if isinstance(a, int):
            return a * b % self.P
        return tuple(x * b % self.P for x in a)

    def is_zero(self, a) -> bool:
        return a == 0 if isinstance(a, int) else all(c == 0 for c in a)

    def _modulus_poly(self, deg: int):
        P = self.P
        if deg == 2:
            q1, q0 = self.quad_reduce
            return [(-q0) % P, (-q1) % P, 1]  # x^2 - q1 x - q0
        e2, e1, e0 = self.cubic_reduce
        return [(-e0) % P, (-e1) % P, (-e2) % P, 1]

    def get_root_of_unity(self, log_n: int) -> int:
        assert 0 < log_n <= self.TWO_ADICITY
        return pow(self.TWO_ADIC_ROOT_OF_UNITY, 1 << (self.TWO_ADICITY - log_n), self.P)

    def get_modulus_le_bytes(self) -> bytes:
        return self.P.to_bytes(self.ELEMENT_BYTES, "little")

    def __repr__(self):
        return f"FieldSpec({self.name})"


def _poly_xgcd_inverse(a, mod, P):
    """Inverse of poly a modulo poly mod over GF(P) (extended Euclid)."""

    def pdeg(p):
        for i in range(len(p) - 1, -1, -1):
            if p[i] % P:
                return i
        return -1

    def pmod(x, y):
        x = [v % P for v in x]
        dy = pdeg(y)
        inv_lead = pow(y[dy], P - 2, P)
        while pdeg(x) >= dy:
            dx = pdeg(x)
            coef = x[dx] * inv_lead % P
            shift = dx - dy
            for i in range(dy + 1):
                x[i + shift] = (x[i + shift] - coef * y[i]) % P
        return x

    def pdivmod(x, y):
        x = [v % P for v in x]
        dy = pdeg(y)
        inv_lead = pow(y[dy], P - 2, P)
        q = [0] * (max(pdeg(x) - dy + 1, 1))
        while pdeg(x) >= dy:
            dx = pdeg(x)
            coef = x[dx] * inv_lead % P
            shift = dx - dy
            q[shift] = coef
            for i in range(dy + 1):
                x[i + shift] = (x[i + shift] - coef * y[i]) % P
        return q, x

    def psub(x, y):
        n = max(len(x), len(y))
        return [((x[i] if i < len(x) else 0) - (y[i] if i < len(y) else 0)) % P for i in range(n)]

    def pmul(x, y):
        out = [0] * (len(x) + len(y) - 1)
        for i, xi in enumerate(x):
            for j, yj in enumerate(y):
                out[i + j] = (out[i + j] + xi * yj) % P
        return out

    r0, r1 = [v % P for v in mod], [v % P for v in a]
    s0, s1 = [0], [1]
    while pdeg(r1) > 0:
        q, r = pdivmod(r0, r1)
        r0, r1 = r1, r
        s0, s1 = s1, psub(s0, pmul(q, s1))
    d = pdeg(r1)
    assert d == 0, "element is not invertible"
    c_inv = pow(r1[0], P - 2, P)
    return [v * c_inv % P for v in s1]


GL64_SPEC = FieldSpec(
    "f64", 0xFFFFFFFF00000001, 8, 7, 32, 7277203076849721926,
    quad_reduce=(1, -2),  # x^2 = x - 2  (f64/mod.rs:397)
    cubic_reduce=(0, 1, 1),  # x^3 = x + 1  (f64/mod.rs:440)
)

F62_SPEC = FieldSpec(
    "f62", 4611624995532046337, 8, 3, 39, 4421547261963328785,
    quad_reduce=(1, 1),  # x^2 = x + 1  (f62/mod.rs:321)
    cubic_reduce=(0, -2, -2),  # x^3 = -2x - 2  (f62/mod.rs:345)
)

F128_SPEC = FieldSpec(
    "f128", 340282366920938463463374557953744961537, 16, 3, 40,
    23953097886125630542083529559205016746,
    quad_reduce=(1, 1),  # x^2 = x + 1  (f128/mod.rs:270)
    cubic_reduce=None,  # unsupported (f128/mod.rs:295-298)
)

FIELDS = {f.name: f for f in (GL64_SPEC, F62_SPEC, F128_SPEC)}
