"""The two prime fields of the benchmark's configurations, on Python ints:
Goldilocks (2^64 - 2^32 + 1) and Winterfell's 128-bit field
(2^128 - 45 * 2^40 + 1), and Winterfell's quadratic extension of
Goldilocks, F[u] / (u^2 - u + 2), whose elements are ``QuadExt``."""

from __future__ import annotations


class PrimeField:
    def __init__(self, name: str, modulus: int, element_bytes: int, generator: int,
                 two_adicity: int, two_adic_root: int, quad=None):
        self.name = name
        self.P = modulus
        self.ELEMENT_BYTES = element_bytes
        self.GENERATOR = generator
        self.TWO_ADICITY = two_adicity
        self.TWO_ADIC_ROOT = two_adic_root
        self.QUAD = quad  # (q1, q0): u^2 = q1 u + q0 in the quadratic extension

    def root_of_unity(self, log_n: int) -> int:
        if not 0 < log_n <= self.TWO_ADICITY:
            raise ValueError(f"no subgroup of size 2^{log_n} in {self.name}")
        return pow(self.TWO_ADIC_ROOT, 1 << (self.TWO_ADICITY - log_n), self.P)

    def inv(self, a: int) -> int:
        if a % self.P == 0:
            raise ZeroDivisionError("inverse of zero")
        return pow(a, self.P - 2, self.P)

    def modulus_bytes(self) -> bytes:
        return self.P.to_bytes(self.ELEMENT_BYTES, "little")

    def interpolate_subgroup(self, values):
        """Coefficients of the polynomial that takes ``values`` on the
        subgroup of size len(values) (a power of two), by inverse DFT."""
        n = len(values)
        if n & (n - 1):
            raise ValueError("the number of values must be a power of two")
        P = self.P
        if n == 1:
            return [values[0] % P]
        w_inv = self.inv(self.root_of_unity(n.bit_length() - 1))

        def dft(vals, w):
            m = len(vals)
            if m == 1:
                return list(vals)
            even = dft(vals[0::2], w * w % P)
            odd = dft(vals[1::2], w * w % P)
            out = [0] * m
            t = 1
            for k in range(m // 2):
                o = odd[k] * t % P
                out[k] = (even[k] + o) % P
                out[k + m // 2] = (even[k] - o) % P
                t = t * w % P
            return out

        n_inv = self.inv(n)
        return [v * n_inv % P for v in dft([v % P for v in values], w_inv)]

    def horner(self, coeffs, x: int) -> int:
        P = self.P
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % P
        return acc


class QuadExt:
    """a + b u in F[u] / (u^2 - q1 u - q0): the operators of an int, so that
    code written on ints with ``% P`` and ``pow(x, e, P)`` runs on it."""

    __slots__ = ("a", "b", "f")

    def __init__(self, a: int, b: int, f: "ExtensionField"):
        self.a, self.b, self.f = a % f.P, b % f.P, f

    def _pair(self, o):
        if isinstance(o, QuadExt):
            return o.a, o.b
        if isinstance(o, int):
            return o, 0
        return None

    def __add__(self, o):
        p = self._pair(o)
        return NotImplemented if p is None else QuadExt(self.a + p[0], self.b + p[1], self.f)

    __radd__ = __add__

    def __sub__(self, o):
        p = self._pair(o)
        return NotImplemented if p is None else QuadExt(self.a - p[0], self.b - p[1], self.f)

    def __rsub__(self, o):
        p = self._pair(o)
        return NotImplemented if p is None else QuadExt(p[0] - self.a, p[1] - self.b, self.f)

    def __neg__(self):
        return QuadExt(-self.a, -self.b, self.f)

    def __mul__(self, o):
        p = self._pair(o)
        if p is None:
            return NotImplemented
        c, d = p
        if d == 0:
            return QuadExt(self.a * c, self.b * c, self.f)
        q1, q0 = self.f.Q
        bd = self.b * d
        return QuadExt(self.a * c + q0 * bd, self.a * d + self.b * c + q1 * bd, self.f)

    __rmul__ = __mul__

    def __mod__(self, modulus):  # already reduced
        return self

    def __pow__(self, e: int, modulus=None):
        out, base = QuadExt(1, 0, self.f), self
        while e:
            if e & 1:
                out = out * base
            base = base * base
            e >>= 1
        return out

    def inverse(self) -> "QuadExt":
        """conj / norm, conj(a + b u) = a + b q1 - b u (u's other root is q1 - u)."""
        q1, q0 = self.f.Q
        norm = (self.a * self.a + q1 * self.a * self.b - q0 * self.b * self.b) % self.f.P
        if norm == 0:
            raise ZeroDivisionError("inverse of zero")
        return QuadExt(self.a + q1 * self.b, -self.b, self.f) * pow(norm, self.f.P - 2, self.f.P)

    def __eq__(self, o):
        p = self._pair(o)
        return p is not None and (self.a, self.b) == (p[0] % self.f.P, p[1] % self.f.P)

    def __hash__(self):
        return hash((self.a, self.b))

    def __repr__(self):
        return f"({self.a} + {self.b}u)"

    def components(self):
        return (self.a, self.b)


class ExtensionField:
    """The field the proof's randomness, out-of-domain frame, DEEP
    composition and FRI live in: the base field itself (degree 1, Python
    ints) or its quadratic extension (degree 2, ``QuadExt``)."""

    def __init__(self, base: PrimeField, degree: int):
        if degree not in (1, 2) or (degree == 2 and base.QUAD is None):
            raise ValueError(f"no extension of degree {degree} over {base.name}")
        self.base, self.DEGREE, self.P = base, degree, base.P
        self.Q = base.QUAD
        self.ELEMENT_BYTES = base.ELEMENT_BYTES * degree

    def element(self, components):
        return components[0] if self.DEGREE == 1 else QuadExt(*components, self)

    def components(self, e):
        return e.components() if isinstance(e, QuadExt) else (e,) + (0,) * (self.DEGREE - 1)

    def inv(self, e):
        return e.inverse() if isinstance(e, QuadExt) else self.base.inv(e)

    def batch_inv(self, xs):
        """Montgomery's batch inversion: one inversion in all."""
        pref = [1]
        for x in xs:
            pref.append(pref[-1] * x % self.P)
        inv = self.inv(pref[-1])
        out = [0] * len(xs)
        for i in range(len(xs) - 1, -1, -1):
            out[i] = pref[i] * inv % self.P
            inv = inv * xs[i] % self.P
        return out


F64 = PrimeField("f64", 0xFFFFFFFF00000001, 8, 7, 32, 7277203076849721926, quad=(1, -2))
F128 = PrimeField("f128", 340282366920938463463374557953744961537, 16, 3, 40,
                  23953097886125630542083529559205016746)
FIELDS = {f.name: f for f in (F64, F128)}
