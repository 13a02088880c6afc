# Copy of starkpack_winterfell_tpu/math/polynom.py; cut: nothing.
"""Host polynomial algebra on python-int/tuple coefficients.

Equivalent of math/src/polynom/mod.rs for the small, irregular host-side
computations (verifier row interpolation, periodic polys, remainder checks).
Bulk polynomial work runs through ops/ntt.py on device.
"""

from __future__ import annotations

from .scalar import P, fadd, fdiv, finv, fmul, fneg, fsub, is_zero, mul_base, zero


def _ops(spec):
    """Scalar-op bundle: the f64 module by default, or a FieldSpec."""
    if spec is None:
        from . import scalar as fs

        return fs
    return spec


def eval_at(p, x, spec=None):
    """Horner evaluation (polynom/mod.rs:53).  Coefficients may be of lower
    degree than x (e.g. base poly at extension point)."""
    o = _ops(spec)
    acc = 0
    for c in reversed(p):
        acc = o.fadd(o.fmul(acc, x), c)
    return acc


def eval_many(p, xs, spec=None):
    return [eval_at(p, x, spec) for x in xs]


def interpolate(xs, ys, spec=None):
    """Lagrange interpolation (polynom/mod.rs:112) — O(n^2), used for tiny n."""
    o = _ops(spec)
    n = len(xs)
    result = [0 for _ in range(n)]
    for i in range(n):
        # numerator poly prod_{j != i} (x - x_j)
        num = [1]
        for j in range(n):
            if j == i:
                continue
            # num *= (x - xs[j])
            new = [0 for _ in range(len(num) + 1)]
            for k, c in enumerate(num):
                new[k + 1] = o.fadd(new[k + 1], c)
                new[k] = o.fsub(new[k], o.fmul(c, xs[j]))
            num = new
        denom = 1
        for j in range(n):
            if j != i:
                denom = o.fmul(denom, o.fsub(xs[i], xs[j]))
        scale = o.fmul(ys[i], o.finv(denom))
        for k in range(len(num)):
            result[k] = o.fadd(result[k], o.fmul(num[k], scale))
    return result


def interpolate_batch(xs_rows, ys_rows, spec=None):
    """polynom/mod.rs:179 — interpolate many small (x, y) row sets."""
    return [interpolate(xs, ys, spec) for xs, ys in zip(xs_rows, ys_rows)]


def degree_of(p) -> int:
    for i in range(len(p) - 1, -1, -1):
        if not is_zero(p[i]):
            return i
    return 0


def syn_div(p, a: int, b, spec=None):
    """Divide p by (x^a - b), returning the quotient (semantics of
    polynom/mod.rs:472; exact when (x^a - b) divides p)."""
    o = _ops(spec)
    assert a != 0
    n = len(p)
    q = [0 for _ in range(n - a)]
    for i in range(n - a - 1, -1, -1):
        hi = q[i + a] if i + a < n - a else 0
        q[i] = o.fadd(p[i + a], o.fmul(b, hi))
    return q


def syn_div_binomial(p, z, spec=None):
    """Divide p by (x - z) assuming p(z) == 0; returns quotient of len-1."""
    o = _ops(spec)
    n = len(p)
    q = [0 for _ in range(n - 1)]
    acc = p[n - 1]
    for i in range(n - 2, -1, -1):
        q[i] = acc
        acc = o.fadd(o.fmul(acc, z), p[i])
    # acc is the remainder p(z); caller may assert it is zero
    return q


def mul(p1, p2, spec=None):
    o = _ops(spec)
    out = [0 for _ in range(len(p1) + len(p2) - 1)]
    for i, a in enumerate(p1):
        for j, b in enumerate(p2):
            out[i + j] = o.fadd(out[i + j], o.fmul(a, b))
    return out


def div(p1, p2, spec=None):
    """Polynomial long division (polynom/mod.rs:330-360): returns the
    quotient of p1 / p2, dropping the remainder; panics-equivalent asserts
    on a zero or higher-degree divisor."""
    o = _ops(spec)
    a = list(p1)
    apos = degree_of(a)
    b = list(p2)
    bpos = degree_of(b)
    assert apos >= bpos, "divisor degree exceeds dividend degree"
    assert not (bpos == 0 and is_zero(b[0])), "division by zero"
    diff = apos - bpos
    result = [0 for _ in range(diff + 1)]
    for i in range(diff, -1, -1):
        quot = o.fdiv(a[apos], b[bpos])
        result[i] = quot
        for j in range(bpos, -1, -1):
            a[i + j] = o.fsub(a[i + j], o.fmul(b[j], quot))
        apos -= 1
    return result
