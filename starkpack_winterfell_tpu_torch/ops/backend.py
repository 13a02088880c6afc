"""Field-backend abstraction: one vectorized-element API over the base field
of an AIR (f64, f62, f128).

Counterpart of starkpack_winterfell_tpu/ops/backend.py (``FieldBackend`` :26,
``GL64Backend`` :431, ``LimbBackend`` :583).  An element array is a tuple of
``deg`` *components* (extension coordinates); each component is a tuple of
int64 word planes — two planes ``(lo, hi)`` for f128, one for f62
(ops/limb_field.py) and one for f64 (ops/gl64.py).  ``GL64Backend`` delegates
to the one-word Goldilocks ops (ops/gl64, ops/gl64_ext, ops/ntt, ops/vec),
which the two f64 pipelines of prover/ call directly; ``parallel/
full_pipeline.py:prove_mesh`` reaches them through it for the f64 proves with
auxiliary trace segments.  The extension products (``ext_mul``, ``ext_inv``)
take degree 2 on every field and degree 3 on f64 and f62, as the JAX
package's do; f128 has no cubic extension (math/fieldspec.py).

Every function runs on the device of the tensors it is given; functions that
create tensors take ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math.fieldspec import FIELDS, GL64_SPEC
from . import gl64 as gl, gl64_ext as ext, ntt, vec
from .limb_field import FIELDS_BY_NAME

# the most elements a cubic inverse takes through the host (JAX
# ``ext_inv``'s round trip): the DEEP point z and its like are one element
HOST_INV_MAX = 64


class FieldBackend:
    """Generic implementation over base ops on one component (a tuple of
    word planes); subclasses bind the base field."""

    def __init__(self, spec):
        self.spec = spec
        self.name = spec.name
        self.P = spec.P
        self.ELEMENT_BYTES = spec.ELEMENT_BYTES

    # -- structural helpers --------------------------------------------------

    @staticmethod
    def cmap(f, comp):
        """Apply a tensor op plane-wise to one component."""
        return tuple(f(l) for l in comp)

    def emap(self, f, elem):
        """Apply a tensor op plane-wise to every component of an element."""
        return tuple(self.cmap(f, c) for c in elem)

    # -- element-level ops ----------------------------------------------------

    def promote(self, a, target_deg: int):
        if len(a) == target_deg:
            return a
        assert len(a) == 1, "can only promote base elements"
        z = self.cmap(torch.zeros_like, a[0])
        return a + (z,) * (target_deg - 1)

    def vadd(self, a, b):
        d = max(len(a), len(b))
        a, b = self.promote(a, d), self.promote(b, d)
        return tuple(self.badd(x, y) for x, y in zip(a, b))

    def vsub(self, a, b):
        d = max(len(a), len(b))
        a, b = self.promote(a, d), self.promote(b, d)
        return tuple(self.bsub(x, y) for x, y in zip(a, b))

    def vneg(self, a):
        return tuple(self.bneg(x) for x in a)

    def vmul(self, a, b):
        if len(a) == 1 and len(b) == 1:
            return (self.bmul(a[0], b[0]),)
        if len(b) == 1:
            return tuple(self.bmul(x, b[0]) for x in a)
        if len(a) == 1:
            return tuple(self.bmul(a[0], y) for y in b)
        return self.ext_mul(a, b)

    def vsquare(self, a):
        if len(a) == 1:
            return (self.bsquare(a[0]),)
        return self.ext_mul(a, a)

    def vinv(self, a):
        if len(a) == 1:
            return (self.b_batch_inv(a[0]),)
        return self.ext_inv(a)

    def vzeros(self, shape, d: int = 1, device="cpu"):
        return tuple(self.b_zeros(shape, device) for _ in range(d))

    def vones(self, shape, d: int = 1, device="cpu"):
        return (self.b_ones(shape, device),) + tuple(
            self.b_zeros(shape, device) for _ in range(d - 1)
        )

    def vbroadcast(self, a, shape):
        return self.emap(lambda l: l.broadcast_to(shape), a)

    def vsum(self, a, axis=-1):
        """Modular sum along an axis via log-halving tree reduction."""
        comps = a
        nd = comps[0][0].dim()
        axis = axis % nd
        n = comps[0][0].shape[axis]
        while n > 1:
            half = n // 2
            new_comps = []
            for c in comps:
                s = self.badd(
                    self.cmap(lambda l: l.narrow(axis, 0, half), c),
                    self.cmap(lambda l: l.narrow(axis, half, half), c),
                )
                if n % 2:
                    s = tuple(
                        torch.cat([sv, l.narrow(axis, 2 * half, 1)], dim=axis)
                        for sv, l in zip(s, c)
                    )
                new_comps.append(s)
            comps = tuple(new_comps)
            n = comps[0][0].shape[axis]
        return tuple(self.cmap(lambda l: l.select(axis, 0), c) for c in comps)

    def horner(self, coeffs, x, axis=-1):
        n = coeffs[0][0].shape[axis]

        def take(j):
            return tuple(self.cmap(lambda l: l.select(axis, j), c) for c in coeffs)

        acc = take(n - 1)
        for j in range(n - 2, -1, -1):
            acc = self.vadd(self.vmul(acc, x), take(j))
        return acc

    def suffix_sums(self, a, axis=-1):
        """Inclusive suffix sums via Hillis-Steele doubling."""
        n = a[0][0].shape[axis]
        axis = axis % a[0][0].dim()
        comps = a
        shift = 1
        while shift < n:
            shifted = tuple(
                tuple(
                    torch.cat([l.narrow(axis, shift, n - shift),
                               torch.zeros_like(l.narrow(axis, 0, shift))], dim=axis)
                    for l in c
                )
                for c in comps
            )
            comps = tuple(self.badd(c, s) for c, s in zip(comps, shifted))
            shift *= 2
        return comps

    def prefix_products(self, a, axis=-1):
        """Inclusive prefix products via Hillis-Steele doubling: log2(n)
        full-width multiplies in place of n sequential ones."""
        n = a[0][0].shape[axis]
        axis = axis % a[0][0].dim()
        shift = 1
        while shift < n:
            head = self.emap(lambda l: l.narrow(axis, 0, shift), a)
            tail = self.vmul(self.emap(lambda l: l.narrow(axis, shift, n - shift), a),
                             self.emap(lambda l: l.narrow(axis, 0, n - shift), a))
            a = tuple(tuple(torch.cat([h, t], dim=axis) for h, t in zip(hc, tc))
                      for hc, tc in zip(head, tail))
            shift *= 2
        return a

    def syn_div_binomial(self, p, z):
        """Divide coeff vector p by (x - z), p(z) == 0, via the parallel
        suffix-scan identity q_i = z^{-(i+1)} * sum_{j>i} p_j z^j."""
        nn = p[0][0].shape[-1]
        d = max(len(p), len(z))
        zp = self.power_series_elem(z, nn)
        s = self.vmul(self.promote(p, d), zp)
        suf = self.suffix_sums(s, axis=-1)
        excl = tuple(
            self.cmap(
                lambda l: torch.cat([l[..., 1:], torch.zeros_like(l[..., :1])], dim=-1),
                c,
            )
            for c in suf
        )
        z_inv = self.vinv(z)
        zi = self.power_series_elem(z_inv, nn)
        zi = self.vmul(zi, self.vbroadcast(z_inv, (nn,)))
        return self.vmul(excl, zi)

    def power_series_elem(self, x, n: int):
        """[1, x, ..., x^(n-1)] for an element array x of shape (1,)."""
        d = len(x)
        out = self.vones((1,), d, x[0][0].device)
        length = 1
        cur_pow = x
        while length < n:
            nxt = self.vmul(out, self.vbroadcast(cur_pow, out[0][0].shape))
            out = tuple(
                tuple(torch.cat([la, lb]) for la, lb in zip(a, b))
                for a, b in zip(out, nxt)
            )
            length *= 2
            if length < n:
                cur_pow = self.vsquare(cur_pow)
        return tuple(self.cmap(lambda l: l[:n], c) for c in out)

    # -- extension arithmetic ------------------------------------------------

    def ext_mul(self, a, b):
        """JAX ``FieldBackend.ext_mul`` :239.  Schoolbook component product
        and reduction by the extension polynomial (fieldspec reduction
        constants), all in elementwise base ops."""
        d = len(a)
        assert len(b) == d
        full = [None] * (2 * d - 1)
        for i in range(d):
            for j in range(d):
                p = self.bmul(a[i], b[j])
                k = i + j
                full[k] = p if full[k] is None else self.badd(full[k], p)
        return self._ext_reduce(full, d)

    def _ext_reduce(self, full, d: int):
        """JAX ``FieldBackend._ext_reduce`` :252.  Folds the coefficients of
        x^d.. back with x^d = sum r_k x^k."""
        if d == 2:
            q1, q0 = self.spec.quad_reduce
            reduce_rows = [[q0 % self.P, q1 % self.P]]
        elif d == 3:
            assert self.spec.cubic_reduce is not None, (
                f"{self.name} has no cubic extension"
            )
            e2, e1, e0 = [v % self.P for v in self.spec.cubic_reduce]
            # x^3 = e2 x^2 + e1 x + e0; x^4 = x * x^3 reduced
            r4 = [
                (e2 * e0) % self.P,
                (e0 + e2 * e1) % self.P,
                (e1 + e2 * e2) % self.P,
            ]
            reduce_rows = [[e0, e1, e2], r4]
        else:
            raise ValueError(f"unsupported extension degree {d}")
        out = list(full[:d])
        for k in range(d, 2 * d - 1):
            row = reduce_rows[k - d]
            for t in range(d):
                if row[t] == 0:
                    continue
                c = self._bconst_like(row[t], full[k])
                out[t] = self.badd(out[t], self.bmul(full[k], c))
        return tuple(out)

    def _bconst_like(self, v: int, like_comp):
        """JAX ``FieldBackend._bconst_like`` :284.  The constant ``v`` as a
        (1,)-shaped component on the device of ``like_comp``."""
        return self.b_from_int(v, (1,), like_comp[0].device)

    def ext_inv(self, a):
        """JAX ``FieldBackend.ext_inv`` :288.  Quadratic: the conjugate over
        the norm, from the reduction polynomial x^2 - q1 x - q0 (conj(x) =
        q1 - x), on the device.  Cubic: a round trip through the host's
        ``FieldSpec.finv``, as the JAX package does, for the tiny arrays that
        need it (the DEEP point z); on a CUDA tensor more than
        ``HOST_INV_MAX`` elements raise instead of running on the host."""
        d = len(a)
        if d == 2:
            q1, q0 = [v % self.P for v in self.spec.quad_reduce]
            a0, a1 = a
            q1c = self._bconst_like(q1, a0)
            q0c = self._bconst_like(q0, a0)
            # conj = (a0 + q1*a1, -a1); N = a0^2 + q1 a0 a1 - q0 a1^2
            conj0 = self.badd(a0, self.bmul(a1, q1c))
            n_val = self.badd(
                self.bsquare(a0),
                self.bsub(
                    self.bmul(self.bmul(a0, a1), q1c),
                    self.bmul(self.bsquare(a1), q0c),
                ),
            )
            ninv = self.b_batch_inv(n_val)
            return (self.bmul(conj0, ninv), self.bneg(self.bmul(a1, ninv)))
        count = a[0][0].numel()
        if a[0][0].device.type != "cpu" and count > HOST_INV_MAX:
            raise NotImplementedError(
                f"a cubic inverse of {count} elements over {self.name} would run "
                f"on the host (at most {HOST_INV_MAX} do)"
            )
        shape = a[0][0].shape
        vals = self.limbs_to_elems(self.emap(lambda l: l.reshape(-1), a), d)
        inv = [self.spec.finv(v) for v in vals]
        out = self.elems_to_limbs(inv, d, a[0][0].device)
        return self.emap(lambda l: l.reshape(shape), out)

    # -- conversions ----------------------------------------------------------

    def scalar_to_limbs(self, v, deg: int, shape=(1,), device="cpu"):
        comps = self.spec.components(self.spec.embed(v, deg))
        return tuple(self.b_from_int(c, shape, device) for c in comps)

    def elems_to_limbs(self, elements, deg: int, device="cpu"):
        if deg == 1:
            return (self.b_from_ints(elements, device),)
        cols = [[0] * len(elements) for _ in range(deg)]
        for i, e in enumerate(elements):
            if isinstance(e, tuple):
                for c in range(len(e)):
                    cols[c][i] = e[c]
            else:
                cols[0][i] = e
        return tuple(self.b_from_ints(col, device) for col in cols)

    def limbs_to_elems(self, comps, deg: int):
        cols = [self.b_to_ints(c) for c in comps]
        if deg == 1:
            return cols[0]
        return [tuple(cols[c][i] for c in range(deg)) for i in range(len(cols[0]))]

    def rows_to_words(self, comps, deg: int):
        """Row data -> hash word layout: per element, its components in
        order, each component as little-endian u32 words (values in int64,
        as ops/blake3.py takes them).  comps: tuple of deg components,
        planes shaped (..., W)."""
        parts = []
        for c in comps:
            words = []
            for plane in c:
                words.append(plane & 0xFFFFFFFF)
                words.append((plane >> 32) & 0xFFFFFFFF)
            parts.append(torch.stack(words, dim=-1))  # (..., W, 2 * planes)
        stacked = torch.stack(parts, dim=-2)  # (..., W, deg, words)
        nw = stacked.shape[-1]
        shape = stacked.shape[:-3] + (stacked.shape[-3] * deg * nw,)
        return stacked.reshape(shape)

    def b_batch_inv(self, comp):
        """Montgomery batch inversion as a product tree along the last axis:
        pairwise products up, ONE scalar inversion of each root on the host,
        the inverses back down (3 multiplies per element instead of a Fermat
        ladder per element).  Zero stays zero, as 0^(p-2) would give.  The
        JAX package runs the same trick sequentially on python ints; inverses
        are unique, so the values agree.  A last axis that is not a power of
        two takes ``binv``."""
        n = comp[0].shape[-1]
        if n == 0 or n & (n - 1):
            return self.binv(comp)
        zero_mask = comp[0] == 0
        for l in comp[1:]:
            zero_mask = zero_mask & (l == 0)
        one = self.b_ones((), comp[0].device)
        vals = tuple(torch.where(zero_mask, o, l) for l, o in zip(comp, one))
        levels = [vals]
        while levels[-1][0].shape[-1] > 1:
            cur = levels[-1]
            levels.append(self.bmul(tuple(l[..., 0::2] for l in cur),
                                    tuple(l[..., 1::2] for l in cur)))
        root = levels[-1]
        shape = root[0].shape
        inv_ints = [pow(v, self.P - 2, self.P) for v in self.b_to_ints(root)]
        inv = tuple(l.reshape(shape) for l in self.b_from_ints(inv_ints, comp[0].device))
        for cur in reversed(levels[:-1]):
            left = self.bmul(inv, tuple(l[..., 1::2] for l in cur))
            right = self.bmul(inv, tuple(l[..., 0::2] for l in cur))
            inv = tuple(torch.stack([a, b], dim=-1).reshape(cur[0].shape)
                        for a, b in zip(left, right))
        return tuple(torch.where(zero_mask, torch.zeros_like(l), l) for l in inv)

    def pow_series_rows(self, bases, length: int):
        """bases: a component shaped (..., 1) -> (..., length) power series
        out[..., j] = base^j, via log-doubling (log2(length) multiplies)."""
        cur = self.b_ones(bases[0].shape[:-1] + (1,), bases[0].device)
        pw = bases
        ln = 1
        while ln < length:
            nxt = self.bmul(cur, pw)
            cur = tuple(torch.cat([x, y], dim=-1) for x, y in zip(cur, nxt))
            ln *= 2
            if ln < length:
                pw = self.bsquare(pw)
        return tuple(l[..., :length] for l in cur)

    def get_root_of_unity(self, log_n: int) -> int:
        return self.spec.get_root_of_unity(log_n)


class GL64Backend(FieldBackend):
    """Goldilocks through the one-word ops (JAX ``GL64Backend`` :431): a
    component is ``(word,)``, one int64 plane, so each method unwraps its
    components, calls ops/gl64, ops/gl64_ext, ops/ntt or ops/vec, and wraps
    the result.  The JAX package's host shortcut for ``syn_div_binomial``
    (the native ``gl_syndiv`` pass) has no counterpart: the generic series
    and suffix scan run on the device of the tensors."""

    def __init__(self):
        super().__init__(GL64_SPEC)

    @staticmethod
    def _w(a):
        """Element comps -> the tuple of component words ops/vec takes."""
        return tuple(c[0] for c in a)

    @staticmethod
    def _c(words):
        """The inverse of ``_w``."""
        return tuple((w,) for w in words)

    # base ops
    def badd(self, a, b):
        return (gl.add(a[0], b[0]),)

    def bsub(self, a, b):
        return (gl.sub(a[0], b[0]),)

    def bneg(self, a):
        return (gl.neg(a[0]),)

    def bmul(self, a, b):
        return (gl.mul(a[0], b[0]),)

    def bsquare(self, a):
        return (gl.square(a[0]),)

    def binv(self, a):
        return (gl.inv(a[0]),)

    def b_zeros(self, shape, device="cpu"):
        return (gl.zeros(shape, device),)

    def b_ones(self, shape, device="cpu"):
        return (gl.ones(shape, device),)

    def b_from_int(self, v: int, shape=(), device="cpu"):
        return (gl.from_int(v, shape, device),)

    def b_from_ints(self, vals, device="cpu"):
        return (gl.from_u64(np.array(vals, dtype=np.uint64).reshape(-1), device),)

    def b_to_ints(self, comp):
        return gl.to_u64(comp[0]).reshape(-1).tolist()

    # extension arithmetic (ops/gl64_ext.py)
    def ext_mul(self, a, b):
        mul = ext.mul2 if len(a) == 2 else ext.mul3
        return self._c(mul(self._w(a), self._w(b)))

    def vsquare(self, a):
        return self._c(vec.vsquare(self._w(a)))

    def ext_inv(self, a):
        """The norm's inverse through ``b_batch_inv`` (one host inversion
        per row of the product tree) in place of a Fermat ladder."""
        inv = ext.inv2 if len(a) == 2 else ext.inv3
        return self._c(inv(self._w(a), base_inv=lambda x: self.b_batch_inv((x,))[0]))

    # NTT (ops/ntt.py; kernels 2 and 3 on a CUDA tensor)
    def interpolate_poly(self, comps):
        return self._c(ntt.interpolate_poly(self._w(comps)))

    def evaluate_poly_with_offset(self, comps, offset: int, blowup: int):
        if offset == 1 and blowup == 1:
            return self._c(ntt.evaluate_poly(self._w(comps)))
        return self._c(ntt.evaluate_poly_with_offset(self._w(comps), offset, blowup))

    def interpolate_poly_with_offset(self, comps, offset: int):
        return self._c(ntt.interpolate_poly_with_offset(self._w(comps), offset))

    def power_series(self, base: int, n: int, device="cpu"):
        return (ntt.power_series(base, n, device),)


class LimbBackend(FieldBackend):
    """f128 and f62 through ops/limb_field.LimbField."""

    def __init__(self, limb_field, spec):
        super().__init__(spec)
        self.F = limb_field

    def badd(self, a, b):
        return self.F.add(a, b)

    def bsub(self, a, b):
        return self.F.sub(a, b)

    def bneg(self, a):
        return self.F.neg(a)

    def bmul(self, a, b):
        return self.F.mul(a, b)

    def bsquare(self, a):
        return self.F.square(a)

    def binv(self, a):
        return self.F.exp_int(a, self.P - 2)

    def b_zeros(self, shape, device="cpu"):
        return self.F.zeros(shape, device)

    def b_ones(self, shape, device="cpu"):
        return self.F.ones(shape, device)

    def b_from_int(self, v: int, shape=(), device="cpu"):
        return self.F.from_int(v, shape, device)

    def b_from_ints(self, vals, device="cpu"):
        return self.F.from_ints(vals, device)

    def b_to_ints(self, comp):
        return self.F.to_ints(comp)

    def interpolate_poly(self, comps):
        return tuple(self.F.interpolate_poly(c) for c in comps)

    def evaluate_poly_with_offset(self, comps, offset: int, blowup: int):
        return tuple(self.F.evaluate_poly_with_offset(c, offset, blowup) for c in comps)

    def interpolate_poly_with_offset(self, comps, offset: int):
        return tuple(self.F.interpolate_poly_with_offset(c, offset) for c in comps)

    def evaluate_coset(self, comps, offset: int, blowup: int, k: int):
        """Coset k of ``evaluate_poly_with_offset(comps, offset, blowup)``
        (natural LDE indices q*blowup + k), shaped like ``comps``."""
        return tuple(self.F.coset_evals(c, offset, blowup, k) for c in comps)

    def power_series(self, base: int, n: int, device="cpu"):
        """[1, b, b^2, ...] as one base component, log-doubled on ``device``."""
        return self.F._pow_series(self.F.from_int(base % self.P, (1,), device), n)

    def eval_base_poly_at(self, c0, x: int):
        """Evaluate a base-field polynomial held as word planes (shape (n,))
        at a python-int point, exactly: p(x) = sum_i x^i sum_j p[j*c+i]
        (x^c)^j turns the n sequential mulmods of Horner into ONE vectorized
        multiply + a log-tree sum + ~2*sqrt(n) scalar mulmods.  Returns None
        (caller falls back to Horner) for tiny or odd sizes."""
        n = int(c0[0].numel())
        if n < 512 or n & (n - 1):
            return None
        F = self.F
        x %= self.P
        cw = 1 << ((n - 1).bit_length() + 1) // 2  # chunk width ~ sqrt(n)
        r = n // cw
        y = pow(x, cw, self.P)
        pw = [1] * r
        for i in range(1, r):
            pw[i] = pw[i - 1] * y % self.P
        pwl = tuple(l.reshape(r, 1) for l in F.from_ints(pw, c0[0].device))
        prod = F.mul(tuple(l.reshape(r, cw) for l in c0), pwl)
        inner = self.vsum((prod,), axis=0)[0]
        acc = 0
        for c in reversed(F.to_ints(inner)):
            acc = (acc * x + c) % self.P
        return acc


_BACKENDS = {}


def get_backend(name: str) -> FieldBackend:
    if name not in _BACKENDS:
        if name == "f64":
            _BACKENDS[name] = GL64Backend()
        elif name in FIELDS_BY_NAME:
            _BACKENDS[name] = LimbBackend(FIELDS_BY_NAME[name], FIELDS[name])
        else:
            raise NotImplementedError(f"no field backend for {name!r}")
    return _BACKENDS[name]
