"""The limb prime fields f128 (p = 2^128 - 45*2^40 + 1) and f62
(p = 2^62 - 111*2^39 + 1) on 64-bit word planes.

Counterpart of starkpack_winterfell_tpu/ops/limb_field.py.  There an element
is a tuple of u32 limb planes (four for f128, two for f62); a GPU has 64-bit
integers, so here an element array is a tuple of ``torch.int64`` tensors
holding the u64 bit patterns of its words: ``(lo, hi)`` for f128, ``(w,)``
for f62 (the conventions of ops/gl64.py: unsigned compares flip the sign
bit, every right shift is masked).  Values are canonical (in [0, p))
everywhere, so proof bytes do not depend on the layout.

f128: the 128x128 -> 256 product is four 64x64 -> 128 products of
``gl64._mul_hi_lo``; the reduction folds with 2^128 = 45*2^40 - 1 (mod p)
twice and finishes with one conditional subtract.  f62: one 64x64 -> 128
product, folded four times at bit 62 with 2^62 = 111*2^39 - 1 (mod p).

``ntt`` keeps the JAX package's routing: above the tile cap the four-step
decomposition (tables log-doubled on the device and cached), a tile through
``ops/limb_ntt.ntt_last_axis``.  Every transform, the coset LDE among them,
is one or two launches of the tile kernel (``ops/limb_ntt.tile``: the CUDA
kernel for CUDA tensors, its plain version for CPU tensors), which also
takes the bit reversal, the layout moves, the coset scales, the zero
padding, the inverse's 1/n and the cosets' interleave.  Not carried over: the numpy/native-C tiers and the
matrix-unit tier (``matvec`` is plain multiply-adds in ops/felt.mds_apply).
"""

from __future__ import annotations

import numpy as np
import torch

from . import gl64 as gl

_M64 = 0xFFFFFFFFFFFFFFFF
_mul_hi_lo = gl._mul_hi_lo


def _ult(a, b):
    """Unsigned a < b as 0/1 words (a carry or a borrow)."""
    return gl._ult(a, b).to(torch.int64)


def _one_layout(planes):
    """The word planes as they are where they share their strides (the
    tile kernel reads all planes through one set), else contiguous."""
    if all(l.stride() == planes[0].stride() for l in planes):
        return planes
    return tuple(l.contiguous() for l in planes)


# tables of the transforms (coset factors, four-step twiddles), built once per
# field, key and device by ``LimbField._cached``
_TABLES: dict = {}


class LimbField:
    """What the limb fields share: conversions and the transforms, on tuples
    of ``n`` word planes.  A field provides add, sub, mul and square."""

    n = None  # 64-bit words per element
    MAX_NTT_TILE = None  # tiles above this size take the four-step split

    def __init__(self, modulus: int, generator: int, two_adicity: int,
                 two_adic_root: int, name: str):
        self.P = modulus
        self.GENERATOR = generator
        self.TWO_ADICITY = two_adicity
        self.TWO_ADIC_ROOT_OF_UNITY = two_adic_root
        self.NAME = name

    # -- conversions --------------------------------------------------------

    def from_int(self, v: int, shape=(), device="cpu"):
        v = int(v) % self.P
        return tuple(
            torch.full(shape, gl._wrap((v >> (64 * i)) & _M64), dtype=torch.int64,
                       device=device)
            for i in range(self.n)
        )

    def from_ints(self, vals, device="cpu"):
        arr = [int(v) % self.P for v in vals]
        return tuple(
            gl.from_u64(np.array([(v >> (64 * i)) & _M64 for v in arr],
                                 dtype=np.uint64), device)
            for i in range(self.n)
        )

    def to_ints(self, a):
        words = [gl.to_u64(l).reshape(-1) for l in a]
        return [sum(int(w[k]) << (64 * i) for i, w in enumerate(words))
                for k in range(words[0].shape[0])]

    def zeros(self, shape, device="cpu"):
        return tuple(torch.zeros(shape, dtype=torch.int64, device=device)
                     for _ in range(self.n))

    def ones(self, shape, device="cpu"):
        return (torch.ones(shape, dtype=torch.int64, device=device),) + tuple(
            torch.zeros(shape, dtype=torch.int64, device=device)
            for _ in range(self.n - 1)
        )

    def neg(self, a):
        return self.sub(self.zeros((), a[0].device), a)

    def exp_int(self, a, e: int):
        e = int(e)
        if e == 0:
            return self.ones(a[0].shape, a[0].device)
        result = None
        base = a
        while e:
            if e & 1:
                result = base if result is None else self.mul(result, base)
            e >>= 1
            if e:
                base = self.square(base)
        return result

    def inv(self, a):
        return self.exp_int(a, self.P - 2)

    def get_root_of_unity(self, log_n: int) -> int:
        assert 0 < log_n <= self.TWO_ADICITY
        return pow(self.TWO_ADIC_ROOT_OF_UNITY, 1 << (self.TWO_ADICITY - log_n), self.P)

    # -- NTT ----------------------------------------------------------------

    def _tile_cap(self) -> int:
        from . import limb_ntt

        return min(self.MAX_NTT_TILE, limb_ntt.max_tile(self))

    def _pow_series(self, bases, length: int):
        """bases: word planes shaped (..., 1) -> (..., length) power series
        out[..., j] = base^j, via log-doubling (log2(length) multiplies)."""
        cur = self.ones(bases[0].shape[:-1] + (1,), bases[0].device)
        pw = bases
        ln = 1
        while ln < length:
            nxt = self.mul(cur, pw)
            cur = tuple(torch.cat([x, y], dim=-1) for x, y in zip(cur, nxt))
            ln *= 2
            if ln < length:
                pw = self.square(pw)
        if cur[0].shape[-1] != length:
            cur = tuple(l[..., :length] for l in cur)
        return cur

    def _split_tiles(self, n: int, cap: int = None):
        cap = self.MAX_NTT_TILE if cap is None else cap
        bits = n.bit_length() - 1
        r = 1 << ((bits + 1) // 2)
        while r > cap:
            r >>= 1
        # c = n // r may exceed cap: _four_step then transforms the columns
        # with ntt(), another four-step level, so any n builds as a tower
        return r, n // r

    def _cached(self, key, build):
        """A table built once per field, key and device (the key names the
        device)."""
        key = (self.NAME,) + key
        if key not in _TABLES:
            _TABLES[key] = build()
        return _TABLES[key]

    def _coset_factors(self, domain_offset: int, blowup: int, n: int, r: int, device):
        """Input factors of the coset LDE of length-n coefficients: coset g
        of the blowup scales coefficient t by s_g^t, s_g = offset * g_L^g.
        r = n: the (blowup, n) series; r < n (the four-step split n = r*c):
        s_g^t = (s_g^c)^{t1} * s_g^{t2} as a row factor (blowup, r) and a
        column factor (blowup, c).  Returns (row, col), col None for r = n."""

        def build():
            L = n * blowup
            g_L = self.get_root_of_unity(L.bit_length() - 1) if blowup > 1 else 1
            s_list = [domain_offset * pow(g_L, k, self.P) % self.P for k in range(blowup)]
            c = n // r
            row_b = self.from_ints([pow(s, c, self.P) for s in s_list], device)
            row = self._pow_series(tuple(l.reshape(blowup, 1) for l in row_b), r)
            if c == 1:
                return tuple(l.contiguous() for l in row), None
            col_b = self.from_ints(s_list, device)
            col = self._pow_series(tuple(l.reshape(blowup, 1) for l in col_b), c)
            return tuple(l.contiguous() for l in row), tuple(l.contiguous() for l in col)

        return self._cached(("coset", domain_offset % self.P, blowup, n, r, str(device)), build)

    def _four_step_table(self, n: int, r: int, inverse: bool, scaled: bool, device):
        """(c, r) inner twiddle of the four-step split n = r*c:
        root^(j1*t2) at [t2, j1], times 1/n for a scaled inverse."""

        def build():
            c = n // r
            root = self.get_root_of_unity(n.bit_length() - 1)
            if inverse:
                root = pow(root, self.P - 2, self.P)
            bases = self._pow_series(self.from_int(root, (1,), device), c)  # root^t2
            T = self._pow_series(tuple(l.reshape(c, 1) for l in bases), r)
            if scaled:
                T = self.mul(T, self.from_int(pow(n, self.P - 2, self.P), (), device))
            return tuple(l.contiguous() for l in T)

        return self._cached(("four_step", n, r, bool(inverse), bool(scaled), str(device)),
                            build)

    def _four_step(self, x, inverse: bool, scaled: bool, out, row=None, col=None):
        """Four-step NTT along the last axis of x, word planes (G, D, n) with
        any strides (G groups of D transforms), written into ``out``, planes
        (G, D, n) with any strides (n = r*c):

          M[t1, t2] = x[t1*c + t2]          (view (G, D, r, c))
          A[j1, t2] = NTT_r over t1         (tile launch; input times the
                                             row / col factors, (G, r) and
                                             (G, c); stored transposed, A^T)
          O[j2, j1] = NTT_c over t2 of A^T times w_n^{+-j1*t2}
                                            (tile launch; the twiddle, and a
                                             scaled inverse's 1/n, as its
                                             pre-multiply table)
          X[j1 + r*j2] = O[j2, j1]          (the second launch's store)

        No gather, transpose or multiply runs beside the two launches.  With
        c above the tile cap the second step is an eager transpose, multiply
        and ntt() of its own (n above cap^2)."""
        from . import limb_ntt

        G, D, n = x[0].shape
        device = x[0].device
        cap = self._tile_cap()
        r, c = self._split_tiles(n, cap)

        def view4(planes, shape, strides):
            return tuple(torch.as_strided(l, shape, strides, l.storage_offset())
                         for l in planes)

        sg, sd, sn = x[0].stride()
        m = view4(x, (G, D, r, c), (sg, sd, c * sn, sn))
        at = tuple(torch.empty((G, D, c, r), dtype=torch.int64, device=device)
                   for _ in range(self.n))
        limb_ntt.tile(self, m, limb_ntt.tile_twiddles(self, r, inverse, device), row=row,
                      col=col, out=tuple(l.transpose(2, 3) for l in at), inverse=inverse)
        T = self._four_step_table(n, r, inverse, scaled, device)
        og, od, on = out[0].stride()
        if c <= cap:
            limb_ntt.tile(self, at, limb_ntt.tile_twiddles(self, c, inverse, device), pre=T,
                          out=view4(out, (G, D, c, r), (og, od, r * on, on)),
                          inverse=inverse)
            return out
        o = self.ntt(tuple(l.transpose(2, 3).contiguous()
                           for l in self.mul(at, T)), inverse=inverse, scale=False)
        for dst, src in zip(view4(out, (G, D, r, c), (og, od, on, r * on)), o):
            dst.copy_(src)
        return out

    def ntt(self, a, inverse: bool = False, scale: bool = True):
        """Transform along the last axis of a word-plane tuple (each plane
        shaped (..., n)); natural order in and out."""
        from . import limb_ntt

        n = a[0].shape[-1]
        if n == 1:
            return a
        scaled = inverse and scale
        if n <= self._tile_cap():
            return limb_ntt.ntt_last_axis(
                self, _one_layout(a), inverse, pow(n, self.P - 2, self.P) if scaled else None)
        out = tuple(torch.empty(a[0].shape, dtype=torch.int64, device=a[0].device)
                    for _ in range(self.n))
        self._four_step(_one_layout(tuple(l.reshape(1, -1, n) for l in a)), inverse, scaled,
                        tuple(l.reshape(1, -1, n) for l in out))
        return out

    def evaluate_poly_with_offset(self, a, domain_offset: int, blowup: int):
        """Coset LDE: scale coeffs by offset^j, zero-pad, transform.  Above
        the tile limit this runs as ``blowup`` coset NTTs of length n, each
        coefficient scaled by its coset's power series, stored interleaved.
        Every scale, the padding and the interleave ride in the tile
        launches."""
        from . import limb_ntt

        n = a[0].shape[-1]
        L = n * blowup
        if L == 1:
            return tuple(l.clone() for l in a)
        lead = a[0].shape[:-1]
        device = a[0].device
        out = tuple(torch.empty(lead + (L,), dtype=torch.int64, device=device)
                    for _ in range(self.n))
        rows = _one_layout(tuple(l.reshape(-1, n) for l in a))
        if L <= self._tile_cap():
            offs = self._coset_factors(domain_offset, 1, n, n, device)[0]
            limb_ntt.tile(self, tuple(l.T[None, None] for l in rows),
                          limb_ntt.tile_twiddles(self, L, False, device), n=L, row=offs,
                          out=tuple(l.reshape(-1, L).T[None, None] for l in out))
            return out
        return self._lde_cosets(rows, domain_offset, blowup, out)

    def _lde_cosets(self, rows, domain_offset: int, blowup: int, out):
        """evals on coset g (natural index i = q*blowup + g) = NTT_n of the
        coefficients scaled by s_g^t, s_g = offset * g_L^g: the coefficient
        rows (nb, n) read once per coset (stride 0 over the cosets), written
        interleaved into ``out`` (..., L)."""
        from . import limb_ntt

        nb, n = rows[0].shape
        rs = rows[0].stride()
        L = n * blowup
        device = rows[0].device
        cap = self._tile_cap()
        if n <= cap:
            row, _ = self._coset_factors(domain_offset, blowup, n, n, device)
            x = tuple(torch.as_strided(l, (blowup, 1, n, nb), (0, 0, rs[1], rs[0]),
                                       l.storage_offset()) for l in rows)
            o = tuple(torch.as_strided(l, (blowup, 1, n, nb), (1, 0, blowup, L),
                                       l.storage_offset()) for l in out)
            limb_ntt.tile(self, x, limb_ntt.tile_twiddles(self, n, False, device), row=row,
                          out=o)
            return out
        r, _ = self._split_tiles(n, cap)
        row, col = self._coset_factors(domain_offset, blowup, n, r, device)
        x = tuple(torch.as_strided(l, (blowup, nb, n), (0, rs[0], rs[1]), l.storage_offset())
                  for l in rows)
        o = tuple(torch.as_strided(l, (blowup, nb, n), (1, L, blowup), l.storage_offset())
                  for l in out)
        self._four_step(x, False, False, o, row=row, col=col)
        return out

    def coset_evals(self, a, domain_offset: int, blowup: int, k: int):
        """Coset k alone of ``evaluate_poly_with_offset(a, domain_offset,
        blowup)``: planes (..., n), element q the LDE's at natural index
        q*blowup + k.  The length-n transform of the coefficients scaled by
        s_k^t, s_k = offset * g_L^k: row k of the factors ``_lde_cosets``
        takes, riding in the launch as there."""
        from . import limb_ntt

        n = a[0].shape[-1]
        device = a[0].device
        rows = _one_layout(tuple(l.reshape(-1, n) for l in a))
        nb = rows[0].shape[0]
        out = tuple(torch.empty((nb, n), dtype=torch.int64, device=device)
                    for _ in range(self.n))
        cap = self._tile_cap()
        if n <= cap:
            row, _ = self._coset_factors(domain_offset, blowup, n, n, device)
            rs = rows[0].stride()
            x = tuple(torch.as_strided(l, (1, 1, n, nb), (0, 0, rs[1], rs[0]),
                                       l.storage_offset()) for l in rows)
            limb_ntt.tile(self, x, limb_ntt.tile_twiddles(self, n, False, device),
                          row=tuple(l[k : k + 1] for l in row),
                          out=tuple(l.T[None, None] for l in out))
        else:
            r, _ = self._split_tiles(n, cap)
            row, col = self._coset_factors(domain_offset, blowup, n, r, device)
            self._four_step(tuple(l[None] for l in rows), False, False,
                            tuple(l[None] for l in out), row=tuple(l[k : k + 1] for l in row),
                            col=tuple(l[k : k + 1] for l in col))
        return tuple(l.reshape(a[0].shape) for l in out)

    def interpolate_poly(self, a):
        return self.ntt(a, inverse=True, scale=True)

    def interpolate_poly_with_offset(self, a, domain_offset: int):
        n = a[0].shape[-1]
        device = a[0].device
        coeffs = self.ntt(a, inverse=True, scale=True)
        inv_off = pow(domain_offset, self.P - 2, self.P)
        base = self.from_int(inv_off, (1,), device)
        return self.mul(coeffs, self._pow_series(base, n))

    def horner(self, coeffs, x):
        """Evaluate along the last axis at point-array x (shape = remaining
        axes)."""
        n = coeffs[0].shape[-1]
        acc = tuple(l[..., n - 1] for l in coeffs)
        for j in range(n - 2, -1, -1):
            acc = self.add(self.mul(acc, x), tuple(l[..., j] for l in coeffs))
        return acc

    def apply_drp(self, transposed, domain_offset: int, alpha: int):
        """FRI degree-respecting projection over this field: transposed
        shaped (m, N); returns the folded evaluations (m,)."""
        m, N = transposed[0].shape
        device = transposed[0].device
        coeffs = self.ntt(transposed, inverse=True, scale=True)
        g = self.get_root_of_unity((m * N).bit_length() - 1)
        inv_g = pow(g, self.P - 2, self.P)
        inv_c = pow(domain_offset, self.P - 2, self.P)
        series = self._pow_series(self.from_int(inv_g, (1,), device), m)
        x = self.mul(series, self.from_int(inv_c * alpha % self.P, (), device))
        return self.horner(coeffs, x)


class F128Field(LimbField):
    """f128 on ``(lo, hi)`` word planes."""

    n = 2
    MAX_NTT_TILE = 4096

    def __init__(self, modulus, generator, two_adicity, two_adic_root, name):
        super().__init__(modulus, generator, two_adicity, two_adic_root, name)
        assert modulus >> 64 == _M64 and (1 << 128) - modulus < (1 << 63)
        self.DELTA = (1 << 128) - modulus  # 2^128 mod p, below 2^46
        self._p_lo_flipped = gl._wrap(modulus & _M64) ^ gl._SIGN

    def _finish(self, lo, hi, carry):
        """(lo, hi) + carry*2^128 with the whole value below 2p -> canonical:
        a carry out of 128 bits and a value >= p both mean "+ DELTA" modulo
        2^128, and they exclude each other."""
        ge_p = (hi == -1) & ((lo ^ gl._SIGN) >= self._p_lo_flipped)
        fix = (carry | ge_p) * self.DELTA
        r_lo = lo + fix
        return r_lo, hi + _ult(r_lo, lo)

    def add(self, a, b):
        lo = a[0] + b[0]
        c0 = _ult(lo, a[0])
        t = a[1] + b[1]
        hi = t + c0
        carry = _ult(t, a[1]) | _ult(hi, t)
        return self._finish(lo, hi, carry)

    def sub(self, a, b):
        lo = a[0] - b[0]
        b0 = _ult(a[0], b[0])
        hi = a[1] - b[1] - b0
        borrow = _ult(a[1], b[1]) | ((a[1] == b[1]) & b0)
        # on borrow add p back, i.e. subtract DELTA modulo 2^128
        fix = borrow * self.DELTA
        r_lo = lo - fix
        return r_lo, hi - _ult(lo, fix)

    def _reduce256(self, w0, w1, w2, w3):
        """Four u64 words of a 256-bit value below p^2 -> canonical residue."""
        D = self.DELTA
        t2l, t2h = _mul_hi_lo(w2, D)  # t2h, t3h < 2^46
        t3l, t3h = _mul_hi_lo(w3, D)
        r0 = w0 + t2l
        c = _ult(r0, w0)
        x = w1 + t2h
        c1 = _ult(x, w1)
        y = x + t3l
        c2 = _ult(y, x)
        r1 = y + c
        c3 = _ult(r1, y)
        r2 = t3h + c1 + c2 + c3  # below 2^47
        ul, uh = _mul_hi_lo(r2, D)  # below 2^93: uh < 2^29
        s0 = r0 + ul
        c = _ult(s0, r0)
        x = r1 + uh
        c1 = _ult(x, r1)
        s1 = x + c
        c2 = _ult(s1, x)
        # a carry here leaves a value below 2^93 + 2^128 = small + DELTA + p
        return self._finish(s0, s1, c1 | c2)

    def mul(self, a, b):
        l00, h00 = _mul_hi_lo(a[0], b[0])
        l01, h01 = _mul_hi_lo(a[0], b[1])
        l10, h10 = _mul_hi_lo(a[1], b[0])
        l11, h11 = _mul_hi_lo(a[1], b[1])
        x = h00 + l01
        c1 = _ult(x, h00)
        w1 = x + l10
        c1 = c1 + _ult(w1, x)
        x = h01 + h10
        c2 = _ult(x, h01)
        y = x + l11
        c2 = c2 + _ult(y, x)
        w2 = y + c1
        c2 = c2 + _ult(w2, y)
        return self._reduce256(l00, w1, w2, h11 + c2)

    def square(self, a):
        l00, h00 = _mul_hi_lo(a[0], a[0])
        l01, h01 = _mul_hi_lo(a[0], a[1])
        l11, h11 = _mul_hi_lo(a[1], a[1])
        x = h00 + l01
        c1 = _ult(x, h00)
        w1 = x + l01
        c1 = c1 + _ult(w1, x)
        x = h01 + h01
        c2 = _ult(x, h01)
        y = x + l11
        c2 = c2 + _ult(y, x)
        w2 = y + c1
        c2 = c2 + _ult(w2, y)
        return self._reduce256(l00, w1, w2, h11 + c2)


class F62Field(LimbField):
    """f62 on one word plane ``(w,)``; values below 2^62 are non-negative
    int64, so signed compares are the unsigned ones."""

    n = 1
    MAX_NTT_TILE = 4096
    _M62 = (1 << 62) - 1

    def __init__(self, modulus, generator, two_adicity, two_adic_root, name):
        super().__init__(modulus, generator, two_adicity, two_adic_root, name)
        assert modulus >> 61 == 1
        self.E = (1 << 62) - modulus  # 2^62 mod p, below 2^46

    def add(self, a, b):
        s = a[0] + b[0]  # below 2^63
        return (s - (s >= self.P) * self.P,)

    def sub(self, a, b):
        d = a[0] - b[0]
        return (d + (d < 0) * self.P,)

    def _fold(self, lo, hi):
        """(lo, hi) words of a value v -> words of (v mod 2^62) + (v >> 62)*E,
        the same residue; v >> 62 has to fit one word."""
        top = (hi << 2) | ((lo >> 62) & 3)
        pl, ph = _mul_hi_lo(top, self.E)
        r = pl + (lo & self._M62)
        return r, ph + _ult(r, pl)

    def mul(self, a, b):
        lo, hi = _mul_hi_lo(a[0], b[0])  # below 2^124
        lo, hi = self._fold(lo, hi)  # below 2^62 + 2^108
        lo, hi = self._fold(lo, hi)  # below 2^62 + 2^92
        lo, hi = self._fold(lo, hi)  # below 2^62 + 2^76: top part below 2^15
        top = (hi << 2) | ((lo >> 62) & 3)
        v = (lo & self._M62) + top * self.E  # below 2^62 + 2^61 < 2p
        return (v - (v >= self.P) * self.P,)

    def square(self, a):
        return self.mul(a, a)


F128 = F128Field(
    modulus=340282366920938463463374557953744961537,  # 2^128 - 45*2^40 + 1
    generator=3,
    two_adicity=40,
    two_adic_root=23953097886125630542083529559205016746,
    name="f128",
)

F62 = F62Field(
    modulus=4611624995532046337,  # 2^62 - 111*2^39 + 1
    generator=3,
    two_adicity=39,
    two_adic_root=4421547261963328785,
    name="f62",
)

FIELDS_BY_NAME = {F128.NAME: F128, F62.NAME: F62}
