# Copy of starkpack_winterfell_tpu/verifier/native_scalar.py; cut: available() (the library builds at first use or the call raises) and the None returns (a C parameter error raises RuntimeError).
"""ctypes wrappers for the native verifier scalar loops (verify_scalar.c).

Packs field constants (modulus, R^2 for the 2^128 Montgomery domain,
extension-reduction coefficients) once per (field, ext_deg) and exposes the
four verify hot loops — FRI layer fold, remainder check, DEEP trace
numerators, DEEP combine — over numpy u64 word buffers, with Horner and
barycentric evaluation beside them.  numpy and ctypes only, no torch.  The
library builds at first use; where it cannot, or a call's parameters are
out of its range, the call raises RuntimeError: no caller falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import get_verify_scalar

_VP = ctypes.c_void_p
_CTX_CACHE: dict = {}


def _words(v: int) -> tuple:
    return (v & 0xFFFFFFFFFFFFFFFF, (v >> 64) & 0xFFFFFFFFFFFFFFFF)


class FieldCtx:
    """Per-(spec, ext_deg) constant pack for the C calls."""

    def __init__(self, spec, ext_deg: int):
        P = spec.P
        self.spec = spec
        self.d = ext_deg
        self.elem_bytes = spec.ELEMENT_BYTES
        self.P = P
        self.p_arr = np.array(_words(P), dtype=np.uint64)
        self.r2_arr = np.array(_words(pow(1 << 128, 2, P)), dtype=np.uint64)
        if ext_deg == 1:
            self.q_arr = None
        elif ext_deg == 2:
            q1, q0 = spec.quad_reduce
            self.q_arr = np.array(
                _words(q0 % P) + _words(q1 % P), dtype=np.uint64
            )
        elif ext_deg == 3:
            e2, e1, e0 = spec.cubic_reduce
            self.q_arr = np.array(
                _words(e0 % P) + _words(e1 % P) + _words(e2 % P),
                dtype=np.uint64,
            )
        else:
            raise ValueError(f"unsupported extension degree {ext_deg}")

    def qptr(self):
        return None if self.q_arr is None else self.q_arr.ctypes.data

    def pack_elems(self, elems) -> np.ndarray:
        """list of ext elements (int for d==1, component tuple for d>1)
        -> (k, d, 2) u64 plain words."""
        d = self.d
        out = np.empty((len(elems), d, 2), dtype=np.uint64)
        for i, e in enumerate(elems):
            comps = (e,) * 1 if isinstance(e, int) else tuple(e)
            if isinstance(e, int):
                comps = (e,) + (0,) * (d - 1)
            elif len(comps) < d:
                comps = comps + (0,) * (d - len(comps))
            for t in range(d):
                out[i, t, 0] = comps[t] & 0xFFFFFFFFFFFFFFFF
                out[i, t, 1] = (comps[t] >> 64) & 0xFFFFFFFFFFFFFFFF
        return out

    def unpack_elems(self, arr: np.ndarray):
        """(k, d, 2) u64 -> list of ints (d==1) / component tuples."""
        k = arr.shape[0]
        if self.d == 1:
            return [int(arr[i, 0, 0]) | (int(arr[i, 0, 1]) << 64)
                    for i in range(k)]
        return [
            tuple(int(arr[i, t, 0]) | (int(arr[i, t, 1]) << 64)
                  for t in range(self.d))
            for i in range(k)
        ]


def get_ctx(spec, ext_deg: int):
    key = (spec.name, ext_deg)
    ctx = _CTX_CACHE.get(key)
    if ctx is None:
        ctx = _CTX_CACHE[key] = FieldCtx(spec, ext_deg)
    return ctx


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def fold_layer(ctx: FieldCtx, N: int, values_bytes: bytes, nrows: int,
               evals_in: np.ndarray, qmap_row, qmap_col, folded_pos,
               g: int, offs: int, alpha, idft_words: np.ndarray):
    """Returns (rc, out_evals (nrows, d, 2)); rc 1 = query-value mismatch."""
    lib = get_verify_scalar()
    d = ctx.d
    qr, qc, fp = _i64(qmap_row), _i64(qmap_col), _i64(folded_pos)
    ev = np.ascontiguousarray(evals_in, dtype=np.uint64)
    out = np.empty((nrows, d, 2), dtype=np.uint64)
    g_arr = np.array(_words(g), dtype=np.uint64)
    o_arr = np.array(_words(offs), dtype=np.uint64)
    a_arr = ctx.pack_elems([alpha])
    rc = lib.vs_fold_layer(
        ctx.p_arr.ctypes.data, ctx.r2_arr.ctypes.data,
        ctx.d, ctx.qptr(), ctx.elem_bytes, N,
        values_bytes, nrows,
        ev.ctypes.data, len(qr),
        qr.ctypes.data, qc.ctypes.data,
        fp.ctypes.data,
        g_arr.ctypes.data, o_arr.ctypes.data,
        a_arr.ctypes.data, idft_words.ctypes.data,
        out.ctypes.data,
    )
    return rc, out


def remainder_check(ctx: FieldCtx, rem_bytes: bytes, nrem: int, positions,
                    g: int, offs: int, evals: np.ndarray) -> int:
    lib = get_verify_scalar()
    pos = _i64(positions)
    ev = np.ascontiguousarray(evals, dtype=np.uint64)
    g_arr = np.array(_words(g), dtype=np.uint64)
    o_arr = np.array(_words(offs), dtype=np.uint64)
    return lib.vs_remainder_check(
        ctx.p_arr.ctypes.data, ctx.r2_arr.ctypes.data,
        ctx.d, ctx.qptr(), ctx.elem_bytes,
        rem_bytes, nrem,
        pos.ctypes.data, len(pos),
        g_arr.ctypes.data, o_arr.ctypes.data,
        ev.ctypes.data,
    )


def deep_trace(ctx: FieldCtx, table_words: np.ndarray, n: int, q: int, w: int,
               d_in: int, ood_cur: np.ndarray, ood_nxt: np.ndarray,
               cc: np.ndarray, t1_num: np.ndarray, t2_num: np.ndarray,
               accumulate: bool) -> int:
    lib = get_verify_scalar()
    tw = np.ascontiguousarray(table_words, dtype=np.uint32)
    return lib.vs_deep_trace(
        ctx.p_arr.ctypes.data, ctx.r2_arr.ctypes.data,
        ctx.d, ctx.qptr(), ctx.elem_bytes,
        tw.ctypes.data, n, q, w, d_in,
        ood_cur.ctypes.data, ood_nxt.ctypes.data,
        cc.ctypes.data,
        t1_num.ctypes.data, t2_num.ctypes.data,
        1 if accumulate else 0,
    )


def deep_combine(ctx: FieldCtx, q: int, positions, g_lde: int, offs: int,
                 z, zg, t1_num: np.ndarray, t2_num: np.ndarray,
                 cons_words: np.ndarray, m: int, ood_c: np.ndarray,
                 cc2: np.ndarray):
    lib = get_verify_scalar()
    pos = _i64(positions)
    g_arr = np.array(_words(g_lde), dtype=np.uint64)
    o_arr = np.array(_words(offs), dtype=np.uint64)
    z_arr = ctx.pack_elems([z])
    zg_arr = ctx.pack_elems([zg])
    cw = np.ascontiguousarray(cons_words, dtype=np.uint32)
    out = np.empty((q, ctx.d, 2), dtype=np.uint64)
    rc = lib.vs_deep_combine(
        ctx.p_arr.ctypes.data, ctx.r2_arr.ctypes.data,
        ctx.d, ctx.qptr(), ctx.elem_bytes,
        q, pos.ctypes.data,
        g_arr.ctypes.data, o_arr.ctypes.data,
        z_arr.ctypes.data, zg_arr.ctypes.data,
        t1_num.ctypes.data, t2_num.ctypes.data,
        cw.ctypes.data, m,
        ood_c.ctypes.data, cc2.ctypes.data,
        out.ctypes.data,
    )
    return rc, out


_PACK_CACHE: dict = {}


def pack_base_cached(ctx: FieldCtx, vals, key=None):
    """(n, 2) u64 word pack of a base-field int list, identity-cached when
    the list object is stable (periodic polys are AIR-class cached)."""
    if key is None:
        key = (ctx.spec.name, id(vals))
        hit = _PACK_CACHE.get(key)
        if hit is not None and hit[0] is vals:
            return hit[1]
    arr = np.empty((len(vals), 2), dtype=np.uint64)
    for i, v in enumerate(vals):
        arr[i, 0] = v & 0xFFFFFFFFFFFFFFFF
        arr[i, 1] = (v >> 64) & 0xFFFFFFFFFFFFFFFF
    if len(_PACK_CACHE) > 512:
        _PACK_CACHE.clear()
    _PACK_CACHE[(ctx.spec.name, id(vals))] = (vals, arr)
    return arr


def poly_eval(ctx: FieldCtx, coeffs_arr: np.ndarray, x):
    """Horner: sum coeffs[i] x^i over the ext field.  Returns the element
    (int / tuple)."""
    lib = get_verify_scalar()
    x_arr = ctx.pack_elems([x])
    out = np.empty((1, ctx.d, 2), dtype=np.uint64)
    rc = lib.vs_poly_eval(
        ctx.p_arr.ctypes.data, ctx.r2_arr.ctypes.data,
        ctx.d, ctx.qptr(),
        coeffs_arr.ctypes.data, coeffs_arr.shape[0],
        x_arr.ctypes.data, out.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"vs_poly_eval failed (rc={rc})")
    return ctx.unpack_elems(out)[0]


def barycentric_eval(ctx: FieldCtx, values_arr: np.ndarray, w: int, x):
    """Evaluate the subgroup interpolant of base-field values at ext x."""
    lib = get_verify_scalar()
    x_arr = ctx.pack_elems([x])
    w_arr = np.array(_words(w), dtype=np.uint64)
    out = np.empty((1, ctx.d, 2), dtype=np.uint64)
    rc = lib.vs_barycentric_eval(
        ctx.p_arr.ctypes.data, ctx.r2_arr.ctypes.data,
        ctx.d, ctx.qptr(),
        values_arr.ctypes.data, values_arr.shape[0],
        w_arr.ctypes.data,
        x_arr.ctypes.data, out.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"vs_barycentric_eval failed (rc={rc})")
    return ctx.unpack_elems(out)[0]


def test_ops(ctx: FieldCtx, a, b, e: int):
    """(mul, add, sub, inv(a), pow(a, e)) via the C core — test hook."""
    lib = get_verify_scalar()
    a_arr = ctx.pack_elems([a])
    b_arr = ctx.pack_elems([b])
    out = np.empty((5, ctx.d, 2), dtype=np.uint64)
    rc = lib.vs_test_ops(
        ctx.p_arr.ctypes.data, ctx.r2_arr.ctypes.data,
        ctx.d, ctx.qptr(),
        a_arr.ctypes.data, b_arr.ctypes.data,
        e & 0xFFFFFFFFFFFFFFFF, (e >> 64) & 0xFFFFFFFFFFFFFFFF,
        out.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"vs_test_ops failed (rc={rc})")
    return ctx.unpack_elems(out)
