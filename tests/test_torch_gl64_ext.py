"""PyTorch port, extension fields: ops/gl64_ext.py, the degree-2 and -3
branches of ops/vec.py and ops/felt.py, the random coin's extension draws and
the extension row layout of utils/convert.py of starkpack_winterfell_tpu_torch
against the JAX package's numpy paths.

Same inputs on both sides (numpy, fixed seed, carried across with
``utils/convert.from_limb_pairs``, plus the edge words 0, 1 and p - 1); the
arithmetic is exact, so the tolerance is zero."""

import numpy as np
import pytest
import torch

from starkpack_winterfell_tpu.crypto.hashers import get_hasher as jget_hasher
from starkpack_winterfell_tpu.crypto.random_coin import RandomCoin as JCoin
from starkpack_winterfell_tpu.math import fieldspec as jfs
from starkpack_winterfell_tpu.ops import gl64 as jgl, gl64_ext as jext, vec as jvec
from starkpack_winterfell_tpu.ops.felt import Felt as JFelt
from starkpack_winterfell_tpu.utils import convert as jconvert

from starkpack_winterfell_tpu_torch.crypto.hashers import get_hasher as tget_hasher
from starkpack_winterfell_tpu_torch.crypto.random_coin import RandomCoin as TCoin
from starkpack_winterfell_tpu_torch.math import fieldspec as tfs, scalar as tsc
from starkpack_winterfell_tpu_torch.ops import gl64 as tgl, gl64_ext as text, vec as tvec
from starkpack_winterfell_tpu_torch.ops.felt import Felt as TFelt
from starkpack_winterfell_tpu_torch.utils import convert

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

P = tgl.P
EDGES = np.array([0, 1, P - 1], dtype=np.uint64)


def _elements(deg, seed, size=512):
    """(deg, N) uint64 components: every combination of the edge words,
    then random words."""
    rng = np.random.default_rng(seed)
    grid = np.array(np.meshgrid(*([EDGES] * deg), indexing="ij")).reshape(deg, -1)
    rnd = rng.integers(0, P, size=(deg, size), dtype=np.uint64)
    return np.concatenate([grid, rnd], axis=1)


def _pair(x):
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32), (x >> np.uint64(32)).astype(np.uint32)


def _j(arr):
    return tuple(jgl.from_u64(c) for c in arr)


def _t(arr):
    """The same components in the port, carried across as (lo, hi) pairs."""
    return tuple(convert.from_limb_pairs(_pair(c)) for c in arr)


def _u(comps, pkg_gl):
    return np.stack([pkg_gl.to_u64(c) for c in comps])


def _operands(deg, seed):
    a = _elements(deg, seed)
    b = np.roll(_elements(deg, seed + 100), 7, axis=1)
    return a, b


@pytest.mark.parametrize("deg,op", [(2, "mul2"), (3, "mul3")])
def test_products_match_reference(deg, op):
    a, b = _operands(deg, deg)
    want = _u(getattr(jext, op)(_j(a), _j(b)), jgl)
    got = _u(getattr(text, op)(_t(a), _t(b)), tgl)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("op", ["square2", "frob2", "inv2", "square3", "frob3", "inv3"])
def test_unary_ops_match_reference(op):
    a, _ = _operands(int(op[-1]), 11)
    want = _u(getattr(jext, op)(_j(a)), jgl)
    got = _u(getattr(text, op)(_t(a)), tgl)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("deg,op", [(2, "mul_base2"), (3, "mul_base3")])
def test_base_products_match_reference(deg, op):
    a, b = _operands(deg, 21)
    want = _u(getattr(jext, op)(_j(a), jgl.from_u64(b[0])), jgl)
    got = _u(getattr(text, op)(_t(a), _t(b[:1])[0]), tgl)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("deg", [2, 3])
def test_inverse_of_zero_is_zero_and_inverses_multiply_to_one(deg):
    a, _ = _operands(deg, 31)
    inv = text.inv2 if deg == 2 else text.inv3
    mul = text.mul2 if deg == 2 else text.mul3
    # a (1,)-shaped zero goes through the host pow, a vector through the ladder
    zero = tuple(tgl.zeros((1,)) for _ in range(deg))
    assert not _u(inv(zero), tgl).any()
    got = _u(inv(_t(a)), tgl)
    zeros = ~a.any(axis=0)
    assert not got[:, zeros].any()
    prod = _u(mul(_t(a), _t(got)), tgl)
    assert (prod[0, ~zeros] == 1).all() and not prod[1:, ~zeros].any()
    # one element: the host inversion of the norm equals the vector one
    one = _u(inv(_t(a[:, -1:])), tgl)
    assert np.array_equal(one[:, 0], got[:, -1])


@pytest.mark.parametrize("da,db", [(2, 2), (3, 3), (1, 2), (3, 1)])
def test_vec_ops_match_reference_at_every_degree(da, db):
    a, b = _elements(da, 41), _elements(db, 42)
    n = min(a.shape[1], b.shape[1])
    a, b = a[:, :n], b[:, :n]
    ja, jb, ta, tb = _j(a), _j(b), _t(a), _t(b)
    for op in ("vadd", "vsub", "vmul"):
        want = _u(getattr(jvec, op)(ja, jb), jgl)
        got = _u(getattr(tvec, op)(ta, tb), tgl)
        assert np.array_equal(got, want), op
    for op in ("vsquare", "vinv", "vneg"):
        assert np.array_equal(_u(getattr(tvec, op)(ta), tgl), _u(getattr(jvec, op)(ja), jgl)), op


@pytest.mark.parametrize("deg", [2, 3])
@pytest.mark.parametrize("n", [1, 7, 256])
def test_power_series_elem_matches_reference(deg, n):
    x = _elements(deg, 51, size=1)[:, -1:]
    want = _u(jvec.power_series_elem(_j(x), n), jgl)
    got = _u(tvec.power_series_elem(_t(x), n), tgl)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dp,dz", [(1, 2), (2, 2), (1, 3), (3, 3)])
def test_syn_div_binomial_matches_reference(dp, dz):
    """p(x) - p(z) divided by (x - z) at an extension point z, for three
    polynomials whose coefficients have degree dp."""
    rng = np.random.default_rng(dp * 10 + dz)
    n = 64
    coeffs = rng.integers(0, P, size=(dp, 3, n), dtype=np.uint64)
    z = _elements(dz, 61, size=1)[:, -1:]
    jp = jvec.promote(_j(coeffs), dz)
    pz = _u(jvec.horner(jp, jvec.vbroadcast(_j(z), (3,))), jgl)  # (dz, 3)
    shifted = _u(jp, jgl)
    shifted[:, :, 0] = (shifted[:, :, 0].astype(object) - pz.astype(object)) % P
    shifted = shifted.astype(np.uint64)
    want = _u(jvec.syn_div_binomial(_j(shifted), _j(z)), jgl)
    got = _u(tvec.syn_div_binomial(_t(shifted), _t(z)), tgl)
    assert np.array_equal(got, want)
    # (x - z) * quotient gives the shifted polynomial back; the quotient's
    # top slot is 0, so x * q is a roll by one slot
    q = _t(got)
    xq = tuple(torch.roll(c, 1, dims=-1) for c in q)
    back = tvec.vsub(xq, tvec.vmul(q, tvec.vbroadcast(_t(z), (3, n))))
    assert np.array_equal(_u(back, tgl), shifted)


@pytest.mark.parametrize("deg", [2, 3])
def test_felt_extension_constructors_and_promotion(deg):
    a = _elements(deg, 71, size=16).T  # (N, deg)
    b = _elements(1, 72, size=a.shape[0] - 1)[0][: a.shape[0]]
    ta, tb = TFelt.from_u64s(a, deg), TFelt.from_u64s(b)
    ja, jb = JFelt.from_u64s(a, deg), JFelt.from_u64s(b)
    assert ta.deg == deg and np.array_equal(ta.to_u64s(), a)
    for t, j in ((ta * tb, ja * jb), (tb * ta, jb * ja), (ta + tb, ja + jb),
                 (tb - ta, jb - ja), (ta / (tb + 1), ja / (jb + 1)), (ta ** 5, ja ** 5),
                 (ta * 3 - 2, ja * 3 - 2)):
        assert t.deg == deg
        assert np.array_equal(t.to_u64s(), j.to_u64s())
    v = tuple(int(x) for x in a[-1])
    assert np.array_equal(TFelt.from_int(v, (2,), deg).to_u64s(),
                          JFelt.from_int(v, (2,), deg).to_u64s())
    assert np.array_equal(TFelt.from_int(5, (2,), deg).to_u64s(),
                          JFelt.from_int(5, (2,), deg).to_u64s())


@pytest.mark.parametrize("deg", [2, 3])
def test_rows_to_words_matches_reference(deg):
    rows = _elements(deg, 81, size=32)[:, -32:].reshape(deg, 4, 8)
    want = np.asarray(jconvert.rows_to_words(_j(rows), deg)).astype(np.int64)
    got = convert.rows_to_words(_t(rows), deg).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(convert.limbs_to_elems(_t(rows[:, 0]), deg),
                          jconvert.limbs_to_elems(_j(rows[:, 0]), deg))
    v = tuple(int(x) for x in rows[:, 1, 2])
    assert _u(convert.scalar_to_limbs(v, deg, (3,)), tgl).tolist() == [[c] * 3 for c in v]
    assert tuple(tsc.components(tsc.embed(7, deg))) == (7,) + (0,) * (deg - 1)


@pytest.mark.parametrize("hname,field,deg", [
    ("blake3_256", "f64", 2), ("blake3_256", "f64", 3), ("blake3_192", "f64", 3),
    ("blake3_192", "f128", 2),  # 24-byte digests, 32-byte draws: the short read
])
def test_coin_extension_draws_match_reference(hname, field, deg):
    seed = [3, 1, 4, 1, 5]
    jc = JCoin(jget_hasher(hname), seed, jfs.FIELDS[field])
    tc = TCoin(tget_hasher(hname), seed, tfs.FIELDS[field])
    for k in (1, 20, 3, 40):
        assert tc.draw_many(k, deg) == jc.draw_many(k, deg)
        assert tc.draw(deg) == jc.draw(deg)
    assert tc.counter == jc.counter
