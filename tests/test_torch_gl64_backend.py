"""PyTorch port, the Goldilocks field backend: ops/backend.py ``GL64Backend``
(one int64 word a component) against the JAX package's ``GL64Backend`` (u32
limb pairs) on numpy arrays, at degrees 1, 2 and 3 — base and extension
operations, the batch inverse with zeros, the NTT entry points,
``syn_div_binomial``, ``power_series_elem``, the prefix products the perm
model builds its aux column with, and ``rows_to_words``; and
air/boundary.py ``_interpolate_subgroup`` on extension values.

Same inputs on both sides (numpy, fixed seed, carried across as python ints,
plus every combination of the edge words 0, 1 and p - 1); the arithmetic is
exact, so the tolerance is zero."""

import numpy as np
import pytest
import torch

from starkpack_winterfell_tpu.air import boundary as j_boundary
from starkpack_winterfell_tpu.math.fieldspec import GL64_SPEC as J_SPEC
from starkpack_winterfell_tpu.ops.backend import get_backend as j_backend

from starkpack_winterfell_tpu_torch.air import boundary as t_boundary
from starkpack_winterfell_tpu_torch.math.fieldspec import GL64_SPEC as T_SPEC
from starkpack_winterfell_tpu_torch.ops.backend import GL64Backend, get_backend as t_backend

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

JB, TB = j_backend("f64"), t_backend("f64")
P = TB.P
DEGS = [1, 2, 3]


def _elements(deg, seed, size=200):
    """Every combination of the edge words in each component, then
    ``size`` random elements: ints at degree 1, tuples above."""
    edges = [0, 1, P - 1]
    grid = np.array(np.meshgrid(*([edges] * deg), indexing="ij"),
                    dtype=object).reshape(deg, -1).T
    rnd = np.random.default_rng(seed).integers(0, P, size=(size, deg), dtype=np.uint64)
    rows = [tuple(int(v) for v in r) for r in list(grid) + list(rnd)]
    return [r[0] for r in rows] if deg == 1 else rows


def _both(elems, deg, shape=None):
    """The same elements in the JAX package and the port, reshaped."""
    j = JB.elems_to_limbs(elems, deg)
    t = TB.elems_to_limbs(elems, deg, "cpu")
    if shape is not None:
        j = JB.emap(lambda l: np.asarray(l).reshape(shape), j)
        t = TB.emap(lambda l: l.reshape(shape), t)
    return j, t


def _same(j_comps, t_comps):
    deg = len(t_comps)
    want = JB.limbs_to_elems(JB.emap(lambda l: np.asarray(l).reshape(-1), j_comps), deg)
    got = TB.limbs_to_elems(TB.emap(lambda l: l.reshape(-1), t_comps), deg)
    return got == want


def test_get_backend_returns_the_goldilocks_backend():
    assert isinstance(TB, GL64Backend) and TB.name == "f64" and TB.ELEMENT_BYTES == 8
    assert TB.P == J_SPEC.P == T_SPEC.P


@pytest.mark.parametrize("deg", DEGS)
def test_field_operations_match_the_jax_backend(deg):
    """vadd, vsub, vneg, vmul (element x element and element x base),
    vsquare and vinv — zeros included, which invert to zero — and the
    conversions both ways."""
    a, b = _elements(deg, 1), _elements(deg, 2)[::-1]
    base = _elements(1, 3, size=len(a))[: len(a)]
    (ja, ta), (jb, tb), (jc, tc) = _both(a, deg), _both(b, deg), _both(base, 1)
    assert TB.limbs_to_elems(ta, deg) == a
    assert _same(JB.vadd(ja, jb), TB.vadd(ta, tb))
    assert _same(JB.vsub(ja, jb), TB.vsub(ta, tb))
    assert _same(JB.vneg(ja), TB.vneg(ta))
    assert _same(JB.vmul(ja, jb), TB.vmul(ta, tb))
    assert _same(JB.vmul(ja, jc), TB.vmul(ta, tc))
    assert _same(JB.vsquare(ja), TB.vsquare(ta))
    got = TB.vinv(ta)
    assert _same(JB.vinv(ja), got)
    zero = tuple(0 for _ in range(deg)) if deg > 1 else 0
    assert TB.limbs_to_elems(got, deg)[0] == zero  # the first grid element is 0


def test_batch_inverse_with_zeros_matches_the_jax_backend():
    """The product-tree batch inversion along the last axis of a (4, 256)
    array with zeros scattered in it; a length that is not a power of two
    takes the Fermat ladder."""
    vals = _elements(1, 4, size=1024 - 3)
    vals[5] = vals[700] = 0
    j, t = _both(vals, 1, (4, 256))
    assert _same((JB.b_batch_inv(j[0]),), (TB.b_batch_inv(t[0]),))
    j3, t3 = _both(vals[:3 * 300], 1, (3, 300))
    assert _same((JB.b_batch_inv(j3[0]),), (TB.b_batch_inv(t3[0]),))


@pytest.mark.parametrize("deg", DEGS)
def test_ntt_entry_points_match_the_jax_backend(deg):
    """interpolate_poly, evaluate_poly_with_offset (a coset and the plain
    transform), interpolate_poly_with_offset and power_series on 3 rows of
    64 points."""
    j, t = _both(_elements(deg, 5)[:192], deg, (3, 64))
    assert _same(JB.interpolate_poly(j), TB.interpolate_poly(t))
    assert _same(JB.evaluate_poly_with_offset(j, 7, 8), TB.evaluate_poly_with_offset(t, 7, 8))
    assert _same(JB.evaluate_poly_with_offset(j, 1, 1), TB.evaluate_poly_with_offset(t, 1, 1))
    assert _same(JB.interpolate_poly_with_offset(j, 7), TB.interpolate_poly_with_offset(t, 7))
    assert _same((JB.power_series(123456789, 100),), (TB.power_series(123456789, 100),))


@pytest.mark.parametrize("deg", DEGS)
def test_series_and_division_match_the_jax_backend(deg):
    """power_series_elem of an extension point, syn_div_binomial of 3 rows
    by (x - z), and at degree 1 also of 2 rows of 4096 (the length from
    which the JAX backend takes its native host pass)."""
    z = _elements(deg, 6)[-1]
    jz, tz = (JB.scalar_to_limbs(z, deg), TB.scalar_to_limbs(z, deg))
    assert _same(JB.power_series_elem(jz, 300), TB.power_series_elem(tz, 300))
    j, t = _both(_elements(deg, 7)[:3 * 64], deg, (3, 64))
    assert _same(JB.syn_div_binomial(j, jz), TB.syn_div_binomial(t, tz))
    if deg == 1:
        vals = _elements(1, 8, size=8192 - 3)
        j, t = _both(vals, 1, (2, 4096))
        assert _same(JB.syn_div_binomial(j, jz), TB.syn_div_binomial(t, tz))


@pytest.mark.parametrize("deg", DEGS)
def test_prefix_products_are_the_running_product(deg):
    """``prefix_products`` (log-depth scan) against the running product of
    the JAX backend's multiply, element by element, along the last axis of
    a (2, 37) array."""
    elems = _elements(deg, 9)[: 2 * 37]
    j, t = _both(elems, deg, (2, 37))
    got = TB.limbs_to_elems(TB.emap(lambda l: l.reshape(-1), TB.prefix_products(t)), deg)
    want = []
    for row in range(2):
        acc = JB.emap(lambda l: np.asarray(l)[row, :1], j)
        want += JB.limbs_to_elems(acc, deg)
        for i in range(1, 37):
            acc = JB.vmul(acc, JB.emap(lambda l: np.asarray(l)[row, i : i + 1], j))
            want += JB.limbs_to_elems(acc, deg)
    assert got == want


@pytest.mark.parametrize("deg", DEGS)
def test_rows_to_words_matches_the_jax_backend(deg):
    """The hash-word layout of (rows, width) extension rows: per element its
    components in order, each as two little-endian u32 words."""
    j, t = _both(_elements(deg, 10)[:5 * 7], deg, (5, 7))
    want = np.asarray(JB.rows_to_words(j, deg)).astype(np.int64)
    got = TB.rows_to_words(t, deg)
    assert got.shape == want.shape and torch.equal(got, torch.from_numpy(want))


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("deg", [2, 3])
def test_interpolate_subgroup_takes_extension_values(n, deg):
    """Sequence (and single) assertion values in the extension interpolate
    to the JAX package's coefficients, component by component."""
    values = _elements(deg, 11 + n)[-n:]
    want = j_boundary._interpolate_subgroup(values, J_SPEC)
    got = t_boundary._interpolate_subgroup(values, T_SPEC)
    assert got == [tuple(int(c) for c in v) for v in want]
