"""PyTorch port, the limb fields f128 and f62: ops/limb_field.py and
ops/backend.py on int64 word planes against the JAX package's LimbField on
numpy u32 limb planes.  Inputs from a numpy seed; tolerance zero (exact integers)."""

import numpy as np
import pytest
import torch

from starkpack_winterfell_tpu.ops.limb_field import F62 as JF62, F128 as JF
from starkpack_winterfell_tpu.ops.backend import get_backend as j_backend

from starkpack_winterfell_tpu_torch.ops.backend import get_backend
from starkpack_winterfell_tpu_torch.ops.limb_field import F62 as TF62, F128 as TF
from starkpack_winterfell_tpu_torch.utils.convert import from_limb_planes, to_limb_planes

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

P = TF.P
EDGES = [0, 1, 2, P - 1, P - 2, (1 << 64) - 1, 1 << 64, (1 << 64) + 1, 1 << 127,
         P >> 1, TF.DELTA, P - (1 << 64), (1 << 128) - (1 << 64) - 1 - P + P - 1]


def edges62():
    p = TF62.P
    return [0, 1, 2, p - 1, p - 2, 1 << 61, TF62.E, p >> 1, (1 << 32) - 1, 1 << 32]


def test_f62_ops_ntt_and_lde_match():
    """The one-word field: boundaries and random values through every op,
    a tile, a four-step transform and a coset LDE."""
    p = TF62.P
    vals = edges62() + [v % p for v in rand_ints(31, 40)]
    a = [x for x in vals for _ in vals]
    b = [y for _ in vals for y in vals]
    ja, jb = JF62.from_ints(a), JF62.from_ints(b)
    ta, tb = from_limb_planes(ja), from_limb_planes(jb)
    assert len(ta) == 1
    for op in ("add", "sub", "mul"):
        assert same(getattr(TF62, op)(ta, tb), getattr(JF62, op)(ja, jb)), op
    for op in ("square", "neg", "inv"):
        assert same(getattr(TF62, op)(ta), getattr(JF62, op)(ja)), op
    for n, inverse in ((64, False), (4096, True), (8192, False)):
        jx = tuple(l.reshape(2, n) for l in JF62.from_ints([v % p for v in rand_ints(n, 2 * n)]))
        assert same(TF62.ntt(from_limb_planes(jx), inverse=inverse),
                    JF62.ntt(jx, inverse=inverse)), n
    jx = tuple(l.reshape(2, 1024) for l in JF62.from_ints([v % p for v in rand_ints(5, 2048)]))
    assert same(TF62.evaluate_poly_with_offset(from_limb_planes(jx), 3, 8),
                JF62.evaluate_poly_with_offset(jx, 3, 8))


def rand_ints(seed, count):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 1 << 64, size=count, dtype=np.uint64)
    hi = rng.integers(0, 1 << 64, size=count, dtype=np.uint64)
    return [((int(h) << 64) | int(l)) % P for l, h in zip(lo, hi)]


def both(ints, shape):
    """The same elements as JAX-package limb planes and port word planes
    (carried across through utils/convert)."""
    jp = tuple(l.reshape(shape) for l in JF.from_ints(ints))
    return jp, from_limb_planes(jp)


def same(t_planes, j_planes):
    got = to_limb_planes(t_planes)
    return len(got) == len(j_planes) and all(
        np.array_equal(g, np.asarray(w)) for g, w in zip(got, j_planes))


def pairs():
    vals = [e % P for e in EDGES] + rand_ints(1, 40)
    return [a for a in vals for _ in vals], [b for _ in vals for b in vals]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_at_boundaries_and_random_values(op):
    a, b = pairs()
    ja, ta = both(a, (len(a),))
    jb, tb = both(b, (len(b),))
    assert same(getattr(TF, op)(ta, tb), getattr(JF, op)(ja, jb))
    ref = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
           "mul": lambda x, y: x * y % P}[op]
    assert TF.to_ints(getattr(TF, op)(ta, tb)) == [ref(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("op", ["square", "neg", "inv"])
def test_unary_ops_match(op):
    vals = [e % P for e in EDGES] + rand_ints(2, 50)
    jv, tv = both(vals, (len(vals),))
    assert same(getattr(TF, op)(tv), getattr(JF, op)(jv))


def test_limb_plane_bridge_round_trips():
    vals = rand_ints(3, 24)
    jv, tv = both(vals, (4, 6))
    assert TF.to_ints(tv) == vals and same(tv, jv)
    assert all(t.dtype == torch.int64 for t in tv)


@pytest.mark.parametrize("n,inverse", [(8, False), (256, True), (2048, False),
                                       (4096, False), (8192, True)])
def test_ntt_matches(n, inverse):
    """n <= 2048 is one tile; 4096 and 8192 take the port's four-step split
    (the JAX package splits elsewhere: values are held, not schedules)."""
    ja, ta = both(rand_ints(n, 3 * n), (3, n))
    assert same(TF.ntt(ta, inverse=inverse), JF.ntt(ja, inverse=inverse))


@pytest.mark.parametrize("n,blowup", [(64, 8), (512, 8), (2048, 2)])
def test_evaluate_poly_with_offset_matches(n, blowup):
    """64 x 8 is the zero-pad path, the others the coset path (with and
    without the four-step split of the cosets)."""
    ja, ta = both(rand_ints(7 * n, 2 * n), (2, n))
    assert same(TF.evaluate_poly_with_offset(ta, 3, blowup),
                JF.evaluate_poly_with_offset(ja, 3, blowup))


def test_interpolate_with_offset_inverts_the_coset_evaluation():
    n = 4096
    ja, ta = both(rand_ints(11, n), (n,))
    assert same(TF.interpolate_poly_with_offset(ta, 3),
                JF.interpolate_poly_with_offset(ja, 3))
    ev = TF.evaluate_poly_with_offset(ta, 3, 1)
    assert same(TF.interpolate_poly_with_offset(ev, 3), ja)


def test_apply_drp_matches():
    m, N = 64, 4
    ja, ta = both(rand_ints(13, m * N), (m, N))
    alpha = rand_ints(14, 1)[0]
    assert same(TF.apply_drp(ta, 3, alpha), JF.apply_drp(ja, 3, alpha))


def test_backend_batch_inverse_power_series_and_words():
    TB, JB = get_backend("f128"), j_backend("f128")
    vals = rand_ints(15, 64)
    vals[5] = 0  # zero stays zero
    jv, tv = both(vals, (2, 32))
    assert TF.to_ints(TB.b_batch_inv(tv)) == [pow(v, P - 2, P) for v in vals]
    x = rand_ints(16, 1)[0]
    assert same(TB.power_series(x, 100), JB.power_series(x, 100))
    want_words = np.asarray(JB.rows_to_words((jv,), 1))
    got_words = TB.rows_to_words((tv,), 1).numpy()
    assert np.array_equal(got_words, want_words.astype(np.int64))
    assert same(TB.vsum((tv,), axis=-1)[0], JB.vsum((jv,), axis=-1)[0])
    poly = rand_ints(17, 1024)
    _, tp = both(poly, (1024,))
    assert TB.eval_base_poly_at(tp, x) == sum(c * pow(x, i, P) for i, c in enumerate(poly)) % P
