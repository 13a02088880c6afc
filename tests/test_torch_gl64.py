"""PyTorch port, field core: ops/gl64.py, ops/vec.py and ops/felt.py of
starkpack_winterfell_tpu_torch against the JAX package's numpy paths.

Same inputs on both sides (numpy, fixed seed, plus the edge words 0, 1,
2^32-1, 2^32, P-1); the arithmetic is exact, so the tolerance is zero."""

import numpy as np
import pytest
import torch

from starkpack_winterfell_tpu.air.transition import EvaluationFrame as JFrame
from starkpack_winterfell_tpu.models import rescue_chain as jrc
from starkpack_winterfell_tpu.ops import gl64 as jgl, vec as jvec
from starkpack_winterfell_tpu.ops.felt import Felt as JFelt

from starkpack_winterfell_tpu_torch.air.transition import EvaluationFrame as TFrame
from starkpack_winterfell_tpu_torch.models import rescue_chain as trc
from starkpack_winterfell_tpu_torch.ops import gl64 as tgl, vec as tvec
from starkpack_winterfell_tpu_torch.ops.backend import get_backend
from starkpack_winterfell_tpu_torch.ops.felt import Felt as TFelt
from starkpack_winterfell_tpu_torch.utils import convert

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

P = tgl.P
EDGES = np.array([0, 1, (1 << 32) - 1, 1 << 32, P - 1, P - 2, (1 << 63), 7],
                 dtype=np.uint64)


def _operands(seed):
    rng = np.random.default_rng(seed)
    rnd = rng.integers(0, P, size=2048, dtype=np.uint64)
    a = np.concatenate([np.repeat(EDGES, len(EDGES)), rnd])
    b = np.concatenate([np.tile(EDGES, len(EDGES)), rnd[::-1]])
    return a, b


def _j(a):
    return jgl.from_u64(a)


def _t(a):
    return tgl.from_u64(a)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_reference(op):
    a, b = _operands(1)
    want = jgl.to_u64(getattr(jgl, op)(_j(a), _j(b)))
    got = tgl.to_u64(getattr(tgl, op)(_t(a), _t(b)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("op", ["neg", "square", "double", "exp7", "inv"])
def test_unary_ops_match_reference(op):
    a, _ = _operands(2)
    want = jgl.to_u64(getattr(jgl, op)(_j(a)))
    got = tgl.to_u64(getattr(tgl, op)(_t(a)))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("e", [0, 1, 2, 7, 65537, P - 2])
def test_exp_int_matches_python_pow(e):
    a, _ = _operands(3)
    a = a[:200]
    got = tgl.to_u64(tgl.exp_int(_t(a), e))
    want = np.array([pow(int(v), e, P) for v in a], dtype=np.uint64)
    assert np.array_equal(got, want)


def test_results_are_canonical_and_roots_agree():
    a, b = _operands(4)
    for op in (tgl.add, tgl.sub, tgl.mul):
        assert (tgl.to_u64(op(_t(a), _t(b))) < np.uint64(P)).all()
    for log_n in (1, 3, 14, 23, 32):
        assert tgl.get_root_of_unity(log_n) == jgl.get_root_of_unity(log_n)


def test_limb_pair_bridge_round_trips():
    a, _ = _operands(5)
    pair = jgl.from_u64(a)
    t = convert.from_limb_pairs(pair)
    assert np.array_equal(tgl.to_u64(t), a)
    lo, hi = convert.to_limb_pairs(t)
    assert np.array_equal(lo, pair[0]) and np.array_equal(hi, pair[1])
    ext = convert.ext_from_limb_pairs((pair, pair))
    back = convert.ext_to_limb_pairs(ext)
    assert len(back) == 2 and np.array_equal(back[1][1], pair[1])


def test_vec_helpers_match_reference():
    rng = np.random.default_rng(6)
    a = rng.integers(0, P, size=(3, 5, 37), dtype=np.uint64)
    b = rng.integers(0, P, size=(3, 5, 37), dtype=np.uint64)
    ja, jb, ta, tb = (_j(a),), (_j(b),), (_t(a),), (_t(b),)
    for name in ("vadd", "vsub", "vmul"):
        want = jgl.to_u64(getattr(jvec, name)(ja, jb)[0])
        got = tgl.to_u64(getattr(tvec, name)(ta, tb)[0])
        assert np.array_equal(got, want), name
    for axis in (-1, 0, 1):
        want = jgl.to_u64(jvec.vsum(ja, axis=axis)[0])
        got = tgl.to_u64(tvec.vsum(ta, axis=axis)[0])
        assert np.array_equal(got, want), axis
    assert np.array_equal(tgl.to_u64(tvec.vinv(ta)[0]), jgl.to_u64(jvec.vinv(ja)[0]))
    assert np.array_equal(
        tgl.to_u64(tvec.promote(ta, 1)[0]), jgl.to_u64(jvec.promote(ja, 1)[0])
    )
    assert not tgl.to_u64(tvec.vzeros((4, 2))[0]).any()


@pytest.mark.parametrize("n", [1, 5, 64, 1000])
def test_power_series_elem_matches_reference(n):
    x = np.array([0x123456789ABCDEF1 % P], dtype=np.uint64)
    want = jgl.to_u64(jvec.power_series_elem((_j(x),), n)[0])
    got = tgl.to_u64(tvec.power_series_elem((_t(x),), n)[0])
    assert np.array_equal(got, want)


def test_vec_refuses_unported_extension_degrees():
    """Goldilocks takes degrees 2 and 3 (tests/test_torch_gl64_ext.py), the
    limb fields degree 2 (tests/test_torch_limb_ext.py); f128 refuses degree
    3, which the reference does not have."""
    a = (tgl.zeros((2,)), tgl.zeros((2,)))
    assert len(tvec.vmul(a, a)) == len(tvec.vinv(a)) == 2
    B = get_backend("f128")
    b = (B.b_from_int(0, (2,), "cpu"),) * 2
    assert len(B.vmul(b, b)) == len(B.vinv(b)) == 2
    c = (B.b_from_int(1, (2,), "cpu"),) * 3
    with pytest.raises(AssertionError, match="no cubic extension"):
        B.vmul(c, c)
    with pytest.raises(AssertionError, match="no cubic extension"):
        B.vsquare(c)


def test_rescue_transition_matches_reference_felt():
    """RescueChainAir.evaluate_transition over a 2^10-row frame: the port's
    tensor Felt against the JAX package's numpy Felt, same AIR code."""
    rng = np.random.default_rng(7)
    rows, w = 1 << 10, 12
    cur = rng.integers(0, P, size=(w, rows), dtype=np.uint64)
    nxt = rng.integers(0, P, size=(w, rows), dtype=np.uint64)
    periodic = rng.integers(0, P, size=(25, rows), dtype=np.uint64)
    periodic[0] = rng.integers(0, 2, size=rows)  # the round/copy flag

    def run(mod, felt, frame_cls):
        air = object.__new__(mod.RescueChainAir)  # evaluate_transition is stateless
        frame = frame_cls([felt.from_u64s(c) for c in cur],
                          [felt.from_u64s(c) for c in nxt])
        result = [None] * w
        air.evaluate_transition(frame, [felt.from_u64s(p) for p in periodic], result)
        return np.stack([r.to_u64s() for r in result])

    assert np.array_equal(run(trc, TFelt, TFrame), run(jrc, JFelt, JFrame))
