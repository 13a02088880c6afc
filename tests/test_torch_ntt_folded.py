"""PyTorch port, the entry points whose layout moves and scales kernels 3 and
4 took in: ``LimbField.ntt`` (forward, inverse, scaled and unscaled),
``evaluate_poly_with_offset`` and ``interpolate_poly`` of
ops/limb_field.py over f128 and f62, and the f64 ``four_step_ntt`` of
ops/ntt_kernel.py, against the JAX package on the same numpy inputs.  On the
CPU every launch takes the kernels' plain versions (``limb_ntt.tile_plain``,
``ntt_kernel.dit_tile_plain``) with the options the CUDA kernels take: the
bit reversal on the load, strided and interleaved stores, the coset factors,
zero padding and the output scale.  The port's tile cap is lowered to reach
the four-step split (two launches) and, above cap^2, its eager column step
at small sizes.  One case holds the JAX entry on its Pallas kernel in
interpret mode.  Exact arithmetic: tolerance 0."""

import numpy as np
import pytest

from starkpack_winterfell_tpu.ops import gl64 as jgl, ntt as jntt
from starkpack_winterfell_tpu.ops.limb_field import F62 as JF62, F128 as JF128
from starkpack_winterfell_tpu.ops.pallas import limb_kernel

from starkpack_winterfell_tpu_torch.ops import gl64 as tgl, limb_ntt, ntt_kernel as tk
from starkpack_winterfell_tpu_torch.ops.limb_field import F62 as TF62, F128 as TF128
from starkpack_winterfell_tpu_torch.utils.convert import from_limb_planes, to_limb_planes

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

FIELDS = {"f128": (JF128, TF128), "f62": (JF62, TF62)}


def _elems(jf, shape, seed):
    rng = np.random.default_rng(seed)
    flat = [int(v) % jf.P for v in rng.integers(0, 1 << 62, size=int(np.prod(shape)))]
    flat[:3] = [0, 1, jf.P - 1]
    return tuple(l.reshape(shape) for l in jf.from_ints(flat))


def _same(t_planes, j_planes):
    return all(np.array_equal(g, np.asarray(w))
               for g, w in zip(to_limb_planes(t_planes), j_planes))


def _cap(monkeypatch, tf, cap):
    if cap is not None:
        monkeypatch.setattr(tf, "MAX_NTT_TILE", cap)


# (n, tile cap): one tile (the shortest, a longer one); the four-step split (16 x 16 and 16 x 64, its
# second launch within the cap); n above cap^2 (32 x 32 at cap 8: the eager
# column step)
NTT_CASES = [(2, None), (256, None), (256, 16), (1024, 16), (1024, 8)]


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("n,cap", NTT_CASES)
def test_ntt_matches_reference(monkeypatch, field, n, cap):
    jf, tf = FIELDS[field]
    _cap(monkeypatch, tf, cap)
    a = _elems(jf, (2, 3, n), seed=n + (cap or 0))
    ta = from_limb_planes(a)
    for inverse, scale in ((False, True), (True, True), (True, False)):
        want = jf.ntt(a, inverse=inverse, scale=scale)
        assert _same(tf.ntt(ta, inverse=inverse, scale=scale), want), (inverse, scale)


# (n, blowup, tile cap): one coefficient; the LDE in one tile (zero
# padding, offset powers); n in a tile and the LDE above it (the cosets of
# one launch, interleaved); n above the cap (each coset's factors split over
# the four-step rows and columns, interleaved by the second launch)
LDE_CASES = [(1, 1, None), (1, 4, None), (64, 4, None), (512, 8, None), (64, 8, 256),
             (256, 4, 16), (1024, 2, 16)]


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("n,blowup,cap", LDE_CASES)
def test_evaluate_poly_with_offset_matches_reference(monkeypatch, field, n, blowup, cap):
    jf, tf = FIELDS[field]
    _cap(monkeypatch, tf, cap)
    a = _elems(jf, (3, n), seed=7 * n + blowup)
    got = tf.evaluate_poly_with_offset(from_limb_planes(a), 7, blowup)
    assert _same(got, jf.evaluate_poly_with_offset(a, 7, blowup))


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("n,cap", [(512, None), (512, 16)])
def test_interpolate_poly_matches_reference(monkeypatch, field, n, cap):
    """A strided view in (the port reads it through its strides): the
    interpolation of the transposed evaluations."""
    jf, tf = FIELDS[field]
    _cap(monkeypatch, tf, cap)
    a = _elems(jf, (n, 4), seed=n + 3)
    got = tf.interpolate_poly(tuple(l.T for l in from_limb_planes(a)))
    assert _same(got, jf.interpolate_poly(tuple(np.ascontiguousarray(l.T) for l in a)))


def test_entries_make_only_tile_launches_at_the_cpu(monkeypatch):
    """On the CPU the entries run the plain version of the tile and launch
    nothing; the four-step twiddles and coset factors are built once."""
    limb_ntt.reset_launch_counts()
    monkeypatch.setattr(TF128, "MAX_NTT_TILE", 16)
    a = from_limb_planes(_elems(JF128, (2, 256), seed=1))
    calls = []
    real = limb_ntt.tile_plain
    monkeypatch.setattr(limb_ntt, "tile_plain", lambda *args, **kw: calls.append(1) or
                        real(*args, **kw))
    TF128.evaluate_poly_with_offset(a, 7, 4)
    assert len(calls) == 2  # the four-step's two launches, cosets and interleave in them
    TF128.evaluate_poly_with_offset(a, 7, 4)
    assert len(calls) == 4 and limb_ntt.LAUNCHES == 0


@pytest.mark.parametrize("bits,inverse,scale", [(13, False, True), (14, True, False)])
def test_four_step_ntt_matches_reference(bits, inverse, scale):
    """64 x 128 forward and 128 x 128 unscaled inverse: the transposed store
    of the first launch read by the second, the twiddle table in natural row
    order."""
    x = np.random.default_rng(bits).integers(0, tgl.P, size=(2, 1 << bits), dtype=np.uint64)
    want = jntt.ntt_components((jgl.from_u64(x),), inverse, scale=scale)[0]
    got = tk.four_step_ntt((tgl.from_u64(x),), inverse, scale)[0]
    assert np.array_equal(tgl.to_u64(got), jgl.to_u64(want))


@pytest.mark.parametrize("bits,blowup", [(10, 8), (12, 4)])
def test_four_step_coset_lde_matches_reference(bits, blowup):
    """f64 evaluate_poly_with_offset above the tile cap as the CUDA path runs
    it: ``four_step_ntt`` with the offset's row and column factors and the
    zero padding in its first launch."""
    x = np.random.default_rng(bits).integers(0, tgl.P, size=(3, 1 << bits), dtype=np.uint64)
    want = jntt.evaluate_poly_with_offset((jgl.from_u64(x),), 7, blowup)[0]
    got = tk.four_step_ntt((tgl.from_u64(x),), n=blowup << bits, offset=7)[0]
    assert np.array_equal(tgl.to_u64(got), jgl.to_u64(want))


def test_scaled_inverse_matches_the_pallas_kernel(monkeypatch):
    """The JAX entry on its Pallas limb kernel (interpret mode; 1/n an eager
    multiply there) against the port's one launch with the scale word."""
    import jax.numpy as jnp

    monkeypatch.setattr(limb_kernel, "INTERPRET", True)
    monkeypatch.setattr(limb_kernel, "ENABLED", True)
    n, batch = JF62.PALLAS_MIN_N, JF62.PALLAS_MIN_LANES
    a = _elems(JF62, (batch, n), seed=9)
    want = JF62.ntt(tuple(jnp.asarray(l) for l in a), inverse=True, scale=True)
    assert _same(TF62.ntt(from_limb_planes(a), inverse=True, scale=True), want)
