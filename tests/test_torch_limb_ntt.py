"""PyTorch port, limb NTT tile: the plain version of the CUDA kernel
(ops/limb_ntt.py) against the JAX package's Pallas kernel
(ops/pallas/limb_kernel.py) in interpret mode, on the same numpy inputs;
tolerance zero.  The CUDA kernel itself is held against the plain version on
the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from starkpack_winterfell_tpu.ops.limb_field import F62 as JF62, F128 as JF
from starkpack_winterfell_tpu.ops.pallas import limb_kernel

from starkpack_winterfell_tpu_torch.ops import limb_ntt
from starkpack_winterfell_tpu_torch.ops.limb_field import F62 as TF62, F128 as TF
from starkpack_winterfell_tpu_torch.utils.convert import from_limb_planes, to_limb_planes

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setattr(limb_kernel, "INTERPRET", True)
    monkeypatch.setattr(limb_kernel, "ENABLED", True)


def _rand_elems(shape, seed, field=JF):
    rng = np.random.default_rng(seed)
    flat = [int(rng.integers(0, 1 << 62)) % field.P for _ in range(int(np.prod(shape)))]
    return tuple(l.reshape(shape) for l in field.from_ints(flat))


def _same(t_planes, j_planes):
    return all(np.array_equal(g, np.asarray(w))
               for g, w in zip(to_limb_planes(t_planes), j_planes))


@pytest.mark.parametrize("fields", [(JF, TF), (JF62, TF62)], ids=["f128", "f62"])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_plain_version_matches_the_pallas_kernel(inverse, fields):
    import jax.numpy as jnp

    jf, tf = fields
    n, batch = 512, 96
    a = _rand_elems((batch, n), seed=11, field=jf)
    want = limb_kernel.ntt_last_axis(jf, tuple(jnp.asarray(l) for l in a), inverse)
    ta = from_limb_planes(a)
    assert len(ta) == tf.n
    assert _same(limb_ntt.ntt_last_axis_plain(tf, ta, inverse), want)
    # a CPU tensor takes the plain version through the wrapper, and launches nothing
    limb_ntt.reset_launch_counts()
    assert _same(limb_ntt.ntt_last_axis(tf, ta, inverse), want)
    assert limb_ntt.LAUNCHES == 0 and not limb_ntt.LAUNCHES_BY_SHAPE


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_fused_pre_multiply_equals_multiply_then_transform(inverse):
    lead, r, n = 3, 8, 64
    a = from_limb_planes(_rand_elems((lead, r, n), seed=5))
    pre = from_limb_planes(_rand_elems((r, n), seed=6))
    want = limb_ntt.ntt_last_axis_plain(TF, TF.mul(a, pre), inverse)
    got = limb_ntt.ntt_last_axis(TF, a, inverse, pre=pre)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _same(got, JF.ntt(to_limb_planes(TF.mul(a, pre)), inverse=inverse, scale=False))


@pytest.mark.parametrize("n", [2, 4, 2048])
def test_tile_sizes_at_the_edges(n):
    a = _rand_elems((5, n), seed=n)
    got = limb_ntt.ntt_last_axis(TF, from_limb_planes(a), False)
    assert _same(got, JF.ntt(a, inverse=False, scale=False))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a = from_limb_planes(_rand_elems((2, 16), seed=1))
    with pytest.raises(ValueError):
        limb_ntt.ntt_last_axis(TF, tuple(l[:, :12] for l in a), False)
    with pytest.raises(ValueError):
        limb_ntt.ntt_last_axis(TF, a[:1], False)
    with pytest.raises(ValueError):
        limb_ntt.ntt_last_axis(TF, from_limb_planes(_rand_elems((1, 4096), seed=2)), False)
    with pytest.raises(ValueError):
        limb_ntt.ntt_last_axis(TF, a, False, pre=tuple(l[:1] for l in a))


def test_lanes_per_block_fills_at_most_one_tile():
    for field in (TF, TF62):
        for n in (2, 64, 1024, limb_ntt.max_tile(field)):
            for lanes in (1, 3, 64, 100000):
                lg = 1 << limb_ntt._lanes_per_block(field, n, lanes)
                assert n * lg * field.n <= limb_ntt.TILE_WORDS and lg < 2 * max(lanes, 1)
        assert limb_ntt.max_tile(field) == field.MAX_NTT_TILE
    assert (limb_ntt.max_tile(TF), limb_ntt.max_tile(TF62)) == (2048, 4096)
