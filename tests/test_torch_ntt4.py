"""PyTorch port, NTT: ops/ntt.py and ops/ntt4.py (the module that holds the
CUDA tile kernel) of starkpack_winterfell_tpu_torch against the JAX package.

On the CPU the wrapper ``ntt_tile`` takes the kernel's plain version, which
is held here against the Pallas kernel run in interpret mode, and against
the numpy radix-2 NTT.  The pipelines are compared with the JAX functions at
n = 2^14, blowup 8, at their boundaries: LDE rows, permuted coefficients,
composition columns and OOD dot products.  Exact arithmetic: tolerance 0."""

import numpy as np
import pytest
import torch

from starkpack_winterfell_tpu.ops import gl64 as jgl, ntt as jntt
from starkpack_winterfell_tpu.ops.pallas import ntt4 as jntt4
from starkpack_winterfell_tpu.ops.pallas.ntt_kernel import _per_position_twiddles

from starkpack_winterfell_tpu_torch.ops import gl64 as tgl, ntt as tntt, ntt4 as tntt4, vec as tvec
from starkpack_winterfell_tpu_torch.utils.convert import from_limb_pairs, to_limb_pairs

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

P = tgl.P
N, BLOWUP, OFFSET = 1 << 14, 8, 7
L = N * BLOWUP


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _jpair(x):
    import jax.numpy as jnp

    return tuple(jnp.asarray(v) for v in jgl.from_u64(x))


def _ju64(pair):
    return jgl.to_u64((np.asarray(pair[0]), np.asarray(pair[1])))


# ---------------------------------------------------------------------------
# the tile transform
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dif", [True, False], ids=["dif", "dit"])
@pytest.mark.parametrize("epilogue", [True, False], ids=["epilogue", "plain"])
def test_tile_plain_matches_pallas_interpret(dif, epilogue):
    """One small tile shape per variant: the plain version of the CUDA
    kernel against the Pallas kernel it replaces (interpret mode)."""
    B, n, lanes = 2, 16, 128
    x = _rand((B, n, lanes), 1)
    ep = _rand((n, lanes), 2)

    call = jntt4._build_call(B, n, lanes, dif, epilogue, True)
    tw = _per_position_twiddles(n, dif)  # DIF tiles use the inverse root
    args = [tw[0], tw[1]]
    if epilogue:
        args += list(jgl.from_u64(ep))
    args += list(jgl.from_u64(x))
    want = _ju64(call(*args))

    got = tntt4.ntt_tile(
        tgl.from_u64(x), tntt4.tile_twiddles(n, dif, "cpu"), dif,
        tgl.from_u64(ep) if epilogue else None,
    )
    assert np.array_equal(tgl.to_u64(got), want)


@pytest.mark.parametrize("n", [2, 8, 256])
def test_tile_plain_matches_radix2_ntt(n):
    """DIF (inverse root) then bit-reversal == the unscaled inverse NTT;
    bit-reversal then DIT (forward root) == the forward NTT."""
    B, lanes = 3, 5
    x = _rand((B, n, lanes), 3)
    rev = jntt._bit_rev_perm(n)
    cols = jgl.from_u64(np.ascontiguousarray(np.moveaxis(x, 1, -1)))  # (B, lanes, n)

    want_inv = jgl.to_u64(jntt.ntt_components((cols,), inverse=True, scale=False)[0])
    got = tntt4.ntt_tile(tgl.from_u64(x), tntt4.tile_twiddles(n, True, "cpu"), True)
    assert np.array_equal(np.moveaxis(tgl.to_u64(got)[:, rev, :], 1, -1), want_inv)

    want_fwd = jgl.to_u64(jntt.ntt_components((cols,), inverse=False)[0])
    got = tntt4.ntt_tile(
        tgl.from_u64(np.ascontiguousarray(x[:, rev, :])),
        tntt4.tile_twiddles(n, False, "cpu"), False,
    )
    assert np.array_equal(np.moveaxis(tgl.to_u64(got), 1, -1), want_fwd)


def test_tile_wrapper_checks_its_arguments():
    x = tgl.zeros((2, 8, 4))
    tw = tntt4.tile_twiddles(8, True, "cpu")
    with pytest.raises(ValueError):
        tntt4.ntt_tile(x[0], tw, True)  # not (B, n, lanes)
    with pytest.raises(ValueError):
        tntt4.ntt_tile(tgl.zeros((2, 6, 4)), tw, True)  # n not a power of two
    with pytest.raises(TypeError):
        tntt4.ntt_tile(x.to(torch.int32), tw, True)
    with pytest.raises(ValueError):
        tntt4.ntt_tile(x, tw[:2], True)  # twiddle table too short
    with pytest.raises(ValueError):
        tntt4.ntt_tile(x, tw, True, tgl.zeros((8, 3)))  # epilogue shape
    with pytest.raises(ValueError):
        tntt4.ntt_tile(tgl.zeros((2, 2, 4)), tw, True, interleave=4)  # DIF interleave
    with pytest.raises(ValueError):
        tntt4.ntt_tile(tgl.zeros((2, 2, 4)), tw, False, interleave=3)  # not a power of two
    with pytest.raises(ValueError):
        tntt4.ntt_tile(tgl.zeros((2, 1, 4)), tw, False, interleave=8)  # nothing left to stage
    with pytest.raises(ValueError):
        tntt4.ntt_tile(tgl.zeros((2, 2, 4)), tw, False, interleave=4, pre=tgl.zeros((8, 4)))
    assert tntt4.LAUNCHES == 0 and not tntt4.LAUNCHES_BY_SHAPE  # the CPU path launches no kernel


@pytest.mark.parametrize("option", ["transposed", "interleave", "pre"])
@pytest.mark.parametrize("n", [2, 16, 256])
def test_tile_options_match_the_copies_they_replace(n, option):
    """Each layout option of the tile kernel's plain version equals the old
    plain stages with the copy it folds in done explicitly: a transpose after
    the stages, a zero buffer holding row r at row r*f before them, a
    multiply before them."""
    B, lanes = 2, 5
    f = min(8, n // 2)
    for dif in ([True, False] if option != "interleave" else [False]):
        tw = tntt4.tile_twiddles(n, dif, "cpu")
        ep = tgl.from_u64(_rand((n, lanes), 21))
        if option == "transposed":
            x = tgl.from_u64(_rand((B, n, lanes), 22))
            got = tntt4.ntt_tile(x, tw, dif, ep, transposed=True)
            want = tntt4.ntt_tile_plain(x, tw, dif, ep).transpose(1, 2)
        elif option == "interleave":
            x = tgl.from_u64(_rand((B, n // f, lanes), 23))
            z = torch.zeros((B, n // f, f, lanes), dtype=torch.int64)
            z[:, :, 0] = x
            got = tntt4.ntt_tile(x, tw, dif, ep, interleave=f, transposed=True)
            want = tntt4.ntt_tile_plain(z.reshape(B, n, lanes), tw, dif, ep).transpose(1, 2)
        else:
            x = tgl.from_u64(_rand((B, n, lanes), 24))
            pre = tgl.from_u64(_rand((n, lanes), 25))
            got = tntt4.ntt_tile(x, tw, dif, ep, pre=pre)
            want = tntt4.ntt_tile_plain(tgl.mul(x, pre.unsqueeze(0)), tw, dif, ep)
        assert got.is_contiguous() and torch.equal(got, want)


# ---------------------------------------------------------------------------
# ops/ntt.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 1024])
def test_radix2_ntt_matches_reference(n):
    x = _rand((2, n), 4)
    jx, tx = (jgl.from_u64(x),), (tgl.from_u64(x),)
    pairs = [
        (jntt.interpolate_poly(jx), tntt.interpolate_poly(tx)),
        (jntt.evaluate_poly(jx), tntt.evaluate_poly(tx)),
        (jntt.interpolate_poly_with_offset(jx, OFFSET),
         tntt.interpolate_poly_with_offset(tx, OFFSET)),
        (jntt.evaluate_poly_with_offset(jx, OFFSET, BLOWUP),
         tntt.evaluate_poly_with_offset(tx, OFFSET, BLOWUP)),
    ]
    for want, got in pairs:
        assert np.array_equal(tgl.to_u64(got[0]), jgl.to_u64(want[0]))
    assert np.array_equal(
        tgl.to_u64(tntt.power_series(OFFSET, n)), jgl.to_u64(jntt.power_series(OFFSET, n))
    )


# ---------------------------------------------------------------------------
# the four-step pipelines at n = 2^14
# ---------------------------------------------------------------------------


def test_pick_factors_and_supported_match_reference():
    for n, big in [(1 << 14, 1 << 17), (1 << 16, 1 << 19), (1 << 20, 1 << 23),
                   (1 << 23, 1 << 23), (1 << 10, 1 << 13), (1 << 22, 1 << 25)]:
        assert tntt4.supported(n, big) == jntt4.supported(n, big)
        if jntt4.supported(n, big):
            assert tntt4._pick_factors(n, big) == jntt4._pick_factors(n, big)


def test_interpolate_lde_matches_reference():
    """LDE rows and the permuted offset^j-scaled coefficients (the OOD-side
    intermediates) equal the JAX package's, word for word."""
    x = _rand((1, N), 5)  # batch 1 throughout: the Pallas tiles compile once
    want_lde, want_pc = jntt4.interpolate_lde(
        (_jpair(x),), BLOWUP, OFFSET, interpret=True, return_permuted=True
    )
    got_lde, got_pc = tntt4.interpolate_lde(
        (tgl.from_u64(x),), BLOWUP, OFFSET, return_permuted=True
    )
    assert np.array_equal(tgl.to_u64(got_lde[0]), _ju64(want_lde[0]))
    assert np.array_equal(tgl.to_u64(got_pc[0]), _ju64(want_pc[0]))
    # and the radix-2 oracle of the port itself
    coeffs = tntt.interpolate_poly((tgl.from_u64(x),))
    oracle = tntt.evaluate_poly_with_offset(coeffs, OFFSET, BLOWUP)[0]
    assert torch.equal(got_lde[0], oracle)


def test_composition_chain_matches_reference():
    """intt_permuted -> slice_columns_permuted -> lde_from_permuted, and the
    permuted OOD dot product, against the JAX functions at the boundaries:
    permuted coefficients, composition columns c[k*tl + t] -> column k, the
    column LDE and H(z)."""
    num_cols = 4
    x = _rand((1, N), 6)
    jpc = jntt4.intt_permuted((_jpair(x),), OFFSET, L, interpret=True)
    tpc = tntt4.intt_permuted((tgl.from_u64(x),), OFFSET, L)
    assert np.array_equal(tgl.to_u64(tpc[0]), _ju64(jpc[0]))

    jcols = jntt4.slice_columns_permuted(jpc, num_cols, keep=3)
    tcols = tntt4.slice_columns_permuted(tpc, num_cols, keep=3)
    assert len(tcols) == len(jcols) == 3
    for jc, tc in zip(jcols, tcols):
        assert np.array_equal(tgl.to_u64(tc[0]), _ju64(jc[0]))

    # the column LDE, for column k = 2 (one column keeps the batch at 1)
    k = 2
    jstacked = ((jcols[k][0][0], jcols[k][0][1]),)
    tstacked = (tcols[k][0],)
    want = jntt4.lde_from_permuted(jstacked, L, OFFSET, interpret=True)
    got = tntt4.lde_from_permuted(tstacked, L, OFFSET)
    assert np.array_equal(tgl.to_u64(got[0]), _ju64(want[0]))

    # column k holds the coefficients c[k*tl + t]: its LDE equals the
    # radix-2 evaluation of that coefficient slice
    tl = N // num_cols
    coeffs = tntt.interpolate_poly_with_offset((tgl.from_u64(x[0]),), OFFSET)[0]
    oracle = tntt.evaluate_poly_with_offset(
        (coeffs.reshape(num_cols, tl)[k : k + 1],), OFFSET, L // tl
    )[0]
    assert torch.equal(got[0], oracle)


def test_permuted_power_series_and_ood_dot_match_reference():
    z = 0x0123456789ABCDEF % P
    a, b, _ = tntt4._pick_factors(N, L)
    jz = (tuple(np.asarray(v) for v in jgl.from_int(z, (1,))),)
    tz = (tgl.from_int(z, (1,)),)
    want = jntt4.permuted_power_series(jz, N, a, b)
    got = tntt4.permuted_power_series(tz, N, a, b)
    assert np.array_equal(tgl.to_u64(got[0]), _ju64(want[0]))

    # dot product of permuted coefficients with the permuted series == P(z)
    x = _rand((N,), 7)
    pc = tntt4.intt_permuted((tgl.from_u64(x),), OFFSET, L)
    dot = tvec.vsum(tvec.vsum(tvec.vmul(pc, got), axis=-1), axis=-1)
    coeffs = tgl.to_u64(tntt.interpolate_poly_with_offset((tgl.from_u64(x),), OFFSET)[0])
    acc = 0
    for c in coeffs[::-1]:
        acc = (acc * z + int(c)) % P
    assert int(tgl.to_u64(dot[0])) == acc
    lo, hi = to_limb_pairs(got[0])
    assert torch.equal(from_limb_pairs((lo, hi)), got[0])
