"""PyTorch port, the DIT NTT kernels: ops/ntt_kernel.py of
starkpack_winterfell_tpu_torch against ops/pallas/ntt_kernel.py of the JAX
package.

On the CPU the wrappers ``ntt_last`` / ``dit_axis1`` take the kernels' plain
versions, which are held here against the Pallas kernels they replace, run in
interpret mode on the same rows (``ntt_last`` reads natural-order rows along
the last axis, the Pallas axis-0 kernel bit-reversed rows along axis 0); the
entry points are held against the JAX entry points (interpret mode) and
against the numpy radix-2 NTT, ``ntt_last_plain`` also against the port's
own radix-2 stages.  Exact arithmetic: tolerance 0."""

import numpy as np
import pytest
import torch

from starkpack_winterfell_tpu.ops import gl64 as jgl, ntt as jntt
from starkpack_winterfell_tpu.ops.pallas import ntt_kernel as jk

from starkpack_winterfell_tpu_torch.ops import gl64 as tgl, ntt as tntt, ntt_kernel as tk
from starkpack_winterfell_tpu_torch.ops.ntt4 import tile_twiddles
from starkpack_winterfell_tpu_torch.prover import device_big

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

P = tgl.P
# (n, lanes, inverse): n = 4, 64, 1024 with 3 and 130 lanes, forward and
# inverse; the full cross at n = 64, one large case (a Pallas kernel in
# interpret mode takes ~10 s to compile at n = 1024)
CASES = [(4, 3, False), (4, 130, True),
         (64, 3, False), (64, 3, True), (64, 130, False), (64, 130, True),
         (1024, 130, True)]


@pytest.fixture(autouse=True, scope="module")
def _interpret_mode():
    jk.INTERPRET = True
    jk._build_call.cache_clear()
    yield
    jk.INTERPRET = False
    jk._build_call.cache_clear()


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _jpair(x):
    import jax.numpy as jnp

    return tuple(jnp.asarray(v) for v in jgl.from_u64(x))


def _ju64(pair):
    return jgl.to_u64((np.asarray(pair[0]), np.asarray(pair[1])))


def _pad_lanes(x):
    """Zero-pad the last axis to the Pallas kernels' 128-lane blocks."""
    pad = (-x.shape[-1]) % jk.LANES
    return np.concatenate([x, np.zeros(x.shape[:-1] + (pad,), dtype=x.dtype)], axis=-1)


# ---------------------------------------------------------------------------
# the kernel-level functions against the Pallas kernel bodies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,lanes,inverse", CASES)
def test_dit_axis0_plain_matches_pallas_interpret(n, lanes, inverse):
    """The Pallas axis-0 kernel on bit-reversed rows x (n, lanes) against
    ``ntt_last`` on the same numbers laid out as the port's callers hold
    them: one natural-order row per lane."""
    x = _rand((n, lanes), 11)
    xp = _pad_lanes(x)
    tw = jk._per_position_twiddles(n, inverse)
    call = jk._build_call(n, xp.shape[1], inverse, True)
    want = _ju64(call(tw[0], tw[1], *jgl.from_u64(xp)))[:, :lanes]
    natural = np.ascontiguousarray(x[jntt._bit_rev_perm(n)].T)  # (lanes, n)
    got = tk.ntt_last(tgl.from_u64(natural), tile_twiddles(n, inverse, "cpu"))
    assert np.array_equal(tgl.to_u64(got).T, want)


@pytest.mark.parametrize("n,lanes,inverse,pre", [
    (4, 3, True, True), (4, 130, False, False), (64, 130, False, True),
    (64, 3, True, False), (1024, 3, False, True),
])
def test_dit_axis1_plain_matches_pallas_interpret(n, lanes, inverse, pre):
    B = 2
    x = _rand((B, n, lanes), 12)
    table = _rand((n, lanes), 13)
    xp, tp = _pad_lanes(x), _pad_lanes(table)
    tw = jk._per_position_twiddles(n, inverse)
    call = jk._build_call3(B, n, xp.shape[2], pre, True)
    args = [tw[0], tw[1]] + (list(jgl.from_u64(tp)) if pre else []) + list(jgl.from_u64(xp))
    want = _ju64(call(*args))[:, :, :lanes]
    got = tk.dit_axis1(tgl.from_u64(x), tile_twiddles(n, inverse, "cpu"),
                       tgl.from_u64(table) if pre else None)
    assert np.array_equal(tgl.to_u64(got), want)


def test_wrappers_check_their_arguments():
    x = tgl.zeros((2, 8, 4))
    tw = tile_twiddles(8, False, "cpu")
    with pytest.raises(ValueError):
        tk.dit_axis1(x[0], tw)  # not (B, n, lanes)
    with pytest.raises(ValueError):
        tk.ntt_last(x, tw)  # not (rows, n)
    with pytest.raises(ValueError):
        tk.ntt_last(tgl.zeros((4, 6)), tw)  # n not a power of two
    with pytest.raises(ValueError):
        tk.ntt_last(tgl.zeros((1, 8192)), tile_twiddles(8192, False, "cpu"))
    with pytest.raises(ValueError):
        tk.ntt_last(tgl.zeros((4, 16)), tw, 8)  # rows longer than the transform
    with pytest.raises(ValueError):
        tk.ntt_last(tgl.zeros((4, 4)), tw, 8, pre=tgl.zeros((8,)))  # pre shape
    with pytest.raises(TypeError):
        tk.ntt_last(tgl.zeros((4, 8)).to(torch.int32), tw)
    with pytest.raises(TypeError):
        tk.dit_axis1(x.to(torch.int32), tw)
    with pytest.raises(ValueError):
        tk.dit_axis1(x, tw[:2])  # twiddle table too short
    with pytest.raises(ValueError):
        tk.dit_axis1(x, tw, tgl.zeros((8, 3)))  # pre shape
    with pytest.raises(ValueError):
        tk.four_step_ntt((tgl.zeros((2, 4096)),))  # one kernel call covers it
    assert tk.LAUNCHES == 0 and not tk.LAUNCHES_BY_SHAPE  # the CPU path launches no kernel


def test_block_shape_fits_the_shared_memory_and_the_lanes():
    for n in [2, 4, 64, 256, 1024, 2048, 4096]:
        for lanes in [1, 3, 24, 130, 768, 16384]:
            log_lg, threads = tk._block_shape(n, lanes)
            lg = 1 << log_lg
            assert n * lg <= tk.TILE_WORDS
            assert lg < 2 * lanes  # no block wider than the next power of two
            assert 32 <= threads <= 1024
            log_rb, threads = tk._last_block_shape(n, lanes)
            assert (n << log_rb) <= max(n, tk.TARGET_TILE_WORDS)
            assert 32 <= threads <= tk.LAST_THREADS


# ---------------------------------------------------------------------------
# the entry points: natural order in and out, forward / inverse with 1/n
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,lanes,inverse", CASES)
def test_ntt_axis0_and_batched_match_reference(n, lanes, inverse):
    x = _rand((n, lanes), 14)
    want = _ju64(jk.pallas_ntt_axis0((_jpair(x),), inverse)[0])
    got = tk.ntt_batched((tgl.from_u64(np.ascontiguousarray(x.T)),), inverse)[0]
    assert np.array_equal(tgl.to_u64(got).T, want)

    cols = np.ascontiguousarray(x.T).reshape(lanes, 1, n)  # (..., n)
    want_b = _ju64(jk.pallas_ntt_batched((_jpair(cols),), inverse)[0])
    got_b = tk.ntt_batched((tgl.from_u64(cols),), inverse)[0]
    assert got_b.shape == (lanes, 1, n)
    assert np.array_equal(tgl.to_u64(got_b), want_b)
    # and the numpy radix-2 transform both packages share as their oracle
    oracle = jntt.ntt_components((jgl.from_u64(cols),), inverse)[0]
    assert np.array_equal(tgl.to_u64(got_b), jgl.to_u64(oracle))


def test_unscaled_inverse_matches_reference():
    x = _rand((5, 64), 15)
    want = jntt.ntt_components((jgl.from_u64(x),), inverse=True, scale=False)[0]
    got = tk.ntt_batched((tgl.from_u64(x),), inverse=True, scale=False)[0]
    assert np.array_equal(tgl.to_u64(got), jgl.to_u64(want))


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "unscaled"])
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("n", [2, 4, 64, 1024])
def test_ntt_last_plain_matches_radix2_stages(n, inverse, scaled):
    """``ntt_last_plain`` (the kernel's plain version) against the port's
    own eager radix-2 stages of ops/ntt.py, the inverse scaled by 1/n in the
    launch or not at all."""
    x = tgl.from_u64(_rand((3, n), 19))
    scale = pow(n, P - 2, P) if scaled else None
    got = tk.ntt_last_plain(x, tile_twiddles(n, inverse, "cpu"), scale=scale)
    want = tntt.ntt_components((x,), inverse, scale=False)[0]
    if scaled:
        want = tgl.mul(want, tgl.from_int(scale, ()))
    assert torch.equal(got, want)


def test_zero_padded_rows_with_pre_match_the_coset_lde():
    """One ``ntt_last`` call with the offset powers as its pre-multiply and
    rows zero-padded to the blowup equals evaluate_poly_with_offset's eager
    multiply, padding and transform (the route a CUDA tensor takes)."""
    n, blowup, offset = 8, 8, 7
    x = tgl.from_u64(_rand((25, n), 20))
    got = tk.ntt_batched((x,), n=n * blowup, pre=tntt.power_series(offset, n))[0]
    want = tntt.evaluate_poly_with_offset((x,), offset, blowup)[0]
    assert got.shape == (25, n * blowup) and torch.equal(got, want)


def test_ntt_batched_reads_a_transposed_view():
    """The FRI fold hands ``ntt_batched`` the transposed view of its layer's
    evaluations, which the kernel reads through its strides: the result is
    that of the same rows made contiguous."""
    view = tgl.from_u64(_rand((4, 300), 21)).T  # (300, 4), strides (1, 300)
    got = tk.ntt_batched((view,), inverse=True)[0]
    want = tk.ntt_batched((view.contiguous(),), inverse=True)[0]
    assert got.is_contiguous() and torch.equal(got, want)


def test_batched_periodic_columns_equal_the_per_column_ones():
    """device_big evaluates all periodic columns of one length in one call;
    each equals the column evaluated on its own."""
    from starkpack_winterfell_tpu_torch import FieldExtension, ProofOptions, TraceInfo
    from starkpack_winterfell_tpu_torch.models.rescue_chain import ChainInputs, RescueChainAir

    air = RescueChainAir(TraceInfo(12, 1 << 14), ChainInputs([1] * 8, [2] * 4),
                         ProofOptions(28, 8, 16, FieldExtension.NONE, 4, 31))
    cols = device_big._small_periodic_columns(air, "cpu")
    polys = air.get_periodic_column_polys()
    assert len(cols) == len(polys) == 25
    for col, poly in zip(cols, polys):
        offset = pow(air.domain_offset(), air.trace_length() // len(poly), P)
        one = tntt.evaluate_poly_with_offset(
            (tgl.from_u64(np.array(poly, dtype=np.uint64)),), offset, air.ce_blowup_factor())[0]
        assert torch.equal(col, one)


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("bits", [13, 14, 15])
def test_four_step_matches_radix2_ntt(bits, inverse):
    """Odd and even splits: 2^13 = 64 x 128 (a size the JAX entry point does
    not cover), 2^14 = 128 x 128, 2^15 = 128 x 256."""
    n = 1 << bits
    x = _rand((3, n), 16)
    want = jntt.ntt_components((jgl.from_u64(x),), inverse)[0]
    got = tk.four_step_ntt((tgl.from_u64(x),), inverse)[0]
    assert np.array_equal(tgl.to_u64(got), jgl.to_u64(want))
    # the eager stages of the port's own ops/ntt.py agree too
    assert torch.equal(got, tntt.ntt_components((tgl.from_u64(x),), inverse)[0])


def test_four_step_matches_pallas_four_step():
    """The inverse: its 1/n rides in the inner twiddle table."""
    inverse = True
    n = 1 << 14
    x = _rand((1, n), 17)
    want = _ju64(jk.four_step_ntt((_jpair(x),), inverse, interpret=True)[0])
    got = tk.four_step_ntt((tgl.from_u64(x),), inverse)[0]
    assert np.array_equal(tgl.to_u64(got), want)


@pytest.mark.parametrize("n,inverse,scale", [
    (1 << 14, False, True), (1 << 14, True, True), (1 << 15, True, True),
    (1 << 15, True, False),
])
def test_four_step_tables_match_reference(n, inverse, scale):
    n1, n2, rev1, rev2, _, _, twT = jk.four_step_consts_np(n, inverse, scale)
    c = tk.four_step_consts(n, inverse, scale, "cpu")
    assert (c["n1"], c["n2"]) == (n1, n2)
    assert np.array_equal(c["rev1"].numpy(), rev1)
    assert np.array_equal(c["rev2"].numpy(), rev2)
    assert np.array_equal(tgl.to_u64(c["twT"]), jgl.to_u64(twT))


def test_ntt_components_on_the_cpu_runs_the_eager_stages():
    """The dispatch goes by the tensor's device alone: a CPU tensor never
    reaches the kernel wrappers."""
    tk.reset_launch_counts()
    x = _rand((2, 256), 18)
    want = jntt.ntt_components((jgl.from_u64(x),))[0]
    got = tntt.ntt_components((tgl.from_u64(x),))[0]
    assert np.array_equal(tgl.to_u64(got), jgl.to_u64(want))
    assert tk.LAUNCHES == 0
