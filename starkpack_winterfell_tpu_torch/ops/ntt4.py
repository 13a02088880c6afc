"""Gather-free four-step NTT pipelines on a hand-written CUDA tile kernel.

Counterpart of starkpack_winterfell_tpu/ops/pallas/ntt4.py.  The tile
transform — every radix-2 stage of a batched length-n Goldilocks NTT along
axis 1 of a (B, n, lanes) array, DIF or DIT, with an optional fused epilogue
table multiply — is the CUDA kernel of ``csrc/ntt_tile.cu`` (it replaces the
Pallas kernel ``_make_body`` / ``_build_call`` there).  The kernel also
takes the layout moves of the pipelines below as options: a transposed
store, a zero-interleaved input and a pre-multiply table.
``ntt_tile_plain`` is the same function in plain PyTorch; the wrapper
``ntt_tile`` takes it only for tensors that lie on the CPU and launches the
kernel for CUDA tensors.

Bound on an H100: one call reads the input rows once and writes the output
once (8 bytes a word each way against 3.35 TB/s) and does (log2(n) -
log2(interleave)) / 2 butterflies per output word, 46 32-bit integer
instructions each (csrc/gl64_sass_count.py), plus 28 per word and table
multiply, against the card's INT32 rate; from n = 16 up the operations are
the larger bound.  The kernel runs three or four stages at a time in
registers (csrc/gl64_radix.cuh) between exchanges through shared memory.

The four-step decomposition is the JAX package's, with the same index
algebra and the same **permuted coefficient layout** (the K2 output: a
(b, a) matrix holding coefficient j = j1 + a*j2 at [rev_b(j2), rev_a(j1)]):

  interpolate+LDE of length-n columns to L = n*blowup, n = a*b, L = a*B:

    view (.., a, b)                 rows t1 (natural)
    K1  DIF_a   (+epilogue W_n^{-j1 t2} at [rev_a(j1), t2]), stored
                transposed -> (.., b, a)
    K2  DIF_b   (+epilogue (1/n) * s^j at [rev_b(j2), rev_a(j1)])
    K3  DIT_B   on the (.., b, a) rows zero-interleaved by the blowup
                (row r at row r*blowup of the (.., B, a) array it stands
                for), (+epilogue W_L^{r j1} at [r, rev_a(j1)]), stored
                transposed -> (.., a, B)
    K4  DIT_a   -> natural X[q*B + r], reshape (.., L)

Element arrays are tuples of component tensors (int64 words, ops/gl64.py).
"""

from __future__ import annotations

import collections
import ctypes
import os

import numpy as np
import torch

from . import gl64 as gl
from . import ntt as ntt_mod
from ..native import launch

MAX_TILE = 4096
MIN_TILE = 128  # smallest tile _pick_factors uses (the factorization rule
#                 is kept so both packages cut every size the same way)
TILE_WORDS = 4096  # u64 words of a block's tile where n allows (32 KB)
SMEM_PER_SM = 228 * 1024  # shared memory of one H100 SM, in bytes
MAX_THREADS = 256  # threads of a block (the kernel's launch bound)

# launches of the CUDA kernel made by ``ntt_tile`` (and nowhere else): the
# total, and the same launches split by (dif, B, n, lanes, has epilogue,
# interleave, has pre, transposed)
LAUNCHES = 0
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()

_TABLE_CACHE: dict = {}
_LAUNCH = None


# ---------------------------------------------------------------------------
# the tile transform: plain version, kernel wrapper
# ---------------------------------------------------------------------------


def tile_twiddles(n: int, inverse: bool, device) -> torch.Tensor:
    """(n/2,) table root^k of the size-n root (inverse root if ``inverse``);
    stage m of a tile transform uses every (n/m)-th entry."""
    key = ("tw", n, inverse, str(device))
    if key not in _TABLE_CACHE:
        root = gl.get_root_of_unity(n.bit_length() - 1)
        if inverse:
            root = pow(root, gl.P - 2, gl.P)
        _TABLE_CACHE[key] = ntt_mod.power_series(root, n // 2, device).contiguous()
    return _TABLE_CACHE[key]


def ntt_tile_plain(x, tw, dif: bool, epilogue=None, interleave: int = 1, pre=None,
                   transposed: bool = False):
    """Plain PyTorch version of the tile kernel: all stages of a length-n
    NTT along axis 1 of x (B, n, lanes).  DIF: natural in, bit-reversed out;
    DIT: bit-reversed in, natural out.  tw: (n/2,) root powers; epilogue:
    optional (n, lanes) table multiplied into the result.

    Options (the kernel's, for the four-step pipelines):
    ``pre``: (rows of x, lanes) table multiplied into x first;
    ``interleave`` f (DIT only): x is (B, n/f, lanes) and stands for the
    (B, n, lanes) array with x's row r at row r*f and zeros in the f-1 rows
    after it — whose first log2(f) DIT stages only copy each row into those
    zero rows, so the rows are repeated f times and the stages start at
    log2(f) + 1;
    ``transposed``: the result is returned (B, lanes, n), contiguous."""
    if pre is not None:
        x = gl.mul(x, pre.unsqueeze(0))
    first = 1
    if interleave > 1:
        if dif:
            raise ValueError("a zero-interleaved input is a DIT option")
        x = x.repeat_interleave(interleave, dim=1)
        first = interleave.bit_length()
    B, n, lanes = x.shape
    bits = n.bit_length() - 1
    stages = range(bits, 0, -1) if dif else range(first, bits + 1)
    for s in stages:
        m = 1 << s
        half = m >> 1
        w = tw[:: n // m].reshape(1, 1, half, 1)
        v = x.reshape(B, n // m, 2, half, lanes)
        a, c = v[:, :, 0], v[:, :, 1]
        if dif:
            top = gl.add(a, c)
            bot = gl.mul(gl.sub(a, c), w)
        else:
            t = gl.mul(c, w)
            top = gl.add(a, t)
            bot = gl.sub(a, t)
        x = torch.stack([top, bot], dim=2).reshape(B, n, lanes)
    if epilogue is not None:
        x = gl.mul(x, epilogue.unsqueeze(0))
    if transposed:
        x = x.transpose(1, 2).contiguous()
    return x


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_SHAPE.clear()


def kernel_sources():
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
    return [os.path.join(d, "ntt_tile.cu")]


def _lib():
    """Build (first use) and load the kernel library, set its kernels'
    shared-memory limits once; raises on failure.  Returns the launcher."""
    global _LAUNCH
    if _LAUNCH is None:
        from ..native import load_kernels

        p, i = ctypes.c_void_p, ctypes.c_int
        _LAUNCH = load_kernels("starkntt", kernel_sources(), "ntt_tile_init", {
            "ntt_tile_launch": [p] * 5 + [i] * 9 + [p],
        })["ntt_tile_launch"]
    return _LAUNCH


def _block_shape(n: int, rows_in: int, lanes: int, transposed: bool):
    """(log2 of the lanes one thread block stages, K, threads of the block).

    The lane group LG is the largest power of two whose (n, LG) tile stays
    within TILE_WORDS words, capped at the next power of two >= lanes; a
    block that writes its rows straight to device memory (no transposed
    store) takes at least two lanes, so that a row segment is 16 bytes (one
    lane would write 8 bytes of every 32-byte sector).  A zero-interleaved
    input stages its ``rows_in`` rows beside the tile.  K, the stages a
    thread runs in registers between two exchanges, is 4 where the block's
    shared memory lets at most two blocks share an SM anyway (fewer passes),
    else 3 (half the registers, so more blocks share an SM).  A pass has
    (n / 2^K) * LG tasks of 2^K words; the block runs up to MAX_THREADS of
    them at once."""
    lg = 1
    while lg < lanes and (n * lg * 2 <= TILE_WORDS or (lg == 1 and not transposed)):
        lg *= 2
    smem = 8 * (n // 2 + n * lg + (rows_in * lg if rows_in < n else 0))
    radix_log = 4 if 3 * smem > SMEM_PER_SM else 3
    tasks = (n >> min(radix_log, n.bit_length() - 1)) * lg
    return lg.bit_length() - 1, radix_log, min(MAX_THREADS, max(32, tasks))


def ntt_tile(x, tw, dif: bool, epilogue=None, interleave: int = 1, pre=None,
             transposed: bool = False):
    """Tile NTT along axis 1 of x (B, n / interleave, lanes); see
    ``ntt_tile_plain``.

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    csrc/ntt_tile.cu on the current stream (no synchronisation) or raise."""
    global LAUNCHES
    if x.dim() != 3:
        raise ValueError(f"expected a (B, n, lanes) tensor, got shape {tuple(x.shape)}")
    B, rows_in, lanes = x.shape
    if interleave < 1 or interleave & (interleave - 1) or (dif and interleave > 1):
        raise ValueError(f"interleave must be a power of two, and 1 for a DIF, got {interleave}")
    n = rows_in * interleave
    if n < 2 or n & (n - 1) or n > MAX_TILE or interleave >= n:
        raise ValueError(f"tile length must be a power of two in [2, {MAX_TILE}] "
                         f"above the interleave, got {n}")
    tensors = [("x", x, (B, rows_in, lanes)), ("tw", tw, (n // 2,))]
    if epilogue is not None:
        tensors.append(("epilogue", epilogue, (n, lanes)))
    if pre is not None:
        tensors.append(("pre", pre, (rows_in, lanes)))
    for name, t, shape in tensors:
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64 (u64 bit patterns), got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
    if x.device.type == "cpu":
        return ntt_tile_plain(x, tw, dif, epilogue, interleave, pre, transposed)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t, _ in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((B, lanes, n) if transposed else (B, n, lanes),
                      dtype=torch.int64, device=x.device)
    if B == 0 or lanes == 0:
        return out
    log_lg, radix_log, threads = _block_shape(n, rows_in, lanes, transposed)
    rc = launch(
        _lib(), x.device, x.data_ptr(), out.data_ptr(), tw.data_ptr(),
        epilogue.data_ptr() if epilogue is not None else None,
        pre.data_ptr() if pre is not None else None,
        B, n, lanes, log_lg, int(dif), interleave.bit_length() - 1,
        int(transposed), radix_log, threads,
    )
    if rc != 0:
        raise RuntimeError(
            f"ntt_tile kernel launch failed: cudaError {rc} "
            f"(B={B}, n={n}, lanes={lanes}, dif={dif}, interleave={interleave})"
        )
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(bool(dif), B, n, lanes, epilogue is not None, interleave,
                       pre is not None, bool(transposed))] += 1
    return out


# ---------------------------------------------------------------------------
# static tables (built once per size and device, with tensor ops)
# ---------------------------------------------------------------------------


def _pick_factors(n: int, L: int):
    """a*b = n, a*B = L with a, b, B all in [MIN_TILE, MAX_TILE].  Maximal a
    so the outer (size-B) tile fits; requires n >= 2^14 and L <= 2^24."""
    bits_n = n.bit_length() - 1
    for log_a in range(min(12, bits_n - 7), 6, -1):
        a = 1 << log_a
        if a <= MAX_TILE and L // a <= MAX_TILE and MIN_TILE <= n // a <= MAX_TILE:
            return a, n // a, L // a
    raise ValueError(f"no valid factorization for n={n}, L={L}")


def supported(n: int, L: int) -> bool:
    try:
        _pick_factors(n, L)
        return True
    except ValueError:
        return False


def _power_series_rows(bases: torch.Tensor, ncols: int) -> torch.Tensor:
    """(R,) bases -> (R, ncols) with out[r, c] = bases[r]^c, log-doubling."""
    R = bases.shape[0]
    cur = gl.ones((R, 1), bases.device)
    scale = bases.reshape(R, 1)
    length = 1
    while length < ncols:
        cur = torch.cat([cur, gl.mul(cur, scale)], dim=1)
        scale = gl.square(scale)
        length *= 2
    return cur[:, :ncols]


def _rev_and_j(a: int, b: int, device):
    """j1s[s] is the j1 with rev_a(j1) == s (bit reversal is an involution,
    so this is rev_a itself), likewise j2s for b."""
    j1s = torch.from_numpy(ntt_mod._bit_rev_perm(a)).to(device)
    j2s = torch.from_numpy(ntt_mod._bit_rev_perm(b)).to(device)
    return j1s, j2s


def _cached(key, build):
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = build()
    return _TABLE_CACHE[key]


def _intt_tables(n: int, L: int, scale_base: int, device):
    """K1/K2 tables: natural length-n evals -> permuted output holding
    (1/n) * scale_base^j * iNTT_j at [rev_b(j2), rev_a(j1)].

    scale_base = 1                    -> plain interpolate
    scale_base = inv(interp_offset)   -> coset interpolation (true coeffs)
    scale_base = eval_offset          -> fused interpolate+LDE pre-scale
    """

    def build():
        a, b, Bf = _pick_factors(n, L)
        j1s, j2s = _rev_and_j(a, b, device)
        w_n_inv = pow(gl.get_root_of_unity(n.bit_length() - 1), gl.P - 2, gl.P)
        n_inv = pow(n, gl.P - 2, gl.P)
        # K1 epilogue: W_n^{-j1*t2} at [rev_a(j1), t2]  (a, b)
        wninv_pows = ntt_mod.power_series(w_n_inv, a, device)
        e1 = _power_series_rows(wninv_pows[j1s], b).contiguous()
        # K2 epilogue: (1/n) * scale_base^j at [rev_b(j2), rev_a(j1)]  (b, a)
        s_pows = ntt_mod.power_series(scale_base % gl.P, n, device)
        jgrid = j1s[None, :] + a * j2s[:, None]  # (b, a)
        e2 = gl.mul(s_pows[jgrid], gl.from_int(n_inv, (), device)).contiguous()
        return {
            "a": a, "b": b, "B": Bf,
            "k1": tile_twiddles(a, True, device), "e1": e1,
            "k2": tile_twiddles(b, True, device), "e2": e2,
        }

    return _cached(("intt", n, L, scale_base % gl.P, str(device)), build)


def _fwd_tables(L: int, a: int, device):
    """K3/K4 tables: permuted (rows, a) coefficients -> natural length-L
    evaluations (the second half of the schedule)."""

    def build():
        Bf = L // a
        j1s, _ = _rev_and_j(a, 2, device)
        w_L = gl.get_root_of_unity(L.bit_length() - 1)
        wl_pows = ntt_mod.power_series(w_L, a, device)
        e3 = _power_series_rows(wl_pows[j1s], Bf).T.contiguous()  # (Bf, a): W_L^{r j1}
        return {
            "k3": tile_twiddles(Bf, False, device), "e3": e3,
            "k4": tile_twiddles(a, False, device),
        }

    return _cached(("fwd", L, a, str(device)), build)


def _scale_table(rows: int, a: int, s: int, device):
    """(rows, a) table s^t at [rev_rows(j2), rev_a(j1)], t = j1 + a*j2 —
    the per-coefficient offset scaling for lde_from_permuted."""

    def build():
        j1s, j2s = _rev_and_j(a, rows, device)
        s_pows = ntt_mod.power_series(s % gl.P, rows * a, device)
        tgrid = j1s[None, :] + a * j2s[:, None]
        return s_pows[tgrid].contiguous()

    return _cached(("scale", rows, a, s % gl.P, str(device)), build)


def lde_consts(n: int, L: int, offset: int, device):
    """Tables for the fused interpolate_lde."""
    t = dict(_intt_tables(n, L, offset, device))
    t.update(_fwd_tables(L, t["a"], device))
    return t


def intt_consts(n: int, L: int, interp_offset: int, device):
    """Tables for intt_permuted (true-coefficient output)."""
    s = pow(interp_offset % gl.P, gl.P - 2, gl.P)
    return dict(_intt_tables(n, L, s, device))


def fwd_consts(L: int, a: int, eval_offset: int, rows: int, device):
    """Tables for lde_from_permuted: K3/K4 + the offset^t coefficient
    pre-scale for a (rows, a) permuted input."""
    t = dict(_fwd_tables(L, a, device))
    t["o"] = _scale_table(rows, a, eval_offset, device)
    return t


# ---------------------------------------------------------------------------
# pipelines
# ---------------------------------------------------------------------------


def _run_k1k2(comps, c):
    """Natural (..., n) -> permuted (..., b, a) through K1 (transposed
    store) and K2: no copy between the two launches."""
    shape = comps[0].shape
    b, a = c["e2"].shape
    batch = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    out = []
    for x in comps:
        x = x.reshape(batch, a, b).contiguous()
        x = ntt_tile(x, c["k1"], True, c["e1"], transposed=True)
        x = ntt_tile(x, c["k2"], True, c["e2"])
        out.append(x.reshape(shape[:-1] + (b, a)))
    return tuple(out)


def _run_interleave_k3k4(comps, c, L, scale=None):
    """Permuted (..., rows, a) -> natural (..., L) through K3 and K4.
    ``scale``: optional (rows, a) pre-multiply table (offset^t).

    K3 takes the coefficient rows as they are: its zero-interleaved input
    stands for the (B, a) array with coefficient row r at row r*f and zeros
    in the f-1 rows after it (the blowup zero-padding in the layout K3
    reads), its pre-multiply takes ``scale``, and its transposed store hands
    K4 its layout: no copy, no zero buffer and no multiply between the two
    launches."""
    shape = comps[0].shape
    rows, a = shape[-2], shape[-1]
    Bf = L // a
    f = Bf // rows  # zero-interleave factor
    batch = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    out = []
    for x in comps:
        x = x.reshape(batch, rows, a).contiguous()
        x = ntt_tile(x, c["k3"], False, c["e3"], interleave=f, pre=scale, transposed=True)
        x = ntt_tile(x, c["k4"], False, None)
        out.append(x.reshape(shape[:-2] + (L,)))
    return tuple(out)


def interpolate_lde(comps, blowup: int, offset: int, return_permuted: bool = False):
    """Length-n natural-order evaluations (..., n) -> natural-order coset
    LDE (..., n*blowup) through four tile transforms.

    Semantics == ntt.interpolate_poly followed by
    ntt.evaluate_poly_with_offset, word for word.

    With return_permuted=True also returns the K2 intermediates: permuted
    (..., b, a) arrays holding offset^j * c_j (pair with
    permuted_power_series of z/offset for OOD evaluation).
    """
    n = comps[0].shape[-1]
    L = n * blowup
    c = lde_consts(n, L, offset, comps[0].device)
    pc = _run_k1k2(comps, c)
    lde = _run_interleave_k3k4(pc, c, L)
    if return_permuted:
        return lde, pc
    return lde


def intt_permuted(comps, interp_offset: int, L: int):
    """Natural-order evaluations (..., n) over the coset interp_offset*<w_n>
    -> TRUE polynomial coefficients in permuted layout (..., b, a):
    out[..., rev_b(j2), rev_a(j1)] = c_{j1 + a*j2}.

    == ntt.interpolate_poly_with_offset, re-laid out.  L picks the tile
    factor ``a`` shared with a later lde_from_permuted to size L.
    """
    n = comps[0].shape[-1]
    c = intt_consts(n, L, interp_offset, comps[0].device)
    return _run_k1k2(comps, c)


def lde_from_permuted(comps, L: int, eval_offset: int):
    """Permuted TRUE coefficients (..., rows, a) of length rows*a polys ->
    natural-order evaluations over eval_offset*<w_L> shaped (..., L).

    == ntt.evaluate_poly_with_offset, fed from the permuted layout.
    """
    rows, a = comps[0].shape[-2:]
    c = fwd_consts(L, a, eval_offset, rows, comps[0].device)
    return _run_interleave_k3k4(comps, c, L, scale=c["o"])


def _rev_bits(k: int, bits: int) -> int:
    r = 0
    for i in range(bits):
        r |= ((k >> i) & 1) << (bits - 1 - i)
    return r


def slice_columns_permuted(comps, num_cols: int, keep: int = None):
    """Permuted (..., b, a) coefficients of a length-n poly -> per-column
    permuted coefficients: a list of ``keep`` (default num_cols) entries,
    column k shaped (..., b/num_cols, a) holding c_{k*tl + t} at
    [rev_{b'}(j2'), rev_a(j1)] with t = j1 + a*j2' and tl = n/num_cols.

    In the permuted layout the coefficient-slice split (coefficient j ->
    column j // tl) is a strided row slice: column k owns rows r with
    r % num_cols == rev(k).
    """
    if num_cols == 1:
        return [comps]
    bits = num_cols.bit_length() - 1
    keep = num_cols if keep is None else keep
    cols = []
    for k in range(keep):
        rk = _rev_bits(k, bits)
        cols.append(tuple(x[..., rk::num_cols, :] for x in comps))
    return cols


def permuted_power_series(x_elem, n: int, a: int, b: int):
    """Power series [x^j for j < n] of a (1,)-shaped extension element,
    laid out (b, a) like the permuted coefficients: out[rev_b(j2),
    rev_a(j1)] = x^{j1 + a*j2}."""
    from . import vec

    device = x_elem[0].device
    rev_a = torch.from_numpy(ntt_mod._bit_rev_perm(a)).to(device)
    rev_b = torch.from_numpy(ntt_mod._bit_rev_perm(b)).to(device)
    ps = vec.power_series_elem(x_elem, n)  # tuple of d tensors shaped (n,)
    return tuple(p.reshape(b, a)[rev_b][:, rev_a] for p in ps)
