"""Decimation-in-time Goldilocks NTT on two hand-written CUDA kernels.

Counterpart of starkpack_winterfell_tpu/ops/pallas/ntt_kernel.py.  The two
kernel-level functions are the CUDA kernels of ``csrc/ntt_dit.cu``:

* ``ntt_last(x, tw, n=None, pre=None, scale=None)`` — the NTT of every row
  of a ``(rows, n_in)`` array along its last axis, natural order in and out,
  in one launch, x read through its strides (a transposed view is read where
  it lies): rows shorter than n zero-padded, an optional ``(n_in,)``
  table multiplied into the input, an optional word multiplied into the
  output (replaces the Pallas kernel ``_make_kernel`` / ``_build_call`` with
  what its entry ``pallas_ntt_batched`` does around it: the transposes, the
  bit-reversal gather and the inverse's 1/n);
* ``dit_tile(x, tw, pre=None, out=None, n=None, row=None, col=None)`` —
  all DIT stages along axis 1 of a ``(B, n_in, lanes)`` array read through
  its strides, zero-padded to n rows, natural order in (bit-reversed on the
  load) and out, with optional elementwise multiplies before the stages (an
  ``(n_in, lanes)`` table, a row and a column factor: the four-step twiddle,
  a coset LDE's offset powers), written through the strides of ``out``
  (replaces ``_make_kernel3`` /
  ``_build_call3``, which take bit-reversed rows; the Goldilocks
  instantiation of the DIT tile frame ``csrc/dit_tile.cuh`` that kernel 4
  shares).

Both work on one-word ``int64`` tensors holding u64 bit patterns
(ops/gl64.py).  ``ntt_last_plain`` / ``dit_tile_plain`` are the same
functions in plain PyTorch; a wrapper takes the plain version only for
tensors that lie on the CPU, and for CUDA tensors launches its kernel or
raises.

The entry points keep the JAX package's contract — natural order in, natural
order out, forward or inverse with the 1/n scale, i.e. the contract of
``ops/ntt.py:ntt_components``, which routes every transform of a CUDA tensor
here:

* ``ntt_batched`` along the last axis of (..., n), n <= MAX_TILE_N: one
  ``ntt_last`` launch per component, on the caller's layout and strides;
* ``four_step_ntt`` along the last axis of (..., n) for n = n1*n2 above
  MAX_TILE_N: ``dit_tile`` over n1 with a transposed store, ``dit_tile``
  over n2 on that layout with the inner twiddle (and the inverse's 1/n) as
  its pre-multiply: no copy between or around the two launches.

Limits, which are the card's: a transform length is a power of two, 2 up to
MAX_TILE_N = 4096 in one kernel call, and any power of two above that up to
MAX_TILE_N^2 = 2^24 through the four-step split (n1 = 2^(bits // 2), so
8192 = 64 x 128 is covered).  Rows and lanes are arbitrary: the ragged last
block is masked in the kernel, nothing is padded.  Not carried over from the
TPU kernels: the (log n, n) per-position twiddle planes (one (n/2,)
root-power table serves every stage), the roll-and-select butterflies, the
128-lane padding and the VMEM limit.

Bound on an H100: a call reads the array once and writes it once and does
log2(n)/2 butterflies of 46 32-bit integer instructions per word (28 more
per word and table multiply); from n = 16 up the operations are the larger
bound.
"""

from __future__ import annotations

import collections
import ctypes
import os

import numpy as np
import torch

from . import gl64 as gl
from . import ntt as ntt_mod
from .limb_ntt import block_shape, key_strides
from .ntt4 import _power_series_rows, tile_twiddles
from ..native import launch

MAX_TILE_N = 4096
MAX_FOUR_STEP = MAX_TILE_N * MAX_TILE_N
TARGET_TILE_WORDS = 4096  # ntt_last: tile size aimed at where n allows (32 KB)
REGISTER_ROWS_MAX_N = 32  # ntt_last keeps a whole row in registers up to here
LAST_THREADS = 256  # ntt_last: most threads a block, and rows a block below 64
MIN_BLOCKS = 2 * 132  # ntt_last: blocks to aim for, two for each SM of an H100

# launches of the CUDA kernels made by ``ntt_last`` / ``dit_tile`` (and
# nowhere else): the total, and the same launches split by
# ("last", rows, n, n_in, strides of x, has pre, has scale) or ("tile", B, n,
# n_in, lanes, strides of x, strides of the output, has pre, has row, has col)
LAUNCHES = 0
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()

_CONSTS_CACHE: dict = {}
_FNS = None


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_SHAPE.clear()


def _rev(n: int, device) -> torch.Tensor:
    key = ("rev", n, str(device))
    if key not in _CONSTS_CACHE:
        _CONSTS_CACHE[key] = torch.from_numpy(ntt_mod._bit_rev_perm(n)).to(device)
    return _CONSTS_CACHE[key]


# ---------------------------------------------------------------------------
# the kernel-level functions: plain versions, kernel wrappers
# ---------------------------------------------------------------------------


def dit_tile_plain(x, tw, pre=None, n: int = None, row=None, col=None):
    """Plain PyTorch version of the batched kernel: x (B, n_in, lanes)
    times ``pre`` (n_in, lanes), ``row`` (n_in,) along the rows and ``col``
    (lanes,) along the lanes where given, zero-padded to n rows (default
    n_in), the rows bit-reversed, then all DIT stages along axis 1 — natural
    order in, natural order out.  tw: (n/2,) root powers.  Returns a
    contiguous (B, n, lanes) array."""
    B, n_in, lanes = x.shape
    n = n_in if n is None else n
    if pre is not None:
        x = gl.mul(x, pre.unsqueeze(0))
    if row is not None:
        x = gl.mul(x, row.reshape(1, n_in, 1))
    if col is not None:
        x = gl.mul(x, col.reshape(1, 1, lanes))
    if n_in < n:
        x = torch.cat([x, torch.zeros((B, n - n_in, lanes), dtype=torch.int64,
                                      device=x.device)], dim=1)
    x = x.index_select(1, _rev(n, x.device))
    for s in range(1, n.bit_length()):
        m = 1 << s
        half = m >> 1
        w = tw[:: n // m].reshape(1, 1, half, 1)
        v = x.reshape(B, n // m, 2, half, lanes)
        t = gl.mul(v[:, :, 1], w)
        x = torch.stack([gl.add(v[:, :, 0], t), gl.sub(v[:, :, 0], t)],
                        dim=2).reshape(B, n, lanes)
    return x


def ntt_last_plain(x, tw, n: int = None, pre=None, scale: int = None):
    """Plain PyTorch version of the last-axis kernel: every row of x
    (rows, n_in), times ``pre`` (n_in,) if given, zero-padded to n (default
    n_in), transformed along its last axis with the root powers tw (n/2,)
    — natural order in, natural order out — and multiplied by the field
    element ``scale`` if given."""
    rows, n_in = x.shape
    n = n_in if n is None else n
    if pre is not None:
        x = gl.mul(x, pre.unsqueeze(0))
    if n_in < n:
        x = torch.cat([x, torch.zeros((rows, n - n_in), dtype=torch.int64,
                                      device=x.device)], dim=1)
    x = dit_tile_plain(x.unsqueeze(-1), tw)[..., 0]
    if scale is not None:
        x = gl.mul(x, gl.from_int(scale, (), x.device))
    return x


def kernel_sources():
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
    return [os.path.join(d, "ntt_dit.cu")]


def _lib():
    """Build (first use) and load the kernel library, set its kernels'
    shared-memory limits once; raises on failure.  Returns the launchers."""
    global _FNS
    if _FNS is None:
        from ..native import load_kernels

        p, i = ctypes.c_void_p, ctypes.c_int
        _FNS = load_kernels("starknttdit", kernel_sources(), "ntt_dit_init", {
            "ntt_last_launch": [p, p, p, p, ctypes.c_uint64, i, ctypes.c_longlong,
                                ctypes.c_longlong, i, i, i, i, i, p],
            "dit_tile_gl64_launch": [p] * 7 + [i] * 9 + [p],
        })
    return _FNS


def _block_shape(n: int, B: int, lanes: int, lanes_contiguous: bool):
    """(log2 of the lanes one thread block stages, K, threads of the block)
    of ``dit_tile``: the frame's rule (``limb_ntt.block_shape``) on 8-byte
    words."""
    return block_shape(8, n, B, lanes, lanes_contiguous)


def _check(tensors, device, strided=()):
    """Dtype, shape and device of each (name, tensor, shape); False for CPU
    tensors, True for CUDA tensors, which must be contiguous unless named in
    ``strided`` (read through their strides by the kernel)."""
    for name, t, shape in tensors:
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64 (u64 bit patterns), got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, x on {device}")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for name, t, _ in tensors:
        if name not in strided and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return True


def _check_length(n: int):
    if n < 2 or n & (n - 1) or n > MAX_TILE_N:
        raise ValueError(
            f"transform length must be a power of two in [2, {MAX_TILE_N}], got {n}")


def _last_block_shape(n: int, rows: int):
    """(log2 of the rows a block transforms, threads of the block) of
    ``ntt_last``: up to REGISTER_ROWS_MAX_N one thread a row; above, a tile
    of about TARGET_TILE_WORDS words (never more rows than the next power of
    two >= rows, and fewer while that leaves under MIN_BLOCKS blocks) and one
    thread per 16 words of it."""
    if n <= REGISTER_ROWS_MAX_N:
        return 0, LAST_THREADS
    rb = 1
    while rb * 2 * n <= TARGET_TILE_WORDS and rb < rows:
        rb *= 2
    while rb > 1 and -(-rows // rb) < MIN_BLOCKS:  # fewer rows a block, more blocks
        rb //= 2
    return rb.bit_length() - 1, min(LAST_THREADS, max(32, rb * n // 16))


def ntt_last(x, tw, n: int = None, pre=None, scale: int = None):
    """NTT of every row of x (rows, n_in) along its last axis, natural order
    in and out; see ``ntt_last_plain``.  x may be any 2-D view (the kernel
    reads it through its strides); the output is contiguous.

    CPU tensors take the plain version.  CUDA tensors launch ``ntt_last`` of
    csrc/ntt_dit.cu on the current stream (no synchronisation) or raise."""
    global LAUNCHES
    if x.dim() != 2:
        raise ValueError(f"expected a (rows, n) tensor, got shape {tuple(x.shape)}")
    rows, n_in = x.shape
    n = n_in if n is None else n
    _check_length(n)
    if not 1 <= n_in <= n:
        raise ValueError(f"rows of {n_in} words do not pad to a length-{n} transform")
    tensors = [("x", x, (rows, n_in)), ("tw", tw, (n // 2,))]
    if pre is not None:
        tensors.append(("pre", pre, (n_in,)))
    if not _check(tensors, x.device, strided=("x",)):
        return ntt_last_plain(x, tw, n, pre, scale)
    out = torch.empty((rows, n), dtype=torch.int64, device=x.device)
    if rows == 0:
        return out
    log_rb, threads = _last_block_shape(n, rows)
    rc = launch(
        _lib()["ntt_last_launch"], x.device, x.data_ptr(), out.data_ptr(),
        tw.data_ptr(), pre.data_ptr() if pre is not None else None,
        0 if scale is None else scale % gl.P, int(scale is not None),
        x.stride(0), x.stride(1), rows, n, n_in, log_rb, threads,
    )
    if rc != 0:
        raise RuntimeError(
            f"ntt_last kernel launch failed: cudaError {rc} (rows={rows}, n={n}, n_in={n_in})")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[("last", rows, n, n_in, tuple(x.stride()), pre is not None,
                       scale is not None)] += 1
    return out


def tile_args(x, tw, pre, out, row=None, col=None):
    """The arguments of ``dit_tile_gl64_launch`` (csrc/ntt_dit.cu) before
    the stream, for checked tensors (``dit_tile``): pointers, the strides
    (one group of B), the sizes, the block shape (``_block_shape``) and the
    task mappings, rows fastest where the rows of x (of the output) lie
    closer together than its lanes."""
    B, n_in, lanes = x.shape
    n = out.shape[1]
    xs, os_ = x.stride(), out.stride()
    ps = pre.stride() if pre is not None else (0, 0)
    rows_in = xs[1] < xs[2]
    log_lg, _, threads = _block_shape(n, B, lanes, not rows_in)
    strides = (ctypes.c_longlong * 10)(0, xs[0], xs[1], xs[2], 0, os_[0], os_[1], os_[2], *ps)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    return [x.data_ptr(), out.data_ptr(), tw.data_ptr(), ptr(pre), ptr(row), ptr(col),
            strides, B, n, n_in, lanes, log_lg, 1, int(rows_in), int(os_[1] < os_[2]),
            threads]


def dit_tile(x, tw, pre=None, out=None, n: int = None, row=None, col=None):
    """DIT stages along axis 1 of x (B, n_in, lanes), any strides, its rows
    times ``pre`` / ``row`` / ``col`` and zero-padded to n; see
    ``dit_tile_plain``.  ``out``: a (B, n, lanes) array to write, any
    strides that do not overlap (default: a new contiguous one); returned.

    CPU tensors take the plain version.  CUDA tensors launch the Goldilocks
    ``dit_tile_kernel`` of csrc/ntt_dit.cu on the current stream (no
    synchronisation) or raise."""
    global LAUNCHES
    if x.dim() != 3:
        raise ValueError(f"expected a (B, n, lanes) tensor, got shape {tuple(x.shape)}")
    B, n_in, lanes = x.shape
    n = n_in if n is None else n
    _check_length(n)
    if not 1 <= n_in <= n:
        raise ValueError(f"{n_in} input rows do not pad to a length-{n} transform")
    tensors = [("x", x, (B, n_in, lanes)), ("tw", tw, (n // 2,))]
    for name, t, shape in (("pre", pre, (n_in, lanes)), ("row", row, (n_in,)),
                           ("col", col, (lanes,)), ("out", out, (B, n, lanes))):
        if t is not None:
            tensors.append((name, t, shape))
    if not _check(tensors, x.device, strided=("x", "pre", "out")):
        got = dit_tile_plain(x, tw, pre, n, row, col)
        return got if out is None else out.copy_(got)
    if out is None:
        out = torch.empty((B, n, lanes), dtype=torch.int64, device=x.device)
    if B == 0 or lanes == 0:
        return out
    rc = launch(_lib()["dit_tile_gl64_launch"], x.device, *tile_args(x, tw, pre, out, row, col))
    if rc != 0:
        raise RuntimeError(
            f"dit_tile kernel launch failed: cudaError {rc} "
            f"(B={B}, n={n}, lanes={lanes}, pre={pre is not None})")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[("tile", B, n, n_in, lanes, key_strides(x), key_strides(out),
                       pre is not None, row is not None, col is not None)] += 1
    return out


# ---------------------------------------------------------------------------
# entry points: natural order in, natural order out
# ---------------------------------------------------------------------------


def ntt_batched(comps, inverse: bool = False, scale: bool = True, n: int = None,
                pre=None):
    """NTT along the LAST axis of (..., n_in) component tensors, one
    ``ntt_last`` launch per component on the caller's layout (a 2-D strided
    view, such as the FRI fold's transposed rows, is read where it lies):
    rows zero-padded to n (default n_in), ``pre`` (n_in,) multiplied into the
    input if given, the inverse scaled by 1/n in the same launch."""
    shape = comps[0].shape
    n_in = shape[-1]
    n = n_in if n is None else n
    _check_length(n)
    device = comps[0].device
    tw = tile_twiddles(n, inverse, device)
    n_inv = pow(n, gl.P - 2, gl.P) if inverse and scale else None
    return tuple(ntt_last(c.reshape(-1, n_in), tw, n, pre, n_inv)
                 .reshape(shape[:-1] + (n,)) for c in comps)


def four_step_consts(n: int, inverse: bool, scale: bool = True, device="cpu"):
    """Tables of the four-step transform of size n = n1*n2, n1 =
    2^(bits // 2), built once per size and device with tensor ops: the two
    (n/2,) root-power tables and ``twT`` (n2, n1): the inner twiddle
    root^(k2*i1) at [k2, i1], times 1/n for the scaled inverse (the second
    launch multiplies it into its natural-order rows)."""
    key = ("four_step", n, bool(inverse), bool(scale), str(device))
    if key not in _CONSTS_CACHE:
        bits = n.bit_length() - 1
        n1 = 1 << (bits // 2)
        n2 = n // n1
        root = gl.get_root_of_unity(bits)
        if inverse:
            root = pow(root, gl.P - 2, gl.P)
        twT = _power_series_rows(ntt_mod.power_series(root, n2, device), n1)
        if inverse and scale:
            twT = gl.mul(twT, gl.from_int(pow(n, gl.P - 2, gl.P), (), device))
        _CONSTS_CACHE[key] = {
            "n1": n1, "n2": n2,
            "tw1": tile_twiddles(n1, inverse, device),
            "tw2": tile_twiddles(n2, inverse, device),
            "twT": twT.contiguous(),
        }
    return _CONSTS_CACHE[key]


def coset_factors(offset: int, rows: int, n2: int, device):
    """(row (rows,), col (n2,)) factors of the coefficient scale s^t split
    by the four-step view t = t1*n2 + t2: (s^n2)^{t1} and s^{t2}."""
    key = ("coset", offset % gl.P, rows, n2, str(device))
    if key not in _CONSTS_CACHE:
        _CONSTS_CACHE[key] = (
            ntt_mod.power_series(pow(offset, n2, gl.P), rows, device).contiguous(),
            ntt_mod.power_series(offset % gl.P, n2, device).contiguous())
    return _CONSTS_CACHE[key]


def four_step_ntt(comps, inverse: bool = False, scale: bool = True, n: int = None,
                  offset: int = None):
    """Four-step NTT along the LAST axis of (..., n_in) component tensors,
    zero-padded to n (default n_in), a power of two above MAX_TILE_N (up to
    MAX_FOUR_STEP); with ``offset`` the coefficients are scaled by offset^t
    first (a coset LDE):

      view (B, n_in / n2, n2) -> kernel over n1 (the rows zero-padded to n1,
      times the offset's row and column factors), stored transposed
      (B, n2, n1) -> kernel over n2 with the inner twiddle (and the
      inverse's 1/n) as its pre-multiply -> (B, n2, n1) = natural-order
      (B, n) output.

    Both launches read natural-order rows (the kernel bit-reverses on the
    load); no copy is made between or around them.  n_in must be a multiple
    of n2."""
    shape = comps[0].shape
    n_in = shape[-1]
    n = n_in if n is None else n
    if n <= MAX_TILE_N or n & (n - 1) or n > MAX_FOUR_STEP:
        raise ValueError(
            f"four-step length must be a power of two in "
            f"({MAX_TILE_N}, {MAX_FOUR_STEP}], got {n}")
    device = comps[0].device
    c = four_step_consts(n, inverse, scale, device)
    n1, n2 = c["n1"], c["n2"]
    if n_in > n or n_in % n2:
        raise ValueError(f"{n_in} coefficients do not fill whole rows of {n2}")
    rows = n_in // n2
    row, col = coset_factors(offset, rows, n2, device) if offset is not None else (None, None)
    B = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    out = []
    for x in comps:
        a = torch.empty((B, n2, n1), dtype=torch.int64, device=device)
        dit_tile(x.reshape(B, rows, n2), c["tw1"], out=a.transpose(1, 2), n=n1, row=row,
                 col=col)
        out.append(dit_tile(a, c["tw2"], c["twT"]).reshape(shape[:-1] + (n,)))
    return tuple(out)
