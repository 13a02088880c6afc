"""Tile NTT over limb-field word planes on a hand-written CUDA kernel.

Counterpart of starkpack_winterfell_tpu/ops/pallas/limb_kernel.py.  The tile
transform — every radix-2 DIT stage of a batched length-n NTT along axis 1
of (B, n, lanes) word planes (bit-reversed rows in, natural rows out, no 1/n
scale), with an optional fused pre-multiply by an (n, lanes) table — is the
CUDA kernel of ``csrc/limb_ntt_tile.cu`` (it replaces the Pallas kernel
``_make_kernel`` / ``_build_call`` there).  ``ntt_last_axis`` is the entry
the field code calls: a transform along the LAST axis of planes shaped
(..., n), natural order in and out.  It moves the transform axis in front of
the lanes, bit-reverses the rows with one gather, runs the tile transform
and moves the axis back; the gather and the transposes are eager tensor
code.  CPU tensors take the plain version of the tile transform, CUDA
tensors launch the kernel or raise.  ``ntt_last_axis_plain`` is the same
function on the plain tile transform whatever the device.

The kernel is a template over the field type, built for f128 (two word
planes) and f62 (one).

Bound on an H100: a call reads the planes once and writes them once (32
bytes per f128 element, 16 per f62 element, against 3.35 TB/s) and does
log2(n)/2 butterflies per element, one field multiply, add and subtract
each, against the card's INT32 rate; the operations are the larger bound
from n = 4 up (instruction counts: csrc/gl64_sass_count.py).  The kernel
keeps all stages of a tile in shared memory so no stage touches device
memory.
"""

from __future__ import annotations

import collections
import ctypes
import os

import torch

from . import ntt as ntt_mod
from ..native import launch

TILE_WORDS = 16384  # u64 words of shared memory per block (128 KB)
MAX_THREADS = 512

# launches of the CUDA kernel made by ``ntt_last_axis`` (and nowhere else):
# the total, and the same launches split by (field, inverse, B, n, lanes,
# has pre)
LAUNCHES = 0
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()

_TW_CACHE: dict = {}
_LIB = None


def max_tile(field) -> int:
    """Largest tile length: a tile of at least four lanes per block (2048
    for f128, 4096 for f62)."""
    return TILE_WORDS // field.n // 4


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_SHAPE.clear()


def kernel_sources():
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
    return [os.path.join(d, "limb_ntt_tile.cu")]


def _lib():
    """Build (first use) and load the kernel library, set its kernels'
    shared-memory limits once; raises on failure.  Returns the launchers."""
    global _LIB
    if _LIB is None:
        from ..native import load_kernels

        p, i = ctypes.c_void_p, ctypes.c_int
        sig = [p] * 8 + [i] * 5 + [p]
        _LIB = load_kernels("starklimbntt", kernel_sources(), "limb_ntt_tile_init", {
            "limb_ntt_tile_f128_launch": sig, "limb_ntt_tile_f62_launch": sig,
        })
    return _LIB


def tile_twiddles(field, n: int, inverse: bool, device):
    """(n/2,) word planes root^k of the size-n root (inverse root if
    ``inverse``); stage m of a tile transform uses every (n/m)-th entry."""
    key = (field.NAME, n, inverse, str(device))
    if key not in _TW_CACHE:
        root = field.get_root_of_unity(n.bit_length() - 1)
        if inverse:
            root = pow(root, field.P - 2, field.P)
        base = field.from_int(root, (1,), device)
        _TW_CACHE[key] = tuple(
            l.contiguous() for l in field._pow_series(base, max(n // 2, 1))
        )
    return _TW_CACHE[key]


# ---------------------------------------------------------------------------
# the tile transform: plain version, kernel launch
# ---------------------------------------------------------------------------


def tile_plain(field, x, tw, pre=None):
    """Plain PyTorch version of the tile kernel: all DIT stages of a
    length-n NTT along axis 1 of word planes x (B, n, lanes), bit-reversed
    rows in, natural rows out.  tw: (n/2,) root powers; pre: optional
    (n, lanes) table multiplied into the input."""
    B, n, lanes = x[0].shape
    if pre is not None:
        x = field.mul(x, tuple(l.unsqueeze(0) for l in pre))
    for s in range(1, n.bit_length()):
        m = 1 << s
        half = m >> 1
        w = tuple(l[:: n // m].reshape(1, 1, half, 1) for l in tw)
        v = tuple(l.reshape(B, n // m, 2, half, lanes) for l in x)
        a = tuple(l[:, :, 0] for l in v)
        c = tuple(l[:, :, 1] for l in v)
        t = field.mul(c, w)
        top, bot = field.add(a, t), field.sub(a, t)
        x = tuple(torch.stack([p, q], dim=2).reshape(B, n, lanes)
                  for p, q in zip(top, bot))
    return x


def _lanes_per_block(field, n: int, lanes: int) -> int:
    """log2 of the lanes one thread block stages: the largest power of two
    with n * LG elements in TILE_WORDS, capped at the next power of two >=
    lanes."""
    cap = max(1, TILE_WORDS // field.n // n)
    lg = 1
    while lg * 2 <= cap and lg < lanes:
        lg *= 2
    return lg.bit_length() - 1


def _tile_launch(field, x, tw, pre, inverse: bool):
    """Launch csrc/limb_ntt_tile.cu on contiguous CUDA planes; counts the
    launch.  Raises when the field has no kernel or the launch is refused."""
    global LAUNCHES
    if field.NAME not in ("f128", "f62"):
        raise NotImplementedError(f"no limb NTT kernel for field {field.NAME}")
    B, n, lanes = x[0].shape
    planes = list(x) + list(tw) + (list(pre) if pre is not None else [])
    for t in planes:
        if t.dtype != torch.int64 or not t.is_contiguous() or t.device != x[0].device:
            raise ValueError("limb NTT planes must be contiguous int64 tensors "
                             "on one device")
    out = tuple(torch.empty_like(l) for l in x)
    if B == 0 or lanes == 0:
        return out
    fn = _lib()[f"limb_ntt_tile_{field.NAME}_launch"]
    log_lg = _lanes_per_block(field, n, lanes)
    threads = min(MAX_THREADS, max(32, (n // 2) << log_lg))

    def ptrs(planes):
        # (low plane, high plane); a one-word field has no high plane
        got = [l.data_ptr() for l in planes] if planes is not None else []
        return got + [None] * (2 - len(got))

    rc = launch(fn, x[0].device, *ptrs(x), *ptrs(out), *ptrs(tw), *ptrs(pre),
                B, n, lanes, log_lg, threads)
    if rc != 0:
        raise RuntimeError(
            f"limb_ntt_tile kernel launch failed: cudaError {rc} "
            f"(field={field.NAME}, B={B}, n={n}, lanes={lanes})"
        )
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(field.NAME, bool(inverse), B, n, lanes, pre is not None)] += 1
    return out


# ---------------------------------------------------------------------------
# the entry the field code calls
# ---------------------------------------------------------------------------


def _ntt_last_axis(field, a, inverse: bool, pre, plain: bool):
    shape = a[0].shape
    n = shape[-1]
    device = a[0].device
    if n < 2 or n & (n - 1) or n > max_tile(field):
        raise ValueError(f"tile length must be a power of two in "
                         f"[2, {max_tile(field)}], got {n}")
    if len(a) != field.n:
        raise ValueError(f"expected {field.n} word planes, got {len(a)}")
    rev = torch.from_numpy(ntt_mod._bit_rev_perm(n)).to(device)
    tw = tile_twiddles(field, n, inverse, device)
    if pre is None:
        # (..., n) -> (n, batch) -> bit-reversed rows -> (1, n, batch)
        x = tuple(l.reshape(-1, n).T.index_select(0, rev).unsqueeze(0).contiguous()
                  for l in a)
        pt = None
    else:
        # (..., r, n) with an (r, n) table -> (lead, n, r), table (n, r)
        r = shape[-2]
        if tuple(pre[0].shape) != (r, n):
            raise ValueError(f"pre must have shape {(r, n)}, got {tuple(pre[0].shape)}")
        x = tuple(l.reshape(-1, r, n).transpose(1, 2).index_select(1, rev).contiguous()
                  for l in a)
        pt = tuple(l.T.index_select(0, rev).contiguous() for l in pre)
    if plain or device.type == "cpu":
        out = tile_plain(field, x, tw, pt)
    elif device.type == "cuda":
        out = _tile_launch(field, x, tw, pt, inverse)
    else:
        raise ValueError(f"unsupported device {device}")
    if pre is None:
        return tuple(l[0].T.reshape(shape) for l in out)
    return tuple(l.transpose(1, 2).reshape(shape) for l in out)


def ntt_last_axis(field, a, inverse: bool, pre=None):
    """NTT along the LAST axis of word planes a (each (..., n)), natural
    order in and out, no 1/n scale: == LimbField.ntt(..., scale=False) of a
    tile.  ``pre``: optional (r, n) table for planes shaped (..., r, n),
    multiplied into the input before the transform (the four-step inner
    twiddle).  CPU tensors take ``tile_plain``; CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise."""
    return _ntt_last_axis(field, a, inverse, pre, plain=False)


def ntt_last_axis_plain(field, a, inverse: bool, pre=None):
    """Plain PyTorch version of ``ntt_last_axis`` on any device."""
    return _ntt_last_axis(field, a, inverse, pre, plain=True)
