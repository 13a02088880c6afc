"""Tile NTT over limb-field word planes on a hand-written CUDA kernel.

Counterpart of starkpack_winterfell_tpu/ops/pallas/limb_kernel.py.  ``tile``
is the kernel-level function: every radix-2 DIT stage of length-n NTTs along
axis 2 of a logical (G, D, n_in, lanes) array of word planes — natural order
in (the kernel bit-reverses on the load) and out, a batch of G groups of D
transforms of ``lanes`` lanes each — read and written through the planes'
strides, so a transform along the contiguous axis, a transposed store, a
broadcast input (stride 0) and an interleaved store are strides, not copies.
Options: zero padding of the n_in rows to n, a pre-multiply table, a row
factor (G, n_in) and a column factor (G, lanes) of each group multiplied
into the input, and a scale word multiplied into the output.  It is the
f128 / f62 instantiation of the DIT tile frame ``csrc/dit_tile.cuh`` (built
from ``csrc/limb_ntt_tile.cu``), which replaces the Pallas kernel
``_make_kernel`` / ``_build_call``.  ``tile_plain`` is the same function in
plain PyTorch; ``tile`` takes it only for tensors that lie on the CPU and
launches the kernel for CUDA tensors or raises.

``ntt_last_axis`` is the entry the field code calls for one tile: a
transform along the LAST axis of planes shaped (..., n), natural order in
and out, one launch on the caller's layout.  ``ops/limb_field.py`` builds
the four-step split, the coset LDE and its interleave on ``tile`` directly.

Bound on an H100: a call reads the planes once and writes them once (32
bytes per f128 element, 16 per f62 element, against 3.35 TB/s) and does
log2(n)/2 butterflies per element, one field multiply, add and subtract
each, plus a multiply per element and table or factor, against the card's
integer pipes (csrc/gl64_sass_count.py); the operations are the larger
bound from n = 4 up.
"""

from __future__ import annotations

import collections
import ctypes
import os

import torch

from . import ntt as ntt_mod
from ..native import launch

MAX_TILE_N = 4096  # longest transform of one launch, both fields
SMEM_PER_SM = 228 * 1024  # shared memory of one H100 SM, in bytes
SMEM_PER_BLOCK = 227 * 1024  # the most one block can have
# a block's tile where n and the lanes allow, by element form: f62 runs
# faster at half the tile of the others (kernel_times.py --only k34 --variants)
TARGET_TILE_BYTES = {"gl64": 64 * 1024, "f128": 64 * 1024, "f62": 32 * 1024}
MIN_LANES_PER_BLOCK = 4  # a 32-byte segment of a row per plane
MIN_BLOCKS = 2 * 132  # blocks to aim for, two for each SM of an H100
MAX_THREADS = 256
# stages a thread runs in registers between two exchanges through shared
# memory: csrc/dit_tile.cuh's DIT_RADIX_LOG, for every field
RADIX_LOG = 3

# launches of the CUDA kernel made by ``tile`` (and nowhere else): the total,
# and the same launches split by ``shape_key``
LAUNCHES = 0
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()

_TW_CACHE: dict = {}
_LIB = None


def max_tile(field) -> int:
    """Longest tile transform of one launch (4096 for both fields)."""
    return MAX_TILE_N


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

        p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
        sig = [p] * 12 + [u64, u64, i, p] + [i] * 9 + [p]
        _LIB = load_kernels("starklimbntt", kernel_sources(), "limb_ntt_tile_init", {
            "dit_tile_f128_launch": sig, "dit_tile_f62_launch": sig,
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


def tile_plain(field, x, tw, n: int = None, pre=None, row=None, col=None, scale: int = None):
    """Plain PyTorch version of the tile kernel.  x: word planes (G, D,
    n_in, lanes); pre: (n_in, lanes); row: (G, n_in); col: (G, lanes);
    scale: a field element.  x times the tables given, zero-padded to n rows
    (default n_in), all DIT stages along axis 2 (natural rows in: they are
    bit-reversed first; natural rows out), times ``scale``.  Returns
    contiguous (G, D, n, lanes) planes."""
    G, D, n_in, lanes = x[0].shape
    n = n_in if n is None else n
    device = x[0].device
    if pre is not None:
        x = field.mul(x, pre)
    if row is not None:
        x = field.mul(x, tuple(l.reshape(G, 1, n_in, 1) for l in row))
    if col is not None:
        x = field.mul(x, tuple(l.reshape(G, 1, 1, lanes) for l in col))
    x = tuple(l.expand(G, D, n_in, lanes).reshape(G * D, n_in, lanes) for l in x)
    if n_in < n:
        x = tuple(torch.cat([l, torch.zeros((G * D, n - n_in, lanes), dtype=torch.int64,
                                            device=device)], dim=1) for l in x)
    rev = torch.from_numpy(ntt_mod._bit_rev_perm(n)).to(device)
    x = tuple(l.index_select(1, rev) for l in x)
    B = G * D
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
    if scale is not None:
        x = field.mul(x, field.from_int(scale, (), device))
    return tuple(l.reshape(G, D, n, lanes) for l in x)


def block_shape(el_bytes: int, n: int, B: int, lanes: int, lanes_contiguous: bool,
                target: int = TARGET_TILE_BYTES["gl64"]):
    """(log2 of the lanes one block stages, K, threads of the block) of a
    launch of the DIT tile frame (csrc/dit_tile.cuh) on elements of
    ``el_bytes`` bytes, B batch entries of ``lanes`` lanes.

    The lane group LG is the largest power of two whose block (the (n/2,)
    twiddles and the (n, LG) tile) lets two blocks share an SM and whose tile
    stays within ``target`` bytes, capped at the next power of two >= lanes;
    then halved while the grid has fewer than MIN_BLOCKS blocks, down to
    MIN_LANES_PER_BLOCK where a row's lanes lie side by side in memory (a
    32-byte segment a plane) and to 1 where they do not.  K = RADIX_LOG
    stages a pass; a pass of (n / 2^K) * LG tasks runs up to MAX_THREADS of
    them at once."""

    def smem(lg):
        return el_bytes * (n // 2 + n * lg)

    lg = 1
    while (lg < lanes and 2 * smem(2 * lg) <= SMEM_PER_SM
           and el_bytes * n * 2 * lg <= target):
        lg *= 2
    floor = MIN_LANES_PER_BLOCK if lanes_contiguous else 1
    while lg > floor and B * -(-lanes // lg) < MIN_BLOCKS:
        lg //= 2
    if smem(lg) > SMEM_PER_BLOCK:
        raise ValueError(f"a length-{n} tile of {el_bytes}-byte elements does not fit a block")
    tasks = (n >> min(RADIX_LOG, n.bit_length() - 1)) * lg
    return lg.bit_length() - 1, RADIX_LOG, min(MAX_THREADS, max(32, tasks))


def _block_shape(field, n: int, B: int, lanes: int, lanes_contiguous: bool):
    """``block_shape`` of a launch on ``field``'s elements."""
    return block_shape(8 * field.n, n, B, lanes, lanes_contiguous,
                       TARGET_TILE_BYTES[field.NAME])


def shape_key(field, inverse, x, n, out, pre, row, col, scale):
    """The launch-count key of one ``tile`` call: (field, inverse, G, D, n,
    n_in, lanes, x strides, output strides, pre strides or None, has row,
    has col, has scale), strides as ``key_strides`` gives them."""
    G, D, n_in, lanes = x[0].shape
    return (field.NAME, bool(inverse), G, D, n, n_in, lanes, key_strides(x[0]),
            key_strides(out[0]), key_strides(pre[0]) if pre is not None else None,
            row is not None, col is not None, scale is not None)


def key_strides(t) -> tuple:
    """t's strides as a launch-count key holds them: 0 along an axis of
    length 1, where the stride is never read."""
    return tuple(0 if size == 1 else st for size, st in zip(t.shape, t.stride()))


def launch_args(field, x, tw, n, pre, row, col, scale, out):
    """The arguments of ``dit_tile_<field>_launch`` (csrc/limb_ntt_tile.cu)
    before the stream, for checked planes (``tile``): pointers, the scale
    words, the strides, the sizes, the block shape (``_block_shape``) and
    the task mappings, rows fastest where the rows of x (of the output) lie
    closer together than its lanes."""
    G, D, n_in, lanes = x[0].shape
    xs, os_ = x[0].stride(), out[0].stride()
    ps = pre[0].stride() if pre is not None else (0, 0)
    rows_in = xs[2] < xs[3]
    log_lg, _, threads = _block_shape(field, n, G * D, lanes, not rows_in)

    def ptrs(planes):
        # (low plane, high plane); a one-word field has no high plane
        got = [l.data_ptr() for l in planes] if planes is not None else []
        return got + [None] * (2 - len(got))

    s = 0 if scale is None else int(scale) % field.P
    return [*ptrs(x), *ptrs(out), *ptrs(tw), *ptrs(pre), *ptrs(row), *ptrs(col),
            s & 0xFFFFFFFFFFFFFFFF, s >> 64, int(scale is not None),
            (ctypes.c_longlong * 10)(*xs, *os_, *ps), G * D, n, n_in, lanes, log_lg, G,
            int(rows_in), int(os_[2] < os_[3]), threads]


def tile(field, x, tw, n: int = None, pre=None, row=None, col=None, scale: int = None,
         out=None, inverse: bool = False):
    """Tile NTT of x (G, D, n_in, lanes) planes, any strides; see
    ``tile_plain``.  ``out``: (G, D, n, lanes) planes to write, any strides
    that do not overlap (default: new contiguous planes); returned.
    ``inverse`` names the twiddles' direction in the launch count.

    CPU tensors take the plain version.  CUDA tensors launch the kernel of
    csrc/limb_ntt_tile.cu on the current stream (no synchronisation) or
    raise."""
    global LAUNCHES
    if len(x) != field.n or x[0].dim() != 4:
        raise ValueError(f"expected {field.n} word planes shaped (G, D, n, lanes)")
    G, D, n_in, lanes = x[0].shape
    n = n_in if n is None else n
    if n < 2 or n & (n - 1) or n > max_tile(field) or not 1 <= n_in <= n:
        raise ValueError(f"tile length must be a power of two in [2, {max_tile(field)}] "
                         f"at least the {n_in} input rows, got {n}")
    device = x[0].device
    shapes = [("x", x, (G, D, n_in, lanes)), ("tw", tw, (n // 2,)),
              ("pre", pre, (n_in, lanes)), ("row", row, (G, n_in)), ("col", col, (G, lanes)),
              ("out", out, (G, D, n, lanes))]
    for name, planes, shape in shapes:
        if planes is None:
            continue
        if len(planes) != field.n:
            raise ValueError(f"{name} must have {field.n} word planes")
        for l in planes:
            if l.dtype != torch.int64 or tuple(l.shape) != shape or l.device != device:
                raise ValueError(f"{name} planes must be int64 {shape} on {device}")
            if l.stride() != planes[0].stride():
                raise ValueError(f"{name} planes must share their strides")
    if device.type == "cpu":
        got = tile_plain(field, x, tw, n, pre, row, col, scale)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return out
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if field.NAME not in ("f128", "f62"):
        raise NotImplementedError(f"no limb NTT kernel for field {field.NAME}")
    for name, planes in (("tw", tw), ("row", row), ("col", col)):
        if planes is not None and not all(l.is_contiguous() for l in planes):
            raise ValueError(f"{name} planes must be contiguous")
    if out is None:
        out = tuple(torch.empty((G, D, n, lanes), dtype=torch.int64, device=device)
                    for _ in range(field.n))
    if G * D == 0 or lanes == 0:
        return out
    rc = launch(_lib()[f"dit_tile_{field.NAME}_launch"], device,
                *launch_args(field, x, tw, n, pre, row, col, scale, out))
    if rc != 0:
        raise RuntimeError(
            f"limb dit_tile kernel launch failed: cudaError {rc} "
            f"(field={field.NAME}, G={G}, D={D}, n={n}, lanes={lanes})")
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[shape_key(field, inverse, x, n, out, pre, row, col, scale)] += 1
    return out


# ---------------------------------------------------------------------------
# the entry the field code calls for one tile
# ---------------------------------------------------------------------------


def _ntt_last_axis(field, a, inverse: bool, scale, plain: bool):
    shape = a[0].shape
    n = shape[-1]
    if n < 2 or n & (n - 1) or n > max_tile(field):
        raise ValueError(f"tile length must be a power of two in "
                         f"[2, {max_tile(field)}], got {n}")
    if len(a) != field.n:
        raise ValueError(f"expected {field.n} word planes, got {len(a)}")
    # (..., n) -> (1, 1, n, batch) views: rows of x along the transform axis
    x = tuple(l.reshape(-1, n).T[None, None] for l in a)
    tw = tile_twiddles(field, n, inverse, a[0].device)
    if plain:
        out = tile_plain(field, x, tw, None, None, None, None, scale)
        return tuple(l[0, 0].T.reshape(shape) for l in out)
    out = tuple(torch.empty(shape, dtype=torch.int64, device=a[0].device) for _ in a)
    tile(field, x, tw, scale=scale, out=tuple(l.reshape(-1, n).T[None, None] for l in out),
         inverse=inverse)
    return out


def ntt_last_axis(field, a, inverse: bool, scale: int = None):
    """NTT along the LAST axis of word planes a (each (..., n)), natural
    order in and out, times the field element ``scale`` if given (the
    inverse's 1/n): one ``tile`` launch on the caller's layout.  CPU tensors
    take the plain version; CUDA tensors launch the kernel on the current
    stream (no synchronisation) or raise."""
    return _ntt_last_axis(field, a, inverse, scale, plain=False)


def ntt_last_axis_plain(field, a, inverse: bool, scale: int = None):
    """Plain PyTorch version of ``ntt_last_axis`` on any device."""
    return _ntt_last_axis(field, a, inverse, scale, plain=True)
