"""Conversions between host scalar elements (ints/tuples), element tensors
and hash-word layouts, plus the bridge to the JAX package's representation.

Counterpart of starkpack_winterfell_tpu/utils/convert.py on the one-word
representation (ops/gl64.py).  ``from_limb_pairs`` / ``to_limb_pairs`` /
``trace_from_u64_columns`` carry data across from the JAX package's
``(lo, hi)`` u32-pair arrays (handed over as numpy), so both packages can
prove the same statement from the same numpy data; ``from_limb_planes`` /
``to_limb_planes`` do the same for the limb fields' k-tuples of u32 planes
(k = 4 for f128, k = 2 for a 64-bit field) and the port's word planes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math import scalar as fs
from ..ops import gl64 as gl


def limbs_to_elems(comps, deg: int):
    """Tuple of ``deg`` tensors with shape (n,) -> list of ints/tuples."""
    u64s = [gl.to_u64(c) for c in comps]
    n = u64s[0].shape[0]
    if deg == 1:
        return [int(v) for v in u64s[0]]
    return [tuple(int(u64s[c][i]) for c in range(deg)) for i in range(n)]


def rows_to_words(comps, deg: int):
    """Row data -> BLAKE3 word layout.

    comps: tuple of ``deg`` tensors, each shaped (..., W) where W is the
    number of elements per row.  Elements serialize as canonical LE u64 per
    component in order, i.e. words [c0.lo, c0.hi, c1.lo, c1.hi, ...] per
    element.  Returns a (..., W * deg * 2) int64 tensor of u32 values.
    """
    parts = []
    for c in range(deg):
        x = comps[c]
        parts.append(torch.stack([x & gl.MASK32, (x >> 32) & gl.MASK32], dim=-1))
    stacked = torch.stack(parts, dim=-2)  # (..., W, deg, 2)
    shape = stacked.shape[:-3] + (stacked.shape[-3] * deg * 2,)
    return stacked.reshape(shape)


def scalar_to_limbs(v, deg: int, shape=(1,), device="cpu"):
    """Single element -> tuple of ``deg`` tensors broadcast to shape."""
    comps = fs.components(fs.embed(v, deg))
    return tuple(gl.from_int(c, shape, device) for c in comps)


# ---------------------------------------------------------------------------
# bridge to the JAX package's u32-pair representation
# ---------------------------------------------------------------------------


def from_limb_pairs(pair, device="cpu") -> torch.Tensor:
    """(lo, hi) uint32 numpy arrays -> one-word tensor."""
    lo = np.asarray(pair[0], dtype=np.uint64)
    hi = np.asarray(pair[1], dtype=np.uint64)
    return gl.from_u64(lo | (hi << np.uint64(32)), device)


def to_limb_pairs(t: torch.Tensor):
    """One-word tensor -> (lo, hi) uint32 numpy arrays."""
    u = gl.to_u64(t)
    return (
        (u & np.uint64(gl.MASK32)).astype(np.uint32),
        (u >> np.uint64(32)).astype(np.uint32),
    )


def ext_from_limb_pairs(comps, device="cpu"):
    """Tuple of (lo, hi) pairs (one per extension component) -> ext tuple."""
    return tuple(from_limb_pairs(c, device) for c in comps)


def ext_to_limb_pairs(comps):
    return tuple(to_limb_pairs(c) for c in comps)


def from_limb_planes(planes, device="cpu"):
    """k-tuple of uint32 numpy limb planes (little-endian limbs, k even) ->
    k/2-tuple of word planes: word i joins limbs 2i and 2i+1."""
    assert len(planes) % 2 == 0
    return tuple(
        from_limb_pairs((planes[2 * i], planes[2 * i + 1]), device)
        for i in range(len(planes) // 2)
    )


def to_limb_planes(t):
    """Tuple of word planes -> the k-tuple of uint32 numpy limb planes."""
    out = []
    for plane in t:
        out.extend(to_limb_pairs(plane))
    return tuple(out)


def trace_from_u64_columns(columns: np.ndarray):
    """(width, length) numpy uint64 columns (e.g. the JAX package's
    ``build_chain_trace(...).main_columns_u64()``) -> the port's TraceTable."""
    from ..prover.trace import TraceTable

    return TraceTable.from_u64_columns(np.asarray(columns, dtype=np.uint64))
