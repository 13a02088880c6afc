"""Execution traces — equivalent of prover/src/trace/{mod,trace_table}.rs.

Counterpart of starkpack_winterfell_tpu/prover/trace.py cut to
``TraceTable``: column-major host staging filled by host builders, handed to
the device with one copy.  f64 traces stage numpy uint64 columns; f128
traces stage (lo, hi) uint64 planes (``from_u64_pairs``, or ``init`` from
python ints).  A multi-segment trace (trace/mod.rs:41-77) overrides
``get_info`` (``TraceInfo.new_multi_segment``), ``num_aux_segments`` and
``build_aux_segment``, which builds its segment on the device of the prove
(models/permutation.py).  Not ported: ``validate`` and the device-builder
hooks (``set_device_builder`` / ``device_planes``).
"""

from __future__ import annotations

import numpy as np

from ..air.trace_info import TraceInfo, TraceLayout
from ..math.fieldspec import FIELDS

_M64 = 0xFFFFFFFFFFFFFFFF


class TraceTable:
    """prover/src/trace/trace_table.rs:62 — main-segment-only trace."""

    def __init__(self, width: int, length: int, meta: bytes = b"", field: str = "f64"):
        assert 0 < width <= TraceInfo.MAX_TRACE_WIDTH
        assert length >= TraceInfo.MIN_TRACE_LENGTH and length & (length - 1) == 0
        self.width = width
        self.length = length
        self.meta = meta
        self.field = field
        self.spec = FIELDS[field]
        # word planes of the columns: one (width, length) uint64 array per
        # 64-bit word of an element, low word first
        self._planes = [
            np.zeros((width, length), dtype=np.uint64)
            for _ in range(self.spec.ELEMENT_BYTES // 8)
        ]

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_u64_columns(cls, columns: np.ndarray, meta: bytes = b"") -> "TraceTable":
        columns = np.asarray(columns, dtype=np.uint64)
        obj = cls(columns.shape[0], columns.shape[1], meta)
        obj._planes = [columns.copy()]
        return obj

    @classmethod
    def from_u64_pairs(cls, lo: np.ndarray, hi: np.ndarray, field: str,
                       meta: bytes = b"") -> "TraceTable":
        """From (width, length) u64 lo/hi planes of <= 128-bit canonical
        elements (filled by native builders)."""
        lo = np.asarray(lo, dtype=np.uint64)
        hi = np.asarray(hi, dtype=np.uint64)
        obj = cls(lo.shape[0], lo.shape[1], meta, field=field)
        assert len(obj._planes) == 2, f"{field} elements are not two words"
        obj._planes = [lo.copy(), hi.copy()]
        return obj

    @classmethod
    def init(cls, columns, field: str = "f64") -> "TraceTable":
        """From a list of per-column python-int lists (trace_table.rs:107)."""
        obj = cls(len(columns), len(columns[0]), field=field)
        for c, col in enumerate(columns):
            for step, v in enumerate(col):
                obj.set(c, step, v)
        return obj

    def fill(self, init_fn, update_fn):
        """Sequential builder (trace_table.rs:230-243): ``init_fn(state)``
        seeds row 0, ``update_fn(step, state)`` computes row step+1 from row
        step.  ``state`` is a list of python ints."""
        state = [0] * self.width
        init_fn(state)
        for c, s in enumerate(state):
            self.set(c, 0, s)
        for i in range(self.length - 1):
            update_fn(i, state)
            for c, s in enumerate(state):
                self.set(c, i + 1, s)

    # -- accessors -----------------------------------------------------------

    def get(self, column: int, step: int) -> int:
        return sum(int(p[column, step]) << (64 * i) for i, p in enumerate(self._planes))

    def set(self, column: int, step: int, value: int):
        value %= self.spec.P
        for i, p in enumerate(self._planes):
            p[column, step] = (value >> (64 * i)) & _M64

    def get_info(self) -> TraceInfo:
        return TraceInfo(self.width, self.length, self.meta)

    def layout(self) -> TraceLayout:
        return self.get_info().layout

    def main_columns_u64(self) -> np.ndarray:
        assert self.field == "f64"
        return self._planes[0]

    def main_segment_limbs(self, backend=None, device="cpu"):
        """Main segment as a tuple-of-1 component of int64 word planes shaped
        (width, length) on ``device`` (one copy per plane)."""
        from ..ops import gl64 as gl

        return (tuple(gl.from_u64(p, device) for p in self._planes),)

    def num_aux_segments(self) -> int:
        return 0

    def build_aux_segment(self, seg_idx: int, rand_elements, backend, device):
        """Auxiliary segment ``seg_idx`` built from the random elements drawn
        for it (trace/mod.rs:60-77): element comps of ``backend`` shaped
        (segment width, length) on ``device``.  Multi-segment traces
        override it."""
        raise NotImplementedError(f"{type(self).__name__} has no auxiliary segments")

    def read_row(self, step: int):
        return [self.get(c, step) for c in range(self.width)]
