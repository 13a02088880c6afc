"""Execution traces — equivalent of prover/src/trace/{mod,trace_table}.rs.

Counterpart of starkpack_winterfell_tpu/prover/trace.py cut to the f64
main-segment ``TraceTable``: column-major numpy uint64 staging filled by
host builders, handed to the device with one copy.  Not ported: the limb
fields' python-int staging, ``from_u64_pairs``, ``validate`` and the
device-builder hooks (``set_device_builder`` / ``device_planes``).
"""

from __future__ import annotations

import numpy as np

from ..air.trace_info import TraceInfo, TraceLayout
from ..math import scalar as fs


class TraceTable:
    """prover/src/trace/trace_table.rs:62 — main-segment-only trace."""

    field = "f64"

    def __init__(self, width: int, length: int, meta: bytes = b""):
        assert 0 < width <= TraceInfo.MAX_TRACE_WIDTH
        assert length >= TraceInfo.MIN_TRACE_LENGTH and length & (length - 1) == 0
        self.width = width
        self.length = length
        self.meta = meta
        self._columns = np.zeros((width, length), dtype=np.uint64)

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_u64_columns(cls, columns: np.ndarray, meta: bytes = b"") -> "TraceTable":
        columns = np.asarray(columns, dtype=np.uint64)
        obj = cls(columns.shape[0], columns.shape[1], meta)
        obj._columns = columns.copy()
        return obj

    @classmethod
    def init(cls, columns) -> "TraceTable":
        """From a list of per-column python-int lists (trace_table.rs:107)."""
        return cls.from_u64_columns(np.array(columns, dtype=np.uint64))

    def fill(self, init_fn, update_fn):
        """Sequential builder (trace_table.rs:230-243): ``init_fn(state)``
        seeds row 0, ``update_fn(step, state)`` computes row step+1 from row
        step.  ``state`` is a list of python ints."""
        state = [0] * self.width
        init_fn(state)
        self._columns[:, 0] = [s % fs.P for s in state]
        for i in range(self.length - 1):
            update_fn(i, state)
            self._columns[:, i + 1] = [s % fs.P for s in state]

    # -- accessors -----------------------------------------------------------

    def get(self, column: int, step: int) -> int:
        return int(self._columns[column, step])

    def set(self, column: int, step: int, value: int):
        self._columns[column, step] = value % fs.P

    def get_info(self) -> TraceInfo:
        return TraceInfo(self.width, self.length, self.meta)

    def layout(self) -> TraceLayout:
        return self.get_info().layout

    def main_columns_u64(self) -> np.ndarray:
        return self._columns

    def num_aux_segments(self) -> int:
        return 0

    def read_row(self, step: int):
        return [int(v) for v in self._columns[:, step]]
