# Copy of starkpack_winterfell_tpu/air/trace_info.py; cut: nothing.
"""TraceInfo / TraceLayout — equivalent of air/src/air/trace_info.rs."""

from __future__ import annotations

from ..utils.serde import ByteWriter, SliceReader

NUM_AUX_SEGMENTS = 1


class TraceLayout:
    """trace_info.rs:158 — main width + aux widths + aux rand counts."""

    def __init__(self, main_width: int, aux_widths=(0,), aux_rands=(0,)):
        # explicit raises: TraceLayout is parsed from untrusted proof bytes
        # via read_from, so bound violations must reject deterministically
        from ..errors import DeserializationError

        if main_width <= 0:
            raise DeserializationError(
                "main trace segment must have at least one column"
            )
        full_width = main_width + sum(aux_widths)
        if full_width > 255:
            raise DeserializationError("total trace width cannot exceed 255")
        num_aux = 0
        was_zero = False
        for w, r in zip(aux_widths, aux_rands):
            if w != 0:
                if was_zero:
                    raise DeserializationError(
                        "non-empty segment cannot follow an empty one"
                    )
                if r <= 0:
                    raise DeserializationError(
                        "non-empty aux segment needs random elements"
                    )
                num_aux += 1
            else:
                if r != 0:
                    raise DeserializationError(
                        "empty aux segment cannot require random elements"
                    )
                was_zero = True
            if r > 255:
                raise DeserializationError("too many aux random elements")
        self.main_segment_width = main_width
        self.aux_segment_widths = tuple(aux_widths)
        self.aux_segment_rands = tuple(aux_rands)
        self.num_aux_segments = num_aux

    def main_trace_width(self) -> int:
        return self.main_segment_width

    def aux_trace_width(self) -> int:
        return sum(self.aux_segment_widths)

    def num_segments(self) -> int:
        return self.num_aux_segments + 1

    def get_aux_segment_width(self, idx: int) -> int:
        return self.aux_segment_widths[idx]

    def get_aux_segment_rand_elements(self, idx: int) -> int:
        return self.aux_segment_rands[idx]

    def to_elements(self):
        """trace_info.rs:273-297."""
        buf = self.main_segment_width
        buf = (buf << 8) | self.num_aux_segments
        if self.num_aux_segments == 1:
            buf = (buf << 8) | self.aux_segment_widths[0]
            buf = (buf << 8) | self.aux_segment_rands[0]
        result = [buf]
        for i in range(1, self.num_aux_segments):
            result.append((self.aux_segment_widths[i] << 8) | self.aux_segment_rands[i])
        return result

    def write_into(self, w: ByteWriter):
        w.write_u8(self.main_segment_width)
        for x in self.aux_segment_widths:
            w.write_u8(x)
        for x in self.aux_segment_rands:
            w.write_u8(x)

    @classmethod
    def read_from(cls, r: SliceReader) -> "TraceLayout":
        main_width = r.read_u8()
        aux_widths = tuple(r.read_u8() for _ in range(NUM_AUX_SEGMENTS))
        aux_rands = tuple(r.read_u8() for _ in range(NUM_AUX_SEGMENTS))
        return cls(main_width, aux_widths, aux_rands)

    def __eq__(self, other):
        return isinstance(other, TraceLayout) and self.__dict__ == other.__dict__


class TraceInfo:
    """trace_info.rs:27 — MIN_TRACE_LENGTH=8, MAX_TRACE_WIDTH=255."""

    MIN_TRACE_LENGTH = 8
    MAX_TRACE_WIDTH = 255
    MAX_META_BYTES = 65535
    MAX_RAND_SEGMENT_ELEMENTS = 255

    def __init__(self, width: int, length: int, meta: bytes = b""):
        self.layout = TraceLayout(width)
        self._init_common(length, meta)

    @classmethod
    def new_multi_segment(cls, layout: TraceLayout, length: int, meta: bytes = b"") -> "TraceInfo":
        obj = cls.__new__(cls)
        obj.layout = layout
        obj._init_common(length, meta)
        return obj

    def _init_common(self, length: int, meta: bytes):
        assert length >= self.MIN_TRACE_LENGTH, "trace too short"
        assert length & (length - 1) == 0, "trace length must be a power of two"
        assert len(meta) <= self.MAX_META_BYTES
        self.length = length
        self.meta = bytes(meta)

    def width(self) -> int:
        return self.layout.main_trace_width() + self.layout.aux_trace_width()

    def main_trace_width(self) -> int:
        return self.layout.main_trace_width()

    def is_multi_segment(self) -> bool:
        return self.layout.num_aux_segments > 0

    def __eq__(self, other):
        return (
            isinstance(other, TraceInfo)
            and self.layout == other.layout
            and self.length == other.length
            and self.meta == other.meta
        )
