# Copy of starkpack_winterfell_tpu/utils/serde.py; cut: nothing.
"""Canonical byte encoding — equivalent of utils/core/src/serde/*.

All integers little-endian (byte_writer.rs:41-63); field elements are written
as canonical values, 8 LE bytes per base component (f64/mod.rs:607-612;
extension components in order, extensions/quadratic.rs / cubic.rs).
"""

from __future__ import annotations

P = 0xFFFFFFFF00000001


class ByteWriter:
    def __init__(self):
        self.buf = bytearray()

    def write_u8(self, v: int):
        self.buf.append(v & 0xFF)

    def write_bool(self, v: bool):
        self.write_u8(1 if v else 0)

    def write_u16(self, v: int):
        self.buf += int(v).to_bytes(2, "little")

    def write_u32(self, v: int):
        self.buf += int(v).to_bytes(4, "little")

    def write_u64(self, v: int):
        self.buf += int(v).to_bytes(8, "little")

    def write_bytes(self, b: bytes):
        self.buf += b

    def write_felt(self, v, elem_bytes: int = 8):
        """Write a field element given as int (base) or tuple of ints (ext);
        each base component is `elem_bytes` canonical LE bytes (8 for
        f64/f62, 16 for f128)."""
        if isinstance(v, int):
            self.buf += int(v).to_bytes(elem_bytes, "little")
        else:
            for c in v:
                self.buf += int(c).to_bytes(elem_bytes, "little")

    def write_felts(self, vs, elem_bytes: int = 8):
        # flatten ext tuples, then emit all components in one C-level pass
        # (int.to_bytes per element dominates hash_elements at 8-byte width)
        flat = []
        for v in vs:
            if isinstance(v, int):
                flat.append(v)
            else:
                flat.extend(v)
        if elem_bytes == 8:
            import numpy as np

            self.buf += np.asarray(flat, dtype=np.uint64).tobytes()
        else:
            for c in flat:
                self.buf += int(c).to_bytes(elem_bytes, "little")

    def to_bytes(self) -> bytes:
        return bytes(self.buf)


class SliceReader:
    """Equivalent of utils/core/src/serde/byte_reader.rs:124 SliceReader."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(
                f"deserialization error: expected {n} more bytes at {self.pos}, "
                f"have {len(self.data) - self.pos}"
            )
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_u8(self) -> int:
        return self._take(1)[0]

    def read_bool(self) -> bool:
        v = self.read_u8()
        if v > 1:
            raise ValueError(f"invalid bool byte {v}")
        return v == 1

    def read_u16(self) -> int:
        return int.from_bytes(self._take(2), "little")

    def read_u32(self) -> int:
        return int.from_bytes(self._take(4), "little")

    def read_u64(self) -> int:
        return int.from_bytes(self._take(8), "little")

    def read_bytes(self, n: int) -> bytes:
        return self._take(n)

    def read_felt(self, deg: int = 1, modulus: int = P, elem_bytes: int = 8):
        """Read a field element; returns int (deg 1) or tuple (deg 2/3).
        Validates canonicity like f64/mod.rs Deserializable (value < M)."""
        comps = []
        for _ in range(deg):
            v = int.from_bytes(self._take(elem_bytes), "little")
            if v >= modulus:
                raise ValueError(f"invalid field element {v} >= modulus")
            comps.append(v)
        return comps[0] if deg == 1 else tuple(comps)

    def read_felts(self, n: int, deg: int = 1, modulus: int = P, elem_bytes: int = 8):
        """Read n field elements — vectorized: one numpy decode of the whole
        slab with a single canonicity check, then python ints (identical
        values and error behavior to a per-element read_felt loop)."""
        if n == 0:
            return []
        if elem_bytes == 8:
            import numpy as _np

            raw = self._take(n * deg * 8)
            arr = _np.frombuffer(raw, dtype="<u8")
            if int(arr.max()) >= modulus:
                raise ValueError("invalid field element >= modulus")
            vals = arr.tolist()
        elif elem_bytes == 16:
            import numpy as _np

            raw = self._take(n * deg * 16)
            pairs = _np.frombuffer(raw, dtype="<u8").reshape(-1, 2).tolist()
            vals = [lo | (hi << 64) for lo, hi in pairs]
            if max(vals) >= modulus:
                raise ValueError("invalid field element >= modulus")
        else:
            return [self.read_felt(deg, modulus, elem_bytes) for _ in range(n)]
        if deg == 1:
            return vals
        return [tuple(vals[i * deg : (i + 1) * deg]) for i in range(n)]

    def has_more(self) -> bool:
        return self.pos < len(self.data)

    def remaining(self) -> int:
        return len(self.data) - self.pos
