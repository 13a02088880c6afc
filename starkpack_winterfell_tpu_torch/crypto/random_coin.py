# Copy of starkpack_winterfell_tpu/crypto/random_coin.py; cut: nothing.
"""Fiat-Shamir random coin — exact port of the *semantics* of
crypto/src/random/default.rs (DefaultRandomCoin).

This is the strictly-sequential heart of the transcript; it lives on the
host.  Every quirk is preserved:

* ``leading_zeros``/``check_leading_zeros`` actually count *trailing* zeros
  of the first 8 seed bytes read little-endian (default.rs:173-186) — the
  proof-of-work check depends on this.
* ``draw`` rejection-samples: hash(seed || ++counter), take the first
  ELEMENT_BYTES, accept iff every 8-byte base component is < modulus
  (default.rs:196-210 + f64/mod.rs TryFrom).
* ``draw_integers`` masks the first 8 LE bytes and skips duplicates
  (default.rs:245-290).
"""

from __future__ import annotations

P = 0xFFFFFFFF00000001


class RandomCoin:
    def __init__(self, hasher, seed_elements, field=None):
        """seed_elements: list of ints/tuples — hashed via hash_elements
        (default.rs:85-88).  ``field``: a FieldSpec (defaults to f64) that
        sets the per-component byte width and modulus for draws."""
        self.h = hasher
        if field is None:
            from ..math.fieldspec import GL64_SPEC as field
        self.field = field
        self.seed = hasher.hash_elements(seed_elements, field.ELEMENT_BYTES)
        self.counter = 0
        self._cache = []
        self._cache_start = 0

    @classmethod
    def from_digest(cls, hasher, seed_digest: bytes, field=None):
        coin = cls.__new__(cls)
        coin.h = hasher
        if field is None:
            from ..math.fieldspec import GL64_SPEC as field
        coin.field = field
        coin.seed = seed_digest
        coin.counter = 0
        coin._cache = []
        coin._cache_start = 0
        return coin

    def _next(self) -> bytes:
        """H(seed || ++counter).  Values are precomputed in vectorized blocks
        when the hasher supports batching — one numpy hash call covers a
        whole run of draws between reseeds (bit-identical values; draws from
        a fixed seed differ only in the counter)."""
        self.counter += 1
        idx = self.counter - self._cache_start
        if 0 <= idx < len(self._cache):
            return self._cache[idx]
        batched = getattr(self.h, "merge_with_int_many", None)
        if batched is None:
            return self.h.merge_with_int(self.seed, self.counter)
        block = min(max(16, 2 * len(self._cache)), 512)
        self._cache = batched(self.seed, range(self.counter, self.counter + block))
        self._cache_start = self.counter
        return self._cache[0]

    def reseed(self, data: bytes):
        self.seed = self.h.merge(self.seed, data)
        self.counter = 0
        self._cache = []

    def reseed_with_int(self, value: int):
        self.seed = self.h.merge_with_int(self.seed, value)
        self.counter = 0
        self._cache = []

    def leading_zeros(self) -> int:
        head = int.from_bytes(self.seed[:8], "little")
        return _trailing_zeros(head)

    def check_leading_zeros(self, value: int) -> int:
        new_seed = self.h.merge_with_int(self.seed, value)
        head = int.from_bytes(new_seed[:8], "little")
        return _trailing_zeros(head)

    def draw(self, deg: int = 1):
        """Draw a field element: int for deg 1, tuple for deg 2/3.  Takes the
        first deg * ELEMENT_BYTES of each PRNG value, rejecting non-canonical
        components (default.rs:196-210 + TryFrom per field)."""
        eb = self.field.ELEMENT_BYTES
        modulus = self.field.P
        for _ in range(1000):
            value = self._next()
            comps = []
            ok = True
            for i in range(deg):
                v = int.from_bytes(value[i * eb : (i + 1) * eb], "little")
                if v >= modulus:
                    ok = False
                    break
                comps.append(v)
            if ok:
                return comps[0] if deg == 1 else tuple(comps)
        raise RuntimeError("failed to draw a valid field element after 1000 tries")

    def draw_many(self, k: int, deg: int = 1):
        """k sequential draws — identical values and counter advancement to k
        ``draw`` calls, but the PRNG block is parsed vectorized (one numpy
        pass instead of k python int.from_bytes loops).  Rejected digests are
        consumed exactly as the scalar path does."""
        if k <= 0:
            return []
        batched = getattr(self.h, "merge_with_int_many", None)
        eb = self.field.ELEMENT_BYTES
        if batched is None or eb not in (8, 16) or k < 16:
            # below ~16 draws the numpy parse overhead exceeds the loop
            return [self.draw(deg) for _ in range(k)]
        import numpy as np

        modulus = self.field.P
        nbytes = deg * eb
        out = []
        for _ in range(1000):
            if len(out) >= k:
                break
            idx = self.counter + 1 - self._cache_start
            if not (0 <= idx < len(self._cache)):
                start = self.counter + 1
                block = min(512, max(16, k - len(out) + 8))
                self._cache = batched(self.seed, range(start, start + block))
                self._cache_start = start
                idx = 0
            digests = self._cache[idx:]
            if len(digests[0]) < nbytes:
                # digest shorter than deg*eb (e.g. blake3_192 + f128 quad):
                # keep the scalar path's short-read semantics
                out.extend(self.draw(deg) for _ in range(k - len(out)))
                return out
            m = len(digests)
            buf = np.frombuffer(
                b"".join(d[:nbytes] for d in digests), dtype="<u8"
            ).reshape(m, nbytes // 8)
            if eb == 8:
                ok = (buf < modulus).all(axis=1)
            else:
                lo, hi = buf[:, 0::2], buf[:, 1::2]
                p_lo = modulus & 0xFFFFFFFFFFFFFFFF
                p_hi = modulus >> 64
                ok = ((hi < p_hi) | ((hi == p_hi) & (lo < p_lo))).all(axis=1)
            acc = np.flatnonzero(ok)
            take = min(k - len(out), len(acc))
            if take == 0:
                self.counter += m
                continue
            for i in acc[:take]:
                row = buf[i]
                if eb == 8:
                    comps = tuple(int(v) for v in row)
                else:
                    comps = tuple(
                        int(row[2 * c]) | (int(row[2 * c + 1]) << 64)
                        for c in range(deg)
                    )
                out.append(comps[0] if deg == 1 else comps)
            self.counter += int(acc[take - 1]) + 1
        if len(out) < k:
            raise RuntimeError("failed to draw enough valid field elements")
        return out

    def draw_integers(self, num_values: int, domain_size: int):
        assert domain_size & (domain_size - 1) == 0, "domain size must be a power of two"
        assert num_values < domain_size
        v_mask = domain_size - 1
        values = []
        for _ in range(1000):
            value = int.from_bytes(self._next()[:8], "little") & v_mask
            if value in values:
                continue
            values.append(value)
            if len(values) == num_values:
                break
        if len(values) < num_values:
            raise RuntimeError("failed to draw enough unique query positions")
        return values


def _trailing_zeros(v: int) -> int:
    if v == 0:
        return 64
    return (v & -v).bit_length() - 1
