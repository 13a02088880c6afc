"""Field-element array wrapper over torch tensors.

Counterpart of starkpack_winterfell_tpu/ops/felt.py.  ``Felt`` wraps a tuple
of component tensors (ops/gl64.py words) and provides operator overloading
so AIR transition constraints can be written naturally while staying fully
vectorized: the same constraint code runs on whole chunks of the
constraint-evaluation domain on the device, and on python ints in the
verifier (through ``ScalarFelt``, verifier/verifier.py).

The JAX package routes every operation through a ``FieldBackend``
(ops/backend.py, there for the f62/f128 limb fields); that indirection is
not carried over — ``Felt`` calls gl64/vec directly.  Only degree 1 is
ported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import gl64 as gl
from . import vec


class Felt:
    __slots__ = ("c", "deg")

    def __init__(self, components, deg=None):
        """components: tuple of per-component int64 tensors."""
        self.c = tuple(components)
        self.deg = deg if deg is not None else len(self.c)
        assert self.deg == len(self.c) in (1, 2, 3)

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_u64s(arr, device="cpu") -> "Felt":
        """From a numpy uint64 array of base-field elements."""
        return Felt((gl.from_u64(np.asarray(arr, dtype=np.uint64), device),))

    @staticmethod
    def from_int(v: int, shape=(), device="cpu") -> "Felt":
        return Felt((gl.from_int(v, shape, device),))

    def to_u64s(self) -> np.ndarray:
        assert self.deg == 1
        return gl.to_u64(self.c[0])

    # -- shape/utils --------------------------------------------------------

    @property
    def shape(self):
        return self.c[0].shape

    @property
    def device(self):
        return self.c[0].device

    def __getitem__(self, idx) -> "Felt":
        return Felt(tuple(x[idx] for x in self.c))

    def reshape(self, *shape) -> "Felt":
        return Felt(tuple(x.reshape(*shape) for x in self.c))

    def broadcast_to(self, shape) -> "Felt":
        return Felt(vec.vbroadcast(self.c, shape))

    # -- promotion ----------------------------------------------------------

    def _promote(self, other):
        """Coerce other to a Felt of the same degree as self."""
        if isinstance(other, int):
            other = Felt.from_int(other, (), self.device)
        if not isinstance(other, Felt):
            return NotImplemented
        d = max(self.deg, other.deg)
        return Felt(vec.promote(self.c, d)), Felt(vec.promote(other.c, d))

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, other):
        r = self._promote(other)
        if r is NotImplemented:
            return NotImplemented
        return Felt(vec.vadd(r[0].c, r[1].c))

    __radd__ = __add__

    def __sub__(self, other):
        r = self._promote(other)
        if r is NotImplemented:
            return NotImplemented
        return Felt(vec.vsub(r[0].c, r[1].c))

    def __rsub__(self, other):
        r = self._promote(other)
        if r is NotImplemented:
            return NotImplemented
        return Felt(vec.vsub(r[1].c, r[0].c))

    def __neg__(self):
        return Felt(tuple(gl.neg(x) for x in self.c))

    def __mul__(self, other):
        if isinstance(other, int):
            other = Felt.from_int(other, (), self.device)
        if not isinstance(other, Felt):
            return NotImplemented
        return Felt(vec.vmul(self.c, other.c))

    __rmul__ = __mul__

    def __pow__(self, e: int):
        e = int(e)
        if e == 0:
            return Felt(vec.vones(self.shape, self.deg, self.device))
        result = None
        base = self
        while e:
            if e & 1:
                result = base if result is None else result * base
            e >>= 1
            if e:
                base = base.square()
        return result

    def square(self):
        return Felt(vec.vsquare(self.c))

    def inverse(self):
        return Felt(vec.vinv(self.c))

    def __truediv__(self, other):
        r = self._promote(other)
        if r is NotImplemented:
            return NotImplemented
        return r[0] * r[1].inverse()

    def double(self):
        return self + self

    def __eq__(self, other):
        r = self._promote(other)
        if r is NotImplemented:
            return NotImplemented
        out = None
        for x, y in zip(r[0].c, r[1].c):
            e = x == y
            out = e if out is None else out & e
        return out

    def __repr__(self):
        return f"Felt(deg={self.deg}, shape={tuple(self.shape)}, device={self.device})"


def mds_apply(states, rows) -> list:
    """out_i = sum_j rows[i][j] * states[j] — dense matrix application over
    a list of Felts (the AIR-side MDS / INV_MDS pattern).  The verifier's
    ScalarFelt states (python ints) take raw-int row dots with one reduction
    per row; tensor Felts take the per-term field math."""
    w = len(states)
    s0 = states[0]
    if not isinstance(s0, Felt) and hasattr(s0, "spec") and all(
        isinstance(getattr(s, "v", None), int) for s in states
    ):
        spec = s0.spec
        P = spec.P
        cls = type(s0)
        vals = [s.v for s in states]
        return [
            cls(sum(int(rows[i][j]) * vals[j] for j in range(w)) % P, spec)
            for i in range(w)
        ]
    out = []
    for i in range(w):
        acc = None
        for j in range(w):
            term = states[j] * int(rows[i][j])
            acc = term if acc is None else acc + term
        out.append(acc)
    return out
