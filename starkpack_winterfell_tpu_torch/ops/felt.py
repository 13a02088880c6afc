"""Field-element array wrapper over torch tensors.

Counterpart of starkpack_winterfell_tpu/ops/felt.py.  ``Felt`` wraps a tuple
of component tensors (ops/gl64.py words) and provides operator overloading
so AIR transition constraints can be written naturally while staying fully
vectorized: the same constraint code runs on whole chunks of the
constraint-evaluation domain on the device, and on python ints in the
verifier (through ``ScalarFelt``, verifier/verifier.py).

A Felt without a backend holds one int64 tensor per component and calls
gl64/vec directly (the f64 big-trace path).  ``Felt(..., B=backend)`` holds
one tuple of word planes per component and routes every operation through
the ``FieldBackend`` (ops/backend.py), so the same AIR code runs on f128
planes.  Goldilocks Felts take degree 1, 2 and 3 (ops/gl64_ext.py); limb
Felts take degree 1 and 2, and 3 over f62 (``FieldBackend.ext_mul``; f128 has
no cubic extension).
"""

from __future__ import annotations

import numpy as np
import torch

from ..math import scalar as fs
from . import gl64 as gl
from . import vec


class Felt:
    __slots__ = ("c", "deg", "B")

    def __init__(self, components, deg=None, B=None):
        """components: tuple of per-component int64 tensors, or with a
        backend ``B`` tuple of per-component word-plane tuples."""
        self.c = tuple(components)
        self.deg = deg if deg is not None else len(self.c)
        self.B = B
        assert self.deg == len(self.c) in (1, 2, 3)

    @property
    def _v(self):
        """The element-array ops of this Felt's field: ops/vec or a backend."""
        return vec if self.B is None else self.B

    def _map(self, f) -> "Felt":
        """Apply a tensor op to every plane."""
        if self.B is None:
            return Felt(tuple(f(x) for x in self.c))
        return Felt(self.B.emap(f, self.c), B=self.B)

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_u64s(arr, deg: int = 1, device="cpu") -> "Felt":
        """From a numpy uint64 array of Goldilocks elements; for deg > 1 the
        last axis holds the ``deg`` components."""
        arr = np.asarray(arr, dtype=np.uint64)
        if deg == 1:
            return Felt((gl.from_u64(arr, device),))
        assert arr.shape[-1] == deg
        return Felt(tuple(gl.from_u64(arr[..., i], device) for i in range(deg)))

    @staticmethod
    def from_int(v, shape=(), deg: int = 1, device="cpu", B=None) -> "Felt":
        """A constant: ``v`` an int (embedded in degree ``deg``) or a tuple
        of ``deg`` components."""
        comps = fs.components(fs.embed(v, deg))
        if B is not None:
            return Felt(tuple(B.b_from_int(x, shape, device) for x in comps), B=B)
        return Felt(tuple(gl.from_int(x, shape, device) for x in comps))

    def to_u64s(self) -> np.ndarray:
        """To a numpy uint64 array (Goldilocks only); deg > 1 appends a
        trailing component axis."""
        if self.deg == 1:
            return gl.to_u64(self.c[0])
        return np.stack([gl.to_u64(c) for c in self.c], axis=-1)

    # -- shape/utils --------------------------------------------------------

    @property
    def _plane(self):
        return self.c[0] if self.B is None else self.c[0][0]

    @property
    def shape(self):
        return self._plane.shape

    @property
    def device(self):
        return self._plane.device

    def __getitem__(self, idx) -> "Felt":
        return self._map(lambda x: x[idx])

    def reshape(self, *shape) -> "Felt":
        return self._map(lambda x: x.reshape(*shape))

    def broadcast_to(self, shape) -> "Felt":
        return Felt(self._v.vbroadcast(self.c, shape), B=self.B)

    # -- promotion ----------------------------------------------------------

    def _promote(self, other):
        """Coerce other to a Felt of the same degree as self."""
        if isinstance(other, int):
            other = Felt.from_int(other, (), device=self.device, B=self.B)
        if not isinstance(other, Felt):
            return NotImplemented
        d = max(self.deg, other.deg)
        v = self._v
        return Felt(v.promote(self.c, d), B=self.B), Felt(v.promote(other.c, d), B=self.B)

    # -- arithmetic ---------------------------------------------------------

    def __add__(self, other):
        r = self._promote(other)
        if r is NotImplemented:
            return NotImplemented
        return Felt(self._v.vadd(r[0].c, r[1].c), B=self.B)

    __radd__ = __add__

    def __sub__(self, other):
        r = self._promote(other)
        if r is NotImplemented:
            return NotImplemented
        return Felt(self._v.vsub(r[0].c, r[1].c), B=self.B)

    def __rsub__(self, other):
        r = self._promote(other)
        if r is NotImplemented:
            return NotImplemented
        return Felt(self._v.vsub(r[1].c, r[0].c), B=self.B)

    def __neg__(self):
        return Felt(self._v.vneg(self.c), B=self.B)

    def __mul__(self, other):
        if isinstance(other, int):
            other = Felt.from_int(other, (), device=self.device, B=self.B)
        if not isinstance(other, Felt):
            return NotImplemented
        return Felt(self._v.vmul(self.c, other.c), B=self.B)

    __rmul__ = __mul__

    def __pow__(self, e: int):
        e = int(e)
        if e == 0:
            return Felt(self._v.vones(self.shape, self.deg, self.device), B=self.B)
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
        return Felt(self._v.vsquare(self.c), B=self.B)

    def inverse(self):
        return Felt(self._v.vinv(self.c), B=self.B)

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
        planes = lambda f: f.c if self.B is None else [l for c in f.c for l in c]
        out = None
        for x, y in zip(planes(r[0]), planes(r[1])):
            e = x == y
            out = e if out is None else out & e
        return out

    def __repr__(self):
        field = "f64" if self.B is None else self.B.name
        return (f"Felt({field}, deg={self.deg}, shape={tuple(self.shape)}, "
                f"device={self.device})")


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
