"""Goldilocks field (p = 2^64 - 2^32 + 1) arithmetic on 64-bit words.

Counterpart of starkpack_winterfell_tpu/ops/gl64.py.  There an element is a
``(lo, hi)`` pair of u32 planes because the target has no 64-bit integer
unit; a GPU has one, so here an element is ONE canonical 64-bit word.

Representation: ``torch.int64`` tensors holding the u64 bit pattern.  torch
implements almost no arithmetic on ``torch.uint64`` on the CPU, and ``>>`` on
``int64`` is arithmetic, so

* unsigned compares flip the sign bit (``_ult``),
* every right shift is followed by a mask,
* the 64x64 -> 128 product is built from 32-bit halves (the wrapping int64
  multiply gives the correct low word).

The same plain code runs on CPU and CUDA tensors.  Elements are canonical
(in [0, p)) everywhere, as in the JAX package.

Reduction: for x = c3*2^96 + c2*2^64 + lo64 with 2^64 = 2^32 - 1 (mod p)
and 2^96 = -1 (mod p):  x = lo64 - c3 + c2*(2^32 - 1)  (mod p).
"""

from __future__ import annotations

import numpy as np
import torch

P = 0xFFFFFFFF00000001  # field modulus
EPS = 0xFFFFFFFF  # 2^32 - 1 == 2^64 mod p == -p mod 2^64
MASK32 = 0xFFFFFFFF
TWO_ADICITY = 32
GENERATOR = 7
TWO_ADIC_ROOT_OF_UNITY = 7277203076849721926  # order 2^32

_SIGN = -(1 << 63)
_P_FLIPPED = P ^ (1 << 63)  # p with the sign bit flipped, as a signed value


# ---------------------------------------------------------------------------
# numpy <-> tensor bridge
# ---------------------------------------------------------------------------


def from_u64(x, device="cpu") -> torch.Tensor:
    """numpy uint64 array (or anything convertible) -> int64 tensor holding
    the same bit patterns, on ``device``."""
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64)).to(device)


def to_u64(a: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 array of the same bit patterns (host)."""
    return a.detach().cpu().contiguous().numpy().view(np.uint64)


def _wrap(v: int) -> int:
    """Python int in [0, 2^64) -> the signed value with the same bits."""
    v &= 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >> 63 else v


def from_int(v: int, shape=(), device="cpu") -> torch.Tensor:
    return torch.full(shape, _wrap(int(v) % P), dtype=torch.int64, device=device)


def zeros(shape, device="cpu") -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int64, device=device)


def ones(shape, device="cpu") -> torch.Tensor:
    return torch.ones(shape, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# unsigned helpers on int64 bit patterns
# ---------------------------------------------------------------------------


def _ult(a, b):
    """Unsigned a < b."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _uge_p(a):
    """Unsigned a >= p."""
    return (a ^ _SIGN) >= _P_FLIPPED


def _mul_hi_lo(a, b):
    """Full 64x64 -> 128 product as (lo, hi) u64 bit patterns."""
    a0 = a & MASK32
    a1 = (a >> 32) & MASK32
    b0 = b & MASK32
    b1 = (b >> 32) & MASK32
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = ((p00 >> 32) & MASK32) + (p01 & MASK32) + (p10 & MASK32)
    hi = p11 + ((p01 >> 32) & MASK32) + ((p10 >> 32) & MASK32) + (mid >> 32)
    return a * b, hi


def _reduce128(lo, hi):
    """(lo, hi) u64 words of a 128-bit value -> canonical residue mod p."""
    hh = (hi >> 32) & MASK32
    hl = hi & MASK32
    # t0 = lo - hh (minus EPS once more on borrow; cannot re-borrow)
    t0 = lo - hh - _ult(lo, hh) * EPS
    # t1 = hl * (2^32 - 1) < 2^64
    t1 = (hl << 32) - hl
    r = t0 + t1
    # carry out adds 2^64 = EPS; otherwise one conditional subtract of p,
    # which is the same +EPS mod 2^64 (the two cases exclude each other)
    return r + (_ult(r, t1) | _uge_p(r)) * EPS


# ---------------------------------------------------------------------------
# field operations on canonical words
# ---------------------------------------------------------------------------


def add(a, b):
    s = a + b
    return s + (_ult(s, a) | _uge_p(s)) * EPS


def sub(a, b):
    return a - b - _ult(a, b) * EPS


def neg(a):
    return sub(torch.zeros_like(a), a)


def mul(a, b):
    return _reduce128(*_mul_hi_lo(a, b))


def square(a):
    return mul(a, a)


def double(a):
    return add(a, a)


def exp_int(a, e: int):
    """Exponentiation by a static python-int exponent (square-and-multiply)."""
    e = int(e)
    if e == 0:
        return torch.ones_like(a)
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def exp7(a):
    """x^7 — the Rescue S-box exponent."""
    x2 = square(a)
    x4 = square(x2)
    x3 = mul(x2, a)
    return mul(x3, x4)


def inv(a):
    """Field inverse via Fermat: a^(p-2).  a == 0 maps to 0.  A single
    element is inverted on the host with a python ``pow`` (one 8-byte copy
    each way in place of the ~4000 launches of the ladder)."""
    if a.numel() == 1:
        v = int(to_u64(a).reshape(-1)[0])
        return from_int(pow(v, P - 2, P), a.shape, a.device)
    return exp_int(a, P - 2)


def get_root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity."""
    assert 0 < log_n <= TWO_ADICITY
    return pow(TWO_ADIC_ROOT_OF_UNITY, 1 << (TWO_ADICITY - log_n), P)
