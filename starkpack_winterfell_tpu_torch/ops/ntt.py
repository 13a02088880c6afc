"""Number-theoretic transform over Goldilocks on one-word tensors.

Counterpart of starkpack_winterfell_tpu/ops/ntt.py: natural-order
evaluations in, natural-order coefficients out.  Every transform of the
small-trace path and the small transforms of the big-trace path (periodic
columns, the FRI fold's N-point iNTT) go through ``ntt_components``: on a
CUDA tensor it runs the DIT kernels of ops/ntt_kernel.py (one launch per
component up to 4096 points, the four-step split above;
``evaluate_poly_with_offset`` up to 4096 points is one launch with its offset
multiply and zero padding); on a CPU tensor an iterative
radix-2 DIT transform expressed as log2(n) full-array stages, which is also
the oracle of the kernels' tests.  Tables are cached per size and device.

Element arrays are tuples of component tensors (one per extension degree).
"""

from __future__ import annotations

import numpy as np
import torch

from . import gl64 as gl

_REV_CACHE: dict = {}
_TW_CACHE: dict = {}


def _bit_rev_perm(n: int) -> np.ndarray:
    if n in _REV_CACHE:
        return _REV_CACHE[n]
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    _REV_CACHE[n] = rev
    return rev


def power_series(base: int, n: int, device="cpu") -> torch.Tensor:
    """[1, base, base^2, ..., base^(n-1)] via log-doubling."""
    out = gl.from_int(1, (1,), device)
    length = 1
    b = base % gl.P
    while length < n:
        step = gl.from_int(pow(b, length, gl.P), (1,), device)
        out = torch.cat([out, gl.mul(out, step)])
        length *= 2
    return out[:n]


def _offset_powers(base: int, n: int, device) -> torch.Tensor:
    """``power_series`` of a coset offset, cached per size and device (the
    offsets of a config are static)."""
    key = ("offs", base % gl.P, n, str(device))
    if key not in _TW_CACHE:
        _TW_CACHE[key] = power_series(base, n, device)
    return _TW_CACHE[key]


def _stage_twiddles(n: int, inverse: bool, device):
    """Per-stage twiddle tables w_m^j (j < m/2) for m = 2, 4, ..., n."""
    key = (n, inverse, str(device))
    if key not in _TW_CACHE:
        bits = n.bit_length() - 1
        root = gl.get_root_of_unity(bits)
        if inverse:
            root = pow(root, gl.P - 2, gl.P)
        full = power_series(root, max(n // 2, 1), device)  # w_n^k, k < n/2
        tables = []
        for s in range(1, bits + 1):
            m = 1 << s
            tables.append(full[:: n // m].contiguous())
        _TW_CACHE[key] = tables
    return _TW_CACHE[key]


def ntt_components(comps, inverse: bool = False, scale: bool = True):
    """Core transform along the last axis of each component tensor.

    Forward: result[..., i] = sum_j comps[..., j] * w^(i*j)  (natural order).
    Inverse (with scale=True): coefficient form, scaled by 1/n.
    """
    n = comps[0].shape[-1]
    if n == 1:
        return comps
    assert n & (n - 1) == 0, "size must be a power of two"
    bits = n.bit_length() - 1
    device = comps[0].device
    if device.type == "cuda":
        from . import ntt_kernel

        if n <= ntt_kernel.MAX_TILE_N:
            return ntt_kernel.ntt_batched(comps, inverse, scale)
        return ntt_kernel.four_step_ntt(comps, inverse, scale)
    rev = torch.from_numpy(_bit_rev_perm(n)).to(device)
    tables = _stage_twiddles(n, inverse, device)
    comps = tuple(c.index_select(-1, rev) for c in comps)
    for s in range(1, bits + 1):
        m = 1 << s
        half = m // 2
        tw = tables[s - 1]
        new_comps = []
        for c in comps:
            y = c.reshape(c.shape[:-1] + (n // m, m))
            e, o = y[..., :half], y[..., half:]
            t = gl.mul(o, tw)
            new_comps.append(
                torch.cat([gl.add(e, t), gl.sub(e, t)], dim=-1).reshape(c.shape)
            )
        comps = tuple(new_comps)
    if inverse and scale:
        n_inv = gl.from_int(pow(n, gl.P - 2, gl.P), (), device)
        comps = tuple(gl.mul(c, n_inv) for c in comps)
    return comps


def evaluate_poly(comps):
    """Coefficients -> evaluations over the size-n subgroup (natural order)."""
    return ntt_components(comps, inverse=False)


def evaluate_poly_with_offset(comps, domain_offset: int, blowup_factor: int):
    """Coefficients (n) -> evaluations over the coset s*<w_L> of size
    L = n * blowup (natural order: result[i] = P(s * w_L^i)); scale by s^j,
    zero-pad, full-size transform."""
    n = comps[0].shape[-1]
    big_n = n * blowup_factor
    device = comps[0].device
    if device.type == "cuda" and 1 < big_n:
        from . import ntt_kernel

        # the offset multiply and the zero padding ride in the launches
        if big_n <= ntt_kernel.MAX_TILE_N:
            return ntt_kernel.ntt_batched(comps, n=big_n,
                                          pre=_offset_powers(domain_offset, n, device))
        if n % ntt_kernel.four_step_consts(big_n, False, True, device)["n2"] == 0:
            return ntt_kernel.four_step_ntt(comps, n=big_n, offset=domain_offset)
    offs = _offset_powers(domain_offset, n, device)
    scaled = []
    for c in comps:
        sc = gl.mul(c, offs)
        pad = torch.zeros(c.shape[:-1] + (big_n - n,), dtype=torch.int64,
                          device=c.device)
        scaled.append(torch.cat([sc, pad], dim=-1))
    return ntt_components(tuple(scaled), inverse=False)


def interpolate_poly(comps):
    """Evaluations over subgroup (natural order) -> coefficients."""
    return ntt_components(comps, inverse=True, scale=True)


def interpolate_poly_with_offset(comps, domain_offset: int):
    """Evaluations over coset s*<w_n> -> coefficients."""
    n = comps[0].shape[-1]
    coeffs = ntt_components(comps, inverse=True, scale=True)
    inv_off = pow(domain_offset, gl.P - 2, gl.P)
    inv_offs = _offset_powers(inv_off, n, comps[0].device)
    return tuple(gl.mul(c, inv_offs) for c in coeffs)
