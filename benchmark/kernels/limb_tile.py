"""Kernel 4: the f128 / f62 limb-plane DIT tile (dit_tile_kernel<F128, 3> /
<F62, 3> of csrc/dit_tile.cuh in csrc/limb_ntt_tile.cu, launched by
ops/limb_ntt.py:tile)."""

from ..roofline import ELEMENT_BYTES, least_time_s as _least

COUNTER = "starkpack_winterfell_tpu_torch.ops.limb_ntt"
NAME = "dit_tile_kernel<F"


def claims(key) -> bool:
    return True


def least_time_s(key) -> float:
    """x read once (a broadcast one once for all groups), the output written
    once, each table once; the stages after the log2(n / n_in) that
    zero-padded rows only copy, a butterfly (a twiddle product, an add and a
    subtract) per two elements and stage, whatever products by 1 the kernel
    skips; a multiply per input element and table or factor, and per output
    element for the scale."""
    field, _, G, D, n, n_in, lanes, xs, _, ps, has_row, has_col, has_scale = key
    B = G * D
    x_elems = (D if G > 1 and xs[0] == 0 else B) * n_in * lanes
    out_elems = B * n * lanes
    tables = (n // 2 + (n_in * lanes if ps is not None else 0)
              + (G * n_in if has_row else 0) + (G * lanes if has_col else 0))
    nbytes = ELEMENT_BYTES[field] * (x_elems + out_elems + tables)
    butterflies = out_elems * (n_in.bit_length() - 1) // 2
    muls = (B * n_in * lanes * ((ps is not None) + has_row + has_col)
            + (out_elems if has_scale else 0))
    return _least(nbytes, {"twmul": butterflies, "mul": muls, "add": butterflies,
                           "sub": butterflies}, field)
