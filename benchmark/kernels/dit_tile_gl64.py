"""Kernel 3: the batched Goldilocks DIT tile (dit_tile_kernel<GL64, 3> of
csrc/dit_tile.cuh in csrc/ntt_dit.cu, launched by
ops/ntt_kernel.py:dit_tile)."""

from ..roofline import least_time_s as _least

COUNTER = "starkpack_winterfell_tpu_torch.ops.ntt_kernel"
NAME = "dit_tile_kernel<GL64"


def claims(key) -> bool:
    return key[0] == "tile"


def least_time_s(key) -> float:
    """x read once, the output written once, each table once; the stages
    after the log2(n / n_in) that zero-padded rows only copy, a butterfly
    per two words and stage; a multiply per input word and table or
    factor."""
    _, B, n, n_in, lanes, _, _, pre, row, col = key
    words_in, words = B * n_in * lanes, B * n * lanes
    nbytes = 8 * (words_in + words + n // 2 + (n_in * lanes if pre else 0)
                  + (n_in if row else 0) + (lanes if col else 0))
    butterflies = words * (n_in.bit_length() - 1) // 2
    muls = words_in * (pre + row + col)
    return _least(nbytes, {"twmul": butterflies, "mul": muls, "add": butterflies,
                           "sub": butterflies}, "gl64")
