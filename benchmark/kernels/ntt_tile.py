"""Kernel 1: the fused Goldilocks NTT tile of the big-trace pipeline
(csrc/ntt_tile.cu, launched by ops/ntt4.py:ntt_tile)."""

from ..roofline import least_time_s as _least

COUNTER = "starkpack_winterfell_tpu_torch.ops.ntt4"
NAME = "ntt_tile_kernel"


def claims(key) -> bool:
    return True


def least_time_s(key) -> float:
    """Every input read once and the output written once, a butterfly (a
    multiply, an add and a subtract) per two words and stage; a
    zero-interleaved input counts the rows read and the stages after the
    log2(interleave) that only copy; a table multiply a multiply per word."""
    dif, B, n, lanes, epilogue, interleave, pre, transposed = key
    words = B * n * lanes
    words_in = words // interleave
    nbytes = 8 * (words_in + words + n // 2 + (n * lanes if epilogue else 0)
                  + (n // interleave * lanes if pre else 0))
    stages = n.bit_length() - interleave.bit_length()
    butterflies = words * stages // 2
    muls = butterflies + (words if epilogue else 0) + (words_in if pre else 0)
    return _least(nbytes, {"mul": muls, "add": butterflies, "sub": butterflies}, "gl64")
