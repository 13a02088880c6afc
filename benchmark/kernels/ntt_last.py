"""Kernel 2: the Goldilocks DIT NTT along the last axis (ntt_last of
csrc/ntt_dit.cu, launched by ops/ntt_kernel.py:ntt_last)."""

from ..roofline import least_time_s as _least

COUNTER = "starkpack_winterfell_tpu_torch.ops.ntt_kernel"
NAME = "ntt_last"


def claims(key) -> bool:
    return key[0] == "last"


def least_time_s(key) -> float:
    """The rows read once and written once; the stages after the
    log2(n / n_in) that a zero-padded row only copies; a multiply a word and
    table multiply."""
    _, rows, n, n_in, _, pre, scale = key
    nbytes = 8 * (rows * n_in + rows * n + n // 2 + (n_in if pre else 0))
    stages = n.bit_length() - (n // n_in).bit_length()
    butterflies = rows * n * stages // 2
    muls = butterflies + (rows * n_in if pre else 0) + (rows * n if scale else 0)
    return _least(nbytes, {"mul": muls, "add": butterflies, "sub": butterflies}, "gl64")
