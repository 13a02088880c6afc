"""Kernel 5: the whole-AIR constraint kernel (csrc/cons_frame.cuh and the
body ops/cons_kernel.py emits for each AIR, launched by
ops/cons_kernel.py:constraint_eval)."""

from ..roofline import ELEMENT_BYTES, least_time_s as _least

COUNTER = "starkpack_winterfell_tpu_torch.ops.cons_kernel"
NAME = "cons_eval_kernel"

# Each priced AIR body, counted from the recorded transition
# (ops/cons_kernel.py:record_transition, count_ops and, on Goldilocks,
# small_constant_rows) with the frame's operations of each point and
# instance: the products by the composition coefficients and divisors, the
# sums, the boundary groups' subtractions.  "periods": the length of each
# periodic column; "K" transition constraints, "groups" boundary divisor
# groups, "n_ccs" boundary constraints, "n_seq" sequence tables.
BODIES = {
    ("f64", "RescueChainAir", 12): {
        "K": 12, "groups": 2, "n_ccs": 16, "n_seq": 0, "ce_blowup": 8, "periods": [8] * 25,
        "per_point": {"mul": 248, "sqr": 48, "add": 186, "sub": 53, "row12": 12}},
    ("f128", "Lamport128AggAir", 14): {
        "K": 14, "groups": 2, "n_ccs": 14, "n_seq": 3, "ce_blowup": 8,
        "periods": [8] * 13 + [1024, 1024],
        "per_point": {"mul": 269, "sqr": 48, "add": 188, "sub": 56}},
}


def claims(key) -> bool:
    return (key[0], key[1], key[3]) in BODIES


def least_time_s(key) -> float:
    """Every input read once (the LDE rows, one period of each periodic
    column over the ce domain, the divisor and sequence tables, the scalar
    bank), the output written once; the body's operations at each of the
    n x ce points."""
    field, air, n, w, ce, n_seq, shift, blowup = key
    body = BODIES[(field, air, w)]
    el = ELEMENT_BYTES[field]
    per_cb = body["ce_blowup"] if blowup > 1 else 1
    scalar_words = n * (body["K"] + 2 * body["n_ccs"] - body["n_seq"] + 1) * (el // 8)
    nbytes = (el * (n * w * ce * shift + sum(p * per_cb for p in body["periods"])
                    + (1 + body["groups"]) * ce + n_seq * n * ce + ce)
              + 8 * scalar_words)
    points = n * ce
    return _least(nbytes, {op: points * k for op, k in body["per_point"].items()}, field)
