"""The yardstick of the hand kernels: the least time an NVIDIA H100 SXM
could take for a launch, the larger of its bytes against the memory rate
and its integer instructions against the issue rates, pipe by pipe.

The per-operation prices are frozen data: the instructions nvcc 12.8 emits
for sm_90a for one field operation, split by pipe, as
starkpack_winterfell_tpu_torch/csrc/gl64_sass_count.py counted them on an
NVIDIA H100 80GB HBM3 (``BY_PIPE``).  They are not counted again on each
run, so a change to the program cannot move the yardstick."""

from __future__ import annotations

import itertools

# NVIDIA H100 SXM: HBM bandwidth from the data sheet; the IMAD pipe and the
# integer ALU pipe (IADD3, LOP3, SHF, ISETP, SEL, LEA) 64 lanes a clock an SM
# each, dispatch 4 x 32 lanes a clock an SM for all instructions together,
# 132 SMs at the 1.98 GHz boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_IMAD_LANES_PER_S = PEAK_ALU_LANES_PER_S = 132 * 64 * 1.98e9
PEAK_DISPATCH_LANES_PER_S = 132 * 128 * 1.98e9
# an IMAD.WIDE (a 64-bit result) takes two issue slots of the IMAD pipe
IMAD_WIDE_SLOTS = 2

# gl64_sass_count.py's "by_pipe": IMAD-pipe instructions (of them IMAD.WIDE)
# and ALU-pipe instructions of one operation.  Goldilocks: mul, add, sub, a
# square with its cross product once (gl64_sqr), a 12- and an 8-term row of
# products by small constants with one reduction (gl64_mds_row, _row8);
# f128 and f62: mul, sqr, add, sub; f62's butterfly product on a Montgomery
# twiddle (f62_twmul).
BY_PIPE = {
    "mul": {"imad": 10, "alu": 18, "imad_wide": 5},
    "add": {"imad": 2, "alu": 8, "imad_wide": 0},
    "sub": {"imad": 1, "alu": 7, "imad_wide": 0},
    "gl64_sqr": {"imad": 6, "alu": 23, "imad_wide": 3},
    "gl64_mds_row": {"imad": 26, "alu": 42, "imad_wide": 24},
    "gl64_mds_row8": {"imad": 19, "alu": 34, "imad_wide": 16},
    "f128_mul": {"imad": 62, "alu": 68, "imad_wide": 32},
    "f128_sqr": {"imad": 46, "alu": 68, "imad_wide": 26},
    "f128_add": {"imad": 4, "alu": 21, "imad_wide": 0},
    "f128_sub": {"imad": 2, "alu": 18, "imad_wide": 0},
    "f62_mul": {"imad": 37, "alu": 41, "imad_wide": 18},
    "f62_sqr": {"imad": 33, "alu": 41, "imad_wide": 17},
    "f62_add": {"imad": 1, "alu": 7, "imad_wide": 0},
    "f62_sub": {"imad": 1, "alu": 7, "imad_wide": 0},
    "f62_twmul": {"imad": 15, "alu": 14, "imad_wide": 9},
}
ELEMENT_BYTES = {"gl64": 8, "f64": 8, "f62": 8, "f128": 16}


def _slotted():
    return {probe: {"imad": c["imad"] + (IMAD_WIDE_SLOTS - 1) * c["imad_wide"], "alu": c["alu"]}
            for probe, c in BY_PIPE.items()}


def _costs():
    """Per-pipe prices by field and operation.  "twmul" is a butterfly's
    twiddle product at its cheapest form; a Goldilocks square has two forms
    (the square, or a multiply); "row_term" / "row_base" price a row of
    small-constant products as one lazy accumulation with one reduction."""
    bp = _slotted()
    term = {k: max(0.0, (bp["gl64_mds_row"][k] - bp["gl64_mds_row8"][k]) / 4) for k in ("imad", "alu")}
    base = {k: max(0.0, bp["gl64_mds_row"][k] - 12 * term[k] - bp["add"][k]) for k in ("imad", "alu")}
    limb = ("mul", "sqr", "add", "sub")
    return {
        "gl64": {"mul": bp["mul"], "add": bp["add"], "sub": bp["sub"],
                 "sqr": [bp["gl64_sqr"], bp["mul"]], "twmul": bp["mul"],
                 "row_term": term, "row_base": base},
        "f128": {**{op: bp[f"f128_{op}"] for op in limb}, "twmul": bp["f128_mul"]},
        "f62": {**{op: bp[f"f62_{op}"] for op in limb}, "twmul": bp["f62_twmul"]},
    }


COSTS = _costs()


def _forms(cost: dict, op: str) -> list:
    """The forms one operation can take at its price: a row of m
    small-constant products ("row<m>") as the lazy accumulation, as one
    reduction priced as a multiply and each term as an add, or as m
    multiplies and m - 1 adds; a listed entry each of its forms."""
    if not op.startswith("row"):
        return cost[op] if isinstance(cost[op], list) else [cost[op]]
    m = int(op[3:])

    def comb(*terms):
        return {k: sum(n * c[k] for n, c in terms) for k in ("imad", "alu")}

    return [comb((1, cost["row_base"]), (m, cost["row_term"])),
            comb((1, cost["mul"]), (m, cost["add"])),
            comb((m, cost["mul"]), (m - 1, cost["add"]))]


def pipe_s(ops: dict) -> float:
    return max(ops["imad"] / PEAK_IMAD_LANES_PER_S, ops["alu"] / PEAK_ALU_LANES_PER_S,
               (ops["imad"] + ops["alu"]) / PEAK_DISPATCH_LANES_PER_S)


def least_time_s(nbytes: int, counts: dict, field: str) -> float:
    """The least seconds of a launch that moves ``nbytes`` and does
    ``counts`` field operations ({"mul", "sqr", "add", "sub", "twmul",
    "row<m>"}: how many), each kind of operation in the form that, with the
    others', takes the least time."""
    field = "gl64" if field == "f64" else field
    choices = [[(n, form) for form in _forms(COSTS[field], op)] for op, n in counts.items()]
    t_ops = min(pipe_s({k: sum(n * form[k] for n, form in pick) for k in ("imad", "alu")})
                for pick in itertools.product(*choices))
    return max(nbytes / PEAK_BYTES_PER_S, t_ops)
