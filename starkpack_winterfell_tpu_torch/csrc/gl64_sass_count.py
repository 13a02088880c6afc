#!/usr/bin/env python3
"""Count the integer instructions nvcc emits for the field operations of
csrc/gl64.cuh (mul, add, sub), csrc/f128.cuh and csrc/f62.cuh (mul, sqr,
add, sub), for the Rescue sponge's own (csrc/rescue_sponge.cu): the
Montgomery f62 multiply of csrc/f62_mont.cuh and one row of each layout's
MDS product with its round-constant add (Rp64_256: twelve 32 x 32-bit
products of the state's halves, one reduction; the width-8 Jive layouts:
eight; Rp62_248: twelve 128-bit products summed, one Montgomery
reduction), for kernel 4's f62 butterfly product (``f62_twmul``: a
canonical word times a twiddle in Montgomery form, made canonical), and
for a Goldilocks square with its cross product taken once (``gl64_sqr``).

    python3 starkpack_winterfell_tpu_torch/csrc/gl64_sass_count.py [SASS_OUT]

Compiles one probe kernel per field operation for sm_90a, disassembles it
with cuobjdump and prints, as one JSON line, the number of 32-bit integer
ALU instructions (multiply-adds, adds, compares, selects, logic, shifts) in
each, Goldilocks under "int32_alu_instructions", f128 and f62 under
"f128_int32_alu_instructions" and "f62_int32_alu_instructions"; and under
"by_pipe" each probe's instructions split by the pipe that runs them:
"imad" (IMAD and its forms, 64 lanes a clock an SM on Hopper) and "alu"
(IADD3, LOP3, SHF, ISETP, SEL, LEA, IMNMX: the integer ALU pipe, 64 lanes a
clock), and "imad_wide", how many of the "imad" ones are IMAD.WIDE (a
64-bit result; kernel_times.py's ``imad`` phase times one against a plain
IMAD).  Moves, uniform-datapath instructions, loads, stores and control
flow are left out of "by_pipe" (uniform ones stay in the totals, as
before).  These counts are the per-operation costs behind the operation
bounds that chip_smoke.py computes for the kernels: the one-pipe totals for
the NTT and constraint kernels, "by_pipe" for the sponge.  Needs the CUDA
toolkit, no GPU.
"""

import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
OPS = ("mul", "add", "sub")
F128_OPS = ("mul", "sqr", "add", "sub")  # probed for f128 and f62
INT_ALU = re.compile(r"^(IMAD|IADD3|ISETP|SEL|LOP3|SHF|LEA|IMNMX|UIADD3|UIMAD|ULOP3|USHF)\b")
MOVES = re.compile(r"^(IMAD\.MOV|UMOV|MOV)\b")
IMAD_PIPE = re.compile(r"^IMAD\b")
IMAD_WIDE = re.compile(r"^IMAD\.WIDE\b")
ALU_PIPE = re.compile(r"^(IADD3|ISETP|SEL|LOP3|SHF|LEA|IMNMX)\b")

# the sponge's operations, kernel 4's f62 butterfly product and the
# Goldilocks square (three 32 x 32-bit products, the cross one once, then
# the reduction of gl64::mul) that the constraint kernel's f64 bound prices
# its squares at: probe name -> body reading a[], writing o[0]
SPONGE_PROBES = {
    "gl64_sqr": (
        "const uint64_t l = (uint32_t)a[0], h = a[0] >> 32;"
        " const uint64_t ll = l * l, lh = l * h;"
        " const uint64_t lo = ll + (lh << 33);"
        " o[0] = gl64::reduce128(lo, h * h + (lh >> 31) + (lo < ll ? 1 : 0));"),
    "f62_twmul": "o[0] = f62m::sub_if(f62m::mul(a[0], a[1]), f62m::P);",
    "f62m_mul": "o[0] = f62m::mul(a[0], a[1]);",
    "f62m_mds_row": (
        "uint64_t lo = 0, hi = 0;"
        " for (int j = 0; j < 12; ++j) f62m::mul_acc(a[j], a[12 + j], lo, hi);"
        " const uint64_t r = f62m::sub_if(f62m::redc(lo, hi), 2 * f62m::P);"
        " o[0] = f62m::sub_if(r + a[24], f62m::P);"),
    "gl64_mds_row": (
        "uint64_t lo = 0, hi = 0;"
        " for (int j = 0; j < 12; ++j) { const uint32_t m = (uint32_t)a[j];"
        " lo += (uint64_t)(uint32_t)a[12 + j] * m;"
        " hi += (uint64_t)(uint32_t)(a[12 + j] >> 32) * m; }"
        " const uint64_t l = lo + (hi << 32);"
        " o[0] = gl64::add(gl64::reduce128(l, (hi >> 32) + (l < lo ? 1 : 0)), a[24]);"),
    "gl64_mds_row8": (
        "uint64_t lo = 0, hi = 0;"
        " for (int j = 0; j < 8; ++j) { const uint32_t m = (uint32_t)a[j];"
        " lo += (uint64_t)(uint32_t)a[8 + j] * m;"
        " hi += (uint64_t)(uint32_t)(a[8 + j] >> 32) * m; }"
        " const uint64_t l = lo + (hi << 32);"
        " o[0] = gl64::add(gl64::reduce128(l, (hi >> 32) + (l < lo ? 1 : 0)), a[16]);"),
}


def count(sass_out=None):
    """Compiles the probes, disassembles them and returns the counts (the
    dict ``main`` prints); ``sass_out``: a file for the disassembly."""
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    src = '#include "gl64.cuh"\n' + "".join(
        f'extern "C" __global__ void probe_{op}(const uint64_t* a, uint64_t* o) '
        f"{{ o[0] = gl64::{op}(a[0], a[1]); }}\n"
        for op in OPS
    ) + '#include "f128.cuh"\n#include "f62.cuh"\n' + "".join(
        f'extern "C" __global__ void probe_f128_{op}(const uint64_t* a, uint64_t* o) '
        "{ F128 x = F128::make(a[0], a[1]), y = F128::make(a[2], a[3]); "
        + ("F128 r = fe_sqr(x); (void)y; " if op == "sqr" else f"F128 r = fe_{op}(x, y); ")
        + "o[0] = r.lo; o[1] = r.hi; }\n"
        f'extern "C" __global__ void probe_f62_{op}(const uint64_t* a, uint64_t* o) '
        "{ F62 x = F62::make(a[0]), y = F62::make(a[1]); "
        + ("F62 r = fe_sqr(x); (void)y; " if op == "sqr" else f"F62 r = fe_{op}(x, y); ")
        + "o[0] = r.v; }\n"
        for op in F128_OPS
    ) + '#include "f62_mont.cuh"\n' + "".join(
        f'extern "C" __global__ void probe_{name}(const uint64_t* a, uint64_t* o) {{ {body} }}\n'
        for name, body in SPONGE_PROBES.items()
    )
    with tempfile.TemporaryDirectory() as tmp:
        cu, cubin = os.path.join(tmp, "probe.cu"), os.path.join(tmp, "probe.cubin")
        with open(cu, "w") as f:
            f.write(src)
        subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-I", HERE, "-cubin", "-o", cubin, cu], check=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
    if sass_out:
        with open(sass_out, "w") as f:
            f.write(sass)
    counts, pipes, current = {}, {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : probe_(\w+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
            pipes[current] = {"imad": 0, "alu": 0, "imad_wide": 0}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", line)
        if not (m and current) or MOVES.match(m.group(1)):
            continue
        op = m.group(1)
        if INT_ALU.match(op):
            counts[current] += 1
        if IMAD_PIPE.match(op):
            pipes[current]["imad"] += 1
            pipes[current]["imad_wide"] += bool(IMAD_WIDE.match(op))
        elif ALU_PIPE.match(op):
            pipes[current]["alu"] += 1
    return {
        "int32_alu_instructions": {op: counts[op] for op in OPS},
        "f128_int32_alu_instructions": {op: counts[f"f128_{op}"] for op in F128_OPS},
        "f62_int32_alu_instructions": {op: counts[f"f62_{op}"] for op in F128_OPS},
        "by_pipe": pipes,
    }


def main():
    print(json.dumps(count(sys.argv[1] if len(sys.argv) > 1 else None)))


if __name__ == "__main__":
    main()
