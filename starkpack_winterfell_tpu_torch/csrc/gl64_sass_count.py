#!/usr/bin/env python3
"""Count the integer instructions nvcc emits for the field operations of
csrc/gl64.cuh (mul, add, sub), csrc/f128.cuh and csrc/f62.cuh (mul, sqr,
add, sub).

    python3 starkpack_winterfell_tpu_torch/csrc/gl64_sass_count.py [SASS_OUT]

Compiles one probe kernel per field operation for sm_90a, disassembles it
with cuobjdump and prints, as one JSON line, the number of 32-bit integer
ALU instructions (multiply-adds, adds, compares, selects, logic, shifts) in
each, Goldilocks under "int32_alu_instructions", f128 and f62 under
"f128_int32_alu_instructions" and "f62_int32_alu_instructions".  Moves,
loads, stores and control flow are left out.  These counts are the per-operation costs behind the operation
bounds that chip_smoke.py computes for the kernels.  Needs the CUDA toolkit,
no GPU.
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


def main():
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
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(sass)
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : probe_(\w+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)", line)
        if m and current and INT_ALU.match(m.group(1)) and not MOVES.match(m.group(1)):
            counts[current] += 1
    print(json.dumps({
        "int32_alu_instructions": {op: counts[op] for op in OPS},
        "f128_int32_alu_instructions": {op: counts[f"f128_{op}"] for op in F128_OPS},
        "f62_int32_alu_instructions": {op: counts[f"f62_{op}"] for op in F128_OPS},
    }))


if __name__ == "__main__":
    main()
