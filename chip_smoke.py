#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's main paths through the entry points a user calls, all
with ProofOptions(28, 8, 16, NONE, 4, 31) and BLAKE3-256 unless named:

* the f64 big-trace path: a Rescue hash-chain STARK of 2^20 rows x 12
  columns, beside it a 2^14-row prove with a pinned digest and an aggregated
  prove of 4 x 2^16 rows;
* the f128 limb-field path: a Rescue128 hash-chain STARK of 2^18 rows x 6
  columns of 16-byte elements (cut from 2^20 rows, whose f128 shapes the
  1024-signature Lamport+ prove runs, to spare most of the chain's serial
  host trace build), beside it a 2^12-row prove with a pinned digest and an
  aggregated prove of 4 x 2^14 rows;
* the f64 small-trace path (every transform through the DIT kernels):
  do-work 32 x 1024 rows x 10 columns and a Rescue hash chain of 64
  instances x 2^13 rows x 12 columns, beside them do-work 2 x 64 with
  ProofOptions(16, 8, 0, NONE, 4, 31) and a pinned digest;
* aggregated Lamport+ signatures over f128 on the limb path, BLAKE3-192:
  1024 signatures of 127-bit messages in ONE trace of 2^20 rows x 14
  columns (the per-signature outputs bound by sequence assertions, read by
  the constraint kernel as tables), beside it 64 signatures (2^16 rows), 4
  signatures at k = 15 (512 rows) with a pinned digest, and 4 StarkPack
  instances of one signature each (lamport128, 1024 rows) with SHA3-256.

Builds the CUDA kernels from ``csrc/`` (one nvcc per library, all started
together) and holds each against its plain PyTorch version on the card at
every shape any of the proves launches; each prove's launch counts are set
to 0 just before it, read just after it and must be exactly the compared
shapes.  The big-trace path's tile shapes are known in advance
(``path_shapes``); the shapes of the limb kernels and of the DIT kernels
(which also serve the small transforms of the big-trace path) are read off
a first prove of each size, compared, and then required of the counted
prove.  Every proof is checked with the port's verifier.  Each phase
(device, build, kernels, dit_kernels, small, main, aggregated,
small_trace_golden, small_trace_main_do_work, small_trace_main_rescue,
limb_small, limb_fib, limb_fib62, limb_main, limb_aggregated,
lamport_agg_golden, lamport_agg_64, lamport_agg_main, lamport128_aggregated)
prints one JSON line as it ends; any failure raises and the run exits
non-zero.  The
last two lines are the per-kernel table and the ``{"ok": ...}`` summary.

Needs a CUDA device (exits non-zero without one) and no network.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from starkpack_winterfell_tpu_torch import (
    Blake3_192,
    Blake3_256,
    FieldExtension,
    ProofOptions,
    Sha3_256,
    VerifierError,
    verify,
)
from starkpack_winterfell_tpu_torch import TraceInfo, native
from starkpack_winterfell_tpu_torch.models.do_work import (
    DoWorkAir,
    DoWorkProver,
    PublicInputs as DoWorkInputs,
    build_do_work_trace,
)
from starkpack_winterfell_tpu_torch.models import lamport128 as lam
from starkpack_winterfell_tpu_torch.models import lamport128_agg as lagg
from starkpack_winterfell_tpu_torch.models.fib_multifield import get_fib_family
from starkpack_winterfell_tpu_torch.models.rescue128_chain import (
    Rescue128ChainAir,
    Rescue128ChainInputs,
    Rescue128ChainProver,
    build_rescue128_chain_trace,
)
from starkpack_winterfell_tpu_torch.models.rescue_chain import (
    ChainInputs,
    RescueChainAir,
    RescueChainProver,
    build_chain_trace,
)
from starkpack_winterfell_tpu_torch.ops import cons_kernel
from starkpack_winterfell_tpu_torch.ops import gl64 as gl
from starkpack_winterfell_tpu_torch.ops import limb_ntt
from starkpack_winterfell_tpu_torch.ops import ntt4
from starkpack_winterfell_tpu_torch.ops import ntt_kernel
from starkpack_winterfell_tpu_torch.ops.backend import get_backend
from starkpack_winterfell_tpu_torch.parallel import full_pipeline
from starkpack_winterfell_tpu_torch.parallel.full_pipeline import plan_groups

from kernel_times import ProfilerDroppedRecords, device_kernel_ms, timed_prove

BENCH_OPTIONS = (28, 8, 16, FieldExtension.NONE, 4, 31)
BLOWUP = 8
WIDTH = 12
COMPOSITION_COLUMNS = 7
# the three proves this script drives: name -> (log2 of the rows, instances)
PATHS = {"small": (14, 1), "main": (20, 1), "aggregated": (16, 4)}
# the limb-field proves (limb_fib, limb_fib62: the cheap second AIR over
# f128 and over f62): name -> (log2 of the rows, instances)
LIMB_PATHS = {"limb_small": (12, 1), "limb_fib": (9, 2), "limb_fib62": (9, 2),
              "limb_main": (18, 1), "limb_aggregated": (14, 4)}
LIMB_WIDTH = 6
# the small-trace proves: name -> (log2 of the rows, instances)
SMALL_TRACE_PATHS = {"small_trace_golden": (6, 2), "small_trace_main_do_work": (10, 32),
                     "small_trace_main_rescue": (13, 64)}
GOLDEN_OPTIONS = (16, 8, 0, FieldExtension.NONE, 4, 31)
# the Lamport+ proves: name -> (signatures, message bits k); a signature is
# 8 * (k + 1) rows.  lamport128_aggregated: that many StarkPack instances of
# one signature each
LAMPORT_PATHS = {"lamport_agg_golden": (4, 15), "lamport_agg_64": (64, 127),
                 "lamport_agg_main": (1024, 127), "lamport128_aggregated": (4, 127)}

# NVIDIA H100 SXM: HBM bandwidth from the data sheet; 32-bit integer rate
# from 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock, one operation per
# lane and clock (half the data sheet's 67 TFLOP/s float32 rate counted
# without the FMA's factor of two)
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit integer ALU instructions of one Goldilocks operation on 64-bit
# words, counted in the SASS that nvcc 12.8 emits for sm_90a by
# starkpack_winterfell_tpu_torch/csrc/gl64_sass_count.py
OPS_FIELD_MUL = 28
OPS_FIELD_ADD = 10
OPS_FIELD_SUB = 8

# the same for one limb-field operation (same script): f128 on {lo, hi}
# words, f62 on one word
OPS_LIMB = {"f128": {"mul": 130, "sqr": 114, "add": 25, "sub": 20},
            "f62": {"mul": 78, "sqr": 74, "add": 8, "sub": 8}}

GOLDEN_LIMB = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "starkpack_winterfell_tpu_torch", "golden", "rescue128_12_bench.sha256",
)
GOLDEN = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "starkpack_winterfell_tpu_torch", "golden", "rescue14_bench.sha256",
)
GOLDEN_SMALL_TRACE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "starkpack_winterfell_tpu_torch", "golden", "do_work_2x64.sha256",
)
GOLDEN_LAMPORT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "starkpack_winterfell_tpu_torch", "golden", "lamport_agg_4x512_b192.sha256",
)


START = time.perf_counter()


def emit(phase: str, **fields):
    """One phase's JSON line; ``at_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - START}),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# kernel shapes of the driven paths
# ---------------------------------------------------------------------------


def path_shapes(log2_rows: int, n_inst: int):
    """(label, (dif, B, n, lanes, epilogue, interleave, pre, transposed)) of
    every tile transform one prove of ``n_inst`` traces of 2^log2_rows rows
    launches: the trace interpolate+LDE (batch = 12 columns per instance),
    the composition interpolate (one per instance) and the composition
    column LDE (the 7 columns of the instances' sum, each 1/ce_over_length
    of the permuted rows, zero-interleaved back to the LDE's rows).  Two
    steps may share a shape."""
    length = 1 << log2_rows
    L = length * BLOWUP
    a, b, Bf = ntt4._pick_factors(length, L)
    w = WIDTH * n_inst
    ce = L  # degree-7 cycle-8 constraints: the ce domain is the LDE domain
    a2, b2, Bf2 = ntt4._pick_factors(ce, L)
    nc = COMPOSITION_COLUMNS
    rows_col = b2 // (ce // length)
    return [
        ("trace K1", (True, w, a, b, True, 1, False, True)),
        ("trace K2", (True, w, b, a, True, 1, False, False)),
        ("trace K3", (False, w, Bf, a, True, Bf // b, False, True)),
        ("trace K4", (False, w, a, Bf, False, 1, False, False)),
        ("composition K1", (True, n_inst, a2, b2, True, 1, False, True)),
        ("composition K2", (True, n_inst, b2, a2, True, 1, False, False)),
        ("composition K3", (False, nc, Bf2, a2, True, Bf2 // rows_col, True, True)),
        ("composition K4", (False, nc, a2, Bf2, False, 1, False, False)),
    ]


def expected_launches(path: str) -> collections.Counter:
    return collections.Counter(key for _, key in path_shapes(*PATHS[path]))


def random_words(shape, rng, device):
    """Canonical field elements drawn with numpy from the run's seed."""
    arr = rng.integers(0, gl.P, size=shape, dtype=np.uint64)
    return gl.from_u64(arr, device)


def time_cuda(fn, reps: int):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events around
    each call: the call's time, host work of the wrapper included (the
    kernel's own time is ``device_kernel_ms``, from the profiler)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_timing(fn, match, bound_ms, wrapper_module):
    """The timing keys of a kernel's row: ``call_ms``, CUDA events around one
    call of ``fn`` (host work of the wrapper included), during which the
    wrapper's launch count (``wrapper_module.LAUNCHES``) must show a launch
    every call; ``device_ms``, the device time of the kernels named by
    ``match`` in one call (profiler, ``device_kernel_ms``); ``bound_share``.
    Where the profiler lost the records of too many calls in every session,
    ``device_ms`` and ``bound_share`` are null and ``ms`` is the call's time
    (``ms_source``)."""
    before = wrapper_module.LAUNCHES
    call_ms = time_cuda(fn, 7)
    launched = wrapper_module.LAUNCHES - before
    if launched < 8:
        raise RuntimeError(f"{match}: {launched} launches counted in 8 calls")
    try:
        device_ms = device_kernel_ms(fn, match, sessions=6)
    except ProfilerDroppedRecords as e:
        print(f"chip_smoke: {e}; ms is the call's time", file=sys.stderr, flush=True)
        return {"ms": call_ms, "ms_source": "call", "device_ms": None,
                "call_ms": call_ms, "bound_share": None}
    return {"ms": device_ms, "ms_source": "device", "device_ms": device_ms,
            "call_ms": call_ms, "bound_share": bound_ms / device_ms}


def tile_bound(dif: bool, B: int, n: int, lanes: int, epilogue: bool,
               interleave: int = 1, pre: bool = False, transposed: bool = False):
    """Least time (ms) the card could take for one tile transform: every
    input read once and the output written once against the memory rate, or
    its field operations against the integer rate, whichever is larger.  A
    zero-interleaved input counts the rows read (n / interleave) and the
    stages after the log2(interleave) that only copy; each table multiply 28
    instructions per word it multiplies.  The store's layout costs nothing."""
    words = B * n * lanes
    words_in = words // interleave
    nbytes = 8 * (words_in + words + n // 2 + (n * lanes if epilogue else 0)
                  + (n // interleave * lanes if pre else 0))
    stages = n.bit_length() - interleave.bit_length()
    butterfly = OPS_FIELD_MUL + OPS_FIELD_ADD + OPS_FIELD_SUB  # per two words
    ops = words * stages * butterfly // 2
    if epilogue:
        ops += words * OPS_FIELD_MUL
    if pre:
        ops += words_in * OPS_FIELD_MUL
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tile_name(key):
    dif, B, n, lanes, epilogue, interleave, pre, transposed = key
    opts = "".join([" +epilogue" if epilogue else "", f" +interleave={interleave}" if interleave > 1 else "",
                    " +pre" if pre else "", " +transposed" if transposed else ""])
    return f"ntt_tile[{'DIF' if dif else 'DIT'} B={B} n={n} lanes={lanes}{opts}]"


def tile_args(key, rng, device):
    """Random inputs of one tile shape: (x, tw, dif, epilogue, interleave,
    pre, transposed) as ``ntt_tile`` takes them."""
    dif, B, n, lanes, epilogue, interleave, pre, transposed = key
    rows_in = n // interleave
    return (random_words((B, rows_in, lanes), rng, device), ntt4.tile_twiddles(n, dif, device),
            dif, random_words((n, lanes), rng, device) if epilogue else None, interleave,
            random_words((rows_in, lanes), rng, device) if pre else None, transposed)


# every option of the tile kernel at small shapes, ragged lane groups and the
# smallest length; the shapes the proves launch come on top
TILE_OPTION_KEYS = [
    (dif, B, n, lanes, ep, f, pre, tr)
    for (B, n, lanes) in ((3, 2, 4096), (5, 2, 3), (2, 16, 33), (1, 256, 130), (2, 4096, 5))
    for dif in (True, False) for ep in (True, False) for pre in (False, True)
    for tr in (False, True) for f in ((1,) if dif else (1, 2, 8)) if f < n
]


def phase_kernels(rng, device):
    """Holds the kernel against its plain version on the card, 0 mismatching
    words required: at every shape and option set any of the driven paths
    launches, and at every option combination (DIF/DIT, epilogue,
    pre-multiply, transposed store, zero-interleaved input) at small shapes;
    times the shapes the paths launch.  Returns the table rows keyed by
    (dif, B, n, lanes, epilogue, interleave, pre, transposed)."""
    used = {}
    for path, args in PATHS.items():
        for label, key in path_shapes(*args):
            used.setdefault(key, []).append(f"{path} {label}")
    rows, compared, mismatching = {}, 0, 0
    for key in list(used) + [k for k in TILE_OPTION_KEYS if k not in used]:
        args = tile_args(key, rng, device)
        got = ntt4.ntt_tile(*args)
        want = ntt4.ntt_tile_plain(*args)
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        compared += 1
        mismatching += mism
        if mism:
            raise RuntimeError(f"ntt_tile disagrees with its plain version in {mism} "
                               f"words at {tile_name(key)}")
        if key in used:
            err = float((got - want).abs().max())
            del got, want
            bound_ms, bound_by = tile_bound(*key)
            timing = kernel_timing(lambda: ntt4.ntt_tile(*args), "ntt_tile_kernel", bound_ms,
                                   ntt4)
            plain_ms = time_cuda(lambda: ntt4.ntt_tile_plain(*args), 2)
            rows[key] = {
                "name": tile_name(key),
                "route": "cuda",
                "source": "starkpack_winterfell_tpu_torch/csrc/ntt_tile.cu",
                "replaces": "starkpack_winterfell_tpu/ops/pallas/ntt4.py:112",
                "used_by": used[key],
                "launches": 0,
                "launches_by_path": {},
                "max_abs_err": err,
                **timing,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            }
        del args
        torch.cuda.empty_cache()
    emit("kernels", names=["ntt_tile_kernel<DIF, K>", "ntt_tile_kernel<DIT, K>"],
         tolerance="exact (modular integer arithmetic)",
         compared=compared, mismatching_words=mismatching,
         shapes=[{k: r[k] for k in ("name", "used_by", "device_ms", "call_ms", "plain_ms",
                                    "bound_ms", "bound_by", "bound_share")}
                 for r in rows.values()])
    return rows


# ---------------------------------------------------------------------------
# kernels 2 and 3: the DIT transforms of ops/ntt_kernel.py
# ---------------------------------------------------------------------------


def dit_inputs(key, rng, device, inverse=False):
    """(function, plain version, arguments) of one DIT kernel shape:
    ("last", rows, n, n_in, strides of x, has pre, has scale) or ("axis1",
    B, n, lanes, has pre).  x of ``ntt_last`` is laid out with the key's
    strides (a transposed view where the prove passes one)."""
    if key[0] == "last":
        _, rows, n, n_in, strides, has_pre, has_scale = key
        size = 1 + (rows - 1) * strides[0] + (n_in - 1) * strides[1]
        x = torch.as_strided(random_words((size,), rng, device), (rows, n_in), strides)
        args = (x, ntt4.tile_twiddles(n, inverse, device), n,
                random_words((n_in,), rng, device) if has_pre else None,
                int(rng.integers(0, gl.P, dtype=np.uint64)) if has_scale else None)
        return ntt_kernel.ntt_last, ntt_kernel.ntt_last_plain, args
    _, B, n, lanes, has_pre = key
    args = (random_words((B, n, lanes), rng, device),
            ntt4.tile_twiddles(n, False, device),
            random_words((n, lanes), rng, device) if has_pre else None)
    return ntt_kernel.dit_axis1, ntt_kernel.dit_axis1_plain, args


def dit_mismatches(key, rng, device, inverse=False):
    fn, plain, args = dit_inputs(key, rng, device, inverse)
    got, want = fn(*args), plain(*args)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    if mism:
        raise RuntimeError(f"ntt_dit disagrees with its plain version in {mism} "
                           f"words at {key}")
    return fn, plain, args, float((got - want).abs().max())


def last_bound(rows: int, n: int, n_in: int, pre: bool, scale: bool):
    """Least time (ms) of one ``ntt_last`` launch: the input rows read once,
    the output written once; the stages after the log2(n / n_in) that a
    zero-padded row only copies, 28 instructions a word and table multiply."""
    nbytes = 8 * (rows * n_in + rows * n + n // 2 + (n_in if pre else 0))
    stages = n.bit_length() - (n // n_in).bit_length()
    ops = rows * n * stages * (OPS_FIELD_MUL + OPS_FIELD_ADD + OPS_FIELD_SUB) // 2
    ops += OPS_FIELD_MUL * ((rows * n_in if pre else 0) + (rows * n if scale else 0))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_dit(key, rng, device, used_by):
    """Kernel 2 or 3 at one launched shape: the wrapper against its plain
    version (0 mismatching words required), then its times and bound."""
    fn, plain, args, err = dit_mismatches(key, rng, device)
    if key[0] == "last":
        _, rows, n, n_in, strides, has_pre, has_scale = key
        name = (f"ntt_last[rows={rows} n={n}{f' n_in={n_in}' if n_in < n else ''}"
                f"{f' strides={strides}' if strides != (n_in, 1) else ''}"
                f"{' +pre' if has_pre else ''}{' +scale' if has_scale else ''}]")
        replaces = "starkpack_winterfell_tpu/ops/pallas/ntt_kernel.py:91"
        match = "ntt_last"
        bound_ms, bound_by = last_bound(rows, n, n_in, has_pre, has_scale)
    else:
        B, n, lanes, has_pre = key[1:]
        name = f"ntt_dit_axis1[B={B} n={n} lanes={lanes}{' +pre' if has_pre else ''}]"
        replaces = "starkpack_winterfell_tpu/ops/pallas/ntt_kernel.py:224"
        match = "ntt_dit_axis1_kernel"
        bound_ms, bound_by = tile_bound(False, B, n, lanes, has_pre)
    timing = kernel_timing(lambda: fn(*args), match, bound_ms, ntt_kernel)
    plain_ms = time_cuda(lambda: plain(*args), 1)
    del args
    torch.cuda.empty_cache()
    return {
        "name": name, "route": "cuda",
        "source": "starkpack_winterfell_tpu_torch/csrc/ntt_dit.cu",
        "replaces": replaces,
        "used_by": [used_by], "launches": 0, "launches_by_path": {},
        "max_abs_err": err, **timing,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }


def phase_dit_kernels(rng, device):
    """Both DIT kernels against their plain versions at fixed shapes before
    any prove runs: ``ntt_last`` at every length 2 ... 4096, forward and
    inverse, with and without the pre-multiply and the scale, zero-padded
    rows, transposed views, one row and ragged row blocks; ``dit_axis1`` at
    the smallest and the largest length, one lane, ragged lane groups, with
    and without the pre-multiply.  The shapes the proves launch are compared,
    and timed, in the proves' own phases."""
    keys = [("last", rows, 1 << bits, 1 << bits, (1 << bits, 1), pre, sc)
            for bits, rows in zip(range(1, 13), (5000, 257, 3, 1000, 33, 25, 7, 300, 2, 9, 1, 3))
            for pre in (False, True) for sc in (False, True)]
    keys += [("last", 25, 64, 8, (8, 1), True, False), ("last", 3, 4096, 512, (512, 1), True, True),
             ("last", 70000, 4, 4, (1, 70000), False, True), ("last", 5, 32, 4, (4, 1), True, False),
             ("last", 33, 128, 128, (1, 33), True, True)]
    keys += [("axis1", 3, 2, 3, True), ("axis1", 2, 64, 130, False),
             ("axis1", 2, 64, 130, True), ("axis1", 5, 256, 768, True),
             ("axis1", 2, 4096, 9, True), ("axis1", 1, 4096, 4, False)]
    compared = 0
    for key in keys:
        for inverse in ((False, True) if key[0] == "last" else (False,)):
            dit_mismatches(key, rng, device, inverse)
            compared += 1
    emit("dit_kernels", names=["ntt_last_reg_kernel<LOGN>", "ntt_last_kernel",
                               "ntt_dit_axis1<PRE>", "ntt_dit_axis1"],
         tolerance="exact (modular integer arithmetic)",
         compared=compared, mismatching_words=0, shapes=[list(k) for k in keys])


# ---------------------------------------------------------------------------
# proofs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def table_build_launches():
    """Counts by shape (``observed_counts`` keys) of the launches made while
    the limb pipeline builds its per-config tables (``full_pipeline._cached``:
    offsets, divisor and periodic tables), which a later prove of the same
    config finds built and does not launch again."""
    built = collections.Counter()
    cached, depth = full_pipeline._cached, [0]

    def counting(key, make):
        if depth[0] or key in full_pipeline._TABLE_CACHE:
            return cached(key, make)
        before = observed_counts()
        depth[0] += 1
        try:
            return cached(key, make)
        finally:
            depth[0] -= 1
            for k, v in observed_counts().items():
                built[k] += v - before.get(k, 0)

    full_pipeline._cached = counting
    try:
        yield built
    finally:
        full_pipeline._cached = cached


def first_prove(path, prover, traces, kernel_rows, rng, device, airs=None):
    """A first prove of a size shows which shapes of the kernels whose
    shapes are not known in advance (the DIT and the limb kernels) the path
    launches; each shape not yet in the table is held against its plain
    version.  Returns (proof, seconds, the counts a steady prove must show:
    the first prove's less its table builds, rows of the new shapes)."""
    reset_observed_counts()
    with table_build_launches() as built:
        proof, seconds, _ = timed_prove(prover, traces)
    seen = observed_counts()
    new_rows = {}
    for key in seen:
        if key in kernel_rows:
            continue
        if key[0] == "dit":
            new_rows[key] = compare_dit(key[1:], rng, device, path)
        elif key[0] == "ntt":
            new_rows[key] = compare_limb_tile(key[1:], rng, device, path)
        else:
            new_rows[key] = compare_cons(key[1:], airs[key[1:3]], rng, device, path)
    steady = {k: v - built[k] for k, v in seen.items() if v > built[k]}
    return proof, seconds, steady, new_rows


def record_observed(path, seen, new_rows, kernel_rows, required):
    """Reads the counts just after a counted prove: it must have launched
    every kind of kernel in ``required``, only compared shapes, and each as
    often as ``seen`` (the first prove's counts less its table builds) says.
    The counts go into the table."""
    counted = observed_counts()
    kinds = {k[0] for k in counted}
    if not set(required) <= kinds or any(seen.get(k) != v for k, v in counted.items()):
        raise RuntimeError(f"the {path} prove launched {counted}, required kinds "
                           f"{required}, compared were {seen}")
    for key, count in counted.items():
        if key not in kernel_rows:
            kernel_rows[key] = new_rows[key]
        elif path not in kernel_rows[key]["used_by"]:
            kernel_rows[key]["used_by"].append(path)
        kernel_rows[key]["launches"] += count
        kernel_rows[key]["launches_by_path"][path] = count
    return counted


def counted_prove(path, prover, traces, kernel_rows, seen, new_rows):
    """One prove of the path with every launch count set to 0 just before
    and read just after.  The launched tile shapes and their counts must be
    exactly those ``path_shapes`` lists (all of them held against the plain
    version by the kernels phase), the DIT shapes (periodic columns, FRI
    folds) those of the first prove; the counts go into the table."""
    ntt4.reset_launch_counts()
    reset_observed_counts()
    proof, seconds, phases = timed_prove(prover, traces)
    dit = record_observed(path, seen, new_rows, kernel_rows, ("dit",))
    total = ntt4.LAUNCHES
    by_shape = collections.Counter(ntt4.LAUNCHES_BY_SHAPE)
    expected = expected_launches(path)
    if total <= 0:
        raise RuntimeError(f"the {path} prove launched the NTT kernel no time")
    if by_shape != expected:
        raise RuntimeError(
            f"the {path} prove launched {dict(by_shape)}, expected {dict(expected)}"
        )
    for key, count in by_shape.items():
        kernel_rows[key]["launches"] += count
        kernel_rows[key]["launches_by_path"][path] = count
    launches = {kernel_rows[key]["name"]: count for key, count in by_shape.items()}
    launches.update({kernel_rows[key]["name"]: count for key, count in dit.items()})
    return proof, seconds, phases, total + sum(dit.values()), launches


def verified_bytes(prover, proof, traces):
    """Serialize, parse back, verify with the port's verifier."""
    data = proof.to_bytes()
    parsed = proof.from_bytes(data)
    if parsed.to_bytes() != data:
        raise RuntimeError("proof serialization round trip failed")
    pub = [prover.get_pub_inputs(t) for t in traces]
    t0 = time.perf_counter()
    verify(RescueChainAir, parsed, pub, Blake3_256)
    return data, time.perf_counter() - t0


def phase_small(prover, kernel_rows, rng, device):
    rows = 1 << PATHS["small"][0]
    traces = [build_chain_trace([7] * 8, rows // 8)]
    _, _, seen, new_rows = first_prove("small", prover, traces, kernel_rows, rng, device)
    proof, seconds, _, total, launches = counted_prove(
        "small", prover, traces, kernel_rows, seen, new_rows)
    data, verify_s = verified_bytes(prover, proof, traces)
    digest = hashlib.sha256(data).hexdigest()
    with open(GOLDEN) as f:
        pinned = f.read().strip()
    if digest != pinned:
        raise RuntimeError(f"2^14 proof digest {digest} differs from pinned {pinned}")
    emit("small", rows=rows, sha256=digest, matches_pinned=True,
         prove_s=seconds, verify_s=verify_s, proof_bytes=len(data),
         kernel_launches=total, launches=launches)


def phase_main(prover, kernel_rows, rng, device):
    rows = 1 << PATHS["main"][0]
    t0 = time.perf_counter()
    traces = [build_chain_trace([7] * 8, rows // 8)]
    trace_s = time.perf_counter() - t0
    _, first_s, seen, new_rows = first_prove("main", prover, traces, kernel_rows, rng, device)
    torch.cuda.reset_peak_memory_stats()
    proof, steady_s, phases, total, launches = counted_prove(
        "main", prover, traces, kernel_rows, seen, new_rows)
    peak = torch.cuda.max_memory_allocated()
    data, verify_s = verified_bytes(prover, proof, traces)
    emit("main", rows=rows, columns=WIDTH, n=1,
         trace_build_s=trace_s, first_prove_s=first_s, steady_prove_s=steady_s,
         phases_ms={name: ms for name, ms in phases},
         kernel_launches=total, launches=launches, peak_memory_bytes=peak,
         proof_bytes=len(data), verify_s=verify_s, verified=True)


def phase_aggregated(prover, kernel_rows, rng, device):
    log2_rows, n = PATHS["aggregated"]
    rows = 1 << log2_rows
    seeds = rng.integers(0, gl.P, size=(n, 8), dtype=np.uint64)
    traces = [build_chain_trace([int(v) for v in s], rows // 8) for s in seeds]
    _, _, seen, new_rows = first_prove("aggregated", prover, traces, kernel_rows, rng, device)
    proof, seconds, _, total, launches = counted_prove(
        "aggregated", prover, traces, kernel_rows, seen, new_rows)
    data, verify_s = verified_bytes(prover, proof, traces)
    pub = [prover.get_pub_inputs(t) for t in traces]
    pub[2] = ChainInputs([(pub[2].seed[0] + 1) % gl.P] + pub[2].seed[1:], pub[2].result)
    try:
        verify(RescueChainAir, proof.from_bytes(data), pub, Blake3_256)
    except VerifierError as e:
        rejected = str(e)
    else:
        raise RuntimeError("a tampered public input was accepted")
    emit("aggregated", n=n, rows=rows, prove_s=seconds, verify_s=verify_s,
         proof_bytes=len(data), verified=True, tampered_rejected=rejected,
         kernel_launches=total, launches=launches)


# ---------------------------------------------------------------------------
# the limb-field path: kernels 4 (limb NTT tile) and 5 (constraint evaluation)
# ---------------------------------------------------------------------------

# fib over a limb field: (air class, build_trace, prover class, inputs)
FIB = {field: get_fib_family(field) for field in ("f128", "f62")}


def limb_air_config(air0):
    """(w, periodic columns, K, plan groups) of the constraint kernel of an
    AIR — what keys its emitted source."""
    template = air0.get_boundary_constraints(None, [0] * air0.context.num_assertions())
    return (air0.trace_info().width(), len(air0.get_periodic_column_values()),
            air0.context.num_transition_constraints(), plan_groups(template))


def smoke_airs():
    """One AIR object per constraint kernel the limb phases launch (the
    emitted body depends on the AIR class and which assertions are
    sequences, not on the sizes: 4 signatures stand for any number)."""
    options = ProofOptions(*BENCH_OPTIONS)
    airs = {("f128", "Rescue128ChainAir"): Rescue128ChainAir(
        TraceInfo(LIMB_WIDTH, 64), Rescue128ChainInputs([1, 2], [3, 4]), options)}
    for field, fam in FIB.items():
        airs[(field, "FibAirF")] = fam[0](TraceInfo(2, 64), fam[3](5), options)
    airs[("f128", "Lamport128AggAir")] = lagg.Lamport128AggAir(
        TraceInfo(lam.TRACE_WIDTH, 512), lagg.LamportAggInputs([1] * 4, [[1, 2]] * 4), options)
    airs[("f128", "Lamport128Air")] = lam.Lamport128Air(
        TraceInfo(lam.TRACE_WIDTH, 128), lam.Lamport128Inputs(1, [1, 2]), options)
    return airs


def random_limb(field, shape, rng, device):
    """Canonical elements of a limb field drawn with numpy from the run's
    seed, as word planes: f128 (lo, hi) with hi below 2^64 - 1, which keeps
    every value below p; f62 one word below p."""
    if field == "f62":
        return (gl.from_u64(rng.integers(0, get_backend("f62").P, size=shape,
                                         dtype=np.uint64), device),)
    lo = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    hi = rng.integers(0, (1 << 64) - 1, size=shape, dtype=np.uint64)
    return gl.from_u64(lo, device), gl.from_u64(hi, device)


def mismatching(got, want):
    return sum(int((g != w).sum()) for g, w in zip(got, want))


def limb_tile_bound(field: str, n: int, B: int, lanes: int, has_pre: bool):
    """Least time (ms) for one limb tile transform; see ``tile_bound``."""
    cost = OPS_LIMB[field]
    elems = B * n * lanes
    el_bytes = get_backend(field).ELEMENT_BYTES
    nbytes = el_bytes * (2 * elems + n // 2 + (n * lanes if has_pre else 0))
    stages = n.bit_length() - 1
    ops = elems * stages * (cost["mul"] + cost["add"] + cost["sub"]) // 2
    if has_pre:
        ops += elems * cost["mul"]
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_limb_tile(key, rng, device, used_by):
    """Kernel 4 at one launched shape: the wrapper against its plain version
    (0 mismatching words required), then the tile transform's time."""
    field, inverse, B, n, lanes, has_pre = key
    F = get_backend(field).F
    if has_pre:
        a = random_limb(field, (B, lanes, n), rng, device)
        pre = random_limb(field, (lanes, n), rng, device)
    else:
        a = random_limb(field, (lanes, n), rng, device)
        pre = None
    got = limb_ntt.ntt_last_axis(F, a, inverse, pre)
    want = limb_ntt.ntt_last_axis_plain(F, a, inverse, pre)
    torch.cuda.synchronize()
    mism = mismatching(got, want)
    if mism:
        raise RuntimeError(f"limb_ntt_tile disagrees with its plain version in "
                           f"{mism} words at {key}")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    del got, want, a
    x = random_limb(field, (B, n, lanes), rng, device)
    pt = random_limb(field, (n, lanes), rng, device) if has_pre else None
    tw = limb_ntt.tile_twiddles(F, n, inverse, device)
    bound_ms, bound_by = limb_tile_bound(field, n, B, lanes, has_pre)
    timing = kernel_timing(lambda: limb_ntt._tile_launch(F, x, tw, pt, inverse),
                           "limb_ntt_tile_kernel", bound_ms, limb_ntt)
    plain_ms = time_cuda(lambda: limb_ntt.tile_plain(F, x, tw, pt), 1)
    torch.cuda.empty_cache()
    return {
        "name": f"limb_ntt_tile[{field} {'inverse' if inverse else 'forward'} B={B} n={n} "
                f"lanes={lanes}{' +pre' if has_pre else ''}]",
        "route": "cuda",
        "source": "starkpack_winterfell_tpu_torch/csrc/limb_ntt_tile.cu",
        "replaces": "starkpack_winterfell_tpu/ops/pallas/limb_kernel.py:151",
        "used_by": [used_by], "launches": 0, "launches_by_path": {},
        "max_abs_err": err, **timing,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }


def ptxas_report(lib_name: str):
    """nvcc seconds and ptxas's registers, spills and stack frame of each
    kernel of a library this process built (``native.BUILD_LOGS``)."""
    if lib_name not in native.BUILD_LOGS:
        return None
    seconds, log = native.BUILD_LOGS[lib_name]
    kernels, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = kernels.setdefault(m.group(1), {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current is not None:
            current.update(stack_frame_bytes=int(m.group(1)),
                           spill_store_bytes=int(m.group(2)),
                           spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    return {"nvcc_s": seconds, "kernels": kernels}


def compare_cons(key, air0, rng, device, used_by):
    """Kernel 5 at one launched shape (AIR, n, w, ce, sequence tables) on
    random inputs: kernel against ``constraint_eval_plain``, then its time."""
    field, air_name, n, w, ce, n_seq = key
    B = get_backend(field)
    cost, el_bytes = OPS_LIMB[field], B.ELEMENT_BYTES
    w_air, n_per, K, groups = limb_air_config(air0)
    assert w_air == w and cons_kernel.seq_count(groups) == n_seq
    shift = BLOWUP // air0.ce_blowup_factor()
    L = ce * shift
    n_ccs = sum(len(g) for g in groups)
    rows = (random_limb(field, (n, w, L), rng, device),)
    # one period of each periodic column over the ce domain, at its own period
    periods = [len(c) * air0.ce_blowup_factor() for c in air0.get_periodic_column_values()]
    pers = [random_limb(field, (p,), rng, device) for p in periods]
    divs = [random_limb(field, (ce,), rng, device) for _ in range(1 + len(groups))]
    seqs = [random_limb(field, (n, ce), rng, device) for _ in range(n_seq)]
    scal = torch.stack(random_limb(field, (n, K + 2 * n_ccs - n_seq + 1), rng, device),
                       dim=-1).contiguous()
    args = (B, air0, groups, K, shift, BLOWUP, rows, pers, divs, scal, seqs)
    got = cons_kernel.constraint_eval(*args)[0]
    want = cons_kernel.constraint_eval_plain(*args)[0]
    torch.cuda.synchronize()
    mism = mismatching(got, want)
    if mism:
        raise RuntimeError(f"the constraint kernel disagrees with its plain "
                           f"version in {mism} words at {key}")
    err = max(float((g - x).abs().max()) for g, x in zip(got, want))
    del got, want
    # bound: every input read once, the output written once; the recorded
    # transition plus the frame's operations per point and instance
    counts = cons_kernel.count_ops(cons_kernel.record_transition(air0, w, n_per, K)[0])
    mul = counts["mul"] + K + 1 + len(groups) + n_ccs + 1
    add = counts["add"] + (K - 1) + len(groups) + n_ccs + 1
    sub = counts["sub"] + counts["neg"] + n_ccs
    ops = n * ce * (mul * cost["mul"] + counts["sqr"] * cost["sqr"]
                    + add * cost["add"] + sub * cost["sub"])
    nbytes = (el_bytes * (n * w * L + sum(periods) + (1 + len(groups)) * ce
                          + n_seq * n * ce + ce)
              + 8 * scal.numel())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    bound_ms, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    timing = kernel_timing(lambda: cons_kernel.constraint_eval(*args), "cons_eval_kernel",
                           bound_ms, cons_kernel)
    plain_ms = time_cuda(lambda: cons_kernel.constraint_eval_plain(*args), 1)
    lib_name, path = cons_kernel.kernel_source(air0, w, n_per, K, groups)
    del rows, pers, divs, seqs, args
    torch.cuda.empty_cache()
    row = {
        "name": f"cons_eval[{field} {air_name} n={n} w={w} ce={ce}"
                f"{f' seq={n_seq}' if n_seq else ''}]",
        "route": "cuda",
        "source": "starkpack_winterfell_tpu_torch/csrc/cons_frame.cuh + "
                  "ops/cons_kernel.py emit_cuda",
        "emitted_source": os.path.relpath(path, os.path.dirname(os.path.abspath(__file__))),
        "emitted_lines": open(path).read().count("\n"),
        "field_ops_per_point": {"mul": mul, "sqr": counts["sqr"], "add": add, "sub": sub},
        "sequence_table_bytes": el_bytes * n_seq * n * ce,
        "ptxas": ptxas_report(lib_name),
        "replaces": "starkpack_winterfell_tpu/ops/pallas/cons_kernel.py:137",
        "used_by": [used_by], "launches": 0, "launches_by_path": {},
        "max_abs_err": err, **timing,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    }
    return row


def observed_counts():
    """Launch counts by shape of the kernels whose shapes a first prove
    shows: ("dit", ...) kernels 2 and 3, ("ntt", ...) kernel 4, ("cons",
    ...) kernel 5."""
    shapes = {("dit",) + k: v for k, v in ntt_kernel.LAUNCHES_BY_SHAPE.items()}
    shapes.update({("ntt",) + k: v for k, v in limb_ntt.LAUNCHES_BY_SHAPE.items()})
    shapes.update({("cons",) + k: v for k, v in cons_kernel.LAUNCHES_BY_SHAPE.items()})
    return shapes


def reset_observed_counts():
    ntt_kernel.reset_launch_counts()
    limb_ntt.reset_launch_counts()
    cons_kernel.reset_launch_counts()


def observed_phase(path, prover, air_class, traces, kernel_rows, rng, device,
                   required, airs=None, golden=None, tampers=(), **extra):
    """One size of a path whose kernel shapes are read off a first prove
    (``first_prove``): each new shape is held against its plain version;
    then the counted prove must launch every kind of kernel in ``required``,
    only compared shapes, each as often as the first prove did less the
    launches of its table builds.  (The first prove of a limb config also
    builds its periodic and divisor tables, which later proves find cached:
    those shapes are compared too, and a shape launched by them alone is
    named ``first_prove_only`` in the phase's line.)  ``tampers``: (name,
    function of the public inputs) pairs, each of whose results the verifier
    must reject; ``extra`` goes into the phase's line."""
    n = len(traces)
    hasher = prover.hasher
    pub = [prover.get_pub_inputs(t) for t in traces]
    first_proof, first_s, seen, new_rows = first_prove(
        path, prover, traces, kernel_rows, rng, device, airs)
    verify(air_class, first_proof, pub, hasher)
    del first_proof

    reset_observed_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # tables cached by earlier proves
    proof, seconds, phases = timed_prove(prover, traces)
    peak = torch.cuda.max_memory_allocated()
    counted = record_observed(path, seen, new_rows, kernel_rows, required)
    data = proof.to_bytes()
    parsed = proof.from_bytes(data)
    if parsed.to_bytes() != data:
        raise RuntimeError("proof serialization round trip failed")
    t0 = time.perf_counter()
    verify(air_class, parsed, pub, hasher)
    verify_s = time.perf_counter() - t0
    fields = dict(extra)
    if golden is not None:
        digest = hashlib.sha256(data).hexdigest()
        with open(golden) as f:
            pinned = f.read().strip()
        if digest != pinned:
            raise RuntimeError(f"{path} proof digest {digest} differs from pinned {pinned}")
        fields.update(sha256=digest, matches_pinned=True)
    for name, tamper in tampers:
        try:
            verify(air_class, proof.from_bytes(data), tamper(pub), hasher)
        except VerifierError as e:
            fields.setdefault("tampered_rejected", {})[name] = str(e)
        else:
            raise RuntimeError(f"a tampered public input ({name}) was accepted")
    el_bytes = traces[0].spec.ELEMENT_BYTES
    lde_bytes = n * traces[0].width * (traces[0].length * BLOWUP) * el_bytes
    emit(path, rows=traces[0].length, columns=traces[0].width, n=n,
         field=traces[0].field, hasher=hasher.NAME,
         first_prove_s=first_s, steady_prove_s=seconds,
         phases_ms={name: ms for name, ms in phases},
         shapes_compared=len(new_rows), mismatching_words=0,
         first_prove_only=[new_rows[k]["name"] for k in new_rows if k not in counted],
         dit_launches=sum(v for k, v in counted.items() if k[0] == "dit"),
         ntt_launches=sum(v for k, v in counted.items() if k[0] == "ntt"),
         cons_launches=sum(v for k, v in counted.items() if k[0] == "cons"),
         launches={kernel_rows[k]["name"]: v for k, v in counted.items()},
         peak_memory_bytes=peak, resident_before_bytes=resident,
         peak_over_main_lde=(peak - resident) / lde_bytes,
         proof_bytes=len(data), verify_s=verify_s, verified=True, **fields)


def tamper_seed(pub):
    bad = list(pub)
    bad[-1] = Rescue128ChainInputs(
        [(bad[-1].seed[0] + 1) % get_backend("f128").P, bad[-1].seed[1]], bad[-1].result)
    return bad


def limb_phases(kernel_rows, rng, device):
    airs = smoke_airs()
    options = ProofOptions(*BENCH_OPTIONS)
    prover = Rescue128ChainProver(options, Blake3_256)

    rows = 1 << LIMB_PATHS["limb_small"][0]
    both = ("ntt", "cons")
    observed_phase("limb_small", prover, Rescue128ChainAir,
                   [build_rescue128_chain_trace([7, 9], rows // 8)],
                   kernel_rows, rng, device, both, airs, golden=GOLDEN_LIMB)

    # the cheap second AIR over both limb fields: other emitted bodies of
    # the constraint kernel, and the f62 instantiation of both kernels
    for path, field in (("limb_fib", "f128"), ("limb_fib62", "f62")):
        fib_air, fib_build, fib_prover, _ = FIB[field]
        log2_rows, n = LIMB_PATHS[path]
        observed_phase(path, fib_prover(options, Blake3_256), fib_air,
                       [fib_build(1 << log2_rows) for _ in range(n)],
                       kernel_rows, rng, device, both, airs)

    rows = 1 << LIMB_PATHS["limb_main"][0]
    t0 = time.perf_counter()
    trace = build_rescue128_chain_trace([7, 9], rows // 8)
    emit("limb_trace", rows=rows, trace_build_s=time.perf_counter() - t0)
    observed_phase("limb_main", prover, Rescue128ChainAir, [trace],
                   kernel_rows, rng, device, both, airs, tampers=[("seed", tamper_seed)])
    del trace

    log2_rows, n = LIMB_PATHS["limb_aggregated"]
    seeds = rng.integers(0, 1 << 62, size=(n, 2), dtype=np.uint64)
    traces = [build_rescue128_chain_trace([int(v) for v in sd], (1 << log2_rows) // 8)
              for sd in seeds]
    observed_phase("limb_aggregated", prover, Rescue128ChainAir, traces,
                   kernel_rows, rng, device, both, airs, tampers=[("seed", tamper_seed)])


# ---------------------------------------------------------------------------
# aggregated Lamport+ signatures: the limb path with sequence assertions
# ---------------------------------------------------------------------------


def phase_airs(prover, traces):
    """The AIR of a prove, keyed as ``first_prove`` looks up the constraint
    kernel's AIR: its periodic columns' periods follow the signature block."""
    air0 = prover.air_class(traces[0].get_info(), prover.get_pub_inputs(traces[0]),
                            prover.options())
    return {(air0.field_spec().name, type(air0).__name__): air0}


def tamper_agg_message(pub):
    p = pub[0]
    messages = list(p.messages)
    messages[len(messages) // 2] ^= 1
    return [lagg.LamportAggInputs(messages, p.pub_keys)]


def tamper_agg_pub_key(pub):
    p = pub[0]
    pub_keys = [list(pk) for pk in p.pub_keys]
    pub_keys[-1][0] = (pub_keys[-1][0] + 1) % lagg.P
    return [lagg.LamportAggInputs(p.messages, pub_keys)]


def lamport_phases(kernel_rows, rng, device):
    """Aggregated Lamport+ signatures over f128 with BLAKE3-192: 4 signatures
    at k = 15 against the pinned digest, then 64 (2^16 rows) and 1024 (2^20
    rows x 14 columns) signatures of 127-bit messages, the first and last
    rows of the reference's aggregation table; then 4 StarkPack instances
    of one signature each (lamport128, k = 127) with SHA3-256.  Every proof
    is verified; a tampered message and a tampered public key are rejected.
    The wallet (keys, messages, signatures) and the trace are built on the
    host and timed apart from the prove."""
    options = ProofOptions(*BENCH_OPTIONS)
    both = ("ntt", "cons")
    for path in ("lamport_agg_golden", "lamport_agg_64", "lamport_agg_main"):
        n_sigs, k = LAMPORT_PATHS[path]
        golden = path == "lamport_agg_golden"
        # the tables and caches of earlier proves go, so the largest prove
        # finds the card's memory free
        full_pipeline._TABLE_CACHE.clear()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        messages, _, sigs = lagg.make_wallet(n_sigs, k, seed=0 if golden else
                                             int(rng.integers(1 << 30)))
        wallet_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        trace = lagg.build_lamport128_agg_trace(messages, sigs, k)
        trace_s = time.perf_counter() - t0
        del messages, sigs
        prover = lagg.Lamport128AggProver(options, Blake3_192)
        observed_phase(path, prover, lagg.Lamport128AggAir, [trace], kernel_rows, rng, device,
                       both, phase_airs(prover, [trace]),
                       golden=GOLDEN_LAMPORT if golden else None,
                       tampers=[("message", tamper_agg_message),
                                ("public key", tamper_agg_pub_key)],
                       signatures=n_sigs, k=k, wallet_s=wallet_s, trace_build_s=trace_s)
        del trace

    n, k = LAMPORT_PATHS["lamport128_aggregated"]
    traces = []
    for i in range(n):
        secrets, pk_hashes, _ = lam.keygen(k, seed=i)
        message = (1 << (k - 1)) | int(rng.integers(1 << 62))
        traces.append(lam.build_lamport128_trace(
            message, lam.sign(secrets, pk_hashes, message, k), k))
    prover = lam.Lamport128Prover(options, Sha3_256)

    def tamper_message(pub):
        return pub[:1] + [lam.Lamport128Inputs(pub[1].message ^ 1, pub[1].pub_key)] + pub[2:]

    def tamper_pub_key(pub):
        bad = [(pub[-1].pub_key[0] + 1) % lam.P, pub[-1].pub_key[1]]
        return pub[:-1] + [lam.Lamport128Inputs(pub[-1].message, bad)]

    observed_phase("lamport128_aggregated", prover, lam.Lamport128Air, traces, kernel_rows,
                   rng, device, both, phase_airs(prover, traces),
                   tampers=[("message", tamper_message), ("public key", tamper_pub_key)],
                   signatures=n, k=k)


# ---------------------------------------------------------------------------
# the f64 small-trace path: kernels 2 and 3 carry every transform
# ---------------------------------------------------------------------------


def small_trace_phases(kernel_rows, rng, device):
    """do-work 2 x 64 against its pinned digest, then the two sizes users of
    this path run, with the bench options: do-work 32 x 1024 and a Rescue
    hash chain of 64 instances x 2^13 rows (main LDE 64 * 12 * 2^16 words).
    Each proof is verified and a tampered public input rejected."""
    dit = ("dit",)

    def tamper_start(pub):
        return pub[:-1] + [DoWorkInputs((pub[-1].start + 1) % gl.P, pub[-1].result)]

    def tamper_chain(pub):
        return pub[:-1] + [ChainInputs([(pub[-1].seed[0] + 1) % gl.P] + pub[-1].seed[1:],
                                       pub[-1].result)]

    log2_rows, n = SMALL_TRACE_PATHS["small_trace_golden"]
    observed_phase("small_trace_golden",
                   DoWorkProver(ProofOptions(*GOLDEN_OPTIONS), Blake3_256), DoWorkAir,
                   [build_do_work_trace(i, 1 << log2_rows) for i in range(n)],
                   kernel_rows, rng, device, dit, golden=GOLDEN_SMALL_TRACE,
                   tampers=[("start", tamper_start)])

    options = ProofOptions(*BENCH_OPTIONS)
    log2_rows, n = SMALL_TRACE_PATHS["small_trace_main_do_work"]
    observed_phase("small_trace_main_do_work", DoWorkProver(options, Blake3_256), DoWorkAir,
                   [build_do_work_trace(i + 1, 1 << log2_rows) for i in range(n)],
                   kernel_rows, rng, device, dit, tampers=[("start", tamper_start)])

    log2_rows, n = SMALL_TRACE_PATHS["small_trace_main_rescue"]
    seeds = rng.integers(0, gl.P, size=(n, 8), dtype=np.uint64)
    t0 = time.perf_counter()
    traces = [build_chain_trace([int(v) for v in sd], (1 << log2_rows) // 8) for sd in seeds]
    emit("small_trace_traces", n=n, rows=1 << log2_rows,
         trace_build_s=time.perf_counter() - t0)
    observed_phase("small_trace_main_rescue", RescueChainProver(options, Blake3_256),
                   RescueChainAir, traces, kernel_rows, rng, device, dit,
                   tampers=[("seed", tamper_chain)])


def build_all():
    """Build every kernel library and host builder of the driven paths, one
    compiler process per library, all started together."""
    airs = smoke_airs()
    jobs = {
        "ntt_tile": ntt4._lib,
        "ntt_dit": ntt_kernel._lib,
        "limb_ntt_tile": limb_ntt._lib,
        "trace_builder": native.get_builders,
        "rescue128_builder": native.get_rescue128,
    }
    for (field, name), air0 in airs.items():
        jobs[f"cons_eval {field} {name}"] = lambda air0=air0: cons_kernel._lib(
            air0, *limb_air_config(air0))
    seconds = {}

    def run(item):
        name, fn = item
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(run, jobs.items()))
    root = os.path.dirname(os.path.abspath(__file__))
    emitted = [cons_kernel.kernel_source(a, *limb_air_config(a))[1] for a in airs.values()]
    emit("build", wall_s=time.perf_counter() - t0, seconds=seconds,
         sources=[os.path.relpath(p, root) for p in
                  ntt4.kernel_sources() + ntt_kernel.kernel_sources()
                  + limb_ntt.kernel_sources() + emitted],
         emitted_lines={os.path.relpath(p, root): open(p).read().count("\n")
                        for p in emitted},
         ptxas={name: ptxas_report(name) for name in native.BUILD_LOGS})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=0,
                   help="numpy seed of the kernel inputs and the aggregated "
                        "phase's chain seeds")
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    device = torch.device("cuda")
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    rng = np.random.default_rng(args.seed)
    prover = RescueChainProver(ProofOptions(*BENCH_OPTIONS), Blake3_256)

    build_all()
    kernel_rows = phase_kernels(rng, device)
    phase_dit_kernels(rng, device)
    phase_small(prover, kernel_rows, rng, device)
    phase_main(prover, kernel_rows, rng, device)
    phase_aggregated(prover, kernel_rows, rng, device)
    small_trace_phases(kernel_rows, rng, device)
    limb_phases(kernel_rows, rng, device)
    lamport_phases(kernel_rows, rng, device)

    print(smi, flush=True)
    print(json.dumps({"kernels": list(kernel_rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
