#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's main paths through the entry points a user calls, all
with ProofOptions(28, 8, 16, NONE, 4, 31) and BLAKE3-256 unless named:

* the f64 big-trace path: a Rescue hash-chain STARK of 2^20 rows x 12
  columns, beside it a 2^14-row prove with a pinned digest and an aggregated
  prove of 4 x 2^16 rows;
* the same path over the extension fields: the 2^20-row chain again with
  the 128-bit options ProofOptions(38, 8, 16, CUBIC, 4, 31) (ext_cubic_main,
  right after the base prove of the same trace), those options at 2^14 rows
  with a pinned digest (ext_cubic_golden), and 4 x 2^16 rows aggregated
  with ProofOptions(28, 8, 16, QUADRATIC, 4, 31) (ext_quad_aggregated);
* the f128 limb-field path: a Rescue128 hash-chain STARK of 2^18 rows x 6
  columns of 16-byte elements (cut from 2^20 rows, whose f128 shapes the
  1024-signature Lamport+ prove runs, to spare most of the chain's serial
  host trace build), beside it a 2^12-row prove with a pinned digest and an
  aggregated prove of 4 x 2^14 rows;
* the f64 small-trace path (every transform through the DIT kernels):
  do-work 32 x 1024 rows x 10 columns and a Rescue hash chain of 64
  instances x 2^13 rows x 12 columns, beside them do-work 2 x 64 with
  ProofOptions(16, 8, 0, NONE, 4, 31) and a pinned digest; then rows 2
  (do-work 1 x 64, quadratic, grinding 4) and 4 (fib 2 x 256, cubic,
  folding 16) of the golden transcript matrix against pinned digests, and
  do-work 32 x 1024 at quadratic;
* aggregated Lamport+ signatures over f128 on the limb path, BLAKE3-192:
  1024 signatures of 127-bit messages in ONE trace of 2^20 rows x 14
  columns (the per-signature outputs bound by sequence assertions, read by
  the constraint kernel as tables), beside it 64 signatures (2^16 rows), 4
  signatures at k = 15 (512 rows) with a pinned digest, and 4 StarkPack
  instances of one signature each (lamport128, 1024 rows) with SHA3-256;
  the 1024-signature trace again forced down the coset-streamed pipeline
  (parallel/streamed.py: the budget at one byte; its proof must be the
  one-shot proof's bytes), and 4096 signatures (2^22 rows x 14, a 7.5 GB
  main LDE), which the memory plan streams by itself;
* the limb path over the extension fields (the eager constraint phase in
  place of the constraint kernel): the 2^18-row Rescue128 chain again at
  ProofOptions(28, 8, 16, QUADRATIC, 4, 31) (limb_ext_main, right after the
  degree-1 prove of the same trace, with kernel 4's launches derived from
  that prove's), and that prove forced down the coset-streamed pipeline
  (limb_stream_quad: the eager constraint phase a ce coset at a time; the
  bytes of limb_ext_main's proof); 256 Merkle authentication paths over
  f128 of depth 32 (256 rows x 7 columns each) aggregated into ONE proof,
  once at degree 1
  with BLAKE3-256 (the constraint kernel's merkle128 body) and once at
  quadratic with SHA3-256 (merkle128_aggregated, merkle128_aggregated_quad);
  rows 10 (rescue128-chain) and 12 (merkle128) of the golden transcript
  matrix, SHA3-256 at quadratic, against pinned digests (limb_ext_golden_*);
  fib over f62 2 x 512 at cubic against a pinned digest (limb_ext_f62);
* the algebraic hashers, every Merkle tree on the sponge kernel: the
  2^20-row chain again with Rp64_256, RpJive64_256 and GriffinJive64_256
  (rp64_main, rpjive_main, griffin_main, right after the BLAKE3 prove of
  the same trace, each proof-of-work search timed); rows 6-8 of the
  golden transcript matrix (rescue-chain with Rp64_256, fib-f62 with
  Rp62_248 at degree 1 and at cubic) against pinned digests
  (rp_golden_row6/7/8); the canonical-bucket chain, 100 live permutations
  in a bucket of 128, with Rp64_256 (rescue_pad); 64 f64 Lamport+
  signatures of 127-bit messages with SHA3-256 (lamport64); fib over f62,
  2 x 2^20 rows at ProofOptions(28, 8, 16, CUBIC, 4, 31) with Rp62_248
  (rp62_main).  The sponge kernel's launches by shape are derived from each
  configuration (``sponge_launches``), its proof-of-work search launches
  from the proof's nonce; after each counted prove its largest
  launch of each (hasher, mode, row length) runs again on random rows at
  that row count, a strided sample of rows held against the plain version
  (``compare_sponge_at_rows``); last, the kernel's proof-of-work search
  against the host C search for the four hashers at grinding 16 (the main
  paths' seeds and three random ones) and every digest of one batch
  against the plain version (sponge_search).  The sponge's twelve
  instantiations (four layouts x hash, merge, search) must build without
  spills (ptxas), and so must the three of the DIT tile frame
  (csrc/dit_tile.cuh: kernel 3 on Goldilocks, kernel 4 on f128 and f62).  Every kernel's bound counts the IMAD-pipe and ALU-pipe
  instructions that csrc/gl64_sass_count.py counts in this run
  (``sponge_bound``, ``op_bound``; kernels 1-5 also at one pipe, the count
  the earlier bounds used, ``bound_ms_one_pipe``).

Every proof is verified by the port's verifier on the host, through its C
tier (``verify_tier``: native/verify_scalar.c and native/blake3_compress.c,
built with the host compiler beside the kernels): ``verify_s`` is the first
verify's wall, ``verify_median_s`` the median of VERIFY_REPS more
(``verify_walls_s``); for 1024 Lamport+ signatures also the wall of the
Fiat-Shamir seed's ``hash_elements`` (``seed_hash_s``).

Builds the CUDA kernels from ``csrc/`` (one nvcc per library, all started
together) and holds each against its plain PyTorch version on the card at
every shape any of the proves launches; each prove's launch counts are set
to 0 just before it, read just after it and must be exactly the compared
shapes.  The big-trace path's tile shapes are known in advance
(``path_shapes``); the shapes of the limb kernels and of the DIT kernels
(which also serve the small transforms of the big-trace path) are read off
a first prove of each size, compared, and then required of the counted
prove.  Every proof is checked with the port's verifier.  Each phase
(device, build, kernels, dit_kernels, small, main, ext_cubic_main,
aggregated, ext_cubic_golden, ext_quad_aggregated, small_trace_golden,
small_trace_main_do_work, small_trace_main_rescue,
small_trace_ext_golden_row2, small_trace_ext_golden_row4,
small_trace_ext_do_work, limb_small, limb_fib, limb_fib62, limb_main,
limb_ext_main, limb_stream_quad, limb_aggregated, merkle128_aggregated,
merkle128_aggregated_quad, limb_ext_golden_row10, limb_ext_golden_row12,
limb_ext_f62, lamport_agg_golden, lamport_agg_64, lamport_agg_main,
lamport_agg_main_streamed, lamport_agg_4096, lamport128_aggregated,
aux_main, aux_golden, aux_cubic, rp64_main,
rpjive_main, griffin_main, rp_golden_row6, rp_golden_row7, rp_golden_row8, rescue_pad, lamport64,
rp62_main, sponge_search) prints one JSON line as it ends; any failure raises
and the run exits non-zero.  A ``prove_mesh`` phase's line says ``streamed``,
the path its proves had to take ("prove_mesh path" records); a streamed
phase's coset transforms and kernel 4 and 5 launches are derived from its
config and its query positions (``streamed_launches``), and kernels 4 and 5
are held against their plain versions at its per-coset shapes like every
other shape.  The last two lines are the per-kernel table
and the ``{"ok": ...}`` summary.

Needs a CUDA device (exits non-zero without one) and no network.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import hashlib
import importlib.util
import json
import logging
import os
import random
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
from starkpack_winterfell_tpu_torch.air.trace_info import TraceLayout
from starkpack_winterfell_tpu_torch.crypto.griffin import GriffinJive64_256
from starkpack_winterfell_tpu_torch.crypto.rescue import Rp64_256
from starkpack_winterfell_tpu_torch.crypto.rescue62 import Rp62_248
from starkpack_winterfell_tpu_torch.crypto.rescue_jive import RpJive64_256
from starkpack_winterfell_tpu_torch.fri import prover as fri_prover
from starkpack_winterfell_tpu_torch.models.cli import get_example
from starkpack_winterfell_tpu_torch.models.do_work import (
    DoWorkAir,
    DoWorkProver,
    PublicInputs as DoWorkInputs,
    build_do_work_trace,
)
from starkpack_winterfell_tpu_torch.models import lamport as lam64
from starkpack_winterfell_tpu_torch.models import lamport128 as lam
from starkpack_winterfell_tpu_torch.models import lamport128_agg as lagg
from starkpack_winterfell_tpu_torch.models import merkle128 as mk
from starkpack_winterfell_tpu_torch.models.fib_multifield import get_fib_family
from starkpack_winterfell_tpu_torch.models.permutation import (
    PermAir,
    PermInputs,
    PermProver,
    build_perm_trace,
)
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
from starkpack_winterfell_tpu_torch.models.rescue_chain_pad import (
    PaddedChainInputs,
    RescueChainPadAir,
    RescueChainPadProver,
    build_padded_chain_trace,
)
from starkpack_winterfell_tpu_torch.ops import cons_kernel
from starkpack_winterfell_tpu_torch.ops import gl64 as gl
from starkpack_winterfell_tpu_torch.ops import limb_ntt
from starkpack_winterfell_tpu_torch.ops import ntt4
from starkpack_winterfell_tpu_torch.ops import ntt_kernel
from starkpack_winterfell_tpu_torch.ops import rescue_sponge
from starkpack_winterfell_tpu_torch.ops.backend import get_backend
from starkpack_winterfell_tpu_torch.parallel import full_pipeline, streamed
from starkpack_winterfell_tpu_torch.prover import channel as prover_channel
from starkpack_winterfell_tpu_torch.prover.domain import StarkDomain

from kernel_times import (
    ProfilerDroppedRecords,
    cons_args,
    cons_config,
    device_kernel_ms,
    hold_cons,
    ptxas_report,
    random_limb,
    timed_prove,
)

BENCH_OPTIONS = (28, 8, 16, FieldExtension.NONE, 4, 31)
# the 128-bit column of the reference's Rescue-chain table: cubic extension,
# 38 queries, grinding 16 (conjectured security 128 bits)
CUBIC128_OPTIONS = (38, 8, 16, FieldExtension.CUBIC, 4, 31)
QUAD_OPTIONS = (28, 8, 16, FieldExtension.QUADRATIC, 4, 31)
BLOWUP = 8
WIDTH = 12
COMPOSITION_COLUMNS = 7
# the big-trace proves this script drives: name -> (log2 of the rows,
# instances, ProofOptions); the field extension is the options' fourth entry
PATHS = {"small": (14, 1, BENCH_OPTIONS), "main": (20, 1, BENCH_OPTIONS),
         "aggregated": (16, 4, BENCH_OPTIONS),
         "rp64_main": (20, 1, BENCH_OPTIONS),
         "rpjive_main": (20, 1, BENCH_OPTIONS),
         "griffin_main": (20, 1, BENCH_OPTIONS),
         "ext_cubic_main": (20, 1, CUBIC128_OPTIONS),
         "ext_cubic_golden": (14, 1, CUBIC128_OPTIONS),
         "ext_quad_aggregated": (16, 4, QUAD_OPTIONS)}
# the limb-field proves (limb_fib, limb_fib62: the cheap second AIR over
# f128 and over f62): name -> (log2 of the rows, instances)
LIMB_PATHS = {"limb_small": (12, 1), "limb_fib": (9, 2), "limb_fib62": (9, 2),
              "limb_main": (18, 1), "limb_aggregated": (14, 4)}
LIMB_WIDTH = 6
# the limb path over the extension fields: the limb_main trace at quadratic;
# Merkle authentication paths (paths, tree depth: 8 rows a level) aggregated
# into one proof, at degree 1 and at quadratic with SHA3-256
LIMB_EXT_OPTIONS = QUAD_OPTIONS
MERKLE_PATHS = (256, 32)
MERKLE_QUAD_OPTIONS = QUAD_OPTIONS
# rows 10 and 12 of the golden transcript matrix and fib-f62 at cubic: name
# -> (example, instances, -l as the CLI takes it, ProofOptions, hasher, pin)
LIMB_EXT_GOLDEN = {
    "limb_ext_golden_row10": ("rescue128-chain", 1, 8, (16, 8, 0, FieldExtension.QUADRATIC, 4, 31),
                              Sha3_256, "rescue128_chain_1x64_quad_sha3"),
    "limb_ext_golden_row12": ("merkle128", 1, 64, (16, 8, 0, FieldExtension.QUADRATIC, 4, 31),
                              Sha3_256, "merkle128_1x64_quad_sha3"),
    "limb_ext_f62": ("fib-f62", 2, 512, (28, 8, 16, FieldExtension.CUBIC, 4, 31),
                     Blake3_256, "fib62_2x512_cubic"),
}
# the small-trace proves: name -> (log2 of the rows, instances)
SMALL_TRACE_PATHS = {"small_trace_golden": (6, 2), "small_trace_main_do_work": (10, 32),
                     "small_trace_main_rescue": (13, 64), "small_trace_ext_do_work": (10, 32)}
GOLDEN_OPTIONS = (16, 8, 0, FieldExtension.NONE, 4, 31)
# rows 2 and 4 of the JAX package's golden transcript matrix: name ->
# (example, instances, rows, ProofOptions, pinned sha256 file)
SMALL_TRACE_EXT_GOLDEN = {
    "small_trace_ext_golden_row2": (
        "do-work", 1, 64, (16, 8, 4, FieldExtension.QUADRATIC, 4, 31), "do_work_1x64_quad"),
    "small_trace_ext_golden_row4": (
        "fib", 2, 256, (16, 8, 0, FieldExtension.CUBIC, 16, 31), "fib_2x256_cubic"),
}
# the permutation AIR (one auxiliary segment) through prove_mesh on f64:
# name -> (instances, rows, ProofOptions, pinned sha256 file or None).
# aux_golden is row 5 of the golden transcript matrix; aux_cubic the perm at
# the 128-bit options
AUX_PATHS = {
    "aux_main": (4, 1 << 20, QUAD_OPTIONS, None),
    "aux_golden": (2, 64, (16, 8, 0, FieldExtension.QUADRATIC, 4, 31), "perm_2x64_quad"),
    "aux_cubic": (2, 1 << 12, CUBIC128_OPTIONS, "perm_2x4096_cubic128"),
}
# the Lamport+ proves: name -> (signatures, message bits k); a signature is
# 8 * (k + 1) rows.  lamport128_aggregated: that many StarkPack instances of
# one signature each
LAMPORT_PATHS = {"lamport_agg_golden": (4, 15), "lamport_agg_64": (64, 127),
                 "lamport_agg_main": (1024, 127), "lamport_agg_4096": (4096, 127),
                 "lamport128_aggregated": (4, 127)}

# the algebraic hashers (the sponge kernel): rp64_main, rpjive_main and
# griffin_main are the main path's chain proved again with Rp64_256,
# RpJive64_256 and GriffinJive64_256 (in PATHS); rp62_main fib over f62
# at golden row 8's options with Rp62_248: (instances, rows, ProofOptions);
# golden rows 6-8: name -> (example, instances, -l as the CLI takes it,
# ProofOptions, hasher, pin); rescue_pad: (live permutations, bucket);
# lamport64: (signatures = StarkPack instances, message bits k)
RP62_MAIN = (2, 1 << 20, (28, 8, 16, FieldExtension.CUBIC, 4, 31))
RP_GOLDEN = {
    "rp_golden_row6": ("rescue-chain", 1, 64, GOLDEN_OPTIONS, Rp64_256,
                       "rescue_chain_1x64_rp64"),
    "rp_golden_row7": ("fib-f62", 2, 64, GOLDEN_OPTIONS, Rp62_248, "fib62_2x64_rp62"),
    "rp_golden_row8": ("fib-f62", 1, 64, (16, 8, 2, FieldExtension.CUBIC, 4, 31), Rp62_248,
                       "fib62_1x64_cubic_rp62"),
}
RESCUE_PAD = (100, 128)
LAMPORT64 = (64, 127)
# the sponge kernel is held against its plain version at each (hasher, mode,
# row length) a prove launches, on this many random rows (a ragged last block)
SPONGE_COMPARE_ROWS = (1 << 16) + 37
# and at the row count of each counted prove's largest launch of each
# (hasher, mode, row length): on this many rows at a stride and the last 37
SPONGE_SAMPLE_ROWS = 4096

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


# the same costs split by pipe ({"imad", "alu"}), field -> operation, from
# csrc/gl64_sass_count.py's "by_pipe" of this run (``build_all``): the
# bounds of kernels 1-5 count their instructions pipe by pipe, as the
# sponge's do (``op_bound``); the one-pipe counts above stay beside them.
# An IMAD.WIDE (a 64-bit result) takes IMAD_WIDE_SLOTS issue slots of the
# IMAD pipe, two, as kernel_times.py's imad phase measured it on an NVIDIA
# H100 80GB HBM3; the earlier per-pipe count, which took one,
# stays beside it (PIPE_COSTS_WIDE1, SPONGE_COSTS_WIDE1)
IMAD_WIDE_SLOTS = 2
PIPE_COSTS: dict = {}
PIPE_COSTS_WIDE1: dict = {}
ONE_PIPE = {field: {**ops, "twmul": ops["mul"]} for field, ops in (
    ("gl64", {"mul": OPS_FIELD_MUL, "add": OPS_FIELD_ADD, "sub": OPS_FIELD_SUB}),
    *OPS_LIMB.items())}
# NVIDIA H100 SXM dispatch rates, lanes a second: the IMAD pipe and the integer
# ALU pipe (IADD3, LOP3, SHF, ISETP, SEL, LEA) 64 lanes a clock an SM each,
# dispatch 4 x 32 lanes a clock an SM for all instructions together
PEAK_IMAD_LANES_PER_S = PEAK_ALU_LANES_PER_S = 132 * 64 * 1.98e9
PEAK_DISPATCH_LANES_PER_S = 132 * 128 * 1.98e9


def slotted(by_pipe, slots: int) -> dict:
    """gl64_sass_count.py's "by_pipe" counts, IMAD-pipe slots and ALU-pipe
    instructions of each probe, each IMAD.WIDE at ``slots`` slots."""
    return {probe: {"imad": c["imad"] + (slots - 1) * c["imad_wide"], "alu": c["alu"]}
            for probe, c in by_pipe.items()}


def pipe_costs(bp) -> dict:
    """``PIPE_COSTS`` from ``slotted`` counts.  "twmul" is an NTT
    butterfly's product by a twiddle at its cheapest form: the multiply,
    except on f62, whose twiddles kernel 4 holds in Montgomery form
    (``f62_twmul``)."""
    limb = ("mul", "sqr", "add", "sub")
    return {"gl64": {**{op: bp[op] for op in ("mul", "add", "sub")}, "twmul": bp["mul"]},
            "f128": {**{op: bp[f"f128_{op}"] for op in limb}, "twmul": bp["f128_mul"]},
            "f62": {**{op: bp[f"f62_{op}"] for op in limb}, "twmul": bp["f62_twmul"]}}


def pipe_ms(ops) -> float:
    """Least milliseconds of {"imad", "alu"} instructions: the larger of
    the IMAD ones over the IMAD rate, the ALU ones over the ALU rate and
    both over the dispatch rate."""
    return max(ops["imad"] / PEAK_IMAD_LANES_PER_S, ops["alu"] / PEAK_ALU_LANES_PER_S,
               (ops["imad"] + ops["alu"]) / PEAK_DISPATCH_LANES_PER_S) * 1e3


def op_bound(nbytes: int, counts: dict, field: str) -> dict:
    """The least time (ms) of a kernel that moves ``nbytes`` and does
    ``counts`` field operations ({"mul", "sqr", "add", "sub"}: how many):
    the bytes against the memory rate or the operations against the
    integer rates, whichever is larger.  ``bound_ms`` prices each
    operation pipe by pipe (``PIPE_COSTS``, ``pipe_ms``);
    ``bound_ms_wide_one_slot`` the same with an IMAD.WIDE at one slot (the
    earlier count); ``bound_ms_one_pipe`` at its instructions all on one
    64-lane pipe (``ONE_PIPE``, ``PEAK_INT32_OPS_PER_S``), the count the
    earlier bounds of these kernels used."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_one = sum(n * ONE_PIPE[field][op] for op, n in counts.items()) \
        / PEAK_INT32_OPS_PER_S * 1e3

    def t_pipe(costs):
        return pipe_ms({k: sum(n * costs[field][op][k] for op, n in counts.items())
                        for k in ("imad", "alu")})

    def pick(t_ops):
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    (ms, by), (ms1, by1) = pick(t_pipe(PIPE_COSTS)), pick(t_one)
    return {"bound_ms": ms, "bound_by": by,
            "bound_ms_wide_one_slot": pick(t_pipe(PIPE_COSTS_WIDE1))[0],
            "bound_ms_one_pipe": ms1, "bound_by_one_pipe": by1}


def bound_fields(bound: dict, timing: dict) -> dict:
    """A row's bound keys: ``op_bound``'s, with the share of each bound in
    the kernel's device time (null where the profiler gave none)."""
    dev = timing.get("device_ms")
    return {**bound,
            "bound_share_wide_one_slot": bound["bound_ms_wide_one_slot"] / dev if dev else None,
            "bound_share_one_pipe": bound["bound_ms_one_pipe"] / dev if dev else None}


def golden_pin(name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "starkpack_winterfell_tpu_torch", "golden", f"{name}.sha256")


GOLDEN_LIMB = golden_pin("rescue128_12_bench")
GOLDEN_SMALL_TRACE = golden_pin("do_work_2x64")
GOLDEN_LAMPORT = golden_pin("lamport_agg_4x512_b192")
# the big-trace proves checked against a pinned digest: path -> pin
GOLDEN_BIG = {"small": golden_pin("rescue14_bench"),
              "ext_cubic_golden": golden_pin("rescue14_cubic128")}


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


def path_shapes(log2_rows: int, n_inst: int, options):
    """(label, (dif, B, n, lanes, epilogue, interleave, pre, transposed)) of
    every tile transform one prove of ``n_inst`` traces of 2^log2_rows rows
    launches: the trace interpolate+LDE (batch = 12 columns per instance),
    the composition interpolate (one per instance) and the composition
    column LDE (the 7 columns of the instances' sum, each 1/ce_over_length
    of the permuted rows, zero-interleaved back to the LDE's rows).  The
    composition is an element of the options' extension field: its steps
    run once per component.  Two steps may share a shape."""
    ext_deg = int(options[3])
    length = 1 << log2_rows
    L = length * BLOWUP
    a, b, Bf = ntt4._pick_factors(length, L)
    w = WIDTH * n_inst
    ce = L  # degree-7 cycle-8 constraints: the ce domain is the LDE domain
    a2, b2, Bf2 = ntt4._pick_factors(ce, L)
    nc = COMPOSITION_COLUMNS
    rows_col = b2 // (ce // length)
    composition = [
        ("K1", (True, n_inst, a2, b2, True, 1, False, True)),
        ("K2", (True, n_inst, b2, a2, True, 1, False, False)),
        ("K3", (False, nc, Bf2, a2, True, Bf2 // rows_col, True, True)),
        ("K4", (False, nc, a2, Bf2, False, 1, False, False)),
    ]
    return [
        ("trace K1", (True, w, a, b, True, 1, False, True)),
        ("trace K2", (True, w, b, a, True, 1, False, False)),
        ("trace K3", (False, w, Bf, a, True, Bf // b, False, True)),
        ("trace K4", (False, w, a, Bf, False, 1, False, False)),
    ] + [(f"composition{f' c{c}' if ext_deg > 1 else ''} {k}", key)
         for c in range(ext_deg) for k, key in composition]


def expected_launches(path: str) -> collections.Counter:
    return collections.Counter(key for _, key in path_shapes(*PATHS[path]))


def random_words(shape, rng, device):
    """Canonical field elements drawn with numpy from the run's seed."""
    arr = rng.integers(0, gl.P, size=shape, dtype=np.uint64)
    return gl.from_u64(arr, device)


def time_cuda(fn, reps: int, warm: bool = True):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events around
    each call: the call's time, host work of the wrapper included (the
    kernel's own time is ``device_kernel_ms``, from the profiler).  ``warm``:
    one untimed call first (False where the caller has just run ``fn``)."""
    if warm:
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


def kernel_timing(fn, match, bound_ms, wrapper_module, counter="LAUNCHES"):
    """The timing keys of a kernel's row: ``call_ms``, CUDA events around one
    call of ``fn`` (host work of the wrapper included), during which the
    wrapper's launch count (``wrapper_module.LAUNCHES``, or the attribute
    ``counter``) must show a launch every call; ``device_ms``, the device
    time of the kernels named by ``match`` in one call (profiler,
    ``device_kernel_ms``); ``bound_share``.
    Where the profiler lost the records of too many calls in every session,
    ``device_ms`` and ``bound_share`` are null and ``ms`` is the call's time
    (``ms_source``)."""
    before = getattr(wrapper_module, counter)
    call_ms = time_cuda(fn, 7)
    launched = getattr(wrapper_module, counter) - before
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
    """Least time (ms) the card could take for one tile transform
    (``op_bound``): every input read once and the output written once, a
    butterfly (a multiply, an add and a subtract) per two words and stage.
    A zero-interleaved input counts the rows read (n / interleave) and the
    stages after the log2(interleave) that only copy; each table multiply a
    multiply per word it multiplies.  The store's layout costs nothing."""
    words = B * n * lanes
    words_in = words // interleave
    nbytes = 8 * (words_in + words + n // 2 + (n * lanes if epilogue else 0)
                  + (n // interleave * lanes if pre else 0))
    stages = n.bit_length() - interleave.bit_length()
    butterflies = words * stages // 2
    muls = butterflies + (words if epilogue else 0) + (words_in if pre else 0)
    return op_bound(nbytes, {"mul": muls, "add": butterflies, "sub": butterflies}, "gl64")


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
            bound = tile_bound(*key)
            timing = kernel_timing(lambda: ntt4.ntt_tile(*args), "ntt_tile_kernel",
                                   bound["bound_ms"], ntt4)
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
                **bound_fields(bound, timing),
                "library_ms": None,
            }
        del args
        torch.cuda.empty_cache()
    emit("kernels", names=["ntt_tile_kernel<DIF, K>", "ntt_tile_kernel<DIT, K>"],
         tolerance="exact (modular integer arithmetic)",
         compared=compared, mismatching_words=mismatching,
         shapes=[{k: r[k] for k in ("name", "used_by", "device_ms", "call_ms", "plain_ms",
                                    "bound_ms", "bound_by", "bound_share",
                                    "bound_ms_one_pipe", "bound_share_one_pipe")}
                 for r in rows.values()])
    return rows


# ---------------------------------------------------------------------------
# kernels 2 and 3: the DIT transforms of ops/ntt_kernel.py
# ---------------------------------------------------------------------------


def strided_words(shape, strides, rng, device, fill=True):
    """A view of ``shape`` with ``strides`` over a new buffer of canonical
    random words (or uninitialised ones with ``fill`` False)."""
    size = 1 + sum((d - 1) * st for d, st in zip(shape, strides))
    buf = random_words((size,), rng, device) if fill else torch.empty(
        size, dtype=torch.int64, device=device)
    return torch.as_strided(buf, shape, strides)


def dit_inputs(key, rng, device, inverse=False):
    """(function, plain version, arguments) of one DIT kernel shape:
    ("last", rows, n, n_in, strides of x, has pre, has scale) or ("tile", B,
    n, n_in, lanes, strides of x, strides of the output, has pre, has row,
    has col).  x is laid out with the key's strides (a transposed view where
    the prove passes one); ``dit_tile``'s output is a view with the key's
    strides, its function returns it."""
    if key[0] == "last":
        _, rows, n, n_in, strides, has_pre, has_scale = key
        x = strided_words((rows, n_in), strides, rng, device)
        args = (x, ntt4.tile_twiddles(n, inverse, device), n,
                random_words((n_in,), rng, device) if has_pre else None,
                int(rng.integers(0, gl.P, dtype=np.uint64)) if has_scale else None)
        return ntt_kernel.ntt_last, ntt_kernel.ntt_last_plain, args
    _, B, n, n_in, lanes, xs, os_, has_pre, has_row, has_col = key
    out = strided_words((B, n, lanes), os_, rng, device, fill=False)
    args = (strided_words((B, n_in, lanes), xs, rng, device),
            ntt4.tile_twiddles(n, inverse, device),
            random_words((n_in, lanes), rng, device) if has_pre else None, n,
            random_words((n_in,), rng, device) if has_row else None,
            random_words((lanes,), rng, device) if has_col else None)
    return ((lambda x, tw, pre, n, row, col: ntt_kernel.dit_tile(x, tw, pre, out, n, row, col)),
            ntt_kernel.dit_tile_plain, args)


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
    """Least time (ms) of one ``ntt_last`` launch (``op_bound``): the input
    rows read once, the output written once; the stages after the
    log2(n / n_in) that a zero-padded row only copies, a multiply a word
    and table multiply."""
    nbytes = 8 * (rows * n_in + rows * n + n // 2 + (n_in if pre else 0))
    stages = n.bit_length() - (n // n_in).bit_length()
    butterflies = rows * n * stages // 2
    muls = butterflies + (rows * n_in if pre else 0) + (rows * n if scale else 0)
    return op_bound(nbytes, {"mul": muls, "add": butterflies, "sub": butterflies}, "gl64")


def dit_tile_bound(B: int, n: int, n_in: int, lanes: int, pre: bool, row: bool, col: bool):
    """Least time (ms) of one kernel 3 launch (``op_bound``): x read once,
    the output written once, each table once; the stages after the
    log2(n / n_in) that zero-padded rows only copy, a butterfly per two
    words and stage; a multiply per input word and table or factor."""
    words_in, words = B * n_in * lanes, B * n * lanes
    nbytes = 8 * (words_in + words + n // 2 + (n_in * lanes if pre else 0)
                  + (n_in if row else 0) + (lanes if col else 0))
    butterflies = words * (n_in.bit_length() - 1) // 2
    muls = words_in * (pre + row + col)
    return op_bound(nbytes, {"twmul": butterflies, "mul": muls, "add": butterflies,
                             "sub": butterflies}, "gl64")


def layout_name(xs, os_) -> str:
    """The layout of a DIT tile launch from the (row, lane) strides of x and
    of the output: where the rows lie along the transform axis ("rows") or
    the lanes side by side ("lanes"), and an interleaved store."""
    def side(st):
        return "rows" if st[0] < st[1] else "lanes"
    return f"{side(xs)}->{side(os_)}"


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
        bound = last_bound(rows, n, n_in, has_pre, has_scale)
    else:
        B, n, n_in, lanes, xs, os_, has_pre, has_row, has_col = key[1:]
        name = (f"dit_tile[gl64 B={B} n={n}{f' n_in={n_in}' if n_in < n else ''} "
                f"lanes={lanes} {layout_name(xs[1:], os_[1:])}{' +pre' if has_pre else ''}"
                f"{' +row' if has_row else ''}{' +col' if has_col else ''}]")
        replaces = "starkpack_winterfell_tpu/ops/pallas/ntt_kernel.py:224"
        match = "dit_tile_kernel<GL64"
        bound = dit_tile_bound(B, n, n_in, lanes, has_pre, has_row, has_col)
    timing = kernel_timing(lambda: fn(*args), match, bound["bound_ms"], ntt_kernel)
    plain_ms = time_cuda(lambda: plain(*args), 1)
    del args
    torch.cuda.empty_cache()
    return {
        "name": name, "route": "cuda",
        "source": "starkpack_winterfell_tpu_torch/csrc/ntt_dit.cu"
                  + ("" if key[0] == "last" else " + csrc/dit_tile.cuh"),
        "replaces": replaces,
        "used_by": [used_by], "launches": 0, "launches_by_path": {},
        "max_abs_err": err, **timing,
        "plain_ms": plain_ms, **bound_fields(bound, timing),
        "library_ms": None,
    }


def phase_dit_kernels(rng, device):
    """Both DIT kernels against their plain versions at fixed shapes before
    any prove runs: ``ntt_last`` at every length 2 ... 4096, forward and
    inverse, with and without the pre-multiply and the scale, zero-padded
    rows, transposed views, one row and ragged row blocks; ``dit_tile`` at
    lengths 2 ... 4096 in each layout (lanes side by side or rows along the
    transform axis, in and out), one lane, ragged lane groups, with and
    without the pre-multiply.  The shapes the proves launch are compared,
    and timed, in the proves' own phases."""
    keys = [("last", rows, 1 << bits, 1 << bits, (1 << bits, 1), pre, sc)
            for bits, rows in zip(range(1, 13), (5000, 257, 3, 1000, 33, 25, 7, 300, 2, 9, 1, 3))
            for pre in (False, True) for sc in (False, True)]
    keys += [("last", 25, 64, 8, (8, 1), True, False), ("last", 3, 4096, 512, (512, 1), True, True),
             ("last", 70000, 4, 4, (1, 70000), False, True), ("last", 5, 32, 4, (4, 1), True, False),
             ("last", 33, 128, 128, (1, 33), True, True)]
    for B, n, lanes, pre in ((3, 2, 3, True), (2, 64, 130, False), (2, 64, 130, True),
                             (5, 256, 768, True), (2, 4096, 9, True), (1, 4096, 4, False),
                             (1, 16, 1, False), (4, 1024, 37, True)):
        lanes_major = (n * lanes, lanes, 1)
        rows_major = (n * lanes, 1, n)
        for xs, os_ in ((lanes_major, lanes_major), (lanes_major, rows_major),
                        (rows_major, rows_major)):
            keys.append(("tile", B, n, n, lanes, tuple(0 if d == 1 else st for d, st in
                                                       zip((B, n, lanes), xs)),
                         tuple(0 if d == 1 else st for d, st in zip((B, n, lanes), os_)),
                         pre, False, False))
    keys += [("tile", 2, 64, 16, 130, (16 * 130, 130, 1), (64 * 130, 1, 64), False, True, True),
             ("tile", 1, 4096, 1024, 9, (0, 9, 1), (0, 1, 4096), True, True, True)]
    compared = 0
    for key in keys:
        for inverse in ((False, True) if key[0] == "last" else (False,)):
            dit_mismatches(key, rng, device, inverse)
            compared += 1
    emit("dit_kernels", names=["ntt_last_reg_kernel<LOGN>", "ntt_last_kernel",
                               "dit_tile_kernel<GL64, K>"],
         tolerance="exact (modular integer arithmetic)",
         compared=compared, mismatching_words=0, shapes=[list(k) for k in keys])


# ---------------------------------------------------------------------------
# the Rescue sponge kernel (Rp64_256, Rp62_248)
# ---------------------------------------------------------------------------


# per-pipe instruction counts of the sponge's operations (``sponge_costs``),
# from csrc/gl64_sass_count.py run by ``build_all``; an IMAD.WIDE at
# IMAD_WIDE_SLOTS slots, and at one
SPONGE_COSTS: dict = {}
SPONGE_COSTS_WIDE1: dict = {}


def sponge_costs(bp) -> dict:
    """The per-pipe instruction counts ({"imad", "alu"}) the sponge bound
    prices its operations at, by field: a multiply, an add and one row of
    an MDS product with its round-constant add, each at the cheaper (fewer
    instructions) of the kernel's own form and the field header's
    (Goldilocks: ``gl64::mul``; a row as one reduction priced as a multiply
    and its twelve small products and round-constant add priced as adds, or
    the kernel's row; the same at width 8 as ``mds_row8``; f62: ``fe_mul`` of csrc/f62.cuh or the Montgomery
    multiply of csrc/f62_mont.cuh; a row as twelve multiplies and twelve
    adds, or the lazy Montgomery row).  ``bp``: ``slotted`` counts."""

    def comb(*terms):
        return {k: sum(n * c[k] for n, c in terms) for k in ("imad", "alu")}

    def least(*costs):
        return min(costs, key=lambda c: c["imad"] + c["alu"])

    gl_mul = bp["mul"]
    f62_mul = least(bp["f62_mul"], bp["f62m_mul"])
    return {
        "gl64": {"mul": gl_mul, "add": bp["add"],
                 "mds_row": least(bp["gl64_mds_row"], comb((1, gl_mul), (13, bp["add"]))),
                 "mds_row8": least(bp["gl64_mds_row8"], comb((1, gl_mul), (9, bp["add"])))},
        "f62": {"mul": f62_mul, "add": bp["f62_add"],
                "mds_row": least(bp["f62m_mds_row"], comb((12, f62_mul), (12, bp["f62_add"])))},
    }


def sponge_bound(layout, rows: int, n_elems, search: bool = False, costs=None):
    """Least time (ms) of one sponge launch: the input words read once and
    the digests written once against the memory rate, or its instructions
    against the dispatch rates, pipe by pipe (``pipe_ms``).  A Rescue-Prime
    permutation is the S-box multiplies by the layouts' addition chains
    (``rescue_sponge.sbox_multiplies``: 7 x width x (4 + 72) or (2 + 72))
    and two MDS products with their round-constant adds, a row a word; a
    Griffin one 7 x (72 + 4 + 3 x 6) multiplies, 7 x 28 adds (the running
    (i - 1) s0, l_i and the quadratic of each of the six words: 3 for the
    first, 5 for each other) and one MDS product a round.  A hash adds its
    row's absorptions, a Jive merge or search its Jive sum (12 adds).  Each
    operation is priced at ``SPONGE_COSTS`` (IMAD-pipe and ALU-pipe
    instructions; MDS rows at the layout's width).  ``search``: a
    proof-of-work search of ``rows`` nonces, which reads nothing and writes
    one word.  ``costs``: SPONGE_COSTS_WIDE1 for the earlier count (an
    IMAD.WIDE at one slot)."""
    cost = (costs or SPONGE_COSTS)[layout.field]
    W = layout.width
    row = cost["mds_row" if W == 12 else f"mds_row{W}"]
    perms = rescue_sponge.permutations(layout, rows, n_elems)
    rounds = rescue_sponge.ROUNDS
    mds_rows = rounds * W * (1 if layout.griffin else 2)
    adds = rounds * (3 + 5 * (W - 3)) if layout.griffin else 0
    jive_adds = 3 * layout.digest_size if layout.jive and n_elems is None else 0
    ops = {}
    for k in ("imad", "alu"):
        per_perm = (rescue_sponge.sbox_multiplies(layout) * cost["mul"][k]
                    + mds_rows * row[k] + (adds + jive_adds) * cost["add"][k])
        ops[k] = perms * per_perm + (rows * n_elems * cost["add"][k] if n_elems else 0)
    if search:
        words = 1
    else:
        words = rows * (2 * n_elems + 8) if n_elems is not None else rows * 24
    t_bytes = 8 * words / PEAK_BYTES_PER_S * 1e3
    t_ops = pipe_ms(ops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


SPONGE_PTXAS: dict = {}


def sponge_ptxas(layout_name: str, mode: str):
    """ptxas's report (registers, spills, stack) of the sponge kernel's
    instantiation for a layout and mode (hash, merge, search), from the
    build of this run."""
    layout = {"rp64_256": "Rp64Layout", "rp62_248": "Rp62Layout",
              "rp_jive64_256": "RpJiveLayout", "griffin_jive64_256": "GriffinLayout"}[layout_name]
    arg = {"hash": "Li0E", "merge": "Li1E", "search": "Li2E"}[mode]
    hits = [v for k, v in SPONGE_PTXAS.items() if layout in k and arg in k]
    if len(hits) != 1:
        raise RuntimeError(f"no single ptxas report for the sponge's {layout_name} {mode}: "
                           f"{sorted(SPONGE_PTXAS)}")
    return hits[0]


def sponge_inputs(key, rng, device):
    """Random inputs of one (hasher, mode, row length) on SPONGE_COMPARE_ROWS
    rows: canonical elements for a hash; for a merge the two halves of a
    level as the Merkle code hands them (row stride 16 words), every word a
    random 32-bit value (the Rp62_248 unpacking masks what it reads)."""
    name, mode, n_elems = key
    layout = rescue_sponge.LAYOUTS[name]
    R = SPONGE_COMPARE_ROWS
    if mode == "hash":
        vals = rng.integers(0, layout.P, size=(R, n_elems), dtype=np.uint64)
        words = np.stack([vals & np.uint64(0xFFFFFFFF), vals >> np.uint64(32)], axis=-1)
        return (layout, torch.from_numpy(words.reshape(R, 2 * n_elems).astype(np.int64))
                .to(device), n_elems)
    cur = torch.from_numpy(rng.integers(0, 1 << 32, size=(2 * R, 8)).astype(np.int64)).to(device)
    return layout, cur[0::2], None, cur[1::2]


# what the sponge kernel's rows replace, by hasher: no Pallas kernel, XLA code
SPONGE_REPLACES = {
    name: f"no Pallas kernel: starkpack_winterfell_tpu/crypto/{where} (XLA)"
    for name, where in (("rp64_256", "rescue.py:92"), ("rp62_248", "rescue62.py:128"),
                        ("rp_jive64_256", "rescue_jive.py:67"),
                        ("griffin_jive64_256", "griffin.py:78"))}


def compare_sponge(key, rng, device, used_by):
    """The sponge kernel at one (hasher, mode, row length) a prove launched:
    the wrapper against ``rescue_sponge_plain`` on the same inputs (0
    mismatching words required), the plain call timed as it runs, then the
    kernel's times and bound."""
    name, mode, n_elems = key
    args = sponge_inputs(key, rng, device)
    got = rescue_sponge.rescue_sponge(*args)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = rescue_sponge.rescue_sponge_plain(*args)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    mism = int((got != want).sum())
    if mism:
        raise RuntimeError(f"rescue_sponge disagrees with its plain version in {mism} "
                           f"words at {key}")
    err = float((got - want).abs().max())
    R = SPONGE_COMPARE_ROWS
    bound_ms, bound_by = sponge_bound(args[0], R, n_elems)
    wide1_ms = sponge_bound(args[0], R, n_elems, costs=SPONGE_COSTS_WIDE1)[0]
    timing = kernel_timing(lambda: rescue_sponge.rescue_sponge(*args), "rescue_sponge_kernel",
                           bound_ms, rescue_sponge)
    del args, got, want
    torch.cuda.empty_cache()
    return {
        "name": f"rescue_sponge[{name} {mode} rows={R}"
                f"{f' elems={n_elems}' if n_elems is not None else ''}]",
        "route": "cuda", "source": "starkpack_winterfell_tpu_torch/csrc/rescue_sponge.cu",
        "replaces": SPONGE_REPLACES[name],
        "used_by": [used_by], "launches": 0, "launches_by_path": {},
        "permutations_compared": rescue_sponge.permutations(rescue_sponge.LAYOUTS[name], R,
                                                            n_elems),
        "ptxas": sponge_ptxas(name, mode),
        "max_abs_err": err, **timing,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_ms_wide_one_slot": wide1_ms,
        "library_ms": None,
    }


def sponge_launches(hasher, air, n_inst: int, options) -> collections.Counter:
    """Sponge launches by (hasher, mode, rows, elements a row) of one prove,
    derived from the configuration: a tree over the trace LDE's rows (n_inst
    * width elements), one over the composition columns' rows (columns x
    extension degree), one over each FRI layer's rows (folding factor x
    degree elements, a row per folded group); a tree is one hash launch of
    its leaves and one merge launch a level.  Every prove path commits
    these trees."""
    _, _, _, ext, folding, _ = options
    d = int(ext)
    L = air.lde_domain_size()
    trees = [(L, n_inst * air.trace_info().width()),
             (L, air.context.num_constraint_composition_columns() * d)]
    size = L
    for _ in range(ProofOptions(*options).to_fri_options().num_fri_layers(L)):
        trees.append((size // folding, folding * d))
        size //= folding
    out = collections.Counter()
    for rows, n_elems in trees:
        out[(hasher.NAME, "hash", rows, n_elems)] += 1
        while rows > 1:
            rows //= 2
            out[(hasher.NAME, "merge", rows, 0)] += 1
    return out


def compare_sponge_at_rows(key, rng, device):
    """The sponge wrapper at one launch shape of a counted prove, (hasher,
    mode, rows, elements a row), at its own row count: random inputs made on
    the card (canonical elements: high words below p's; a merge's two
    halves of a level, as ``sponge_inputs``), the whole launch run, and
    SPONGE_SAMPLE_ROWS rows at a stride plus the last 37 held against
    ``rescue_sponge_plain`` on the same input rows (each digest depends on
    its own row only; 0 mismatching words required).  Returns the shape and
    the rows compared."""
    name, mode, rows, n = key
    layout = rescue_sponge.LAYOUTS[name]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(1 << 62)))
    if mode == "hash":
        lo = torch.randint(0, 1 << 32, (rows, n), generator=gen, device=device)
        hi = torch.randint(0, layout.P >> 32, (rows, n), generator=gen, device=device)
        x, y = torch.stack([lo, hi], dim=-1).reshape(rows, 2 * n), None
        del lo, hi
    else:
        cur = torch.randint(0, 1 << 32, (2 * rows, 8), generator=gen, device=device)
        x, y = cur[0::2], cur[1::2]
    got = rescue_sponge.rescue_sponge(layout, x, n if mode == "hash" else None, y)
    stride = max(1, rows // SPONGE_SAMPLE_ROWS)
    idx = torch.unique(torch.cat([torch.arange(0, rows, stride, device=device),
                                  torch.arange(max(0, rows - 37), rows, device=device)]))
    want = rescue_sponge.rescue_sponge_plain(layout, x[idx], n if mode == "hash" else None,
                                             None if y is None else y[idx])
    mism = int((got[idx] != want).sum())
    if mism:
        raise RuntimeError(f"rescue_sponge disagrees with its plain version in {mism} "
                           f"words at {key}")
    del x, y, got, want
    torch.cuda.empty_cache()
    return {"hasher": name, "mode": mode, "rows": rows, "elems": n,
            "rows_compared": int(idx.numel()), "mismatching_words": 0}


# the search mode's launches in each counted prove: hasher -> {path: launches}
SEARCH_LAUNCHES_BY_PATH: dict = {}


def check_sponge(path, got, expected, rng, device, search=None):
    """The sponge launches of a counted prove, by (hasher, mode, rows,
    elements a row), must be the derived ones; with ``search`` (the search
    mode's launches by hasher read just after the prove, the proof, its
    grinding factor, the hasher's name) the proof-of-work search must have
    launched the kernel's search once per NONCE_BATCH_CARD nonces up to
    the proof's nonce (none at grinding 0); the largest launch of each
    (hasher, mode, elements a row) is then compared at its own row count
    (``compare_sponge_at_rows``; the prove's counts were read before).
    Returns the phase line's fields: launches, permutations, the least time
    the card could take for all of them (``sponge_bound``), the shapes
    compared and the seconds that took."""
    if got != expected:
        raise RuntimeError(f"the {path} prove launched the sponge {dict(got)}, "
                           f"derived were {dict(expected)}")
    fields = {}
    if search is not None:
        seen, proof, grinding, name = search
        batch = prover_channel.NONCE_BATCH_CARD
        want = {name: (proof.pow_nonce - 1) // batch + 1} if grinding > 0 else {}
        if seen != want:
            raise RuntimeError(f"the {path} prove launched the sponge's search {seen}, "
                               f"derived from nonce {proof.pow_nonce} were {want}")
        for k, v in seen.items():
            SEARCH_LAUNCHES_BY_PATH.setdefault(k, {})[path] = v
        fields = {"search_launches": sum(seen.values()), "search_launches_as_derived": True}
    perms = bound_ms = wide1_ms = 0
    largest = {}
    for (name, mode, rows, n), v in got.items():
        n_elems = n if mode == "hash" else None
        layout = rescue_sponge.LAYOUTS[name]
        perms += v * rescue_sponge.permutations(layout, rows, n_elems)
        bound_ms += v * sponge_bound(layout, rows, n_elems)[0]
        wide1_ms += v * sponge_bound(layout, rows, n_elems, costs=SPONGE_COSTS_WIDE1)[0]
        largest[(name, mode, n)] = max(rows, largest.get((name, mode, n), 0))
    t0 = time.perf_counter()
    compared = [compare_sponge_at_rows((name, mode, rows, n), rng, device)
                for (name, mode, n), rows in sorted(largest.items())]
    return {**fields, "sponge_launches": sum(got.values()), "sponge_permutations": perms,
            "sponge_bound_ms": bound_ms, "sponge_bound_ms_wide_one_slot": wide1_ms,
            "sponge_launches_as_derived": True,
            "sponge_compared_at_path_rows": compared,
            "sponge_compare_at_path_rows_s": time.perf_counter() - t0}


@contextlib.contextmanager
def nonce_search_timer():
    """Records the nonce, the wall seconds and the seed (hex) of each
    proof-of-work search (``ProverChannel._find_nonce``) run inside; the
    last one stays."""
    found = {}
    search = prover_channel.ProverChannel._find_nonce

    def timed(self, grinding_factor):
        t0 = time.perf_counter()
        nonce = search(self, grinding_factor)
        found.update(nonce=nonce, seconds=time.perf_counter() - t0,
                     grinding_factor=grinding_factor, seed=self.public_coin.seed.hex())
        return nonce

    prover_channel.ProverChannel._find_nonce = timed
    try:
        yield found
    finally:
        prover_channel.ProverChannel._find_nonce = search


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
        elif key[0] == "sponge":
            new_rows[key] = compare_sponge(key[1:], rng, device, path)
        else:
            new_rows[key] = compare_cons(key[1:], airs[key[1:3]], rng, device, path)
    steady = {k: v - built[k] for k, v in seen.items() if v > built[k]}
    return proof, seconds, steady, new_rows


def record_observed(path, seen, new_rows, kernel_rows, required):
    """Reads the counts just after a counted prove: it must have launched
    every kind of kernel in ``required`` and no other kind, only compared
    shapes, and each as often as ``seen`` (the first prove's counts less its
    table builds) says.  The counts go into the table."""
    counted = observed_counts()
    kinds = {k[0] for k in counted}
    if set(required) != kinds or any(seen.get(k) != v for k, v in counted.items()):
        raise RuntimeError(f"the {path} prove launched {counted}, required kinds "
                           f"{required} and no other, compared were {seen}")
    for key, count in counted.items():
        if key not in kernel_rows:
            kernel_rows[key] = new_rows[key]
        elif path not in kernel_rows[key]["used_by"]:
            kernel_rows[key]["used_by"].append(path)
        kernel_rows[key]["launches"] += count
        kernel_rows[key]["launches_by_path"][path] = count
    return counted


def counted_prove(path, prover, traces, kernel_rows, seen, new_rows, required=("dit",)):
    """One prove of the path with every launch count set to 0 just before
    and read just after.  The launched tile shapes and their counts must be
    exactly those ``path_shapes`` lists (all of them held against the plain
    version by the kernels phase), the DIT shapes (periodic columns, FRI
    folds) those of the first prove; the counts go into the table."""
    ntt4.reset_launch_counts()
    reset_observed_counts()
    proof, seconds, phases = timed_prove(prover, traces)
    dit = record_observed(path, seen, new_rows, kernel_rows, required)
    sponge = collections.Counter(rescue_sponge.LAUNCHES_BY_SHAPE)
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
    return proof, seconds, phases, total + sum(dit.values()), launches, sponge


# verifies of each proof after the first, for the median verify wall
VERIFY_REPS = 5


def verify_walls(air_class, parsed, pub, hasher) -> dict:
    """The verify fields of a phase's line: the first verify's wall, then
    the median and each of VERIFY_REPS more on the same parsed proof."""
    t0 = time.perf_counter()
    verify(air_class, parsed, pub, hasher)
    first = time.perf_counter() - t0
    more = []
    for _ in range(VERIFY_REPS):
        t0 = time.perf_counter()
        verify(air_class, parsed, pub, hasher)
        more.append(time.perf_counter() - t0)
    return dict(verify_s=first, verify_median_s=statistics.median(more),
                verify_walls_s=more, verify_tier="c")


def seed_hash_walls(proof, pub, hasher, elem_bytes: int) -> dict:
    """The Fiat-Shamir seed (context 0 and every public input, as the
    prover's channel and the verifier's coin build it) and the walls of its
    ``hash_elements``: its first, the median of VERIFY_REPS more."""
    seed = list(proof.contexts[0].to_elements())
    for p in pub:
        seed.extend(p.to_elements())
    walls = []
    for _ in range(VERIFY_REPS + 1):
        t0 = time.perf_counter()
        hasher.hash_elements(seed, elem_bytes)
        walls.append(time.perf_counter() - t0)
    return dict(seed_bytes=len(seed) * elem_bytes, seed_hash_s=walls[0],
                seed_hash_median_s=statistics.median(walls[1:]))


def verified_bytes(prover, proof, traces):
    """Serialize, parse back, verify with the port's verifier: the bytes
    and the verify fields (``verify_walls``)."""
    data = proof.to_bytes()
    parsed = proof.from_bytes(data)
    if parsed.to_bytes() != data:
        raise RuntimeError("proof serialization round trip failed")
    pub = [prover.get_pub_inputs(t) for t in traces]
    return data, verify_walls(RescueChainAir, parsed, pub, prover.hasher)


def tamper_chain_seed(pub):
    return pub[:-1] + [ChainInputs([(pub[-1].seed[0] + 1) % gl.P] + pub[-1].seed[1:],
                                   pub[-1].result)]


def big_phase(path, kernel_rows, rng, device, traces, hasher=Blake3_256, **extra):
    """One prove size of the f64 big-trace path with its ``PATHS`` options: a
    first prove (each DIT shape it shows is held against its plain version),
    then the counted prove and its peak device memory over the main LDE;
    the proof is verified, a tampered seed rejected and, where the path has
    a pin (``GOLDEN_BIG``), its sha256 matched.  ``extra`` goes into the
    phase's line; with ``base_steady_prove_s`` the line also gives the
    steady prove over it.  With a hasher other than BLAKE3 (Rp64_256) the
    sponge kernel runs too: its shapes are compared as the first prove shows
    them and its launches by shape must be those ``sponge_launches``
    derives.  Returns the steady prove's seconds."""
    log2_rows, n, options = PATHS[path]
    prover = RescueChainProver(ProofOptions(*options), hasher)
    required = ("dit",) if hasher.NAME.startswith("blake3") else ("dit", "sponge")
    _, first_s, seen, new_rows = first_prove(path, prover, traces, kernel_rows, rng, device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    proof, steady_s, phases, total, launches, sponge = counted_prove(
        path, prover, traces, kernel_rows, seen, new_rows, required)
    search = dict(rescue_sponge.SEARCH_LAUNCHES_BY_LAYOUT)
    peak = torch.cuda.max_memory_allocated()
    data, verified = verified_bytes(prover, proof, traces)
    fields = dict(extra)
    if "sponge" in required:
        air0 = RescueChainAir(traces[0].get_info(), prover.get_pub_inputs(traces[0]),
                              prover.options())
        fields.update(check_sponge(path, sponge, sponge_launches(hasher, air0, n, options),
                                   rng, device, (search, proof, options[2], hasher.NAME)))
    if "base_steady_prove_s" in extra:
        fields["steady_over_base"] = steady_s / extra["base_steady_prove_s"]
    pub = [prover.get_pub_inputs(t) for t in traces]
    try:
        verify(RescueChainAir, proof.from_bytes(data), tamper_chain_seed(pub), hasher)
    except VerifierError as e:
        fields["tampered_rejected"] = str(e)
    else:
        raise RuntimeError(f"{path}: a tampered seed was accepted")
    if path in GOLDEN_BIG:
        digest = hashlib.sha256(data).hexdigest()
        with open(GOLDEN_BIG[path]) as f:
            pinned = f.read().strip()
        if digest != pinned:
            raise RuntimeError(f"{path} proof digest {digest} differs from pinned {pinned}")
        fields.update(sha256=digest, matches_pinned=True)
    lde_bytes = n * WIDTH * (1 << log2_rows) * BLOWUP * 8
    emit(path, rows=1 << log2_rows, columns=WIDTH, n=n, options=list(options),
         hasher=prover.hasher.NAME, first_prove_s=first_s, steady_prove_s=steady_s,
         phases_ms={name: ms for name, ms in phases},
         kernel_launches=total, launches=launches,
         peak_memory_bytes=peak, resident_before_bytes=resident,
         peak_over_main_lde=(peak - resident) / lde_bytes,
         proof_bytes=len(data), security_level_conjectured=proof.security_level_conjectured(),
         verified=True, **verified, **fields)
    return steady_s


def big_trace_phases(kernel_rows, rng, device):
    """The f64 big-trace path: 2^14 rows against its pinned digest, the
    2^20-row chain with the bench options and then, on the same trace, with
    Rp64_256, RpJive64_256 and GriffinJive64_256 (the sponge kernel's three
    Goldilocks layouts) and with the 128-bit options (cubic), 4 x 2^16 rows
    aggregated; then the 128-bit options at 2^14 rows against their pin,
    and 4 x 2^16 rows at quadratic."""
    chain = lambda seeds, rows: [build_chain_trace([int(v) for v in s], rows // 8)
                                 for s in seeds]
    big_phase("small", kernel_rows, rng, device, chain([[7] * 8], 1 << PATHS["small"][0]))
    t0 = time.perf_counter()
    main_traces = chain([[7] * 8], 1 << PATHS["main"][0])
    trace_s = time.perf_counter() - t0
    base_s = big_phase("main", kernel_rows, rng, device, main_traces, trace_build_s=trace_s)
    for path, hasher in (("rp64_main", Rp64_256), ("rpjive_main", RpJive64_256),
                         ("griffin_main", GriffinJive64_256)):
        with nonce_search_timer() as nonce:
            big_phase(path, kernel_rows, rng, device, main_traces, hasher=hasher,
                      trace_build_s=trace_s, base_steady_prove_s=base_s, nonce_search=nonce)
        MAIN_SEEDS[hasher.NAME] = nonce["seed"]
    big_phase("ext_cubic_main", kernel_rows, rng, device, main_traces, trace_build_s=trace_s,
              base_steady_prove_s=base_s)
    del main_traces
    for path in ("aggregated", "ext_cubic_golden", "ext_quad_aggregated"):
        log2_rows, n, _ = PATHS[path]
        seeds = ([[7] * 8] if path in GOLDEN_BIG
                 else rng.integers(0, gl.P, size=(n, 8), dtype=np.uint64))
        big_phase(path, kernel_rows, rng, device, chain(seeds, 1 << log2_rows))


# ---------------------------------------------------------------------------
# the limb-field path: kernels 4 (limb NTT tile) and 5 (constraint evaluation)
# ---------------------------------------------------------------------------

# fib over a limb field: (air class, build_trace, prover class, inputs)
FIB = {field: get_fib_family(field) for field in ("f128", "f62")}


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
    airs[("f128", "Merkle128Air")] = mk.Merkle128Air(
        TraceInfo(mk.TRACE_WIDTH, 64), mk.Merkle128Inputs([1, 2]), options)
    return airs


def mismatching(got, want):
    return sum(int((g != w).sum()) for g, w in zip(got, want))


def limb_tile_bound(key):
    """Least time (ms) of one kernel 4 launch at a ``limb_ntt.shape_key``
    (``op_bound``): x read once (a broadcast one once for all groups), the
    output written once, each table once; the stages after the
    log2(n / n_in) that zero-padded rows only copy, a butterfly (a twiddle
    product, an add and a subtract) per two elements and stage, whatever
    products by 1 the kernel skips; a multiply per input element and table
    or factor, and per output element for the scale."""
    field, _, G, D, n, n_in, lanes, xs, _, ps, has_row, has_col, has_scale = key
    el_bytes = get_backend(field).ELEMENT_BYTES
    B = G * D
    x_elems = (D if G > 1 and xs[0] == 0 else B) * n_in * lanes
    out_elems = B * n * lanes
    tables = (n // 2 + (n_in * lanes if ps is not None else 0)
              + (G * n_in if has_row else 0) + (G * lanes if has_col else 0))
    nbytes = el_bytes * (x_elems + out_elems + tables)
    butterflies = out_elems * (n_in.bit_length() - 1) // 2
    muls = (B * n_in * lanes * ((ps is not None) + has_row + has_col)
            + (out_elems if has_scale else 0))
    return op_bound(nbytes, {"twmul": butterflies, "mul": muls, "add": butterflies,
                             "sub": butterflies}, field)


def limb_tile_name(key) -> str:
    field, inverse, G, D, n, n_in, lanes, xs, os_, ps, has_row, has_col, has_scale = key
    opts = "".join([" +bcast" if G > 1 and xs[0] == 0 else "",
                    " +interleaved" if G > 1 and os_[0] == 1 else "",
                    f" n_in={n_in}" if n_in < n else "", " +pre" if ps is not None else "",
                    " +row" if has_row else "", " +col" if has_col else "",
                    " +scale" if has_scale else ""])
    return (f"limb_dit_tile[{field} {'inverse' if inverse else 'forward'} G={G} D={D} n={n} "
            f"lanes={lanes} {layout_name(xs[2:], os_[2:])}{opts}]")


def limb_tile_inputs(key, rng, device):
    """(run, plain) of one kernel 4 shape: the wrapper on views laid out with
    the key's strides (x, pre and a new output) and random tables, and its
    plain version on the same inputs."""
    field, inverse, G, D, n, n_in, lanes, xs, os_, ps, has_row, has_col, has_scale = key
    F = get_backend(field).F

    def view(shape, strides, fill=True):
        size = 1 + sum((d - 1) * st for d, st in zip(shape, strides))
        flat = random_limb(field, (size,), rng, device) if fill else tuple(
            torch.empty(size, dtype=torch.int64, device=device) for _ in range(F.n))
        return tuple(torch.as_strided(l, shape, strides) for l in flat)

    x = view((G, D, n_in, lanes), xs)
    out = view((G, D, n, lanes), os_, fill=False)
    pre = view((n_in, lanes), ps) if ps is not None else None
    row = random_limb(field, (G, n_in), rng, device) if has_row else None
    col = random_limb(field, (G, lanes), rng, device) if has_col else None
    scale = int(rng.integers(1, 1 << 62)) if has_scale else None
    tw = limb_ntt.tile_twiddles(F, n, inverse, device)
    return (lambda: limb_ntt.tile(F, x, tw, n, pre, row, col, scale, out, inverse),
            lambda: limb_ntt.tile_plain(F, x, tw, n, pre, row, col, scale))


def compare_limb_tile(key, rng, device, used_by):
    """Kernel 4 at one launched shape: the wrapper against its plain version
    (0 mismatching words required), then its times and bound."""
    run, plain = limb_tile_inputs(key, rng, device)
    got, want = run(), plain()
    torch.cuda.synchronize()
    mism = mismatching(got, want)
    if mism:
        raise RuntimeError(f"limb dit_tile disagrees with its plain version in "
                           f"{mism} words at {limb_tile_name(key)}")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    del got, want
    bound = limb_tile_bound(key)
    timing = kernel_timing(run, "dit_tile_kernel<F", bound["bound_ms"], limb_ntt)
    plain_ms = time_cuda(plain, 1, warm=False)  # ``want`` was its first run
    del run, plain
    torch.cuda.empty_cache()
    return {
        "name": limb_tile_name(key),
        "route": "cuda",
        "source": "starkpack_winterfell_tpu_torch/csrc/limb_ntt_tile.cu + csrc/dit_tile.cuh",
        "replaces": "starkpack_winterfell_tpu/ops/pallas/limb_kernel.py:151",
        "used_by": [used_by], "launches": 0, "launches_by_path": {},
        "max_abs_err": err, **timing,
        "plain_ms": plain_ms, **bound_fields(bound, timing),
        "library_ms": None,
    }


def compare_cons(key, air0, rng, device, used_by):
    """Kernel 5 at one launched shape (AIR, n, w, ce, sequence tables) on
    random inputs: kernel against ``constraint_eval_plain``, then its time."""
    field, air_name, n, w, ce, n_seq, shift, blowup = key
    el_bytes = get_backend(field).ELEMENT_BYTES
    w_air, n_per, K, groups = cons_config(air0)
    assert w_air == w and cons_kernel.seq_count(groups) == n_seq
    args = cons_args(air0, n, ce, blowup, rng, device, shift=shift)
    pers, scal = args[7], args[9]
    L = ce * shift
    n_ccs = sum(len(g) for g in groups)
    periods = [p[0].shape[0] for p in pers]  # one period of each column over the ce domain
    err, _ = hold_cons(args, key)
    # bound: every input read once, the output written once; the recorded
    # transition plus the frame's operations per point and instance
    body, results = cons_kernel.record_transition(air0, w, n_per, K)
    counts = cons_kernel.count_ops(body)
    mul = counts["mul"] + K + 1 + len(groups) + n_ccs + 1
    add = counts["add"] + (K - 1) + len(groups) + n_ccs + 1
    sub = counts["sub"] + counts["neg"] + n_ccs
    nbytes = (el_bytes * (n * w * L + sum(periods) + (1 + len(groups)) * ce
                          + n_seq * n * ce + ce)
              + 8 * scal.numel())
    points = n * ce
    bound = op_bound(nbytes, {"mul": points * mul, "sqr": points * counts["sqr"],
                              "add": points * add, "sub": points * sub}, field)
    timing = kernel_timing(lambda: cons_kernel.constraint_eval(*args), "cons_eval_kernel",
                           bound["bound_ms"], cons_kernel)
    # ``hold_cons`` made the plain version's first run
    plain_ms = time_cuda(lambda: cons_kernel.constraint_eval_plain(*args), 1, warm=False)
    lib_name, path = cons_kernel.kernel_source(air0, w, n_per, K, groups)
    design = cons_kernel.design(body, results)
    del args, pers, scal
    torch.cuda.empty_cache()
    row = {
        "name": f"cons_eval[{field} {air_name} n={n} w={w} ce={ce}"
                f"{f' seq={n_seq}' if n_seq else ''}"
                f"{' one LDE coset (shift 1, blowup 1)' if blowup == 1 else ''}]",
        "route": "cuda",
        "source": "starkpack_winterfell_tpu_torch/csrc/cons_frame.cuh + "
                  "ops/cons_kernel.py emit_cuda",
        "emitted_source": os.path.relpath(path, os.path.dirname(os.path.abspath(__file__))),
        "emitted_lines": open(path).read().count("\n"),
        "field_ops_per_point": {"mul": mul, "sqr": counts["sqr"], "add": add, "sub": sub},
        # the emitter's design of the body: its roles (results, mul+sqr of
        # each, repeated between them), the blocks an SM must hold; the
        # body's field constants, all literals
        "roles": len(design["roles"]), "design": design,
        "constants": {"placement": "literals",
                      "count": sum(op[0] == "const" for op in body)},
        "sequence_table_bytes": el_bytes * n_seq * n * ce,
        "ptxas": ptxas_report(native.BUILD_LOGS, lib_name),
        "replaces": "starkpack_winterfell_tpu/ops/pallas/cons_kernel.py:137",
        "used_by": [used_by], "launches": 0, "launches_by_path": {},
        "max_abs_err": err, **timing,
        "plain_ms": plain_ms, **bound_fields(bound, timing),
        "library_ms": None,
    }
    return row


def observed_counts():
    """Launch counts by shape of the kernels whose shapes a first prove
    shows: ("dit", ...) kernels 2 and 3, ("ntt", ...) kernel 4, ("cons",
    ...) kernel 5, ("sponge", hasher, mode, elements a row) the Rescue
    sponge summed over the rows of its launches (``check_sponge`` holds the
    rows)."""
    shapes = {("dit",) + k: v for k, v in ntt_kernel.LAUNCHES_BY_SHAPE.items()}
    shapes.update({("ntt",) + k: v for k, v in limb_ntt.LAUNCHES_BY_SHAPE.items()})
    shapes.update({("cons",) + k: v for k, v in cons_kernel.LAUNCHES_BY_SHAPE.items()})
    for (name, mode, _, n_elems), v in rescue_sponge.LAUNCHES_BY_SHAPE.items():
        key = ("sponge", name, mode, n_elems if mode == "hash" else None)
        shapes[key] = shapes.get(key, 0) + v
    return shapes


def reset_observed_counts():
    ntt_kernel.reset_launch_counts()
    limb_ntt.reset_launch_counts()
    cons_kernel.reset_launch_counts()
    rescue_sponge.reset_launch_counts()


@contextlib.contextmanager
def extension_side_launches():
    """Counts by shape (``observed_counts`` keys) of kernel 4's launches made
    inside the steps of a limb prove that run once per extension component
    at degree > 1: the composition's interpolation and the FRI remainder
    (``interpolate_poly_with_offset``), the coset LDE of the composition
    columns and of the DEEP polynomial (``full_pipeline.sharded_lde_blocks``)
    and the FRI folds (``fri/prover.py:limb_apply_drp``).  Everything else
    kernel 4 does in a prove (the trace LDE, the sequence tables) is the
    same at every degree."""
    counts = collections.Counter()
    depth = [0]

    def counted(fn):
        def call(*args, **kwargs):
            if depth[0]:
                return fn(*args, **kwargs)
            before = dict(limb_ntt.LAUNCHES_BY_SHAPE)
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                for key, v in limb_ntt.LAUNCHES_BY_SHAPE.items():
                    counts[("ntt",) + key] += v - before.get(key, 0)
        return call

    saved = (full_pipeline.sharded_lde_blocks, fri_prover.limb_apply_drp)
    backends = [get_backend(field) for field in ("f128", "f62")]
    full_pipeline.sharded_lde_blocks = counted(saved[0])
    fri_prover.limb_apply_drp = counted(saved[1])
    for B in backends:
        B.interpolate_poly_with_offset = counted(B.interpolate_poly_with_offset)
    try:
        yield counts
    finally:
        full_pipeline.sharded_lde_blocks, fri_prover.limb_apply_drp = saved
        for B in backends:
            del B.interpolate_poly_with_offset


def extension_launches(base, side, ext_deg):
    """Kernel 4's launches by shape that a prove at ``ext_deg`` must make,
    from the degree-1 prove of the same trace and options: ``base``, its
    counts, and ``side``, those of them made by the steps that run once per
    extension component (``extension_side_launches``); kernel 5 gives way
    to the eager constraint phase."""
    want = collections.Counter({k: v for k, v in base.items() if k[0] == "ntt"})
    for key, v in side.items():
        want[key] += (ext_deg - 1) * v
    return +want


@contextlib.contextmanager
def forced_stream(on: bool):
    """With ``on``, the memory budget at one byte (``STARKPACK_HBM_BUDGET``),
    so ``prove_mesh``'s gate sends a limb prove down the coset-streamed
    path."""
    old = os.environ.get("STARKPACK_HBM_BUDGET")
    if on:
        os.environ["STARKPACK_HBM_BUDGET"] = "1"
    try:
        yield
    finally:
        if on and old is None:
            del os.environ["STARKPACK_HBM_BUDGET"]
        elif on:
            os.environ["STARKPACK_HBM_BUDGET"] = old


class MeshPaths(logging.Handler):
    """The path each ``prove_mesh`` took, from its "prove_mesh path" record."""

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.paths = []

    def emit(self, record):
        if str(record.msg).startswith("prove_mesh path"):
            self.paths.append(record.args[0])


@contextlib.contextmanager
def mesh_paths():
    handler = MeshPaths()
    logger = logging.getLogger("starkpack_winterfell_tpu_torch.prover.device")
    logger.addHandler(handler)
    try:
        yield handler.paths
    finally:
        logger.removeHandler(handler)


@contextlib.contextmanager
def coset_transforms():
    """What the streamed pipeline did in a prove: its coset transforms (each
    component's ``LimbField.coset_evals`` call), kernel 4's launches inside
    them, and the query positions ``streamed_query_rows`` re-derived."""
    seen = {"transforms": 0, "launches": 0, "positions": []}
    fields = [get_backend(field).F for field in ("f128", "f62")]

    def counted(fn):
        def call(*args, **kwargs):
            before = limb_ntt.LAUNCHES
            seen["transforms"] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                seen["launches"] += limb_ntt.LAUNCHES - before
        return call

    saved = streamed.streamed_query_rows

    def query_rows(*args, **kwargs):
        rows = saved(*args, **kwargs)

        def call(positions):
            seen["positions"].append(list(positions))
            return rows(positions)
        return call

    for F in fields:
        F.coset_evals = counted(F.coset_evals)
    streamed.streamed_query_rows = query_rows
    try:
        yield seen
    finally:
        for F in fields:
            del F.coset_evals
        streamed.streamed_query_rows = saved


def streamed_launches(air0, options, num_aux: int, positions) -> dict:
    """The coset transforms (one extension component each) and kernel 4 and 5
    launches a streamed prove makes, from its config and its query
    positions: P1 and P1b ``blowup`` cosets a segment; P2 the cb ce cosets
    (LDE coset rc * shift) of the main segment, and of every aux segment
    where the eager branch reads aux frames; P3 ``blowup`` cosets of the
    composition columns; P8 each coset the positions touch, for every
    segment.  A transform of ``length`` points is one kernel 4 launch up to
    the tile cap, two (the four-step) above it; kernel 5 runs once a ce
    coset where it takes the prove (degree 1, no aux segments)."""
    length, cb = air0.trace_length(), air0.ce_blowup_factor()
    blowup, d = options.blowup_factor, int(options.field_extension)
    kernel5 = d == 1 and num_aux == 0
    cosets = len({p % blowup for p in positions})
    transforms = (blowup * (1 + num_aux * d) + cb * (1 + num_aux * d)
                  + blowup * d + cosets * (1 + num_aux * d + d))
    return {"coset_transforms": transforms,
            "coset_transform_launches": transforms * (1 if length <= limb_ntt.MAX_TILE_N else 2),
            "cons_launches": cb if kernel5 else 0, "query_cosets": cosets}


def observed_phase(path, prover, air_class, traces, kernel_rows, rng, device,
                   required, airs=None, golden=None, tampers=(), side=None,
                   expected=None, sponge=None, seed_hash=False, stream=False,
                   force_stream=False, same_as=None, **extra):

    """One size of a path whose kernel shapes are read off a first prove
    (``first_prove``): each new shape is held against its plain version;
    then the counted prove must launch every kind of kernel in ``required``
    and no other kind, only compared shapes, each as often as the first prove did less the
    launches of its table builds.  (The first prove of a limb config also
    builds its periodic and divisor tables, which later proves find cached:
    those shapes are compared too, and a shape launched by them alone is
    named ``first_prove_only`` in the phase's line.)  ``tampers``: (name,
    function of the public inputs) pairs, each of whose results the verifier
    must reject.  ``side``: a dict that gets the counted prove's
    ``extension_side_launches``; ``expected``: the counts the counted prove
    must show, derived beforehand (``extension_launches``, ``perm_launches``);
    ``sponge``: the sponge launches by rows it must show (``sponge_launches``);
    ``seed_hash``: also time the Fiat-Shamir seed's hash (``seed_hash_walls``).
    ``stream``: the path every prove of a ``prove_mesh`` phase must take
    (its "prove_mesh path" records; the line says ``streamed``), and for a
    streamed one the coset transforms and kernel 4 and 5 launches
    ``streamed_launches`` derives; ``force_stream``: both proves with the
    budget at one byte (``forced_stream``); ``same_as``: the sha256 the
    proof must have (another path's proof of the same statement).  ``extra`` goes
    into the phase's line; with ``base_steady_prove_s`` the line also gives
    the steady prove over it.  Returns {"counted", "steady_prove_s",
    "phases_ms", "sha256"} of the counted prove."""
    n = len(traces)
    hasher = prover.hasher
    pub = [prover.get_pub_inputs(t) for t in traces]
    with forced_stream(force_stream), mesh_paths() as paths:
        first_proof, first_s, seen, new_rows = first_prove(
            path, prover, traces, kernel_rows, rng, device, airs)
    verify(air_class, first_proof, pub, hasher)
    del first_proof

    reset_observed_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # tables cached by earlier proves
    with (extension_side_launches() if side is not None
          else contextlib.nullcontext()) as side_counts, forced_stream(force_stream), \
            mesh_paths() as counted_paths, coset_transforms() as transforms:
        proof, seconds, phases = timed_prove(prover, traces)
    peak = torch.cuda.max_memory_allocated()
    paths += counted_paths
    want_path = "streamed" if stream else "one-shot"
    if paths and set(paths) != {want_path}:
        raise RuntimeError(f"the {path} proves took the paths {paths}, expected {want_path}")
    sponge_seen = collections.Counter(rescue_sponge.LAUNCHES_BY_SHAPE)
    search_seen = dict(rescue_sponge.SEARCH_LAUNCHES_BY_LAYOUT)
    counted = record_observed(path, seen, new_rows, kernel_rows, required)
    fields = dict(extra)
    if paths:
        fields["streamed"] = stream
    if stream:
        air0 = prover.air_class(traces[0].get_info(), pub[0], prover.options())
        want = streamed_launches(air0, prover.options(), traces[0].num_aux_segments(),
                                 transforms["positions"][0])
        got = {"coset_transforms": transforms["transforms"],
               "coset_transform_launches": transforms["launches"],
               "cons_launches": sum(v for k, v in counted.items() if k[0] == "cons"),
               "query_cosets": want["query_cosets"]}
        if got != want or len(transforms["positions"]) != 1:
            raise RuntimeError(f"the {path} prove made {got}, derived were {want}")
        fields.update(stream_launches=got, stream_launches_as_derived=True)
    if sponge is not None:
        search = (search_seen, proof, prover.options().grinding_factor, hasher.NAME)
        fields.update(check_sponge(path, sponge_seen, sponge, rng, device, search))
    if side is not None:
        side.update(+side_counts)
    if expected is not None:
        if dict(counted) != dict(expected):
            raise RuntimeError(f"the {path} prove launched {counted}, derived "
                               f"were {dict(expected)}")
        fields["launches_as_derived"] = True
    if "base_steady_prove_s" in extra:
        fields["steady_over_base"] = seconds / extra["base_steady_prove_s"]
    data = proof.to_bytes()
    parsed = proof.from_bytes(data)
    if parsed.to_bytes() != data:
        raise RuntimeError("proof serialization round trip failed")
    fields.update(verify_walls(air_class, parsed, pub, hasher))
    if seed_hash:
        fields.update(seed_hash_walls(proof, pub, hasher, traces[0].spec.ELEMENT_BYTES))
    if golden is not None:
        digest = hashlib.sha256(data).hexdigest()
        with open(golden) as f:
            pinned = f.read().strip()
        if digest != pinned:
            raise RuntimeError(f"{path} proof digest {digest} differs from pinned {pinned}")
        fields.update(sha256=digest, matches_pinned=True)
    if same_as is not None:
        digest = hashlib.sha256(data).hexdigest()
        if digest != same_as:
            raise RuntimeError(f"{path} proof digest {digest} differs from the other "
                               f"path's {same_as}")
        fields.update(sha256=digest, matches_other_path=True)
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
         proof_bytes=len(data), security_level_conjectured=proof.security_level_conjectured(),
         verified=True, **fields)
    return {"counted": counted, "steady_prove_s": seconds,
            "phases_ms": {name: ms for name, ms in phases},
            "sha256": hashlib.sha256(data).hexdigest()}


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
    side = {}
    base = observed_phase("limb_main", prover, Rescue128ChainAir, [trace],
                          kernel_rows, rng, device, both, airs, side=side,
                          tampers=[("seed", tamper_seed)])
    # the same trace at quadratic: the eager constraint phase in place of
    # kernel 5, the extension's steps through kernel 4 once per component
    ext_prover = Rescue128ChainProver(ProofOptions(*LIMB_EXT_OPTIONS), Blake3_256)
    quad = observed_phase("limb_ext_main", ext_prover, Rescue128ChainAir, [trace], kernel_rows,
                          rng, device, ("ntt",),
                          expected=extension_launches(base["counted"], side,
                                                      int(LIMB_EXT_OPTIONS[3])),
                          tampers=[("seed", tamper_seed)], options=list(LIMB_EXT_OPTIONS),
                          base_steady_prove_s=base["steady_prove_s"],
                          base_phases_ms=base["phases_ms"])
    # the same prove down the coset-streamed path: the eager constraint
    # branch per ce coset, in the extension
    observed_phase("limb_stream_quad", ext_prover, Rescue128ChainAir, [trace], kernel_rows,
                   rng, device, ("ntt",), stream=True, force_stream=True,
                   same_as=quad["sha256"], tampers=[("seed", tamper_seed)],
                   options=list(LIMB_EXT_OPTIONS), base_steady_prove_s=quad["steady_prove_s"],
                   base_phases_ms=quad["phases_ms"])
    del trace

    log2_rows, n = LIMB_PATHS["limb_aggregated"]
    seeds = rng.integers(0, 1 << 62, size=(n, 2), dtype=np.uint64)
    traces = [build_rescue128_chain_trace([int(v) for v in sd], (1 << log2_rows) // 8)
              for sd in seeds]
    observed_phase("limb_aggregated", prover, Rescue128ChainAir, traces,
                   kernel_rows, rng, device, both, airs, tampers=[("seed", tamper_seed)])


# ---------------------------------------------------------------------------
# the limb path over the extension fields: Merkle paths, golden rows, f62
# ---------------------------------------------------------------------------


def merkle_paths(n: int, depth: int, rng):
    """``n`` Merkle authentication paths of ``depth`` levels over f128,
    drawn from the run's seed: (leaf, siblings, index) each."""
    prng = random.Random(int(rng.integers(1 << 62)))
    return [([prng.randrange(mk.P) for _ in range(2)],
             [[prng.randrange(mk.P) for _ in range(2)] for _ in range(depth)],
             prng.getrandbits(depth)) for _ in range(n)]


def tamper_root(pub):
    return pub[:-1] + [mk.Merkle128Inputs([(pub[-1].root[0] + 1) % mk.P, pub[-1].root[1]])]


def limb_ext_phases(kernel_rows, rng, device):
    """Merkle authentication paths over f128, many aggregated into ONE proof
    (a batch of membership proofs against one tree, such as the account
    reads of a block): at degree 1 with BLAKE3-256 through the constraint
    kernel's merkle128 body, then on the same traces at quadratic with
    SHA3-256 (the golden row's hasher) through the eager constraint phase,
    kernel 4's launches derived from the degree-1 prove's.  A tampered root
    is rejected.  The paths and their traces are built on the host (native
    builder) and timed apart.  Then golden rows 10 and 12 and fib-f62 at
    cubic against their pins."""
    n, depth = MERKLE_PATHS
    t0 = time.perf_counter()
    paths = merkle_paths(n, depth, rng)
    traces = mk.build_merkle128_traces(paths)
    trace_s = time.perf_counter() - t0
    leaf, sibs, index = paths[0]
    root = [traces[0].get(c, traces[0].length - 1) for c in (0, 1)]
    if root != mk.compute_root128(leaf, sibs, index):
        raise RuntimeError("the native Merkle-path builder disagrees with compute_root128")
    del paths
    prover = mk.Merkle128Prover(ProofOptions(*BENCH_OPTIONS), Blake3_256)
    side = {}
    base = observed_phase("merkle128_aggregated", prover, mk.Merkle128Air, traces, kernel_rows,
                          rng, device, ("ntt", "cons"), phase_airs(prover, traces), side=side,
                          tampers=[("root", tamper_root)], paths=n, depth=depth,
                          trace_build_s=trace_s)
    quad = mk.Merkle128Prover(ProofOptions(*MERKLE_QUAD_OPTIONS), Sha3_256)
    observed_phase("merkle128_aggregated_quad", quad, mk.Merkle128Air, traces, kernel_rows,
                   rng, device, ("ntt",),
                   expected=extension_launches(base["counted"], side,
                                               int(MERKLE_QUAD_OPTIONS[3])),
                   tampers=[("root", tamper_root)], paths=n, depth=depth,
                   options=list(MERKLE_QUAD_OPTIONS), base_steady_prove_s=base["steady_prove_s"],
                   base_phases_ms=base["phases_ms"])
    del traces

    for path, (example, n, l, opts, hasher, pin) in LIMB_EXT_GOLDEN.items():
        air_class, prover_class, build = get_example(example)
        if example == "rescue128-chain":  # the golden matrix's seeds
            traces = [build_rescue128_chain_trace([i + 1, i + 2], l) for i in range(n)]
        else:
            traces = [build(i, l) for i in range(n)]
        observed_phase(path, prover_class(ProofOptions(*opts), hasher), air_class, traces,
                       kernel_rows, rng, device, ("ntt",), golden=golden_pin(pin),
                       options=list(opts))


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
    rows of the reference's aggregation table; the 1024 again forced down
    the coset-streamed path (its bytes the one-shot proof's), then 4096
    (2^22 rows, the next row of the table), which the memory plan streams;
    then 4 StarkPack instances of one signature each (lamport128, k = 127)
    with SHA3-256.  Every proof is verified; a tampered message and a
    tampered public key are rejected.  The wallet (keys, messages,
    signatures) and the trace are built on the host and timed apart from
    the prove; the 1024 signatures are the first of the 4096's wallet."""
    options = ProofOptions(*BENCH_OPTIONS)
    both = ("ntt", "cons")
    prover = lagg.Lamport128AggProver(options, Blake3_192)
    tampers = [("message", tamper_agg_message), ("public key", tamper_agg_pub_key)]
    big = None  # the 4096-signature wallet and its build's seconds
    for path in ("lamport_agg_golden", "lamport_agg_64", "lamport_agg_main",
                 "lamport_agg_4096"):
        n_sigs, k = LAMPORT_PATHS[path]
        golden = path == "lamport_agg_golden"
        # the tables and caches of earlier proves go, so the largest prove
        # finds the card's memory free
        full_pipeline._TABLE_CACHE.clear()
        torch.cuda.empty_cache()
        if path in ("lamport_agg_main", "lamport_agg_4096"):
            # one wallet of 4096: make_wallet draws each signature's keys and
            # message in turn, so its first 1024 are make_wallet(1024)'s
            if big is None:
                t0 = time.perf_counter()
                big = (lagg.make_wallet(LAMPORT_PATHS["lamport_agg_4096"][0], k,
                                        seed=int(rng.integers(1 << 30))),
                       time.perf_counter() - t0)
            messages, _, sigs = (part[:n_sigs] for part in big[0])
            wallet = ({"wallet_s": big[1]} if path == "lamport_agg_4096" else
                      {"wallet": "the first 1024 signatures of lamport_agg_4096's wallet"})
        else:
            t0 = time.perf_counter()
            messages, _, sigs = lagg.make_wallet(n_sigs, k, seed=0 if golden else
                                                 int(rng.integers(1 << 30)))
            wallet = {"wallet_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        trace = lagg.build_lamport128_agg_trace(messages, sigs, k)
        trace_s = time.perf_counter() - t0
        del messages, sigs
        # 4096 signatures (a 7.5 GB main LDE) stream by the gate alone
        done = observed_phase(path, prover, lagg.Lamport128AggAir, [trace], kernel_rows, rng,
                              device, both, phase_airs(prover, [trace]),
                              golden=GOLDEN_LAMPORT if golden else None, tampers=tampers,
                              seed_hash=path == "lamport_agg_main",
                              stream=path == "lamport_agg_4096",
                              signatures=n_sigs, k=k, trace_build_s=trace_s, **wallet)
        if path == "lamport_agg_main":
            # the same trace forced down the coset-streamed path: kernel 5
            # once a ce coset, the same proof bytes
            full_pipeline._TABLE_CACHE.clear()
            torch.cuda.empty_cache()
            observed_phase("lamport_agg_main_streamed", prover, lagg.Lamport128AggAir, [trace],
                           kernel_rows, rng, device, both, phase_airs(prover, [trace]),
                           tampers=tampers, stream=True, force_stream=True,
                           same_as=done["sha256"], signatures=n_sigs, k=k,
                           base_steady_prove_s=done["steady_prove_s"],
                           base_phases_ms=done["phases_ms"])
        del trace
    del big

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
                   tampers=[("seed", tamper_chain_seed)])
    del traces

    # the extension fields: golden rows 2 and 4 against their pins, then
    # do-work 32 x 1024 at quadratic
    for path, (example, n, rows, opts, pin) in SMALL_TRACE_EXT_GOLDEN.items():
        air_class, prover_class, build = get_example(example)
        observed_phase(path, prover_class(ProofOptions(*opts), Blake3_256), air_class,
                       [build(i, rows) for i in range(n)], kernel_rows, rng, device, dit,
                       golden=golden_pin(pin), options=list(opts),
                       tampers=[("start", tamper_start)] if example == "do-work" else ())
    log2_rows, n = SMALL_TRACE_PATHS["small_trace_ext_do_work"]
    observed_phase("small_trace_ext_do_work",
                   DoWorkProver(ProofOptions(*QUAD_OPTIONS), Blake3_256), DoWorkAir,
                   [build_do_work_trace(i + 1, 1 << log2_rows) for i in range(n)],
                   kernel_rows, rng, device, dit, options=list(QUAD_OPTIONS),
                   tampers=[("start", tamper_start)])


# ---------------------------------------------------------------------------
# auxiliary trace segments: the permutation AIR through prove_mesh on f64
# ---------------------------------------------------------------------------


def dit_keys(batch: int, n: int, comps: int, n_in: int = None, pre: bool = False,
             scale: bool = False):
    """``observed_counts`` keys of the kernel 2 and 3 launches that
    ops/ntt.py makes for ``comps`` components of ``batch`` rows transformed
    along their last axis: up to ``ntt_kernel.MAX_TILE_N`` points one
    ``ntt_last`` a component (rows of ``n_in`` zero-padded to n, a
    pre-multiply table, the inverse's scale), above it the four-step
    split's two ``dit_tile`` launches a component: over n1 on the rows
    viewed (batch, n_in / n2, n2), zero-padded to n1 rows (a coset LDE's
    rows also times the offset's row and column factors), stored
    transposed, then over n2 on that (batch, n2, n1) array with the
    twiddle table."""
    n_in = n if n_in is None else n_in
    if n <= ntt_kernel.MAX_TILE_N:
        return [("dit", "last", batch, n, n_in, (n_in, 1), pre, scale)] * comps
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    rows = n_in // n2
    coset = n_in < n
    return [("dit", "tile", batch, n1, rows, n2,
             (0 if batch == 1 else n_in, n2 if rows > 1 else 0, 1),
             (0 if batch == 1 else n, 1, n1), False, coset, coset),
            ("dit", "tile", batch, n2, n2, n1, (0 if batch == 1 else n, n1, 1),
             (0 if batch == 1 else n, n1, 1), True, False, False)] * comps


def perm_launches(n: int, length: int, options) -> collections.Counter:
    """Kernel 2 and 3 launches, by shape, of one prove of ``n`` perm traces
    of ``length`` rows with ``options`` (prove_mesh through GL64Backend),
    derived from the configuration: P1 interpolates the main trace (2
    columns an instance) and extends it to the LDE domain; P1b the aux
    column, once per extension component; P3 interpolates the composition
    over the ce domain and extends its columns coset by coset; then the
    DEEP polynomial coset by coset, one inverse transform of the folding
    factor a row in each FRI layer's fold, and the remainder's
    interpolation, all once per component.  No table build of the path
    launches a transform, so the first prove and a later one agree."""
    _, blowup, _, ext, folding, _ = options
    d = int(ext)
    opts = ProofOptions(*options)
    air = PermAir(TraceInfo.new_multi_segment(TraceLayout(2, (1,), (1,)), length),
                  PermInputs(1, 1), opts)
    domain = StarkDomain(air)
    ce, L = domain.ce_size, domain.lde_size
    cols = air.context.num_constraint_composition_columns()

    def interpolate(batch, size, comps):
        return dit_keys(batch, size, comps, scale=True)

    def lde(batch, comps):  # the coset LDE, offset multiply and padding in the launch
        return dit_keys(batch, L, comps, n_in=length, pre=L <= ntt_kernel.MAX_TILE_N)

    keys = interpolate(2 * n, length, 1) + lde(2 * n, 1)
    keys += interpolate(n, length, d) + lde(n, d)
    keys += interpolate(1, ce, d) + dit_keys(blowup * cols, length, d)
    keys += dit_keys(blowup, length, d)
    size = L
    for _ in range(opts.to_fri_options().num_fri_layers(L)):
        keys += interpolate(size // folding, folding, d)
        size //= folding
    keys += interpolate(1, size, d)
    return collections.Counter(keys)


def tamper_a0(pub):
    return pub[:-1] + [PermInputs((pub[-1].a0 + 1) % gl.P, pub[-1].b0)]


def aux_phases(kernel_rows, rng, device):
    """StarkPack aggregation of permutation arguments, each trace with one
    auxiliary segment (a grand product in the extension field): 4 x 2^20
    rows at quadratic (aux_main, starts drawn from the run's seed), then
    golden row 5 (2 x 64, quadratic) and 2 x 2^12 at the 128-bit options
    (cubic) against their pins.  Every transform goes through kernels 2 and
    3, whose launches by shape must equal ``perm_launches``; each new
    shape is held against its plain version and timed.  Each proof is
    verified and a tampered a0 rejected."""
    for path, (n, rows, opts, pin) in AUX_PATHS.items():
        starts = ([i + 3 for i in range(n)] if pin else
                  [int(v) for v in rng.integers(1, gl.P, size=n, dtype=np.uint64)])
        t0 = time.perf_counter()
        traces = [build_perm_trace(s, rows) for s in starts]
        trace_s = time.perf_counter() - t0
        out = observed_phase(path, PermProver(ProofOptions(*opts), Blake3_256), PermAir,
                             traces, kernel_rows, rng, device, ("dit",),
                             golden=golden_pin(pin) if pin else None,
                             tampers=[("a0", tamper_a0)],
                             expected=perm_launches(n, rows, opts), options=list(opts),
                             trace_build_s=trace_s)
        emit(f"{path}_dit_shapes", shapes=[
            {k: kernel_rows[key][k] for k in ("name", "device_ms", "bound_ms", "bound_by",
                                                "bound_share", "plain_ms")}
            | {"launches": count} for key, count in out["counted"].items()])
        del traces


# ---------------------------------------------------------------------------
# the algebraic hashers: the Rescue sponge kernel on every commit
# ---------------------------------------------------------------------------


def rp_phases(kernel_rows, rng, device):
    """Golden rows 6-8 (rescue-chain with Rp64_256; fib-f62 with Rp62_248 at
    degree 1 and at cubic) against their pins; the canonical-bucket chain
    (100 live permutations in a bucket of 128) with Rp64_256, a tampered
    n_live rejected; 64 f64 Lamport+ signatures of 127-bit messages (64
    instances x 1024 rows x 26 columns) with SHA3-256, the reference's
    pairing for this AIR, a tampered message rejected; fib over f62, 2 x
    2^20 rows at golden row 8's options with the main path's queries and
    grinding (``RP62_MAIN``), a tampered result rejected.  Every sponge
    launch of a counted prove is derived from the configuration
    (``sponge_launches``); each (hasher, mode, row length) is held against
    the plain version."""
    for path, (example, n, l, opts, hasher, pin) in RP_GOLDEN.items():
        air_class, prover_class, build = get_example(example)
        traces = [build(i, l) for i in range(n)]
        prover = prover_class(ProofOptions(*opts), hasher)
        air0 = prover.air_class(traces[0].get_info(), prover.get_pub_inputs(traces[0]),
                                prover.options())
        f62 = example == "fib-f62"
        required = (("ntt", "cons", "sponge") if f62 and int(opts[3]) == 1
                    else ("ntt", "sponge") if f62 else ("dit", "sponge"))
        observed_phase(path, prover, air_class, traces, kernel_rows, rng, device, required,
                       phase_airs(prover, traces), golden=golden_pin(pin),
                       sponge=sponge_launches(hasher, air0, n, opts), options=list(opts))

    options = ProofOptions(*BENCH_OPTIONS)
    n_live, bucket = RESCUE_PAD
    seed = [int(v) for v in rng.integers(0, gl.P, size=8, dtype=np.uint64)]
    t0 = time.perf_counter()
    traces = [build_padded_chain_trace(seed, n_live, bucket)]
    trace_s = time.perf_counter() - t0
    prover = RescueChainPadProver(options, Rp64_256, n_live)

    def tamper_n_live(pub):
        return [PaddedChainInputs(pub[0].seed, pub[0].result, pub[0].n_live + 1)]

    air0 = RescueChainPadAir(traces[0].get_info(), prover.get_pub_inputs(traces[0]), options)
    observed_phase("rescue_pad", prover, RescueChainPadAir, traces, kernel_rows, rng, device,
                   ("dit", "sponge"), tampers=[("n_live", tamper_n_live)],
                   sponge=sponge_launches(Rp64_256, air0, 1, BENCH_OPTIONS),
                   n_live=n_live, bucket=bucket, trace_build_s=trace_s)

    n, k = LAMPORT64
    t0 = time.perf_counter()
    wallet = []
    for i in range(n):
        secrets, pk_hashes, _ = lam64.keygen(k, seed=i)
        message = (1 << (k - 1)) | int(rng.integers(1 << 62))
        wallet.append((message, lam64.sign(secrets, pk_hashes, message, k)))
    wallet_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    traces = lam64.build_lamport_traces([m for m, _ in wallet], [sig for _, sig in wallet], k)
    trace_s = time.perf_counter() - t0

    def tamper_message(pub):
        return pub[:-1] + [lam64.LamportInputs(pub[-1].message ^ 1, pub[-1].pub_key)]

    observed_phase("lamport64", lam64.LamportProver(options, Sha3_256), lam64.LamportAir,
                   traces, kernel_rows, rng, device, ("dit",),
                   tampers=[("message", tamper_message)], signatures=n, k=k,
                   wallet_s=wallet_s, trace_build_s=trace_s)
    del traces

    n, rows, opts = RP62_MAIN
    fib_air, fib_build, fib_prover, fib_inputs = FIB["f62"]
    t0 = time.perf_counter()
    traces = [fib_build(rows) for _ in range(n)]
    trace_s = time.perf_counter() - t0
    prover = fib_prover(ProofOptions(*opts), Rp62_248)
    air0 = fib_air(traces[0].get_info(), prover.get_pub_inputs(traces[0]), prover.options())

    def tamper_result(pub):
        return pub[:-1] + [fib_inputs((pub[-1].result + 1) % air0.field_spec().P)]

    full_pipeline._TABLE_CACHE.clear()
    torch.cuda.empty_cache()
    with nonce_search_timer() as nonce:
        observed_phase("rp62_main", prover, fib_air, traces, kernel_rows, rng, device,
                       ("ntt", "sponge"), tampers=[("result", tamper_result)],
                       sponge=sponge_launches(Rp62_248, air0, n, opts), options=list(opts),
                       trace_build_s=trace_s, nonce_search=nonce)
    MAIN_SEEDS[Rp62_248.NAME] = nonce["seed"]
    del traces


# the proof-of-work seeds of the main paths' counted proves (hex), by hasher
MAIN_SEEDS: dict = {}
SEARCH_BITS = 16
SEARCH_RANDOM_SEEDS = 3


def random_seed(hasher, rng) -> bytes:
    """A random seed digest: the Goldilocks hashers four canonical elements,
    Rp62_248 31 random bytes (its unpacked values may lie in [p, 2^62))."""
    if hasher is not Rp62_248:
        return b"".join(int(v).to_bytes(8, "little")
                        for v in rng.integers(0, gl.P, size=4, dtype=np.uint64))
    return bytes(rng.integers(0, 256, size=31, dtype=np.uint8))


def search_nonce(hasher, seed: bytes, batch: int, device) -> int:
    """The lowest nonce >= 1 at SEARCH_BITS, in ascending batches, as
    ``ProverChannel._find_nonce`` asks for it."""
    nonce = 1
    while (found := hasher.first_merge_with_int(seed, nonce, batch, SEARCH_BITS,
                                                device)) is None:
        nonce += batch
    return found


SEARCH_HASHERS = (Rp64_256, Rp62_248, RpJive64_256, GriffinJive64_256)


def sponge_search_phase(kernel_rows, rng, device):
    """The sponge kernel's proof-of-work search against the host C search
    (``first_merge_with_int`` of the byte API) for the four hashers at
    grinding 16: the main paths' seeds (``MAIN_SEEDS``) and three random
    ones, equal nonces required; for the main seed every digest of one
    batch of NONCE_BATCH_CARD nonces held against the plain version (0
    mismatching words); then the kernel's times at that batch.  Its
    launches on the main paths were counted by ``check_sponge``."""
    batch = prover_channel.NONCE_BATCH_CARD
    results = []
    for hasher in SEARCH_HASHERS:
        layout = hasher.LAYOUT
        seeds = [bytes.fromhex(MAIN_SEEDS[hasher.NAME])]
        seeds += [random_seed(hasher, rng) for _ in range(SEARCH_RANDOM_SEEDS)]
        for k, seed in enumerate(seeds):
            t0 = time.perf_counter()
            host = search_nonce(hasher, seed, 1 << 12, "cpu")
            host_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            card = search_nonce(hasher, seed, batch, device)
            card_s = time.perf_counter() - t0
            if card != host:
                raise RuntimeError(f"{hasher.NAME}: the card's search found nonce {card}, "
                                   f"the host's {host} (seed {seed.hex()})")
            results.append({"hasher": hasher.NAME, "seed": "main" if k == 0 else "random",
                            "nonce": card, "card_s": card_s, "host_s": host_s})
        elems = hasher.seed_elements(seeds[0])
        nonce, got = rescue_sponge.first_merge_with_int(layout, elems, 1, batch, SEARCH_BITS,
                                                        device, digests=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain_nonce, want = rescue_sponge.first_merge_with_int_plain(
            layout, elems, 1, batch, SEARCH_BITS, device)
        end.record()
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        if mism or nonce != plain_nonce:
            raise RuntimeError(f"{hasher.NAME}: the search disagrees with its plain version "
                               f"({mism} digest words, nonce {nonce} against {plain_nonce})")
        bound_ms, bound_by = sponge_bound(layout, batch, None, search=True)
        wide1_ms = sponge_bound(layout, batch, None, search=True, costs=SPONGE_COSTS_WIDE1)[0]
        timing = kernel_timing(
            lambda: rescue_sponge.first_merge_with_int(layout, elems, 1, batch, SEARCH_BITS,
                                                       device),
            "rescue_sponge_kernel", bound_ms, rescue_sponge, counter="SEARCH_LAUNCHES")
        by_path = SEARCH_LAUNCHES_BY_PATH.get(hasher.NAME, {})
        kernel_rows[("sponge_search", hasher.NAME)] = {
            "name": f"rescue_sponge[{hasher.NAME} search nonces={batch} bits={SEARCH_BITS}]",
            "route": "cuda", "source": "starkpack_winterfell_tpu_torch/csrc/rescue_sponge.cu",
            "replaces": ("no Pallas kernel: starkpack_winterfell_tpu/prover/channel.py:114 "
                         "_find_nonce (the host C sponge)"),
            "used_by": sorted(by_path), "launches": sum(by_path.values()),
            "launches_by_path": by_path, "permutations_compared": batch,
            "ptxas": sponge_ptxas(hasher.NAME, "search"),
            "max_abs_err": float((got - want).abs().max()), **timing,
            "plain_ms": start.elapsed_time(end), "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_ms_wide_one_slot": wide1_ms, "library_ms": None,
        }
        del got, want
    for hasher in SEARCH_HASHERS:
        if not SEARCH_LAUNCHES_BY_PATH.get(hasher.NAME):
            raise RuntimeError(f"no counted prove launched the {hasher.NAME} search")
    emit("sponge_search", bits=SEARCH_BITS, batch=batch, searches=results,
         nonces_equal=True, digests_compared=len(SEARCH_HASHERS) * batch, mismatching_words=0,
         search_launches_by_path=SEARCH_LAUNCHES_BY_PATH)


def kernel_sums(kernel_rows) -> dict:
    """Per phase, each kernel's (by the TPU kernel it replaces) launches, and
    its device ms and bound summed over them (a shape's ms times its
    launches in that phase's counted prove)."""
    sums = {}
    for row in kernel_rows.values():
        for path, count in row["launches_by_path"].items():
            s = sums.setdefault(path, {}).setdefault(
                row["replaces"], {"launches": 0, "ms": 0.0, "bound_ms": 0.0})
            s["launches"] += count
            s["ms"] += count * (row.get("ms") or 0.0)
            s["bound_ms"] += count * (row.get("bound_ms") or 0.0)
    return sums


def build_all():
    """Build every kernel library and host builder of the driven paths, one
    compiler process per library, all started together."""
    airs = smoke_airs()
    jobs = {
        "ntt_tile": ntt4._lib,
        "ntt_dit": ntt_kernel._lib,
        "limb_ntt_tile": limb_ntt._lib,
        "rescue_sponge": rescue_sponge._lib,
        "sass_counts": sass_costs,
        "rescue_perm_host": lambda: (Rp64_256.merge(bytes(32), bytes(32)),
                                     Rp62_248.merge(bytes(31), bytes(31)),
                                     RpJive64_256.merge(bytes(32), bytes(32))),
        "griffin_perm_host": lambda: GriffinJive64_256.merge(bytes(32), bytes(32)),
        "trace_builder": native.get_builders,
        "rescue128_builder": native.get_rescue128,
        "blake3_host": native.get_blake3,
        "verify_scalar_host": native.get_verify_scalar,
    }
    for (field, name), air0 in airs.items():
        jobs[f"cons_eval {field} {name}"] = lambda air0=air0: cons_kernel._lib(
            air0, *cons_config(air0))
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
    emitted = [cons_kernel.kernel_source(a, *cons_config(a))[1] for a in airs.values()]
    emit("build", wall_s=time.perf_counter() - t0, seconds=seconds,
         sources=[os.path.relpath(p, root) for p in
                  ntt4.kernel_sources() + ntt_kernel.kernel_sources()
                  + limb_ntt.kernel_sources() + rescue_sponge.kernel_sources() + emitted],
         emitted_lines={os.path.relpath(p, root): open(p).read().count("\n")
                        for p in emitted},
         ptxas={name: ptxas_report(native.BUILD_LOGS, name) for name in native.BUILD_LOGS},
         sponge_costs=SPONGE_COSTS, pipe_costs=PIPE_COSTS, imad_wide_slots=IMAD_WIDE_SLOTS,
         pipe_costs_wide_one_slot=PIPE_COSTS_WIDE1)
    report = ptxas_report(native.BUILD_LOGS, rescue_sponge.kernel_source()[0])
    if report is None:
        raise RuntimeError("the sponge library was not built by this run: no ptxas report")
    SPONGE_PTXAS.update(report["kernels"])
    spilled = {k: v for k, v in SPONGE_PTXAS.items()
               if v.get("spill_store_bytes") or v.get("spill_load_bytes")}
    if len(SPONGE_PTXAS) != 3 * len(rescue_sponge.LAYOUTS) or spilled:
        raise RuntimeError(f"the sponge kernel's {3 * len(rescue_sponge.LAYOUTS)} "
                           f"instantiations (layout x mode) must not spill: {SPONGE_PTXAS}")
    # kernels 3 and 4: dit_tile_kernel<field, K> on Goldilocks, f128 and f62
    tiles = {}
    for lib in ("starknttdit", "starklimbntt"):
        report = ptxas_report(native.BUILD_LOGS, lib)
        if report is None:
            raise RuntimeError(f"{lib} was not built by this run: no ptxas report")
        tiles.update({k: v for k, v in report["kernels"].items() if "dit_tile_kernel" in k})
    spilled = {k: v for k, v in tiles.items()
               if v.get("spill_store_bytes") or v.get("spill_load_bytes")}
    if len(tiles) != 3 or spilled:
        raise RuntimeError(f"the DIT tile kernel's 3 instantiations (one a field) must not "
                           f"spill: {tiles}")


def sass_costs():
    """``SPONGE_COSTS`` and ``PIPE_COSTS`` from one run of the counter, an
    IMAD.WIDE at IMAD_WIDE_SLOTS slots, and at one (the ``_WIDE1`` ones);
    the one-pipe count of kernel 4's f62 twiddle product (a form the
    fixed one-pipe counts do not have) from the same run."""
    sass = sass_count()
    for slots, pipe, sponge in ((IMAD_WIDE_SLOTS, PIPE_COSTS, SPONGE_COSTS),
                                (1, PIPE_COSTS_WIDE1, SPONGE_COSTS_WIDE1)):
        bp = slotted(sass["by_pipe"], slots)
        pipe.update(pipe_costs(bp))
        sponge.update(sponge_costs(bp))
    ONE_PIPE["f62"]["twmul"] = sum(sass["by_pipe"]["f62_twmul"][k] for k in ("imad", "alu"))


def sass_count() -> dict:
    """csrc/gl64_sass_count.py's counts (nvcc and cuobjdump of this run)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "starkpack_winterfell_tpu_torch", "csrc", "gl64_sass_count.py")
    spec = importlib.util.spec_from_file_location("gl64_sass_count", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.count()


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

    build_all()
    kernel_rows = phase_kernels(rng, device)
    phase_dit_kernels(rng, device)
    big_trace_phases(kernel_rows, rng, device)
    small_trace_phases(kernel_rows, rng, device)
    aux_phases(kernel_rows, rng, device)
    limb_phases(kernel_rows, rng, device)
    limb_ext_phases(kernel_rows, rng, device)
    lamport_phases(kernel_rows, rng, device)
    rp_phases(kernel_rows, rng, device)
    sponge_search_phase(kernel_rows, rng, device)
    emit("kernel_sums", by_phase=kernel_sums(kernel_rows))

    print(smi, flush=True)
    print(json.dumps({"kernels": list(kernel_rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
