#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives the port's main path (Rescue hash-chain STARK, 2^20 rows x 12
columns, BLAKE3-256, ProofOptions(28, 8, 16, NONE, 4, 31)) through the
entry points a user calls, and beside it a 2^14-row prove with a pinned
digest and an aggregated prove of 4 x 2^16 rows.  Builds the CUDA kernel
from ``csrc/`` and holds it against its plain PyTorch version on the card at
every shape any of the three proves launches; each prove's launch counts
are set to 0 just before it, read just after it and must be exactly the
compared shapes.  Every proof is checked with the port's verifier.  Each of
the six phases (device, build, kernels, small, main, aggregated) prints one
JSON line as it ends; any failure raises and the run exits non-zero.  The
last two lines are the per-kernel table and the ``{"ok": ...}`` summary.

Needs a CUDA device (exits non-zero without one) and no network.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import logging
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from starkpack_winterfell_tpu_torch import (
    Blake3_256,
    FieldExtension,
    ProofOptions,
    VerifierError,
    verify,
)
from starkpack_winterfell_tpu_torch import native
from starkpack_winterfell_tpu_torch.models.rescue_chain import (
    ChainInputs,
    RescueChainAir,
    RescueChainProver,
    build_chain_trace,
)
from starkpack_winterfell_tpu_torch.ops import gl64 as gl
from starkpack_winterfell_tpu_torch.ops import ntt4

BENCH_OPTIONS = (28, 8, 16, FieldExtension.NONE, 4, 31)
BLOWUP = 8
WIDTH = 12
COMPOSITION_COLUMNS = 7
# the three proves this script drives: name -> (log2 of the rows, instances)
PATHS = {"small": (14, 1), "main": (20, 1), "aggregated": (16, 4)}

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

GOLDEN = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "starkpack_winterfell_tpu_torch", "golden", "rescue14_bench.sha256",
)


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    """(label, (dif, B, n, lanes, epilogue)) of every tile transform one
    prove of ``n_inst`` traces of 2^log2_rows rows launches: the trace
    interpolate+LDE (batch = 12 columns per instance), the composition
    interpolate (one per instance) and the composition column LDE (the 7
    columns of the instances' sum).  Two steps may share a shape."""
    length = 1 << log2_rows
    L = length * BLOWUP
    a, b, Bf = ntt4._pick_factors(length, L)
    w = WIDTH * n_inst
    ce = L  # degree-7 cycle-8 constraints: the ce domain is the LDE domain
    a2, b2, Bf2 = ntt4._pick_factors(ce, L)
    nc = COMPOSITION_COLUMNS
    return [
        ("trace K1", (True, w, a, b, True)),
        ("trace K2", (True, w, b, a, True)),
        ("trace K3", (False, w, Bf, a, True)),
        ("trace K4", (False, w, a, Bf, False)),
        ("composition K1", (True, n_inst, a2, b2, True)),
        ("composition K2", (True, n_inst, b2, a2, True)),
        ("composition K3", (False, nc, Bf2, a2, True)),
        ("composition K4", (False, nc, a2, Bf2, False)),
    ]


def expected_launches(path: str) -> collections.Counter:
    return collections.Counter(key for _, key in path_shapes(*PATHS[path]))


def random_words(shape, rng, device):
    """Canonical field elements drawn with numpy from the run's seed."""
    arr = rng.integers(0, gl.P, size=shape, dtype=np.uint64)
    return gl.from_u64(arr, device)


def time_cuda(fn, reps: int):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
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


def tile_bound(dif: bool, B: int, n: int, lanes: int, epilogue: bool):
    """Least time (ms) the card could take for one tile transform: every
    input read once and the output written once against the memory rate, or
    its field operations against the integer rate, whichever is larger."""
    words = B * n * lanes
    nbytes = 8 * (2 * words + n // 2 + (n * lanes if epilogue else 0))
    stages = n.bit_length() - 1
    butterfly = OPS_FIELD_MUL + OPS_FIELD_ADD + OPS_FIELD_SUB  # per two words
    ops = words * stages * butterfly // 2
    if epilogue:
        ops += words * OPS_FIELD_MUL
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(rng, device):
    """Holds the kernel against its plain version on the card at every
    (B, n, lanes) that any of the driven paths launches, and at n = 2, in
    all four DIF/DIT x epilogue variants (0 mismatching words required),
    and times the variants the paths launch.  Returns the table rows keyed
    by (dif, B, n, lanes, epilogue)."""
    used = {}
    for path, args in PATHS.items():
        for label, key in path_shapes(*args):
            used.setdefault(key, []).append(f"{path} {label}")
    sizes = sorted({key[1:4] for key in used}) + [(3, 2, 4096), (5, 2, 3)]
    rows, compared, mismatching = {}, 0, 0
    for B, n, lanes in sizes:
        x = random_words((B, n, lanes), rng, device)
        table = random_words((n, lanes), rng, device)
        for dif in (True, False):
            tw = ntt4.tile_twiddles(n, dif, device)
            for epilogue in (True, False):
                ep = table if epilogue else None
                got = ntt4.ntt_tile(x, tw, dif, ep)
                want = ntt4.ntt_tile_plain(x, tw, dif, ep)
                bad = got != want
                mism = int(bad.sum())
                compared += 1
                mismatching += mism
                if mism:
                    raise RuntimeError(
                        f"ntt_tile disagrees with its plain version in {mism} words "
                        f"at dif={dif} B={B} n={n} lanes={lanes} epilogue={epilogue}"
                    )
                key = (dif, B, n, lanes, epilogue)
                if key not in used:
                    continue
                err = float((got - want).abs().max())
                del got, want, bad
                ms = time_cuda(lambda: ntt4.ntt_tile(x, tw, dif, ep), 7)
                plain_ms = time_cuda(lambda: ntt4.ntt_tile_plain(x, tw, dif, ep), 2)
                bound_ms, bound_by = tile_bound(*key)
                rows[key] = {
                    "name": f"ntt_tile[{'DIF' if dif else 'DIT'} B={B} n={n} "
                            f"lanes={lanes}{' +epilogue' if epilogue else ''}]",
                    "route": "cuda",
                    "source": "starkpack_winterfell_tpu_torch/csrc/ntt_tile.cu",
                    "replaces": "starkpack_winterfell_tpu/ops/pallas/ntt4.py:112",
                    "used_by": used[key],
                    "launches": 0,
                    "launches_by_path": {},
                    "max_abs_err": err,
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by,
                    "library_ms": None,
                }
        del x, table
        torch.cuda.empty_cache()
    if set(rows) != set(used):
        raise RuntimeError(f"shapes not compared: {sorted(set(used) - set(rows))}")
    emit("kernels", names=["ntt_tile<DIF>", "ntt_tile<DIT>"],
         tolerance="exact (modular integer arithmetic)",
         compared=compared, mismatching_words=mismatching,
         shapes=[{k: r[k] for k in ("name", "used_by", "ms", "plain_ms",
                                    "bound_ms", "bound_by")}
                 for r in rows.values()])
    return rows


# ---------------------------------------------------------------------------
# proofs
# ---------------------------------------------------------------------------


class PhaseLog(logging.Handler):
    """Collects the (phase name, milliseconds) records prove_big logs."""

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.phases = []

    def emit(self, record):
        if isinstance(record.args, tuple) and len(record.args) == 2:
            self.phases.append((str(record.args[0]), float(record.args[1])))


def timed_prove(prover, traces):
    log = PhaseLog()
    logger = logging.getLogger("starkpack_winterfell_tpu_torch.prover.device")
    old_level = logger.level
    logger.addHandler(log)
    logger.setLevel(logging.DEBUG)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        proof = prover.prove(len(traces), traces)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        logger.removeHandler(log)
        logger.setLevel(old_level)
    return proof, seconds, log.phases


def counted_prove(path, prover, traces, kernel_rows):
    """One prove of the path with the kernel's launch counts set to 0 just
    before and read just after.  The launched shapes and their counts must
    be exactly those ``path_shapes`` lists (all of them held against the
    plain version by the kernels phase); the counts go into the table."""
    ntt4.reset_launch_counts()
    proof, seconds, phases = timed_prove(prover, traces)
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
    return proof, seconds, phases, total, launches


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


def phase_small(prover, kernel_rows):
    rows = 1 << PATHS["small"][0]
    traces = [build_chain_trace([7] * 8, rows // 8)]
    proof, seconds, _, total, launches = counted_prove(
        "small", prover, traces, kernel_rows)
    data, verify_s = verified_bytes(prover, proof, traces)
    digest = hashlib.sha256(data).hexdigest()
    with open(GOLDEN) as f:
        pinned = f.read().strip()
    if digest != pinned:
        raise RuntimeError(f"2^14 proof digest {digest} differs from pinned {pinned}")
    emit("small", rows=rows, sha256=digest, matches_pinned=True,
         prove_s=seconds, verify_s=verify_s, proof_bytes=len(data),
         kernel_launches=total, launches=launches)


def phase_main(prover, kernel_rows):
    rows = 1 << PATHS["main"][0]
    t0 = time.perf_counter()
    traces = [build_chain_trace([7] * 8, rows // 8)]
    trace_s = time.perf_counter() - t0
    _, first_s, _ = timed_prove(prover, traces)
    torch.cuda.reset_peak_memory_stats()
    proof, steady_s, phases, total, launches = counted_prove(
        "main", prover, traces, kernel_rows)
    peak = torch.cuda.max_memory_allocated()
    data, verify_s = verified_bytes(prover, proof, traces)
    emit("main", rows=rows, columns=WIDTH, n=1,
         trace_build_s=trace_s, first_prove_s=first_s, steady_prove_s=steady_s,
         phases_ms={name: ms for name, ms in phases},
         kernel_launches=total, launches=launches, peak_memory_bytes=peak,
         proof_bytes=len(data), verify_s=verify_s, verified=True)


def phase_aggregated(prover, kernel_rows, rng):
    log2_rows, n = PATHS["aggregated"]
    rows = 1 << log2_rows
    seeds = rng.integers(0, gl.P, size=(n, 8), dtype=np.uint64)
    traces = [build_chain_trace([int(v) for v in s], rows // 8) for s in seeds]
    proof, seconds, _, total, launches = counted_prove(
        "aggregated", prover, traces, kernel_rows)
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

    t0 = time.perf_counter()
    ntt4._lib()
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.get_builders()
    emit("build", kernel_library_s=kernel_s,
         trace_builder_s=time.perf_counter() - t0,
         sources=[os.path.relpath(s, os.path.dirname(os.path.abspath(__file__)))
                  for s in ntt4.kernel_sources()])
    kernel_rows = phase_kernels(rng, device)
    phase_small(prover, kernel_rows)
    phase_main(prover, kernel_rows)
    phase_aggregated(prover, kernel_rows, rng)

    print(smi, flush=True)
    print(json.dumps({"kernels": list(kernel_rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
