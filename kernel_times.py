#!/usr/bin/env python3
"""Device-only times of the port's Goldilocks NTT kernels on one NVIDIA GPU,
for one checkout of the port: this one, or another commit unpacked beside it.

    python3 kernel_times.py [--root DIR] [--prove]

``--root`` names the directory whose ``starkpack_winterfell_tpu_torch``
package is measured (default: the one beside this script), so that two
commits can be timed in one call on one card: unpack the other commit with
``git archive`` into a git-ignored directory and run the script for each,
in turns (parent, change, change, parent).  Prints one JSON line per
measurement:

* ``pipeline``: the four-step pipelines of the f64 big-trace path at the
  2^20 x 12 prove's shapes (``ops/ntt4.py`` ``_run_k1k2`` and
  ``_run_interleave_k3k4`` for the trace and the composition), run under
  ``torch.profiler``: each ``ntt_tile`` launch's device time (median of 7
  calls), the device time of everything else the call launches (copies, zero
  buffers, eager multiplies) and the call's wall time;
* ``radix`` (this checkout only): the same pipelines with kernel 1's K, the
  stages a thread runs in registers between two exchanges, forced to 3 and
  to 4 at every launch, against which ``ops/ntt4.py:_block_shape``'s choice
  is checked;
* ``entry``: the small transforms that kernel 2 carries (``ops/ntt.py``
  entries at the shapes the big-trace and small-trace proves use): device
  time of the NTT kernels, of everything else, and kernel launches per call;
* ``host``: host microseconds per wrapper call, perf_counter over 1000 calls
  with no synchronisation (the kernel wrappers of kernels 1, 3 and 4);
* ``prove`` (with ``--prove``): one warm and one timed 2^20 x 12 Rescue-chain
  prove: its phase walls, peak device memory and kernel launches.

``device_kernel_ms`` and ``timed_prove`` are also what ``chip_smoke.py``
times kernels and proves with.  Inputs are drawn from a fixed numpy seed.
Needs a CUDA device (exits non-zero without one).
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPS = 7


def _device_events(prof):
    """(name, start us, duration us) of every device activity the profiler
    recorded, in start order."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.elapsed_us()))
    out.sort(key=lambda t: t[1])
    return out


class ProfilerDroppedRecords(RuntimeError):
    """The profiler lost records: no session recorded a call, or the calls
    recorded show the kernel but fewer than asked for were recorded whole."""


MARK = "spin_kernel"  # torch.cuda._sleep's kernel, launched between calls
# markers before the first call: the profiler drops the first records of a
# session now and then (up to five in a row on an H100)
LEAD_MARKS = 8


def profile_calls(fn, reps: int = REPS):
    """Runs ``fn`` once to warm up, then ``reps`` times under torch.profiler
    (CUDA activity only), a synchronisation and a marker kernel after each
    call and LEAD_MARKS before the first.  Each call launches kernels, so
    the non-empty groups of device events between markers are the calls.
    The profiler loses records now and then: the first few of a session,
    its tail, or all of it.  A call whose marker was dropped merges with the
    next one, a call whose own records were dropped is missing.  Returns
    (device events of each call recorded, at most ``reps`` of them; wall
    seconds of each call)."""
    fn()
    torch.cuda.synchronize()
    walls = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_MARKS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    segments, cur = [], []
    for ev in _device_events(prof):
        if MARK in ev[0]:
            segments.append(cur)
            cur = []
        else:
            cur.append(ev)
    segments.append(cur)
    return [seg for seg in segments if seg][-reps:], walls


def device_kernel_ms(fn, match, reps: int = REPS, sessions: int = 3):
    """Median device milliseconds, per call, of the kernels whose names hold
    one of the substrings ``match`` (a string or a tuple), over ``reps``
    profiled calls of ``fn``.  A call whose record lacks a launch that the
    others show, or holds two calls' launches, is left out and made up by
    another profiling session, up to ``sessions`` of them.  Raises
    RuntimeError when calls were recorded and none launched a matching
    kernel, ``ProfilerDroppedRecords`` when no session recorded a call or
    fewer than ``reps`` calls were recorded whole.  Whether ``fn`` launched
    its kernel at all is for its wrapper's launch count to say: a session
    that recorded no call tells nothing."""
    match = (match,) if isinstance(match, str) else tuple(match)
    hits, launches, full = [], 0, []
    for _ in range(sessions):
        per_call, _ = profile_calls(fn, reps)
        hits += [split_call(ev, match)[0] for ev in per_call]
        # launches of a whole call: the count most calls show
        launches = collections.Counter(len(h) for h in hits).most_common(1)[0][0] if hits else 0
        full = [sum(h) for h in hits if len(h) == launches]
        if launches > 0 and len(full) >= reps:
            return statistics.median(full) / 1e3
    if not hits:
        raise ProfilerDroppedRecords(f"{match}: no call recorded in {sessions} sessions")
    if launches == 0:
        raise RuntimeError(f"{match}: none of {len(hits)} recorded calls launched a "
                           f"matching kernel")
    raise ProfilerDroppedRecords(
        f"{match}: {len(full)} of {reps} calls recorded whole in {sessions} sessions "
        f"(launches per recorded call {[len(h) for h in hits]})")


def split_call(events, match):
    """(durations in us of the matching kernels in launch order, summed us of
    every other device activity) of one call."""
    hits = [d for name, _, d in events if any(m in name for m in match)]
    other = sum(d for name, _, d in events if not any(m in name for m in match))
    return hits, other


def host_us(fn, calls: int = 1000):
    """Host microseconds per call of ``fn`` with no synchronisation."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


class PhaseLog(logging.Handler):
    """Collects the (phase name, milliseconds) records the provers log."""

    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.phases = []

    def emit(self, record):
        if isinstance(record.args, tuple) and len(record.args) == 2:
            self.phases.append((str(record.args[0]), float(record.args[1])))


def timed_prove(prover, traces):
    """One synchronised prove with the provers' phase records collected.
    Returns (proof, wall seconds, [(phase name, ms), ...])."""
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


def emit(kind, **fields):
    print(json.dumps({"kind": kind, **fields}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                   help="directory holding the starkpack_winterfell_tpu_torch to time")
    p.add_argument("--prove", action="store_true", help="also time a 2^20 x 12 prove")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times.py needs a CUDA device: torch.cuda.is_available() is False")
    root = os.path.abspath(args.root)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from starkpack_winterfell_tpu_torch import Blake3_256, FieldExtension, ProofOptions, TraceInfo
    from starkpack_winterfell_tpu_torch.models.rescue_chain import (
        ChainInputs, RescueChainAir, RescueChainProver, build_chain_trace)
    from starkpack_winterfell_tpu_torch.ops import gl64 as gl, limb_ntt, ntt, ntt4, ntt_kernel
    from starkpack_winterfell_tpu_torch.ops.backend import get_backend
    from starkpack_winterfell_tpu_torch.prover import device_big

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0].strip()
    label = os.path.relpath(root, here)
    emit("device", root=label, nvidia_smi=smi, torch=torch.__version__)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def words(shape):
        return gl.from_u64(rng.integers(0, gl.P, size=shape, dtype=np.uint64), dev)

    # kernel 1: the four-step pipelines at the 2^20 x 12 prove's shapes
    length, blowup, offset, width, nc_total, num_cols = 1 << 20, 8, 7, 12, 8, 7
    L = length * blowup
    c_tr = ntt4.lde_consts(length, L, offset, dev)
    c_ce = ntt4.intt_consts(L, L, offset, dev)
    b2, a2 = c_ce["e2"].shape
    c_col = ntt4.fwd_consts(L, a2, offset, b2 // nc_total, dev)
    trace = words((1, width, length))
    pc = ntt4._run_k1k2((trace,), c_tr)
    comp = words((1, L))
    cols = words((num_cols, b2 // nc_total, a2))
    steps = {
        "trace K1+K2": lambda: ntt4._run_k1k2((trace,), c_tr),
        "trace K3+K4": lambda: ntt4._run_interleave_k3k4(pc, c_tr, L),
        "composition K1+K2": lambda: ntt4._run_k1k2((comp,), c_ce),
        "composition K3+K4": lambda: ntt4._run_interleave_k3k4((cols,), c_col, L, scale=c_col["o"]),
    }
    def time_steps(kind, **tags):
        for name, fn in steps.items():
            per_call, walls = profile_calls(fn)
            split = [split_call(ev, ("ntt_tile_kernel",)) for ev in per_call]
            split = [(k, o) for k, o in split if len(k) == 2]  # records the profiler kept whole
            if len(split) < 3:
                raise RuntimeError(f"{name}: too few calls with their two tile launches")
            emit(kind, root=label, step=name, **tags,
                 kernel_ms=[statistics.median(k[i] for k, _ in split) / 1e3 for i in range(2)],
                 other_device_ms=statistics.median(o for _, o in split) / 1e3,
                 other_device_kernels=statistics.median(len(ev) - 2 for ev in per_call),
                 wall_ms=statistics.median(walls) * 1e3)

    time_steps("pipeline")
    if root == here:
        # K forced at every launch; the threads follow K as _block_shape has them
        chosen = ntt4._block_shape
        for k in (3, 4):
            def forced(n, rows_in, lanes, transposed, k=k):
                log_lg, _, _ = chosen(n, rows_in, lanes, transposed)
                tasks = (n >> min(k, n.bit_length() - 1)) << log_lg
                return log_lg, k, min(ntt4.MAX_THREADS, max(32, tasks))
            ntt4._block_shape = forced
            try:
                time_steps("radix", radix_log=k)
            finally:
                ntt4._block_shape = chosen
    del trace, pc, comp, cols
    torch.cuda.empty_cache()

    # kernel 2: the small transforms on the proves' paths (the FRI fold's rows
    # as the prove holds them: a transposed view of the layer's evaluations)
    options = ProofOptions(28, 8, 16, FieldExtension.NONE, 4, 31)
    air = RescueChainAir(TraceInfo(width, length), ChainInputs([1] * 8, [2] * 4), options)
    entries = {
        "big-trace periodic columns (25 x 8 -> 64)":
            lambda: device_big._small_periodic_columns(air, dev),
        "big-trace FRI fold iNTT m=2^21 N=4": (lambda x: lambda: ntt.interpolate_poly((x,)))(words((4, 1 << 21)).T),
        "big-trace FRI fold iNTT m=2^19 N=4": (lambda x: lambda: ntt.interpolate_poly((x,)))(words((4, 1 << 19)).T),
        "big-trace FRI fold iNTT m=2^17 N=4": (lambda x: lambda: ntt.interpolate_poly((x,)))(words((4, 1 << 17)).T),
        "do-work interpolate 320 x 1024": (lambda x: lambda: ntt.interpolate_poly((x,)))(words((320, 1024))),
        "do-work interpolate 32 x 2048": (lambda x: lambda: ntt.interpolate_poly((x,)))(words((32, 2048))),
        "coset LDE 32 x 256 -> 2048": (lambda x: lambda: ntt.evaluate_poly_with_offset((x,), offset, 8))(words((32, 256))),
    }
    match = ("ntt_dit_axis0", "ntt_last")  # kernel 2 before and after its redesign
    for name, fn in entries.items():
        per_call, walls = profile_calls(fn)
        split = [split_call(ev, match) for ev in per_call]
        emit("entry", root=label, step=name,
             kernel_launches=statistics.median(len(k) for k, _ in split),
             kernel_ms=statistics.median(sum(k) for k, _ in split) / 1e3,
             other_device_ms=statistics.median(o for _, o in split) / 1e3,
             other_device_kernels=statistics.median(len(ev) - len(k) for ev, (k, _) in zip(per_call, split)),
             wall_ms=statistics.median(walls) * 1e3)

    # host time of one wrapper call (small shapes: the launch, not the work)
    x3, tw64 = words((2, 64, 64)), ntt4.tile_twiddles(64, False, dev)
    F = get_backend("f128").F
    lx = (words((2, 64, 64)), words((2, 64, 64)))
    ltw = limb_ntt.tile_twiddles(F, 64, False, dev)
    emit("host", root=label, us_per_call={
        "ntt_tile": host_us(lambda: ntt4.ntt_tile(x3, tw64, False)),
        "dit_axis1": host_us(lambda: ntt_kernel.dit_axis1(x3, tw64)),
        "limb_ntt_tile": host_us(lambda: limb_ntt._tile_launch(F, lx, ltw, None, False)),
        "ntt_components n=64": host_us(lambda: ntt.ntt_components((x3[0],))),
    })

    if args.prove:
        prover = RescueChainProver(options, Blake3_256)
        traces = [build_chain_trace([7] * 8, length // 8)]
        timed_prove(prover, traces)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ntt4.reset_launch_counts()
        ntt_kernel.reset_launch_counts()
        _, seconds, phases = timed_prove(prover, traces)
        emit("prove", root=label, rows=length, columns=width, seconds=seconds,
             phases_ms=dict(phases), peak_memory_bytes=torch.cuda.max_memory_allocated(),
             ntt_tile_launches=ntt4.LAUNCHES, dit_launches=ntt_kernel.LAUNCHES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
