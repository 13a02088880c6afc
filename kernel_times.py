#!/usr/bin/env python3
"""Device-only times of the port's Goldilocks NTT kernels and of its
constraint kernel on one NVIDIA GPU, for one checkout of the port: this one,
or another commit unpacked beside it.

    python3 kernel_times.py [--root DIR] [--prove] [--only ntt|k34|cons|ext|limb_ext|sponge] [--variants]

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
  with no synchronisation (the kernel wrappers of kernels 1 and 3, kernel
  4's entry ``ntt_last_axis``);
* ``entry_kernels``: the entries whose eager passes kernels 3 and 4 took in
  (``time_folded_entries``: the coset LDE of the Lamport 1024 trace over
  f128, the same over f62, perm's f64 four-step transform): device time of
  the kernels, of everything else, and its kernel count; with ``--variants``
  (this checkout only) also with the lanes a block stages halved and
  doubled;
* ``prove_kernels``: kernels 3 and 4 summed over one whole Lamport 1024
  prove and one whole perm 4 x 2^20 quadratic prove
  (``time_prove_kernels``), with the prove's walls;
* ``tile_sass`` (this checkout only): kernels 3 and 4's SASS by pipe
  (``time_tile_sass``);
* ``imad`` (this checkout only): the IMAD.WIDE microbenchmark
  (``time_imad``): one slot of the IMAD pipe or two;
* ``prove`` (with ``--prove``): one warm and one timed 2^20 x 12 Rescue-chain
  prove: its phase walls, peak device memory and kernel launches;
* ``cons``: kernel 5, the constraint kernel (``time_cons``), at the
  Lamport+ 1024- and 64-signature shapes and the f128 Rescue128 2^18 x 6
  one, held against its plain version, with ptxas's registers and spills;
  with ``--variants`` (this checkout only) also with the emitter's rules
  varied (``CONS_VARIANTS``).

* ``ext`` (only with ``--only ext``): the eager extension-field steps of
  the 2^20 x 12 prove at degree 1 and 3 (``time_ext``).
* ``limb_ext`` (only with ``--only limb_ext``): the eager steps of the f128
  Rescue128 2^18 x 6 prove at degree 1 and at quadratic, the eager
  constraint phase among them, beside kernel 5 on the same inputs
  (``time_limb_ext``).
* ``sponge`` (only with ``--only sponge``): one steady prove of each of the
  smoke's algebraic-hasher main paths (the 2^20 x 12 chain with Rp64_256,
  RpJive64_256 and GriffinJive64_256, fib-f62 2 x 2^20 at cubic with
  Rp62_248; the Jive hashers only where the checkout has them) under
  ``torch.profiler``: the sponge kernel's launches and device time in the
  prove (its search mode apart), the device time of everything else, the wall and the
  proof-of-work search's wall (``time_sponge``); with ``--variants`` (this
  checkout only) first the kernel at each S-box group size
  (``time_sponge_groups``): ptxas's registers and spills, device ms.

``--only`` times the NTT kernels alone (``ntt``), kernels 3 and 4 alone
(``k34``: ``entry_kernels``, ``tile_sass``, ``imad``, ``prove_kernels``),
kernel 5 alone (``cons``)
or the eager extension-field steps alone (``ext`` on f64, ``limb_ext`` on
f128).  ``cons_args`` and
``hold_cons`` also build and check ``chip_smoke.py``'s kernel-5 inputs.

``device_kernel_ms`` and ``timed_prove`` are also what ``chip_smoke.py``
times kernels and proves with.  Inputs are drawn from a fixed numpy seed.
Needs a CUDA device (exits non-zero without one).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import json
import logging
import os
import re
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


def ptxas_report(build_logs, lib_name: str):
    """nvcc seconds and ptxas's registers, spills and stack frame of each
    kernel of a library this process built (``native.BUILD_LOGS``)."""
    if lib_name not in build_logs:
        return None
    seconds, log = build_logs[lib_name]
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


# kernel 5's designs timed beside the emitter's rules (``--variants``): name
# -> the rule constants of ops/cons_kernel.py it sets
CONS_VARIANTS = {
    "rules": {},
    "one role": {"SPLIT_MIN_MULS": 1 << 30},
    "two roles": {"SPLIT_MAX_REPEAT": 1.0},
    "inputs held from first use": {"RELOADED": ("const",)},
    "min blocks 4": {"MIN_BLOCKS": 4},
    "min blocks 2": {"MIN_BLOCKS": 2},
}


@contextlib.contextmanager
def cons_rules(cons_kernel, **rules):
    """The emitter's rule constants set to ``rules`` for the duration, with
    the wrapper's library cache emptied on the way in and out."""
    old = {k: getattr(cons_kernel, k) for k in rules}
    cons_kernel._LIBS.clear()
    for k, v in rules.items():
        setattr(cons_kernel, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(cons_kernel, k, v)
        cons_kernel._LIBS.clear()


def random_limb(field, shape, rng, device):
    """Canonical elements of a limb field drawn with numpy from ``rng``, as
    word planes: f128 (lo, hi) with hi below 2^64 - 1, which keeps every
    value below p; f62 one word below p."""
    from starkpack_winterfell_tpu_torch.ops import gl64 as gl
    from starkpack_winterfell_tpu_torch.ops.backend import get_backend

    if field == "f62":
        return (gl.from_u64(rng.integers(0, get_backend("f62").P, size=shape,
                                         dtype=np.uint64), device),)
    lo = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    hi = rng.integers(0, (1 << 64) - 1, size=shape, dtype=np.uint64)
    return gl.from_u64(lo, device), gl.from_u64(hi, device)


def cons_config(air0):
    """(w, periodic columns, K, plan groups) of kernel 5 for an AIR: what
    keys its emitted source."""
    from starkpack_winterfell_tpu_torch.parallel.full_pipeline import plan_groups

    template = air0.get_boundary_constraints(None, [0] * air0.context.num_assertions())
    return (air0.trace_info().width(), len(air0.get_periodic_column_values()),
            air0.context.num_transition_constraints(), plan_groups(template))


def cons_args(air0, n: int, ce: int, blowup: int, rng, device, shift=None):
    """Arguments of ``constraint_eval`` / ``constraint_eval_plain`` for an
    AIR at n instances and ce points, on random elements: LDE rows (n, w,
    ce * shift), one period of each periodic column at its own period, the
    divisor tables, the scalar bank, the (n, ce) sequence tables.  ``shift``
    defaults to blowup over the AIR's ce blowup (one LDE coset of the
    streamed pipeline: shift 1, blowup 1)."""
    from starkpack_winterfell_tpu_torch.ops.backend import get_backend

    field = air0.field_spec().name
    w, _, K, groups = cons_config(air0)
    if shift is None:
        shift = blowup // air0.ce_blowup_factor()
    n_ccs = sum(len(g) for g in groups)
    n_seq = sum(pl > 1 for g in groups for (_, _, pl) in g)
    rows = (random_limb(field, (n, w, ce * shift), rng, device),)
    # one period over the ce domain; over one LDE coset (blowup 1) a cb-th
    per_cb = air0.ce_blowup_factor() if blowup > 1 else 1
    pers = [random_limb(field, (len(c) * per_cb,), rng, device)
            for c in air0.get_periodic_column_values()]
    divs = [random_limb(field, (ce,), rng, device) for _ in range(1 + len(groups))]
    seqs = [random_limb(field, (n, ce), rng, device) for _ in range(n_seq)]
    scal = torch.stack(random_limb(field, (n, K + 2 * n_ccs - n_seq + 1), rng, device),
                       dim=-1).contiguous()
    return (get_backend(field), air0, groups, K, shift, blowup, rows, pers, divs, scal, seqs)


def hold_cons(args, where, want=None):
    """Kernel 5 on ``cons_args`` against its plain version (``want``, or
    computed here): raises RuntimeError naming ``where`` on any mismatching
    word.  Returns (largest absolute difference of a word, the plain
    version's output)."""
    from starkpack_winterfell_tpu_torch.ops import cons_kernel

    got = cons_kernel.constraint_eval(*args)[0]
    if want is None:
        want = cons_kernel.constraint_eval_plain(*args)[0]
    torch.cuda.synchronize()
    mism = sum(int((g != x).sum()) for g, x in zip(got, want))
    if mism:
        raise RuntimeError(f"the constraint kernel disagrees with its plain version in "
                           f"{mism} words at {where}")
    return max(float((g - x).abs().max()) for g, x in zip(got, want)), want


def time_cons(label, variants: bool, dev):
    """Kernel 5 (``ops/cons_kernel.py:constraint_eval``) at the shapes of
    the 1024- and 64-signature Lamport+ proves (n = 1, w = 14, ce = 2^23 and
    2^19, three sequence tables) and of the f128 Rescue128 2^18 x 6 prove
    (ce = 2^21), on random inputs from a fixed seed: each design held
    against ``constraint_eval_plain`` (``hold_cons``), then its device time
    (``device_kernel_ms``) and ptxas's report.  With ``variants`` the
    designs of ``CONS_VARIANTS`` are timed beside the rules at the largest
    Lamport+ shape and the Rescue128 one; their libraries are emitted first
    and built in parallel."""
    from starkpack_winterfell_tpu_torch import FieldExtension, ProofOptions, TraceInfo, native
    from starkpack_winterfell_tpu_torch.models import lamport128_agg as lagg
    from starkpack_winterfell_tpu_torch.models.rescue128_chain import (
        Rescue128ChainAir, Rescue128ChainInputs)
    from starkpack_winterfell_tpu_torch.ops import cons_kernel

    options = ProofOptions(28, 8, 16, FieldExtension.NONE, 4, 31)
    blowup = 8

    def lamport(sigs, rows):
        pub = lagg.LamportAggInputs([1] * sigs, [[1, 2]] * sigs)
        return lagg.Lamport128AggAir(TraceInfo(14, rows), pub, options)

    shapes = {  # name -> (AIR, rows, designs timed)
        "lamport-agg 1024 signatures": (lamport(1024, 1 << 20), 1 << 20, variants),
        "lamport-agg 64 signatures": (lamport(64, 1 << 16), 1 << 16, False),
        "rescue128 2^18 x 6": (Rescue128ChainAir(TraceInfo(6, 1 << 18), Rescue128ChainInputs(
            [1, 2], [3, 4]), options), 1 << 18, variants),
    }

    def designs(timed):
        return CONS_VARIANTS if timed else {"rules": {}}

    # emit every design's source, then build them all at once
    libs = {}
    for air0, _, timed in shapes.values():
        for rules in designs(timed).values():
            with cons_rules(cons_kernel, **rules):
                name, path = cons_kernel.kernel_source(air0, *cons_config(air0))
            libs[name] = path
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda item: native.build_cuda(item[0], [item[1]]), libs.items()))

    rng = np.random.default_rng(0)
    for shape, (air0, rows, timed) in shapes.items():
        w, n_per, K, groups = cons_config(air0)
        ce = rows * blowup // (blowup // air0.ce_blowup_factor())
        args = cons_args(air0, 1, ce, blowup, rng, dev)
        want = None
        for variant, rules in designs(timed).items():
            with cons_rules(cons_kernel, **rules):
                name, _ = cons_kernel.kernel_source(air0, w, n_per, K, groups)
                _, want = hold_cons(args, f"{shape} ({variant})", want)
                ms = device_kernel_ms(lambda: cons_kernel.constraint_eval(*args),
                                      "cons_eval_kernel", sessions=6)
                design = None
                if hasattr(cons_kernel, "design"):
                    ops, results = cons_kernel.record_transition(air0, w, n_per, K)
                    design = cons_kernel.design(ops, results)
            emit("cons", root=label, shape=shape, n=1, w=w, ce=ce,
                 sequence_tables=cons_kernel.seq_count(groups), variant=variant,
                 design=design, device_ms=ms, mismatching_words=0,
                 ptxas=ptxas_report(native.BUILD_LOGS, name))
        del args, want
        torch.cuda.empty_cache()


def time_ext(label, dev):
    """The eager extension-field steps of the 2^20 x 12 big-trace prove at
    its shapes (L = 2^23), each at degree 1 and at 3 (cubic) on random
    inputs: wall ms of a call (CUDA-synchronised), device ms and device
    kernels of a call (``profile_calls``), medians of 3 calls."""
    from starkpack_winterfell_tpu_torch import Blake3_256
    from starkpack_winterfell_tpu_torch.ops import gl64 as gl, ntt4, vec
    from starkpack_winterfell_tpu_torch.prover import device, device_big

    rng = np.random.default_rng(1)
    length, blowup, offset, width, nc_total, num_cols, K = 1 << 20, 8, 7, 12, 8, 7, 12
    L, chunk = length * blowup, 1 << 20
    b1, a1 = ntt4._pick_factors(length, L)[1::-1]
    a2, b2 = ntt4._pick_factors(L, L)[:2]

    def words(*shape):
        return gl.from_u64(rng.integers(0, gl.P, size=shape, dtype=np.uint64), dev)

    def elem(deg, *shape):
        return tuple(words(*shape) for _ in range(deg))

    lde = (words(1, width, L),)
    pc1 = words(1, width, b1, a1)
    evals = words(K, 1, chunk)
    divisor = words(chunk)
    for deg in (1, 3):
        z, zg = elem(deg, 1), elem(deg, 1)
        comp_lde = elem(deg, num_cols, L)
        pc_cols = elem(deg, num_cols, b2 // nc_total, a2)
        t_coeffs = elem(deg, 1, K)
        deep_args = (lde, comp_lde, z, zg, elem(deg, 1, width), elem(deg, 1, width),
                     elem(deg, num_cols), elem(deg, 1, width), elem(deg, num_cols),
                     offset, deg)
        layer = elem(deg, L)
        transposed = tuple(c.reshape(4, L // 4).T for c in layer)

        def combine():
            acc = vec.vzeros((1, chunk), deg, dev)
            for k in range(K):
                coef = tuple(c[:, k : k + 1] for c in t_coeffs)
                acc = vec.vadd(acc, vec.vmul(coef, (evals[k],)))
            return vec.vmul(acc, (divisor,))

        steps = {
            "P2+3 combine 12 transition results and divide, one 2^20 chunk of 8": combine,
            "P4 ood_kernel_big": lambda: device_big.ood_kernel_big(
                pc1, pc_cols, z, zg, z, length, length),
            "P5+6 deep_kernel_big": lambda: device_big.deep_kernel_big(*deep_args),
            "P5+6 vinv(x - z) over L": lambda: vec.vinv(vec.vsub((lde[0][0, 0],), z)),
            "P5+6 first FRI layer hash (L/4 rows of 4)": lambda: device.fri_hash_kernel(
                layer, 4, deg, Blake3_256),
            "P5+6 first FRI fold": lambda: device.fri_fold_kernel(
                transposed, z, offset, deg),
        }
        for name, fn in steps.items():
            per_call, walls = profile_calls(fn, 3)
            emit("ext", root=label, step=name, ext_deg=deg,
                 wall_ms=statistics.median(walls) * 1e3,
                 device_ms=statistics.median(sum(d for _, _, d in ev) for ev in per_call) / 1e3,
                 device_kernels=statistics.median(len(ev) for ev in per_call))
            torch.cuda.empty_cache()
        del comp_lde, pc_cols, deep_args, layer, transposed
        torch.cuda.empty_cache()


def time_limb_ext(label, dev):
    """The eager steps of the f128 Rescue128 2^18 x 6 prove (rescue128-chain,
    ce = L = 2^21) that change with the extension, at degree 1 and at
    quadratic on random inputs: the eager constraint phase
    (``full_pipeline.eager_constraint_phase``, the whole ce domain), the two
    OOD power series of length 2^18 (P4), one DEEP quotient
    (``syn_div_binomial`` of 6 rows of 2^18) and the first FRI fold (P5+6).
    Kernel 5 on the same degree-1 inputs is timed beside the eager phase;
    then P1's leaf hashing of the 256-path merkle128 prove's rows with
    BLAKE3-256 and SHA3-256 (wall ms of one call only).  Wall ms of a call (CUDA-synchronised), device ms and device kernels of a
    call (``profile_calls``), medians of 3 calls."""
    from starkpack_winterfell_tpu_torch import ProofOptions, TraceInfo
    from starkpack_winterfell_tpu_torch.fri.prover import limb_apply_drp, limb_drp_inv_offsets
    from starkpack_winterfell_tpu_torch.models.rescue128_chain import (
        Rescue128ChainAir, Rescue128ChainInputs)
    from starkpack_winterfell_tpu_torch.ops import cons_kernel
    from starkpack_winterfell_tpu_torch.ops.backend import get_backend
    from starkpack_winterfell_tpu_torch.parallel import full_pipeline
    from starkpack_winterfell_tpu_torch.prover.domain import StarkDomain

    rng = np.random.default_rng(2)
    B = get_backend("f128")
    length, width, n = 1 << 18, 6, 1
    air = Rescue128ChainAir(TraceInfo(width, length), Rescue128ChainInputs([1, 2], [3, 4]),
                            ProofOptions(28, 8, 16, 1, 4, 31))
    domain = StarkDomain(air)
    template = air.get_boundary_constraints(None, [0] * air.context.num_assertions())
    plan = full_pipeline._build_plan(air, template, domain, B, dev)
    K, ce, L = plan["K"], domain.ce_size, domain.lde_size
    n_ccs = sum(len(g) for g in plan["groups"])

    def elem(deg, *shape):
        return tuple(random_limb("f128", shape, rng, dev) for _ in range(deg))

    rows = elem(1, n, width, L)
    singles = [elem(1, n, 1) for _ in range(n_ccs)]
    for deg in (1, 2):
        t_main, fp = elem(deg, n, K), elem(deg, n)
        ccs = [elem(deg, n, 1) for _ in range(n_ccs)]
        x, z = elem(deg, 1), elem(deg, 1)
        p = elem(deg, width, length)
        layer = elem(deg, L)
        transposed = tuple(B.cmap(lambda l: l.reshape(4, L // 4).T.contiguous(), c)
                           for c in layer)
        inv_offs = limb_drp_inv_offsets(B, L // 4, 4, air.domain_offset(), dev)
        steps = {
            "P2 eager constraint phase": lambda: full_pipeline.eager_constraint_phase(
                B, air, domain.ce_to_lde_blowup, domain.trace_to_lde_blowup, plan, rows,
                t_main, singles, [], ccs, fp),
            "P4 two OOD power series of 2^18": lambda: [B.power_series_elem(v, length)
                                                        for v in (x, z)],
            "P5+6 syn_div_binomial of 6 x 2^18": lambda: B.syn_div_binomial(p, z),
            "P5+6 first FRI fold (2^19 rows of 4)": lambda: limb_apply_drp(
                B, transposed, x, inv_offs, deg),
        }
        if deg == 1:
            scal = cons_kernel.pack_scalar_bank(B, t_main, singles, ccs, fp, n, K)
            steps["P2 kernel 5"] = lambda: cons_kernel.constraint_eval(
                B, air, plan["groups"], K, domain.ce_to_lde_blowup,
                domain.trace_to_lde_blowup, rows, plan["periodic_tabs"],
                plan["div_tables"], scal)
        for name, fn in steps.items():
            per_call, walls = profile_calls(fn, 3)
            emit("limb_ext", root=label, step=name, ext_deg=deg, ce=ce,
                 wall_ms=statistics.median(walls) * 1e3,
                 device_ms=statistics.median(sum(d for _, _, d in ev) for ev in per_call) / 1e3,
                 device_kernels=statistics.median(len(ev) for ev in per_call))
            torch.cuda.empty_cache()
        if deg == 1:
            # the eager phase at degree 1 computes what kernel 5 does
            got = full_pipeline.eager_constraint_phase(
                B, air, domain.ce_to_lde_blowup, domain.trace_to_lde_blowup, plan, rows,
                t_main, singles, [], ccs, fp)
            hold_cons((B, air, plan["groups"], K, domain.ce_to_lde_blowup,
                       domain.trace_to_lde_blowup, rows, plan["periodic_tabs"],
                       plan["div_tables"], scal, []), "the eager phase's inputs", got[0])
            del got, scal
        del p, layer, transposed
        torch.cuda.empty_cache()

    # P1's leaves of the 256-path merkle128 prove: the LDE rows (2048 of them,
    # 256 instances x 7 columns of f128 each) hashed whole, with each hasher;
    # one call's wall alone (under the profiler a call takes minutes)
    from starkpack_winterfell_tpu_torch.crypto.hashers import get_hasher

    row_elems = 256 * 7
    words = B.rows_to_words(elem(1, 2048, row_elems), 1)
    for hname in ("blake3_256", "sha3_256"):
        hasher = get_hasher(hname)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hasher.hash_words(words, row_elems * B.ELEMENT_BYTES)
        torch.cuda.synchronize()
        emit("limb_ext", root=label, step=f"P1 leaves of 2048 rows of {row_elems} f128",
             hasher=hname, wall_ms=(time.perf_counter() - t0) * 1e3)


def time_sponge(label, dev):
    """The sponge kernel's share of a whole prove: one warm-up prove, then
    one under the profiler, for the 2^20 x 12 Rescue chain with Rp64_256,
    RpJive64_256 and GriffinJive64_256 (bench options; one trace for the
    three, the Jive hashers where the checkout has them) and fib-f62 2 x
    2^20 with Rp62_248 at cubic.  The search mode's launches (a template
    argument of 2 in the kernel's name) are counted apart from the hashes
    and merges; the proof-of-work search's wall
    (``ProverChannel._find_nonce``) is timed in the profiled prove."""
    from starkpack_winterfell_tpu_torch import FieldExtension, ProofOptions
    from starkpack_winterfell_tpu_torch.crypto.hashers import HASHERS
    from starkpack_winterfell_tpu_torch.crypto.rescue import Rp64_256
    from starkpack_winterfell_tpu_torch.crypto.rescue62 import Rp62_248
    from starkpack_winterfell_tpu_torch.models.fib_multifield import get_fib_family
    from starkpack_winterfell_tpu_torch.models.rescue_chain import (
        RescueChainProver, build_chain_trace)
    from starkpack_winterfell_tpu_torch.prover import channel

    _, fib_build, fib_prover, _ = get_fib_family("f62")
    chain = []

    def chain_trace():
        if not chain:
            chain.append(build_chain_trace([7] * 8, (1 << 20) // 8))
        return chain

    bench = ProofOptions(28, 8, 16, FieldExtension.NONE, 4, 31)
    configs = {"rp64_main 2^20 x 12": (RescueChainProver(bench, Rp64_256), chain_trace)}
    for path, name in (("rpjive_main", "rp_jive64_256"), ("griffin_main", "griffin_jive64_256")):
        if name in HASHERS:
            configs[f"{path} 2^20 x 12"] = (RescueChainProver(bench, HASHERS[name]), chain_trace)
    configs["rp62_main 2 x 2^20 cubic"] = (
        fib_prover(ProofOptions(28, 8, 16, FieldExtension.CUBIC, 4, 31), Rp62_248),
        lambda: [fib_build(1 << 20) for _ in range(2)])
    search = channel.ProverChannel._find_nonce
    found = {}

    def timed(self, grinding_factor):
        t0 = time.perf_counter()
        nonce = search(self, grinding_factor)
        found.update(nonce=nonce, seconds=time.perf_counter() - t0)
        return nonce

    channel.ProverChannel._find_nonce = timed
    try:
        for name, (prover, build) in configs.items():
            traces = build()
            per_call, walls = profile_calls(lambda: prover.prove(len(traces), traces), reps=1)
            if not per_call:
                raise ProfilerDroppedRecords(f"{name}: the prove was not recorded")
            events = per_call[-1]
            searches = [e for e in events if "rescue_sponge_kernel" in e[0] and ", 2>" in e[0]]
            hits, other = split_call([e for e in events if e not in searches],
                                     ("rescue_sponge_kernel",))
            emit("sponge", root=label, prove=name, hasher=prover.hasher.NAME, wall_s=walls[-1],
                 sponge_launches=len(hits),
                 sponge_device_ms=sum(hits) / 1e3, search_launches=len(searches),
                 search_device_ms=sum(d for _, _, d in searches) / 1e3,
                 nonce=found.get("nonce"), nonce_search_s=found.get("seconds"),
                 other_device_ms=other / 1e3,
                 other_device_kernels=len(events) - len(hits) - len(searches))
            del traces
            torch.cuda.empty_cache()
    finally:
        channel.ProverChannel._find_nonce = search


# S-box group sizes of the sponge kernel timed by ``--only sponge --variants``
SPONGE_GROUPS = (12, 6, 4, 3, 2)


def time_sponge_groups(label, dev):
    """The sponge kernel built with each S-box group size of SPONGE_GROUPS
    (ops/rescue_sponge.py SBOX_GROUP; the builds run together; a width-8
    layout takes the greatest common divisor): ptxas's registers and spills
    of each instantiation, then each (hasher, mode) at 2^16 + 37 rows
    (hashes of 12 elements, merges, a search) held against the plain
    version and its device ms."""
    from starkpack_winterfell_tpu_torch import native
    from starkpack_winterfell_tpu_torch.ops import rescue_sponge as rsp

    with concurrent.futures.ThreadPoolExecutor(len(SPONGE_GROUPS)) as pool:
        list(pool.map(rsp._lib, SPONGE_GROUPS))
    rng = np.random.default_rng(0)
    R = (1 << 16) + 37
    cases = {}
    for layout in rsp.LAYOUTS.values():
        vals = rng.integers(0, layout.P, size=(R, 12), dtype=np.uint64)
        words = torch.from_numpy(np.stack([vals & np.uint64(0xFFFFFFFF), vals >> np.uint64(32)],
                                          axis=-1).reshape(R, 24).astype(np.int64)).to(dev)
        cur = torch.from_numpy(rng.integers(0, 1 << 32, size=(2 * R, 8)).astype(np.int64)).to(dev)
        seed = [int(v) for v in rng.integers(0, layout.P, size=4, dtype=np.uint64)]
        cases[(layout.name, "hash 12")] = (
            lambda l=layout, w=words: rsp.rescue_sponge(l, w, 12),
            lambda l=layout, w=words: rsp.rescue_sponge_plain(l, w, 12))
        cases[(layout.name, "merge")] = (
            lambda l=layout, c=cur: rsp.rescue_sponge(l, c[0::2], y=c[1::2]),
            lambda l=layout, c=cur: rsp.rescue_sponge_plain(l, c[0::2], y=c[1::2]))
        cases[(layout.name, "search")] = (
            lambda l=layout, sd=seed: rsp.first_merge_with_int(l, sd, 1, R, 16, dev, True)[1],
            lambda l=layout, sd=seed: rsp.first_merge_with_int_plain(l, sd, 1, R, 16, dev)[1])
    old = rsp.SBOX_GROUP
    try:
        for group in SPONGE_GROUPS:
            rsp.SBOX_GROUP = group
            lib = rsp.kernel_source(group)[0]
            report = ptxas_report(native.BUILD_LOGS, lib)
            for (name, mode), (fn, plain) in cases.items():
                mism = int((fn() != plain()).sum())
                if mism:
                    raise RuntimeError(f"group {group}: {name} {mode} disagrees with the plain "
                                       f"version in {mism} words")
                emit("sponge_group", root=label, group=group, hasher=name, mode=mode, rows=R,
                     device_ms=device_kernel_ms(fn, "rescue_sponge_kernel"),
                     mismatching_words=0)
            emit("sponge_group_ptxas", root=label, group=group, ptxas=report)
    finally:
        rsp.SBOX_GROUP = old


# kernels 3 and 4 by the names nvcc gives them, before their redesign and
# after it (the Goldilocks and the limb instantiations of csrc/dit_tile.cuh)
KERNEL3 = ("ntt_dit_axis1_kernel", "dit_tile_kernel<GL64")
KERNEL4 = ("limb_ntt_tile_kernel", "dit_tile_kernel<F")


def main_proves():
    """{name: function building (prover, traces)} of the proves whose kernel 3
    and 4 time ``time_prove_kernels`` reads, chip_smoke.py's: 1024 Lamport+
    signatures in one 2^20 x 14 f128 trace (BLAKE3-192, bench options;
    lamport_agg_main), the Rescue128 chain of 2^18 x 6 f128 at degree 1 and
    at quadratic (limb_main, limb_ext_main), fib over f62 2 x 2^20 at cubic
    with Rp62_248 (rp62_main) and perm 4 x 2^20 at quadratic (BLAKE3-256;
    aux_main); each built when its turn comes."""
    from starkpack_winterfell_tpu_torch import Blake3_192, Blake3_256, FieldExtension, ProofOptions
    from starkpack_winterfell_tpu_torch.crypto.rescue62 import Rp62_248
    from starkpack_winterfell_tpu_torch.models import lamport128_agg as lagg
    from starkpack_winterfell_tpu_torch.models.fib_multifield import get_fib_family
    from starkpack_winterfell_tpu_torch.models.permutation import PermProver, build_perm_trace
    from starkpack_winterfell_tpu_torch.models.rescue128_chain import (
        Rescue128ChainProver, build_rescue128_chain_trace)

    def options(ext):
        return ProofOptions(28, 8, 16, ext, 4, 31)

    def lamport():
        messages, _, sigs = lagg.make_wallet(1024, 127, seed=1)
        prover = lagg.Lamport128AggProver(options(FieldExtension.NONE), Blake3_192)
        return prover, [lagg.build_lamport128_agg_trace(messages, sigs, 127)]

    def chain(ext):
        return (Rescue128ChainProver(options(ext), Blake3_256),
                [build_rescue128_chain_trace([7, 9], (1 << 18) // 8)])

    def rp62():
        _, fib_build, fib_prover, _ = get_fib_family("f62")
        return (fib_prover(options(FieldExtension.CUBIC), Rp62_248),
                [fib_build(1 << 20) for _ in range(2)])

    def perm():
        prover = PermProver(options(FieldExtension.QUADRATIC), Blake3_256)
        return prover, [build_perm_trace(s, 1 << 20) for s in (3, 5, 7, 11)]

    return {"lamport 1024 (2^20 x 14 f128)": lamport,
            "f128 chain 2^18 x 6": lambda: chain(FieldExtension.NONE),
            "f128 chain 2^18 x 6 quadratic": lambda: chain(FieldExtension.QUADRATIC),
            "rp62_main fib-f62 2 x 2^20 cubic": rp62,
            "perm 4 x 2^20 quadratic": perm}


def time_prove_kernels(label, dev):
    """Kernels 3 and 4 in whole proves (``main_proves``): one warm-up prove,
    one timed (its wall, phase walls and peak device memory over the bytes
    of its main LDE, less what was resident before), then one under the
    profiler: the summed device ms and launches of each kernel, the device
    ms and kernel count of everything else.  A prove records several
    hundred thousand kernels, so the profiler's dropped records (see
    ``profile_calls``) can shave the counts a little; the launch counts
    say whether each kernel's were whole."""
    from starkpack_winterfell_tpu_torch.parallel import full_pipeline

    for name, build in main_proves().items():
        full_pipeline._TABLE_CACHE.clear()
        torch.cuda.empty_cache()
        prover, traces = build()
        timed_prove(prover, traces)  # warm: builds, cached tables
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        _, seconds, phases = timed_prove(prover, traces)
        peak = torch.cuda.max_memory_allocated() - resident
        lde_bytes = (len(traces) * traces[0].width * traces[0].length * 8
                     * traces[0].spec.ELEMENT_BYTES)
        # the limb path's memory check reads the card's free memory: hand the
        # cached blocks back before each prove
        torch.cuda.empty_cache()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prover.prove(len(traces), traces)
            torch.cuda.synchronize()
            profiled_s = time.perf_counter() - t0
        events = _device_events(prof)
        if not events:
            raise ProfilerDroppedRecords(f"{name}: the prove was not recorded")
        k3, _ = split_call(events, KERNEL3)
        k4, _ = split_call(events, KERNEL4)
        _, other = split_call(events, KERNEL3 + KERNEL4)
        emit("prove_kernels", root=label, prove=name, steady_prove_s=seconds,
             phases_ms=dict(phases), peak_over_main_lde=peak / lde_bytes,
             profiled_wall_s=profiled_s,
             kernel3_launches=len(k3), kernel3_device_ms=sum(k3) / 1e3,
             kernel4_launches=len(k4), kernel4_device_ms=sum(k4) / 1e3,
             other_device_ms=other / 1e3, other_device_kernels=len(events) - len(k3) - len(k4))
        del prover, traces
        torch.cuda.empty_cache()


def time_folded_entries(label, dev, lg_shifts=(0,)):
    """One call of each of the entry points whose eager passes the kernels
    took in, at the shapes of the main proves: the f128 coset LDE of
    the Lamport 1024 trace (14 columns of 2^20 coefficients, blowup 8), the
    same over f62 (4 columns, rp62_main's), and the f64 four-step transforms
    of perm's 2^23-point composition and of 2^20 points (8 rows each: the
    two sizes of the perm prove).  Device ms of kernels 3 and
    4 (each launch's too), launches, the device ms and count of every other
    kernel in the call, and the wall.  ``lg_shifts``: also with the lanes a
    block stages (``limb_ntt.block_shape``) scaled by 2^shift at every
    launch, where the block still fits."""
    from starkpack_winterfell_tpu_torch.ops import gl64 as gl, limb_ntt, ntt_kernel
    from starkpack_winterfell_tpu_torch.ops.backend import get_backend

    rng = np.random.default_rng(5)
    units = {}
    for field, cols in (("f128", 14), ("f62", 4)):
        F = get_backend(field).F
        coeffs = random_limb(field, (cols, 1 << 20), rng, dev)
        units[f"{field} evaluate_poly_with_offset {cols} x 2^20 -> x8"] = (
            lambda F=F, c=coeffs: F.evaluate_poly_with_offset(c, 7, 8), KERNEL4)
    x = gl.from_u64(rng.integers(0, gl.P, size=(8, 1 << 23), dtype=np.uint64), dev)
    units["f64 four_step_ntt 8 x 2^23 inverse"] = (
        lambda: ntt_kernel.four_step_ntt((x,), True), KERNEL3)
    units["f64 four_step_ntt 8 x 2^20 inverse"] = (
        lambda: ntt_kernel.four_step_ntt((x[:, : 1 << 20],), True), KERNEL3)
    rule = getattr(limb_ntt, "block_shape", None)
    for shift in lg_shifts:
        if shift:
            def shifted(el_bytes, n, B, lanes, contiguous, *target, shift=shift):
                log_lg, k, threads = rule(el_bytes, n, B, lanes, contiguous, *target)
                lg = 1 << max(0, log_lg + shift)
                if el_bytes * (n // 2 + n * lg) > limb_ntt.SMEM_PER_BLOCK:
                    return log_lg, k, threads
                tasks = (n >> min(k, n.bit_length() - 1)) * lg
                return lg.bit_length() - 1, k, min(limb_ntt.MAX_THREADS, max(32, tasks))
            limb_ntt.block_shape = ntt_kernel.block_shape = shifted
        try:
            for name, (fn, match) in units.items():
                per_call, walls = profile_calls(fn)
                split = [split_call(ev, match) for ev in per_call]
                whole = [h for h, _ in split if len(h) == len(split[0][0])]
                emit("entry_kernels", root=label, step=name, lg_shift=shift,
                     kernel_launches=statistics.median(len(h) for h, _ in split),
                     kernel_ms=statistics.median(sum(h) for h, _ in split) / 1e3,
                     per_launch_ms=[statistics.median(h[i] for h in whole) / 1e3
                                    for i in range(len(split[0][0]))],
                     other_device_ms=statistics.median(o for _, o in split) / 1e3,
                     other_device_kernels=statistics.median(
                         len(ev) - len(h) for ev, (h, _) in zip(per_call, split)),
                     wall_ms=statistics.median(walls) * 1e3)
        finally:
            if shift:
                limb_ntt.block_shape = ntt_kernel.block_shape = rule
    del units, x
    torch.cuda.empty_cache()


SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);")


def sass_functions(so: str) -> dict:
    """{function name: [(address, opcode, operands), ...]} of a built library
    (cuobjdump -sass)."""
    from starkpack_winterfell_tpu_torch import native

    cuobjdump = os.path.join(os.path.dirname(native.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    funcs, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = funcs.setdefault(m.group(1), [])
            continue
        m = SASS_LINE.match(line)
        if m and current is not None:
            current.append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def pipe_of(op: str) -> str:
    """The pipe gl64_sass_count.py assigns an opcode to, or its class."""
    if re.match(r"^(IMAD\.MOV|UMOV|MOV)\b", op):
        return "move"
    if op.startswith("IMAD"):
        return "imad"
    if re.match(r"^(IADD3|ISETP|SEL|LOP3|SHF|LEA|IMNMX)\b", op):
        return "alu"
    if re.match(r"^(LDS|STS|LDG|STG|LD|ST)\b", op):
        return "memory"
    return "other"


def time_tile_sass(label):
    """What the SASS of kernels 3 and 4 spends beside the field arithmetic:
    each dit_tile_kernel instantiation's instructions by pipe (static
    counts of the whole function), the IMAD / ALU ratio against that of the
    field's butterfly (csrc/gl64_sass_count.py), and the instructions of
    its hottest loop (the longest one, a radix pass over its tasks)."""
    from starkpack_winterfell_tpu_torch import native
    from starkpack_winterfell_tpu_torch.ops import limb_ntt, ntt_kernel

    limb_ntt._lib()
    ntt_kernel._lib()
    for lib in ("starknttdit", "starklimbntt"):
        for name, body in sass_functions(os.path.join(native.BUILD_DIR, f"lib{lib}.so")).items():
            if "dit_tile_kernel" not in name:
                continue
            loops = [(src, dst) for src, (addr, op, operands) in enumerate(body)
                     if op == "BRA" and (m := re.search(r"0x([0-9a-f]+)", operands))
                     and int(m.group(1), 16) < addr
                     for dst in [next(i for i, b in enumerate(body)
                                      if b[0] == int(m.group(1), 16))]]
            src, dst = max(loops, key=lambda l: l[0] - l[1]) if loops else (0, 0)
            emit("tile_sass", root=label, kernel=name,
                 whole=dict(collections.Counter(pipe_of(op) for _, op, _ in body)),
                 longest_loop=dict(collections.Counter(pipe_of(op) for _, op, _ in
                                                       body[dst:src + 1])))


# the IMAD microbenchmark (``time_imad``): CHAINS independent multiply-add
# chains a thread, one IMAD.WIDE.U32 (64-bit result) or one IMAD (32-bit)
# a step
IMAD_PROBE = r"""
#include <cstdint>
#include <cuda_runtime.h>

constexpr int CHAINS = 16;

// acc[k] = lo(acc[k ^ 1]) * m: one IMAD.WIDE.U32 (32 x 32 -> 64 bits) a
// step, in inline PTX, each product's operand another chain's last value
// so that no product can be hoisted out of the loop (with an addend, ptxas
// splits the 64-bit add off into IADD3s)
extern "C" __global__ void probe_imad_wide(const uint64_t* in, uint64_t* out, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t m = (uint32_t)in[0] | 1u;
  uint64_t acc[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) acc[k] = in[2 + k] + t;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      asm volatile("mul.wide.u32 %0, %1, %2;" : "=l"(acc[k]) : "r"((uint32_t)acc[k ^ 1]),
                   "r"(m));
  }
  uint64_t s = 0;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s ^= acc[k];
  out[t] = s;
}

// the same with one IMAD (32 x 32 -> 32 bits) a step
extern "C" __global__ void probe_imad(const uint64_t* in, uint64_t* out, int iters) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t m = (uint32_t)in[0] | 1u;
  uint32_t acc[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) acc[k] = (uint32_t)in[2 + k] + t;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      asm volatile("mul.lo.u32 %0, %1, %2;" : "=r"(acc[k]) : "r"(acc[k ^ 1]), "r"(m));
  }
  uint32_t s = 0;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s ^= acc[k];
  out[t] = s;
}

extern "C" int imad_probe_launch(int wide, const void* in, void* out, int blocks,
                                 int threads, int iters, void* stream) {
  if (wide)
    probe_imad_wide<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, iters);
  else
    probe_imad<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint64_t*)in, (uint64_t*)out, iters);
  return (int)cudaGetLastError();
}
"""


def time_imad(label, dev):
    """Does an IMAD.WIDE take one issue slot of the IMAD pipe or two?
    Builds IMAD_PROBE (16 multiply chains a thread, in inline PTX), reads
    in its SASS the instructions of each kernel's loop (cuobjdump) and
    times each kernel over a grid that fills the card (CUDA events, median
    of 5).  The plain kernel's loop is IMADs alone and runs the IMAD pipe at
    its full rate, 64 lanes a clock an SM; the wide kernel's loop mixes
    IMAD.WIDEs with IMADs (ptxas keeps 64 bits only where they are read).
    If the wide loop is IMAD-pipe bound too, the slots an IMAD.WIDE takes
    solve rate x (IMADs + slots x IMAD.WIDEs) = the plain loop's slot rate;
    the shares of 132 SMs x 64 lanes x 1.98 GHz at one slot and at two are
    given beside it, with the SM clock nvidia-smi reads."""
    import ctypes

    from starkpack_winterfell_tpu_torch import native

    os.makedirs(native.BUILD_DIR, exist_ok=True)
    src = os.path.join(native.BUILD_DIR, "imad_probe.cu")
    with open(src, "w") as f:
        f.write(IMAD_PROBE)
    lib = native.build_cuda("imadprobe", [src])
    fn = lib.imad_probe_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    funcs = sass_functions(os.path.join(native.BUILD_DIR, "libimadprobe.so"))
    chains, iters, threads = 16, 1 << 14, 256
    blocks = 132 * 8
    peak = 132 * 64 * 1.98e9
    buf = torch.arange(2 + chains, dtype=torch.int64, device=dev) * 0x9E3779B97F4A7C15
    out = torch.empty(blocks * threads, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    found = {}
    for wide, name in ((0, "probe_imad"), (1, "probe_imad_wide")):
        body = funcs[name]
        loops = [(i, next(k for k, b in enumerate(body) if b[0] == int(m.group(1), 16)))
                 for i, (addr, op, operands) in enumerate(body)
                 if op == "BRA" and (m := re.search(r"0x([0-9a-f]+)", operands))
                 and int(m.group(1), 16) < addr]
        src_i, dst_i = max(loops, key=lambda l: l[0] - l[1])
        loop = collections.Counter(op for _, op, _ in body[dst_i:src_i + 1])
        n_wide = sum(c for op, c in loop.items() if op.startswith("IMAD.WIDE"))
        n_imad = loop.get("IMAD", 0)
        # one multiply a step: a pass of the loop runs (IMADs + IMAD.WIDEs) / chains
        # iterations of the source loop
        unroll = (n_imad + n_wide) // chains

        def run():
            rc = fn(wide, buf.data_ptr(), out.data_ptr(), blocks, threads, iters, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: cudaError {rc}")

        times = []
        run()
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60).stdout.strip()
        loops_per_s = blocks * threads * (iters // unroll) / (ms * 1e-3)
        found[name] = (loops_per_s, n_imad, n_wide)
        emit("imad", root=label, kernel=name, loop_opcodes=dict(loop),
             loop_head=[f"{op}{operands}" for _, op, operands in body[dst_i:dst_i + 6]],
             ms=ms, share_at_one_slot=loops_per_s * (n_imad + n_wide) / peak,
             share_at_two_slots=loops_per_s * (n_imad + 2 * n_wide) / peak,
             sm_clock_after=clock)
    plain_rate = found["probe_imad"][0] * found["probe_imad"][1]
    loops_per_s, n_imad, n_wide = found["probe_imad_wide"]
    emit("imad_slots", root=label,
         slots_of_an_imad_wide=(plain_rate / loops_per_s - n_imad) / n_wide if n_wide else None)


def emit(kind, **fields):
    print(json.dumps({"kind": kind, **fields}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                   help="directory holding the starkpack_winterfell_tpu_torch to time")
    p.add_argument("--prove", action="store_true", help="also time a 2^20 x 12 prove")
    p.add_argument("--only", choices=("ntt", "k34", "cons", "ext", "limb_ext", "sponge"),
                   help="time only the NTT kernels, only kernels 3 and 4 (their entries, "
                        "the SASS and IMAD probes, whole proves), only kernel 5, only the "
                        "eager extension-field steps (f64, or f128), or only the Rescue "
                        "sponge's share of the algebraic hashers' main proves")
    p.add_argument("--variants", action="store_true",
                   help="also time kernel 5 with the emitter's rules varied, or with --only "
                        "sponge the sponge kernel at each S-box group size (this checkout)")
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
    if args.only == "ext":
        time_ext(label, dev)
        return 0
    if args.only == "limb_ext":
        time_limb_ext(label, dev)
        return 0
    if args.only == "sponge":
        if args.variants and root == here:
            time_sponge_groups(label, dev)
        time_sponge(label, dev)
        return 0
    if args.only in ("ntt", "k34"):
        # kernels 3 and 4 first: the entries whose eager passes they took in,
        # the probes (this checkout), then whole proves while the card's
        # memory is free
        time_folded_entries(label, dev, (0, -1, 1) if args.variants and root == here else (0,))
        if root == here:
            time_tile_sass(label)
            time_imad(label, dev)
        time_prove_kernels(label, dev)
        if args.only == "k34":
            return 0
    if args.only != "ntt":
        time_cons(label, args.variants and root == here, dev)
    if args.only == "cons":
        return 0
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

    # host time of one wrapper call (small shapes: the launch, not the work);
    # kernel 3 through its wrapper of either checkout, kernel 4 through the
    # entry both checkouts have, ntt_last_axis on (128, 64) planes
    x3, tw64 = words((2, 64, 64)), ntt4.tile_twiddles(64, False, dev)
    F = get_backend("f128").F
    lx = (words((128, 64)), words((128, 64)))
    dit3 = getattr(ntt_kernel, "dit_tile", None) or ntt_kernel.dit_axis1
    emit("host", root=label, us_per_call={
        "ntt_tile": host_us(lambda: ntt4.ntt_tile(x3, tw64, False)),
        "kernel 3": host_us(lambda: dit3(x3, tw64)),
        "kernel 4 (ntt_last_axis)": host_us(lambda: limb_ntt.ntt_last_axis(F, lx, False)),
        "ntt_components n=64": host_us(lambda: ntt.ntt_components((x3[0],))),
    })
    del x3, lx
    torch.cuda.empty_cache()

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
