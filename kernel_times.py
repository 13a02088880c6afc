#!/usr/bin/env python3
"""Device-only times of the port's Goldilocks NTT kernels and of its
constraint kernel on one NVIDIA GPU, for one checkout of the port: this one,
or another commit unpacked beside it.

    python3 kernel_times.py [--root DIR] [--prove] [--only ntt|cons|ext|limb_ext] [--variants]

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

``--only`` times the NTT kernels alone (``ntt``), kernel 5 alone (``cons``)
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


def cons_args(air0, n: int, ce: int, blowup: int, rng, device):
    """Arguments of ``constraint_eval`` / ``constraint_eval_plain`` for an
    AIR at n instances and ce points, on random elements: LDE rows (n, w,
    ce * shift), one period of each periodic column at its own period, the
    divisor tables, the scalar bank, the (n, ce) sequence tables."""
    from starkpack_winterfell_tpu_torch.ops.backend import get_backend

    field = air0.field_spec().name
    w, _, K, groups = cons_config(air0)
    shift = blowup // air0.ce_blowup_factor()
    n_ccs = sum(len(g) for g in groups)
    n_seq = sum(pl > 1 for g in groups for (_, _, pl) in g)
    rows = (random_limb(field, (n, w, ce * shift), rng, device),)
    pers = [random_limb(field, (len(c) * air0.ce_blowup_factor(),), rng, device)
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
                B, air, domain, plan, rows, t_main, singles, [], ccs, fp),
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
            got = full_pipeline.eager_constraint_phase(B, air, domain, plan, rows, t_main,
                                                       singles, [], ccs, fp)
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


def emit(kind, **fields):
    print(json.dumps({"kind": kind, **fields}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                   help="directory holding the starkpack_winterfell_tpu_torch to time")
    p.add_argument("--prove", action="store_true", help="also time a 2^20 x 12 prove")
    p.add_argument("--only", choices=("ntt", "cons", "ext", "limb_ext"),
                   help="time only the NTT kernels, only kernel 5, or only the eager "
                        "extension-field steps (f64, or f128)")
    p.add_argument("--variants", action="store_true",
                   help="also time kernel 5 with the emitter's rules varied (this checkout)")
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
