"""One run of one cell: set-up, the measured window, the traced prove, the
judgment of every proof by the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, metric or kernel
lives in a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json`` (named by the entry's ``file``),
``workloads/<traffic>.json``, ``statements/<statement>.py`` (named by the
configuration), ``metrics/<metric>.py`` and ``kernels/<kernel>.py``."""

from __future__ import annotations

import gc
import hashlib
import importlib
import json
import logging
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np

PROGRAM = "starkpack_winterfell_tpu_torch"
PHASE_LOGGER = PROGRAM + ".prover.device"
# the program's pipeline functions, by the route a prove through each takes
ROUTES = {"prove_big": "prove_big", "_generate_proof_device": "small_trace",
          "prove_mesh": "prove_mesh"}
# modules whose presence in the process refuses the run (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "starkpack_winterfell_tpu")
TOP_OPS, TOP_GAPS = 10, 10


class RunError(RuntimeError):
    """The run cannot give a result."""


@dataclass
class Step:
    statement: int
    prove_s: float
    verify_s: float
    phases: list  # (phase name, ms) as the program recorded them
    route: str
    proof: bytes = b""
    error: str = ""


@dataclass
class Run:
    """What the metric readers read."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float = 0.0
    build_s: float = 0.0
    window_s: float = 0.0
    steps: list = field(default_factory=list)
    peak_bytes: int = 0
    profile: dict = None  # the traced prove: DeviceTrace, launches, t0, t1, phase marks

    @property
    def done(self):
        return [s for s in self.steps if not s.error]


class PhaseRecords(logging.Handler):
    """The program's DEBUG phase records: (route, args, time.time_ns()), the
    route the pipeline function on the call stack that made the record."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        frame, route = sys._getframe(), "unknown"
        while frame is not None:
            if frame.f_code.co_name in ROUTES and frame.f_globals.get("__name__", "").startswith(
                    PROGRAM + "."):
                route = ROUTES[frame.f_code.co_name]
                break
            frame = frame.f_back
        self.records.append((route, record.args, time.time_ns()))

    def take(self):
        out, self.records = self.records, []
        return out


def phases_and_route(records):
    """[(phase, ms, end ns)] and the route of one prove's records."""
    phases, route, path = [], "unknown", None
    for where, args, t in records:
        if len(args) == 2 and isinstance(args[1], (int, float)):
            if not phases:
                route = where
            phases.append((str(args[0]), float(args[1]), t))
        elif len(args) == 1 and args[0] in ("streamed", "one-shot"):
            path = args[0]
    if route == "prove_mesh" and path:
        route = f"prove_mesh {path}"
    return phases, route


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise RunError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(name: str):
    return importlib.import_module(f"{__package__}.metrics.{name}").read


def cell_files(root: str, spec: dict, cell_name: str):
    cell = find(spec["workloads"], cell_name, "workload")
    config_entry = find(spec["configs"], cell["config"], "configuration")
    with open(os.path.join(root, config_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, spec["paths"][0], "workloads", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, config, traffic


def _sync(device):
    if device == "cuda":
        import torch

        torch.cuda.synchronize()


def _step(pool, index: int, device: str, log: PhaseRecords, verify) -> Step:
    """One proof of the pool's statement ``index`` and one verify of it by
    the program, the proof's bytes on the host in between."""
    stmt = pool.statements[index]
    log.take()
    t0 = time.perf_counter()
    try:
        proof = pool.prover.prove(len(stmt.traces), stmt.traces, device=device)
        data = proof.to_bytes()
        t1 = time.perf_counter()
        accepted = verify(pool.air_class, proof.from_bytes(data), stmt.pub_inputs,
                          pool.prover.hasher)
        t2 = time.perf_counter()
        error = "" if accepted else "the program's verify rejected the proof"
    except Exception as e:  # a failed step is counted and the loop goes on
        t1 = t2 = time.perf_counter()
        data, error = b"", f"{type(e).__name__}: {e}"
    phases, route = phases_and_route(log.take())
    return Step(index, t1 - t0, t2 - t1, [(p, ms) for p, ms, _ in phases], route, data, error)


def run_cell(root: str, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None, spec: dict = None) -> dict:
    """One run of a cell; returns the result line's object.  ``t_start``:
    the process's start on ``time.perf_counter`` (set-up is counted from
    it); ``spec``: BENCHMARK.json's object, where not the one at ``root``."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(root) if spec is None else spec
    cell, config, traffic = cell_files(root, spec, cell_name)
    run = Run(cell, config, traffic)

    from starkpack_winterfell_tpu_torch import verify

    log = PhaseRecords()
    logger = logging.getLogger(PHASE_LOGGER)
    logger.setLevel(logging.DEBUG)
    logger.addHandler(log)
    try:
        statements = importlib.import_module(f"{__package__}.statements.{config['statement']}")
        rng = np.random.default_rng(seed % (1 << 64))
        pool = statements.build(traffic["statement_params"], config, rng, traffic["pool"])
        run.build_s = pool.build_s
        # warm-up: kernel builds and loads, the program's cached tables, the
        # verifier's C tier; every statement of a pool has the same shapes
        warm = _step(pool, 0, device, log, verify)
        if warm.error:
            raise RunError(f"the warm-up prove failed: {warm.error}")
        print(f"set-up: statements built in {pool.build_s:.3f} s, warm prove "
              f"{warm.prove_s:.3f} s, verify {warm.verify_s:.3f} s", file=sys.stderr)
        _sync(device)
        gc.collect()  # set-up's garbage is not the window's
        if device == "cuda":
            import torch

            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run.setup_s = t0 - t_start
        index = 1
        while True:
            run.steps.append(_step(pool, index % len(pool.statements), device, log, verify))
            index += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(device)
        run.window_s = time.perf_counter() - t0
        if device == "cuda":
            import torch

            run.peak_bytes = torch.cuda.max_memory_allocated()
        judged = [(s.statement, s.proof) for s in run.done]
        if trace:
            judged.append(_traced_prove(run, pool, index % len(pool.statements), device, log))
    finally:
        logger.removeHandler(log)
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = _judge(config, pool, judged, run)
    print(f"reference: {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    metrics = _metrics(spec, run, trace)
    return _result(run, metrics, checks, trace, device)


def _traced_prove(run: Run, pool, index: int, device: str, log: PhaseRecords):
    """One more steady prove, outside the window, under the profiler."""
    from .profiling import profile_prove

    stmt = pool.statements[index]
    log.take()
    proof, dtrace, launches, t0, t1 = profile_prove(
        lambda: pool.prover.prove(len(stmt.traces), stmt.traces, device=device))
    phases, route = phases_and_route(log.take())
    ops = dtrace.ops
    if ops:
        print(f"traced prove: {len(ops)} device operations, the first {ops[0][1] - t0} ns after "
              f"its start, the last ending {t1 - ops[-1][2]} ns before its end", file=sys.stderr)
    print("traced prove's hand-kernel launches: " + json.dumps(
        {c: [[list(k), n] for k, n in keys.items()] for c, keys in launches.items()}),
        file=sys.stderr)
    run.profile = {"trace": dtrace, "launches": launches, "t0": t0, "t1": t1,
                   "phases": phases, "route": route}
    return index, proof.to_bytes()


def _judge(config: dict, pool, judged, run: Run) -> dict:
    """The numbers compared, each with its limit: the proofs the plain
    reference rejects (each distinct proof once), the steps that never gave
    an accepted proof, and the statement module's own checks."""
    reference = importlib.import_module(f"{__package__}.reference.{config['reference']}")

    rejected, seen = 0, set()
    for index, data in judged:
        key = (index, hashlib.sha256(data).hexdigest())
        if key in seen:
            continue
        seen.add(key)
        try:
            reference.verify(config, pool.statements[index].reference, data)
        except Exception as e:  # a proof the reference cannot read is not a proof
            rejected += 1
            print(f"reference rejects the proof of statement {index}: {type(e).__name__}: {e}",
                  file=sys.stderr)
    for s in run.steps:
        if s.error:
            print(f"step on statement {s.statement} failed: {s.error}", file=sys.stderr)
    checks = {"rejected_proofs": {"value": rejected, "limit": 0},
              "failed_steps": {"value": len(run.steps) - len(run.done), "limit": 0}}
    for name, (fn, limit) in pool.checks.items():
        checks[name] = {"value": fn(), "limit": limit}
    return checks


def _correct(run: Run, checks: dict) -> bool:
    """Every count of wrong answers at or under its limit, over a window
    that proved something."""
    return bool(run.done) and all(c["value"] <= c["limit"] for c in checks.values())


def _metrics(spec: dict, run: Run, trace: bool) -> dict:
    name = run.cell["name"]
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    out = {}
    for m in entries:
        if not applies(m, name):
            continue
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _breakdown(run: Run) -> dict:
    p = run.profile
    ops = sorted(p["trace"].by_name().items(), key=lambda kv: -kv[1][1])[:TOP_OPS]
    marks = p["phases"]

    def phase_at(t):
        for name, _, end in marks:
            if t < end:
                return name
        return "after the last phase"

    gaps = sorted(p["trace"].gaps(p["t0"], p["t1"]), key=lambda g: -g[1])[:TOP_GAPS]
    return {"device_ops": [[name[:160], ns / 1e9] for name, (_, ns) in ops],
            "idle_gaps": [[phase_at(start), ns / 1e9] for start, ns in gaps]}


def _result(run: Run, metrics: dict, checks: dict, trace: bool, device: str) -> dict:
    if device == "cuda":
        import torch

        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": run.cell["chips"], "memory_peak_bytes": run.peak_bytes}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    out = {"correct": _correct(run, checks), "attempted": len(run.steps),
           "failed": len(run.steps) - len(run.done), "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        p = run.profile
        dev["busy_s"] = p["trace"].busy_ns() / 1e9
        dev["window_s"] = (p["t1"] - p["t0"]) / 1e9
        out["breakdown"] = _breakdown(run)
    out["steps"] = [{"statement": s.statement, "prove_s": s.prove_s, "verify_s": s.verify_s,
                     "route": s.route, "phases_ms": dict(s.phases), "error": s.error}
                    for s in run.steps]
    out["checks"] = checks
    return out


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
