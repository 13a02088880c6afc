#!/usr/bin/env python3
"""Device-side profile of one steady prove of the PyTorch/CUDA port.

    python3 profile_prove.py [--config do-work|rescue-small|rescue-big|rp64-main|rpjive-main|
                                        griffin-main|rp62-main]
                             [--seed N]

Proves once to warm up (kernel builds, cached tables), then proves again
under ``torch.profiler`` with only the CUDA activity recorded, and prints
one JSON line: the prove's wall seconds under the profiler and without it,
the number of device kernels it launched, their summed device time, the
device's idle share (1 - device time / wall, against the profiled wall and
against the wall without the profiler), the device time and launch count of
each of the port's own kernels by name, and the kernels that take the most
device time.  The proof of the profiled run is verified.

Configs (BLAKE3-256, ProofOptions(28, 8, 16, NONE, 4, 31)): ``do-work`` 32 x
1024 rows and ``rescue-small`` 64 x 2^13 rows (small-trace path),
``rescue-big`` 1 x 2^16 rows (big-trace path).  The algebraic hashers'
main paths of chip_smoke.py: ``rp64-main``, ``rpjive-main`` and
``griffin-main`` the 2^20 x 12 Rescue chain with Rp64_256, RpJive64_256 and
GriffinJive64_256 (same options, big-trace path), ``rp62-main`` fib over f62, 2 x
2^20 rows with Rp62_248 at ProofOptions(28, 8, 16, CUBIC, 4, 31) (mesh
path).

Needs a CUDA device (exits non-zero without one) and no network.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from starkpack_winterfell_tpu_torch import Blake3_256, FieldExtension, ProofOptions, verify
from starkpack_winterfell_tpu_torch.crypto.griffin import GriffinJive64_256
from starkpack_winterfell_tpu_torch.crypto.rescue import Rp64_256
from starkpack_winterfell_tpu_torch.crypto.rescue_jive import RpJive64_256
from starkpack_winterfell_tpu_torch.crypto.rescue62 import Rp62_248
from starkpack_winterfell_tpu_torch.models.fib_multifield import get_fib_family
from starkpack_winterfell_tpu_torch.models.do_work import (
    DoWorkAir,
    DoWorkProver,
    build_do_work_trace,
)
from starkpack_winterfell_tpu_torch.models.rescue_chain import (
    RescueChainAir,
    RescueChainProver,
    build_chain_trace,
)
from starkpack_winterfell_tpu_torch.ops import gl64 as gl

OPTIONS = (28, 8, 16, FieldExtension.NONE, 4, 31)
TOP = 12
# the port's hand-written kernels, by the names nvcc gives them
PORT_KERNELS = ("ntt_tile_kernel", "ntt_last", "ntt_dit_axis1_kernel",
                "limb_ntt_tile_kernel", "cons_eval_kernel", "rescue_sponge_kernel")


def build(config: str, rng):
    options = ProofOptions(*OPTIONS)
    chain_hashers = {"rp64-main": Rp64_256, "rpjive-main": RpJive64_256,
                     "griffin-main": GriffinJive64_256}
    if config in chain_hashers:
        return (RescueChainAir, RescueChainProver(options, chain_hashers[config]),
                [build_chain_trace([7] * 8, (1 << 20) // 8)])
    if config == "rp62-main":
        air, fib_build, fib_prover, _ = get_fib_family("f62")
        cubic = ProofOptions(28, 8, 16, FieldExtension.CUBIC, 4, 31)
        return air, fib_prover(cubic, Rp62_248), [fib_build(1 << 20) for _ in range(2)]
    if config == "do-work":
        traces = [build_do_work_trace(i + 1, 1024) for i in range(32)]
        return DoWorkAir, DoWorkProver(options, Blake3_256), traces
    n, rows = (64, 1 << 13) if config == "rescue-small" else (1, 1 << 16)
    seeds = rng.integers(0, gl.P, size=(n, 8), dtype=np.uint64)
    traces = [build_chain_trace([int(v) for v in s], rows // 8) for s in seeds]
    return RescueChainAir, RescueChainProver(options, Blake3_256), traces


def timed(prover, traces):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = prover.prove(len(traces), traces)
    torch.cuda.synchronize()
    return proof, time.perf_counter() - t0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="do-work",
                   choices=["do-work", "rescue-small", "rescue-big", "rp64-main",
                            "rpjive-main", "griffin-main", "rp62-main"])
    p.add_argument("--seed", type=int, default=0, help="numpy seed of the chain seeds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_prove.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()

    air, prover, traces = build(args.config, np.random.default_rng(args.seed))
    timed(prover, traces)  # builds, cached tables
    _, plain_s = timed(prover, traces)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        proof, profiled_s = timed(prover, traces)
    verify(air, proof, [prover.get_pub_inputs(t) for t in traces], prover.hasher)

    events = [e for e in prof.key_averages() if e.device_time_total > 0]
    if not events:
        raise SystemExit("the profiler recorded no device time")
    device_s = sum(e.device_time_total for e in events) / 1e6
    launches = sum(e.count for e in events)
    events.sort(key=lambda e: -e.device_time_total)
    port = [e for e in events if any(k in e.key for k in PORT_KERNELS)]
    print(json.dumps({
        "config": args.config, "n": len(traces), "rows": traces[0].length,
        "hasher": prover.hasher.NAME,
        "nvidia_smi": smi, "torch": torch.__version__,
        "steady_prove_s": plain_s, "profiled_prove_s": profiled_s,
        "device_kernels": launches, "device_busy_s": device_s,
        "device_idle_share": 1.0 - device_s / profiled_s,
        "device_idle_share_of_steady": 1.0 - device_s / plain_s,
        "host_us_per_kernel": profiled_s / launches * 1e6,
        "port_kernels": [
            {"name": e.key, "count": e.count, "device_ms": e.device_time_total / 1e3,
             "device_ms_per_launch": e.device_time_total / 1e3 / e.count}
            for e in port
        ],
        "top_kernels": [
            {"name": e.key[:80], "count": e.count,
             "device_ms": e.device_time_total / 1e3,
             "share_of_device": e.device_time_total / 1e6 / device_s}
            for e in events[:TOP]
        ],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
