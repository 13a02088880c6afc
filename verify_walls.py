#!/usr/bin/env python3
"""Verify walls of one checkout of the port (this one, or another commit
unpacked beside it), beside the prove they verify:

    python3 verify_walls.py [--root DIR] [--device cuda|cpu]

``--root`` names the directory whose ``starkpack_winterfell_tpu_torch``
package is measured (default: the one beside this script); to compare two
commits on one machine, unpack the other with ``git archive`` into a
git-ignored directory and run the script for each in turns (parent,
change, change, parent) in one call.  The walls are taken by this
checkout's ``chip_smoke.py`` (``verify_walls``: the first verify, then the
median of five more; ``seed_hash_walls``), whatever ``--root`` is.  On the
card, two proves, each warmed once (its kernels built, its tables cached),
then proved once with its phase walls (``kernel_times.timed_prove``):

* ``lamport_1024``: 1024 Lamport+ signatures of 127-bit messages in one
  2^20 x 14 f128 trace, BLAKE3-192 (``chip_smoke.py``'s
  lamport_agg_main), with the walls of the Fiat-Shamir seed's
  ``hash_elements`` (the context and the 3 x 1024 public elements, about
  48 KB), which the prover's channel hashes inside P1 and the verifier's
  coin before anything else;
* ``f64_main``: the Rescue chain of 2^20 rows x 12 Goldilocks columns,
  BLAKE3-256 (``chip_smoke.py``'s main).

Both at ProofOptions(28, 8, 16, NONE, 4, 31).  Prints one JSON line a
proof: the steady prove's wall and phase ms, the verify walls, the seed
hash's walls, the card's name and power limit.  Needs a CUDA device
(exits non-zero without one).

With ``--device cpu`` it proves on the host instead, at the same options,
and times the verifies there: do-work 32 x 1024, and two f64 proofs of
several instances without auxiliary segments, rescue-chain 64 x 256 and 4
x 1024 in the quadratic extension (the OOD evaluation of every instance
is a share of their verify).  The verifier is a host function on every
machine, so these lines read the host's CPU, and no device number comes
from them."""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

OPTIONS = (28, 8, 16, 1, 4, 31)
LAMPORT_SIGNATURES, LAMPORT_K = 1024, 127
MAIN_LOG2_ROWS = 20
# (example, instances, rows, extension degree) of the --device cpu proofs
HOST_PROOFS = (("do-work", 32, 1024, 1), ("rescue-chain", 64, 256, 1),
               ("rescue-chain", 4, 1024, 2))


def load_chip_smoke():
    """This checkout's chip_smoke.py, by its path: with --root first on
    sys.path, a plain import would find the other checkout's."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def measure(smoke, name, prover, air_class, traces, torch, full_pipeline, timed_prove,
            **fields):
    """Warm prove, steady prove, the verify walls of the steady proof after
    a serialization round trip, the seed hash's walls.  The tables the warm
    prove cached stay, as they do between a service's proves; the blocks
    torch's allocator holds go back to the card before each prove, so the
    memory check of the largest prove finds the card free (as in
    ``chip_smoke.py``)."""
    full_pipeline._TABLE_CACHE.clear()
    torch.cuda.empty_cache()
    prover.prove(len(traces), traces)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    proof, seconds, phases = timed_prove(prover, traces)
    data = proof.to_bytes()
    parsed = proof.from_bytes(data)
    pub = [prover.get_pub_inputs(t) for t in traces]
    return dict(proof=name, steady_prove_s=seconds, phases_ms=dict(phases),
                proof_bytes=len(data),
                **smoke.verify_walls(air_class, parsed, pub, prover.hasher),
                **smoke.seed_hash_walls(proof, pub, prover.hasher,
                                        traces[0].spec.ELEMENT_BYTES),
                **fields)


def host_cpu() -> str:
    """The host CPU's model name as /proc/cpuinfo gives it, and its cores."""
    try:
        with open("/proc/cpuinfo") as f:
            names = [line.split(":", 1)[1].strip() for line in f
                     if line.startswith("model name")]
    except OSError:
        names = []
    return f"{names[0] if names else 'unknown'} x {os.cpu_count()}"


def on_the_host(smoke, example, n, rows, ext, **fields) -> dict:
    """One HOST_PROOFS entry proved and verified on the host CPU."""
    from starkpack_winterfell_tpu_torch import Blake3_256, ProofOptions
    from starkpack_winterfell_tpu_torch.models.cli import get_example

    air_class, prover_class, build = get_example(example)
    traces = [build(i + 1, rows) for i in range(n)]
    options = (*OPTIONS[:3], ext, *OPTIONS[4:])
    prover = prover_class(ProofOptions(*options), Blake3_256)
    proof = prover.prove(n, traces, device="cpu")
    data = proof.to_bytes()
    parsed = proof.from_bytes(data)
    pub = [prover.get_pub_inputs(t) for t in traces]
    return dict(proof=f"{example}_{n}x{rows}_e{ext}", device="cpu", host_cpu=host_cpu(),
                options=list(options), proof_bytes=len(data),
                **smoke.verify_walls(air_class, parsed, pub, Blake3_256), **fields)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                   help="directory holding the starkpack_winterfell_tpu_torch to measure")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the HOST_PROOFS verifies on the host alone")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    smoke = load_chip_smoke()
    if args.device == "cpu":
        for entry in HOST_PROOFS:
            print(json.dumps(on_the_host(smoke, *entry, root=os.path.relpath(root))),
                  flush=True)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("verify_walls.py needs a CUDA device")
    from kernel_times import timed_prove
    from starkpack_winterfell_tpu_torch import Blake3_192, Blake3_256, ProofOptions
    from starkpack_winterfell_tpu_torch.models import lamport128_agg as lagg
    from starkpack_winterfell_tpu_torch.models.rescue_chain import (
        RescueChainAir,
        RescueChainProver,
        build_chain_trace,
    )
    from starkpack_winterfell_tpu_torch.parallel import full_pipeline

    common = dict(root=os.path.relpath(root), nvidia_smi=smoke.nvidia_smi_line(),
                  options=list(OPTIONS))
    options = ProofOptions(*OPTIONS)

    t0 = time.perf_counter()
    messages, _, sigs = lagg.make_wallet(LAMPORT_SIGNATURES, LAMPORT_K, seed=1)
    trace = lagg.build_lamport128_agg_trace(messages, sigs, LAMPORT_K)
    setup_s = time.perf_counter() - t0
    print(json.dumps(measure(smoke, "lamport_1024", lagg.Lamport128AggProver(options, Blake3_192),
                             lagg.Lamport128AggAir, [trace], torch, full_pipeline,
                             timed_prove, wallet_and_trace_s=setup_s, **common)), flush=True)
    del trace, messages, sigs

    t0 = time.perf_counter()
    traces = [build_chain_trace([7] * 8, (1 << MAIN_LOG2_ROWS) // 8)]
    setup_s = time.perf_counter() - t0
    print(json.dumps(measure(smoke, "f64_main", RescueChainProver(options, Blake3_256),
                             RescueChainAir, traces, torch, full_pipeline,
                             timed_prove, trace_build_s=setup_s, **common)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
