"""Example runner CLI: prove + serialize + round-trip + verify with timing
and proof-size reporting.

Counterpart of starkpack_winterfell_tpu/models/cli.py cut to the examples
that reach a ported path: do-work, fib and rescue-chain (f64: the
small-trace pipeline below 2^14 rows, the big-trace pipeline from there up),
rescue128-chain and fib-f128 (f128) and fib-f62 (f62), limb pipeline.

Usage:
  python -m starkpack_winterfell_tpu_torch.models.cli do-work -n 32 -l 1024
  python -m starkpack_winterfell_tpu_torch.models.cli do-work -n 4 -l 256 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli fib -n 2 -l 1024 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli rescue-chain -n 1 -l 131072
  python -m starkpack_winterfell_tpu_torch.models.cli rescue-chain -n 2 -l 2048 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli rescue128-chain -n 1 -l 512 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli fib-f128 -n 2 -l 512 --device cpu
"""

from __future__ import annotations

import argparse
import time

from ..air.options import ProofOptions
from ..crypto.hashers import HASHERS, get_hasher
from ..ops import blake3 as b3
from ..verifier import verify


def get_example(name: str):
    if name == "do-work":
        from .do_work import DoWorkAir, DoWorkProver, build_do_work_trace

        return DoWorkAir, DoWorkProver, lambda i, l: build_do_work_trace(i, l)
    if name == "fib":
        from .fibonacci import FibAir, FibProver, build_fib_trace

        return FibAir, FibProver, lambda i, l: build_fib_trace(l)
    if name == "rescue-chain":
        from .rescue_chain import RescueChainAir, RescueChainProver, build_chain_trace

        # -l is the CHAIN LENGTH (number of hash permutations), matching the
        # upstream example invocation (rescue -n); trace length = 8 * l
        return (
            RescueChainAir,
            RescueChainProver,
            lambda i, l: build_chain_trace([i + 1] * 8, l),
        )
    if name == "rescue128-chain":
        from .rescue128_chain import (
            Rescue128ChainAir,
            Rescue128ChainProver,
            build_rescue128_chain_trace,
        )

        # -l is the CHAIN LENGTH; trace length = 8 * l
        return (
            Rescue128ChainAir,
            Rescue128ChainProver,
            lambda i, l: build_rescue128_chain_trace([i + 1, 2 * i + 7], l),
        )
    if name in ("fib-f128", "fib-f62"):
        from .fib_multifield import get_fib_family

        air, build, prover, _ = get_fib_family(name[4:])
        return air, prover, lambda i, l: build(l)
    raise SystemExit(f"unknown example {name}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("example", choices=["do-work", "fib", "rescue-chain",
                                       "rescue128-chain", "fib-f128", "fib-f62"])
    p.add_argument("-n", "--num-traces", type=int, default=2)
    p.add_argument("-l", "--trace-length", type=int, default=2048,
                   help="the hash chains: CHAIN length (hashes), the trace has "
                        "8*l rows; the others: the trace length")
    p.add_argument("-q", "--queries", type=int, default=32)
    p.add_argument("-b", "--blowup", type=int, default=8)
    p.add_argument("-g", "--grinding", type=int, default=0)
    p.add_argument("-e", "--extension", type=int, default=1, choices=[1, 2, 3])
    p.add_argument("-f", "--folding", type=int, default=8)
    p.add_argument("-r", "--remainder", type=int, default=31)
    p.add_argument("--hash", default="blake3_256", choices=sorted(HASHERS))
    p.add_argument("--device", default="cuda",
                   help="torch device of the prove (default cuda; raises "
                        "without a card unless cpu is named)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="per-phase prover debug timing")
    args = p.parse_args(argv)
    if args.verbose:
        import logging

        logging.basicConfig(
            level=logging.DEBUG, format="[%(levelname)s %(name)s] %(message)s"
        )

    air_class, prover_class, build = get_example(args.example)
    hasher = get_hasher(args.hash)
    options = ProofOptions(
        args.queries, args.blowup, args.grinding, args.extension, args.folding,
        args.remainder,
    )

    t0 = time.perf_counter()
    traces = [build(i, args.trace_length) for i in range(args.num_traces)]
    t1 = time.perf_counter()
    print(f"Built {args.num_traces} execution traces of {traces[0].length} steps "
          f"in {(t1 - t0) * 1000:.0f} ms")

    prover = prover_class(options, hasher)
    pub_inputs = [prover.get_pub_inputs(t) for t in traces]
    t2 = time.perf_counter()
    proof = prover.prove(args.num_traces, traces, device=args.device)
    t3 = time.perf_counter()
    print(f"Generated the aggregated proof on {args.device} in "
          f"{(t3 - t2) * 1000:.0f} ms")

    proof_bytes = proof.to_bytes()
    print(f"Proof size: {len(proof_bytes) / 1024:.1f} KB")
    print(f"Conjectured security: {proof.security_level_conjectured()} bits, "
          f"proven: {proof.security_level_proven()} bits")
    print(f"Proof hash (blake3): {b3.hash_bytes(proof_bytes).hex()}")

    parsed = proof.from_bytes(proof_bytes)
    if parsed.to_bytes() != proof_bytes:
        raise SystemExit("serialization round trip failed")

    t4 = time.perf_counter()
    verify(air_class, parsed, pub_inputs, hasher)
    t5 = time.perf_counter()
    print(f"Proof verified in {(t5 - t4) * 1000:.1f} ms")


if __name__ == "__main__":
    main()
