"""Example runner CLI: prove + serialize + round-trip + verify with timing
and proof-size reporting.

Counterpart of starkpack_winterfell_tpu/models/cli.py: do-work, fib,
rescue-chain, rescue-chain-pad and lamport (f64: the small-trace pipeline
below 2^14 rows, the big-trace pipeline from there up), rescue128-chain,
fib-f128, merkle128, lamport128 and lamport128-agg (f128) and fib-f62 (f62),
limb pipeline; perm (f64 with an auxiliary segment,
parallel/full_pipeline.py).  ``-e 2`` (quadratic) reaches every example,
``-e 3`` (cubic) every one but the f128 examples, which have no cubic
extension.  ``--hash`` takes blake3_256, blake3_192, sha3_256 and, on f64,
rp64_256, rp_jive64_256 and griffin_jive64_256, on f62 rp62_248.

Usage:
  python -m starkpack_winterfell_tpu_torch.models.cli do-work -n 32 -l 1024
  python -m starkpack_winterfell_tpu_torch.models.cli do-work -n 4 -l 256 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli fib -n 2 -l 1024 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli rescue-chain -n 1 -l 131072
  python -m starkpack_winterfell_tpu_torch.models.cli rescue-chain -n 2 -l 2048 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli rescue128-chain -n 1 -l 512 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli fib-f128 -n 2 -l 512 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli fib-f62 -n 2 -l 256 -e 3 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli merkle128 -n 2 -l 64 -e 2 --hash sha3_256 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli lamport128 -n 2 -l 128 --hash sha3_256 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli lamport128-agg -n 1 -l 2048 --hash blake3_192 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli perm -n 2 -l 64 -e 2 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli rescue-chain -n 1 -l 64 --hash rp64_256 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli fib-f62 -n 2 -l 64 --hash rp62_248 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli rescue-chain-pad -n 1 -l 5 --hash rp64_256 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli lamport -n 2 -l 64 --hash sha3_256 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli do-work -n 1 -l 32 --hash rp_jive64_256 --device cpu
  python -m starkpack_winterfell_tpu_torch.models.cli do-work -n 1 -l 32 --hash griffin_jive64_256 --device cpu
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
    if name == "rescue-chain-pad":
        import os

        from .rescue_chain_pad import (
            RescueChainPadAir,
            RescueChainPadProver,
            build_padded_chain_trace,
        )

        # -l is the LIVE chain length (permutations), any value; the trace is
        # padded to a bucket of the next power of two permutations (at least
        # 4), or STARKPACK_PAD_BUCKET
        holder = {}

        def build_pad(i, l):
            bucket = int(os.environ.get("STARKPACK_PAD_BUCKET",
                                        max(4, 1 << (l - 1).bit_length())))
            holder["n_live"] = l
            return build_padded_chain_trace([i + 1] * 8, l, bucket)

        def make_prover(options, hasher):
            return RescueChainPadProver(options, hasher, holder["n_live"])

        return RescueChainPadAir, make_prover, build_pad
    if name == "lamport":
        from .lamport import LamportAir, LamportProver, build_lamport_trace, keygen, sign
        from .rescue_chain import CYCLE_LENGTH

        def build(i, l):
            # -l is the trace length: 8 rows per message bit plus a final cycle
            k = l // CYCLE_LENGTH - 1
            secrets, pk_hashes, _ = keygen(k, seed=i)
            message = (0x6A09E667F3BCC908 + i) % (1 << k) if k < 63 else i + 1
            sig = sign(secrets, pk_hashes, message, k)
            return build_lamport_trace(message, sig, k)

        return LamportAir, LamportProver, build
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
    if name == "merkle128":
        import random as _random

        from .merkle128 import P, Merkle128Air, Merkle128Prover, build_merkle128_trace

        def build_mk(i, l):
            # -l is the trace length: 8 rows per tree level
            depth = l // 8
            rng = _random.Random(i)
            leaf = [rng.randrange(P), rng.randrange(P)]
            sibs = [[rng.randrange(P), rng.randrange(P)] for _ in range(depth)]
            return build_merkle128_trace(leaf, sibs, rng.getrandbits(depth))

        return Merkle128Air, Merkle128Prover, build_mk
    if name == "lamport128":
        from . import lamport128 as lam

        def build128(i, l):
            # -l is the trace length: 8 rows per message bit plus a final cycle
            k = l // 8 - 1
            secrets, pk_hashes, _ = lam.keygen(k, seed=i)
            message = (0x6A09E667F3BCC908 + i) % (1 << k) if k < 63 else i + 1
            sig = lam.sign(secrets, pk_hashes, message, k)
            return lam.build_lamport128_trace(message, sig, k)

        return lam.Lamport128Air, lam.Lamport128Prover, build128
    if name == "lamport128-agg":
        from . import lamport128_agg as lagg

        def build_agg(i, l):
            # one trace aggregating l/1024 signatures over 127-bit messages
            # (1024 rows per signature, the reference benchmark's block)
            k = 127
            n_sigs = max(1, l // (8 * (k + 1)))
            messages, _, sigs = lagg.make_wallet(n_sigs, k, seed=i)
            return lagg.build_lamport128_agg_trace(messages, sigs, k)

        return lagg.Lamport128AggAir, lagg.Lamport128AggProver, build_agg
    if name in ("fib-f128", "fib-f62"):
        from .fib_multifield import get_fib_family

        air, build, prover, _ = get_fib_family(name[4:])
        return air, prover, lambda i, l: build(l)
    if name == "perm":
        from .permutation import PermAir, PermProver, build_perm_trace

        return PermAir, PermProver, lambda i, l: build_perm_trace(i + 3, l)
    raise SystemExit(f"unknown example {name}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("example", choices=["do-work", "fib", "rescue-chain",
                                       "rescue-chain-pad", "lamport",
                                       "rescue128-chain", "fib-f128", "fib-f62",
                                       "merkle128", "lamport128", "lamport128-agg",
                                       "perm"])
    p.add_argument("-n", "--num-traces", type=int, default=2)
    p.add_argument("-l", "--trace-length", type=int, default=2048,
                   help="the hash chains: CHAIN length (hashes), the trace has "
                        "8*l rows (rescue-chain-pad: the live length, padded to a "
                        "bucket); the others: the trace length (lamport128-agg: "
                        "l/1024 signatures)")
    p.add_argument("-q", "--queries", type=int, default=32)
    p.add_argument("-b", "--blowup", type=int, default=8)
    p.add_argument("-g", "--grinding", type=int, default=0)
    p.add_argument("-e", "--extension", type=int, default=1, choices=[1, 2, 3])
    p.add_argument("-f", "--folding", type=int, default=8)
    p.add_argument("-r", "--remainder", type=int, default=31)
    p.add_argument("--hash", default="blake3_256", choices=sorted(HASHERS),
                   help="every path takes blake3_256, blake3_192 and sha3_256; "
                        "the f64 paths also rp64_256, rp_jive64_256 and "
                        "griffin_jive64_256, the f62 one rp62_248")
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
