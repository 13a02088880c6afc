"""The control of the comparison that decides ``correct``: whole runs of a
cell through the harness, with the program's work broken underneath while
each proof's header still states the configuration's options.  The break:
every proof's first FRI fold is taken at a challenge one above the one the
transcript draws, so the proof passes the options, the transcript, the
openings, the out-of-domain and DEEP checks and the grinding, and only the
fold gives it away.  The program's own verify is made to accept anything,
so the plain reference alone judges.  The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <n> ...] [--seconds <s>]

Prints one JSON line a seed: ``correct`` (false, for the comparison to
hold) and the numbers compared with their limits."""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BREAK = "the first FRI fold of each proof at the transcript's challenge + 1"


@contextlib.contextmanager
def broken_fold():
    """The program with its first FRI challenge a proof one off, and its
    own verify accepting anything."""
    import starkpack_winterfell_tpu_torch as program
    from starkpack_winterfell_tpu_torch.prover.channel import ProverChannel

    draw, verify = ProverChannel.draw_fri_alpha, program.verify

    def off_by_one(channel):
        alpha = draw(channel)
        if getattr(channel, "_control_folded", False):
            return alpha
        channel._control_folded = True
        P = channel.public_coin.field.P
        if isinstance(alpha, int):
            return (alpha + 1) % P
        return ((alpha[0] + 1) % P,) + tuple(alpha[1:])

    ProverChannel.draw_fri_alpha = off_by_one
    program.verify = lambda *args, **kwargs: True
    try:
        yield
    finally:
        ProverChannel.draw_fri_alpha, program.verify = draw, verify


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness
    from benchmark.run import _caches

    _caches()
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seed:
        t0 = time.perf_counter()
        with broken_fold():
            result = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "control": BREAK,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "checks": result["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
