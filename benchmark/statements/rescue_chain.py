"""Rescue hash chains: each instance's 8 seed elements drawn from the
seed, its trace built by the program's host builder.  The reference takes
the drawn seed and the program's claimed result, which the proof has to
back."""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import Pool, Statement

P = 0xFFFFFFFF00000001


def build(params: dict, config: dict, rng: np.random.Generator, pool_size: int) -> Pool:
    from starkpack_winterfell_tpu_torch import Blake3_256, ProofOptions
    from starkpack_winterfell_tpu_torch.models.rescue_chain import (
        RescueChainAir,
        RescueChainProver,
        build_chain_trace,
    )
    from starkpack_winterfell_tpu_torch.native import get_builders

    if config["hasher"] != "blake3_256":
        raise ValueError(f"no prover for hasher {config['hasher']}")
    n, rows = params["instances"], 1 << params["log2_rows"]
    prover = RescueChainProver(ProofOptions(*config["options"]), Blake3_256)
    seeds = rng.integers(0, P, size=(pool_size, n, 8), dtype=np.uint64)
    t0 = time.perf_counter()
    # each chain is one sequential scan in native code, which runs without
    # the interpreter lock: the pool's chains are built side by side, once
    # the builder is built and loaded here (threads of one process that build
    # it at once would write the same temporary file)
    get_builders()
    flat = [[int(v) for v in seed] for per_proof in seeds for seed in per_proof]
    with ThreadPoolExecutor(min(len(flat), os.cpu_count() or 1)) as ex:
        built = list(ex.map(lambda s: build_chain_trace(s, rows // config["rows_per_permutation"]),
                            flat))
    statements = []
    for i in range(pool_size):
        traces = built[i * n:(i + 1) * n]
        pub = [prover.get_pub_inputs(t) for t in traces]
        ref = [{"seed": seed, "result": list(claim.result)}
               for seed, claim in zip(flat[i * n:(i + 1) * n], pub)]
        statements.append(Statement(traces, pub, ref))
    return Pool(prover, RescueChainAir, statements, time.perf_counter() - t0)
