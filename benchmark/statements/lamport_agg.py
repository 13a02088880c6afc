"""Aggregated Lamport+ signatures: every secret key and message drawn from
the seed; the secrets' digests, signatures and traces made by the program's
host builders (the Rescue128 digests of native/rescue128.c).  The pool's first
statement is the wallet in its drawn order, each later one the same
signatures in another order drawn from the seed, which changes the trace.

The reference takes the drawn messages and the public keys the program's
trace claims, which the proof has to back; a sample of those keys, drawn from the
seed, is worked out again from the drawn secrets by the reference's
Rescue128."""

from __future__ import annotations

import ctypes
import time

import numpy as np

from . import Pool, Statement

M64 = (1 << 64) - 1


def _wallet(rng, n: int, k: int):
    """Secrets (n, k, 2 sides, 2 elements) as (lo, hi) u64 words, each
    below the f128 modulus (a high word below 2^64 - 1 is), and k-bit
    messages with the top bit set."""
    lo = rng.integers(0, 1 << 64, size=(n, k, 2, 2), dtype=np.uint64)
    hi = rng.integers(0, (1 << 64) - 1, size=(n, k, 2, 2), dtype=np.uint64)
    words = rng.integers(0, 1 << 64, size=(n, 2), dtype=np.uint64)
    messages = [((int(h) << 64 | int(l)) & ((1 << k) - 1)) | (1 << (k - 1)) for l, h in words]
    return np.stack([lo, hi], axis=-1), messages


def _ints(words):
    """(..., 2) u64 (lo, hi) words -> nested lists of Python ints."""
    return ((words[..., 1].astype(object) << 64) | words[..., 0].astype(object)).tolist()


def build(params: dict, config: dict, rng: np.random.Generator, pool_size: int) -> Pool:
    from starkpack_winterfell_tpu_torch import Blake3_192, ProofOptions
    from starkpack_winterfell_tpu_torch.models import lamport128_agg as lagg
    from starkpack_winterfell_tpu_torch.models.lamport128 import sign
    from starkpack_winterfell_tpu_torch.native import get_rescue128

    from ..reference.airs import rescue128_digest

    if config["hasher"] != "blake3_192":
        raise ValueError(f"no prover for hasher {config['hasher']}")
    n, k = params["signatures"], config["message_bits"]
    if config["rows_per_signature"] != 8 * (k + 1):
        raise ValueError("a signature block is 8 (k + 1) rows")
    secret_words, messages = _wallet(rng, n, k)
    orders = [np.arange(n)] + [rng.permutation(n) for _ in range(pool_size - 1)]
    sample = [int(i) for i in rng.choice(n, size=params.get("pub_key_sample", 0), replace=False)]

    t0 = time.perf_counter()
    lib = get_rescue128()
    vp = ctypes.c_void_p
    flat = np.ascontiguousarray(secret_words.reshape(-1))
    hashes = np.zeros(n * k * 2 * 4, dtype=np.uint64)
    lib.r128_digest_batch(flat.ctypes.data_as(vp), 2, n * k * 2, hashes.ctypes.data_as(vp))
    secrets = _ints(secret_words)  # (n, k, side, element)
    pk_hashes = _ints(hashes.reshape(n, k, 2, 2, 2))
    sigs = [sign(secrets[s], pk_hashes[s], messages[s], k) for s in range(n)]
    prover = lagg.Lamport128AggProver(ProofOptions(*config["options"]), Blake3_192)
    statements = []
    for order in orders:
        trace = lagg.build_lamport128_agg_trace([messages[i] for i in order],
                                                [sigs[i] for i in order], k)
        claim = prover.get_pub_inputs(trace)
        statements.append(Statement([trace], [claim], [
            {"messages": [messages[i] for i in order], "pub_keys": claim.pub_keys}]))
    build_s = time.perf_counter() - t0
    # only the sampled secrets outlive set-up: the window's process holds no
    # more of the harness's objects than it needs
    sampled = {s: secrets[s] for s in sample}
    del secrets, pk_hashes, sigs

    def wrong_pub_keys():
        """Sampled signatures whose claimed public key is not the Rescue128
        digest of the drawn secrets' digests."""
        claimed = statements[0].reference[0]["pub_keys"]
        wrong = 0
        for s in sample:
            digests = [rescue128_digest(sampled[s][i][side]) for i in range(k) for side in range(2)]
            if rescue128_digest([e for d in digests for e in d]) != list(claimed[s]):
                wrong += 1
        return wrong

    checks = {"wrong_pub_keys": (wrong_pub_keys, 0)} if sample else {}
    return Pool(prover, lagg.Lamport128AggAir, statements, build_s, checks)
