"""PyTorch port, the slice as a whole: a Rescue hash-chain proof of 2^14 rows
through the big-trace path of starkpack_winterfell_tpu_torch on the CPU,
byte-identical to the JAX package's host proof (numpy + C, no jit), verified
by both packages' verifiers.  2^14 rows is the smallest trace the path
supports."""

import hashlib
import os

import numpy as np
import pytest
import torch

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.models import rescue_chain as jrc

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.models import rescue_chain as trc
from starkpack_winterfell_tpu_torch.prover import device_big
from starkpack_winterfell_tpu_torch.utils.convert import trace_from_u64_columns

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

ROWS = 1 << 14
BENCH = (28, 8, 16, 1, 4, 31)
CHEAP = (8, 8, 0, 1, 4, 31)
GOLDEN = os.path.join(os.path.dirname(T.__file__), "golden", "rescue14_bench.sha256")


def _both(seeds, options):
    """The same statement in both packages: traces built once by the JAX
    package's host builder and carried across as numpy columns."""
    jtraces = [jrc._build_chain_trace_host(s, ROWS // 8) for s in seeds]
    ttraces = [trace_from_u64_columns(t.main_columns_u64()) for t in jtraces]
    jprover = jrc.RescueChainProver(J.ProofOptions(*options), J.Blake3_256)
    tprover = trc.RescueChainProver(T.ProofOptions(*options), T.Blake3_256)
    return jtraces, ttraces, jprover, tprover


@pytest.fixture(scope="module")
def bench_case():
    jtraces, ttraces, jprover, tprover = _both([[7] * 8], BENCH)
    jproof = jprover.prove(1, jtraces)
    tproof = tprover.prove(1, ttraces, device="cpu")
    return jtraces, ttraces, jprover, tprover, jproof, tproof


def test_bench_options_proof_is_byte_identical(bench_case):
    *_, jproof, tproof = bench_case
    assert tproof.to_bytes() == jproof.to_bytes()


def test_each_verifier_accepts_the_other_proof(bench_case):
    jtraces, ttraces, jprover, tprover, jproof, tproof = bench_case
    jpub = [jprover.get_pub_inputs(t) for t in jtraces]
    tpub = [tprover.get_pub_inputs(t) for t in ttraces]
    assert J.verify(jrc.RescueChainAir, jproof.from_bytes(tproof.to_bytes()), jpub,
                    J.Blake3_256)
    assert T.verify(trc.RescueChainAir, tproof.from_bytes(jproof.to_bytes()), tpub,
                    T.Blake3_256)


@pytest.mark.parametrize("where", [0.1, 0.5, 0.9])
def test_flipped_byte_is_rejected(bench_case, where):
    _, ttraces, _, tprover, jproof, tproof = bench_case
    data = bytearray(jproof.to_bytes())
    data[int(len(data) * where)] ^= 0x01
    tpub = [tprover.get_pub_inputs(t) for t in ttraces]
    with pytest.raises((T.VerifierError, T.DeserializationError)):
        T.verify(trc.RescueChainAir, tproof.from_bytes(bytes(data)), tpub, T.Blake3_256)


def test_wrong_public_input_is_rejected(bench_case):
    _, ttraces, _, tprover, _, tproof = bench_case
    pub = tprover.get_pub_inputs(ttraces[0])
    pub.seed[0] = (pub.seed[0] + 1) % T.crypto.rescue.P
    with pytest.raises(T.VerifierError):
        T.verify(trc.RescueChainAir, tproof, [pub], T.Blake3_256)


def test_bench_proof_digest_is_pinned(bench_case):
    *_, tproof = bench_case
    with open(GOLDEN) as f:
        pinned = f.read().strip()
    assert hashlib.sha256(tproof.to_bytes()).hexdigest() == pinned


def test_two_instances_chunked_scan_is_byte_identical(monkeypatch):
    """n = 2 aggregated into one proof with the ce domain (2^17) walked in
    four chunks, so the per-chunk carries and the end-of-domain wrap of the
    next-row frame are exercised."""
    monkeypatch.setattr(device_big, "CHUNK_SIZE", 1 << 15)
    jtraces, ttraces, jprover, tprover = _both([[3] * 8, list(range(1, 9))], CHEAP)
    jproof = jprover.prove(2, jtraces)
    tproof = tprover.prove(2, ttraces, device="cpu")
    assert tproof.to_bytes() == jproof.to_bytes()
    tpub = [tprover.get_pub_inputs(t) for t in ttraces]
    assert T.verify(trc.RescueChainAir, tproof, tpub, T.Blake3_256)
    jpub = [jprover.get_pub_inputs(t) for t in jtraces]
    assert J.verify(jrc.RescueChainAir, jproof.from_bytes(tproof.to_bytes()), jpub,
                    J.Blake3_256)


def test_native_and_python_trace_builders_agree():
    want = jrc._build_chain_trace_host([5] * 8, 1024).main_columns_u64()
    assert np.array_equal(trc._build_chain_trace_native([5] * 8, 1024).main_columns_u64(), want)
    assert np.array_equal(
        trc._build_chain_trace_python([5] * 8, 16).main_columns_u64(), want[:, :128]
    )


@pytest.mark.parametrize("case", ["quadratic", "short", "trace_count"])
def test_unsupported_configs_raise(case):
    """What the f64 paths take at every extension degree is held by
    tests/test_torch_prove_ext.py, what the limb path takes by
    tests/test_torch_prove_limb_ext.py; still refused: f128 beyond quadratic
    (the 2^14-row Rescue128 chain at cubic, which the reference does not
    have) and SHA3-256 on the f64 paths (a short chain at cubic)."""
    hasher = T.Blake3_256
    if case == "quadratic":
        from starkpack_winterfell_tpu_torch.models import rescue128_chain as tr

        options = T.ProofOptions(8, 8, 0, T.FieldExtension.CUBIC, 4, 31)
        prover = tr.Rescue128ChainProver(options, hasher)
        trace, n = tr.build_rescue128_chain_trace([1, 2], ROWS // 8), 1
    else:
        if case == "short":
            options, perms, n = T.ProofOptions(8, 8, 0, T.FieldExtension.CUBIC, 4, 31), (1 << 10) // 8, 1
            hasher = T.Sha3_256
        else:
            options, perms, n = T.ProofOptions(*CHEAP), (1 << 10) // 8, 2
        prover = trc.RescueChainProver(options, hasher)
        trace = trc.build_chain_trace([1] * 8, perms)
    expected = {"trace_count": T.ProverError, "quadratic": AssertionError}.get(
        case, NotImplementedError)
    with pytest.raises(expected):
        prover.prove(n, [trace], device="cpu")
