"""PyTorch port, the Lamport+ slice: aggregated Lamport+ signatures over f128
(models/lamport128_agg.py: many signatures as 8*(k+1)-row blocks of ONE
trace, per-block outputs bound by sequence assertions) and one signature per
StarkPack instance (models/lamport128.py), proved through
parallel/full_pipeline.py prove_mesh on the CPU.  Each proof is held byte for
byte against the JAX package's HOST proof (``Prover.prove``) of the same
wallet, with BLAKE3-256, BLAKE3-192 and SHA3-256, and against the three SHA3
rows of the JAX package's golden matrix; each package's verifier accepts the
other's proof.  Wallets come from fixed seeds; tolerance zero."""

import hashlib
import os

import numpy as np
import pytest

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.models import lamport128 as jl
from starkpack_winterfell_tpu.models import lamport128_agg as ja
from starkpack_winterfell_tpu.ops import blake3 as jb3

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.models import lamport128 as tl
from starkpack_winterfell_tpu_torch.models import lamport128_agg as ta
from starkpack_winterfell_tpu_torch.models.cli import get_example

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

BENCH = (28, 8, 16, 1, 4, 31)
CHEAP = (16, 8, 0, 1, 4, 31)
GOLDEN = os.path.join(os.path.dirname(T.__file__), "golden", "lamport_agg_4x512_b192.sha256")
_CASES: dict = {}


def _agg_case(n_sigs, k, hname, options, seed=0):
    """(JAX host proof, port proof, JAX pub inputs, port pub inputs) of one
    wallet, computed once per module."""
    key = (n_sigs, k, hname, options, seed)
    if key not in _CASES:
        messages, _, sigs = ta.make_wallet(n_sigs, k, seed=seed)
        jtrace = ja.build_lamport128_agg_trace(messages, sigs, k, device_builder=False)
        ttrace = ta.build_lamport128_agg_trace(messages, sigs, k)
        jprover = ja.Lamport128AggProver(J.ProofOptions(*options), J.get_hasher(hname))
        tprover = ta.Lamport128AggProver(T.ProofOptions(*options), T.get_hasher(hname))
        _CASES[key] = (jprover.prove(1, [jtrace]), tprover.prove(1, [ttrace], device="cpu"),
                       [jprover.get_pub_inputs(jtrace)], [tprover.get_pub_inputs(ttrace)])
    return _CASES[key]


def test_wallet_and_trace_builders_match_the_jax_package():
    jw, tw = ja.make_wallet(4, 7, seed=4), ta.make_wallet(4, 7, seed=4)
    assert jw == tw
    jt = ja.build_lamport128_agg_trace(jw[0], jw[2], 7, device_builder=False)
    tt = ta.build_lamport128_agg_trace(tw[0], tw[2], 7)
    assert all(np.array_equal(a, b) for a, b in zip(ja._u64_planes(jt), ta._u64_planes(tt)))
    assert tt.meta == jt.meta == (4).to_bytes(4, "little")
    three = [part[:3] for part in tw]
    assert ta.pad_wallet(*three, bucket=4, k=7) == ja.pad_wallet(*three, bucket=4, k=7)


@pytest.mark.parametrize("hname", ["blake3_192", "blake3_256", "sha3_256"])
def test_four_signatures_are_byte_identical(hname):
    """4 signatures at k = 15 (512 rows): three sequence assertions over 4
    values; the bench options, grinding included."""
    jproof, tproof, _, _ = _agg_case(4, 15, hname, BENCH)
    assert tproof.to_bytes() == jproof.to_bytes()


def test_four_signature_digest_is_pinned():
    """The digest chip_smoke.py's lamport_agg_golden phase holds the card's
    proof against."""
    _, tproof, _, _ = _agg_case(4, 15, "blake3_192", BENCH)
    with open(GOLDEN) as f:
        assert hashlib.sha256(tproof.to_bytes()).hexdigest() == f.read().strip()


def test_each_verifier_accepts_the_other_proof():
    jproof, tproof, jpub, tpub = _agg_case(4, 15, "blake3_192", BENCH)
    assert J.verify(ja.Lamport128AggAir, jproof.from_bytes(tproof.to_bytes()), jpub,
                    J.Blake3_192)
    assert T.verify(ta.Lamport128AggAir, tproof.from_bytes(jproof.to_bytes()), tpub,
                    T.Blake3_192)


@pytest.mark.parametrize("what", ["message", "public key"])
def test_tampered_message_or_public_key_is_rejected(what):
    _, tproof, _, tpub = _agg_case(4, 15, "blake3_192", BENCH)
    messages, pub_keys = list(tpub[0].messages), [list(pk) for pk in tpub[0].pub_keys]
    if what == "message":
        messages[2] ^= 1
    else:
        pub_keys[1][0] = (pub_keys[1][0] + 1) % ta.P
    with pytest.raises(T.VerifierError):
        T.verify(ta.Lamport128AggAir, tproof, [ta.LamportAggInputs(messages, pub_keys)],
                 T.Blake3_192)


@pytest.mark.parametrize("n_sigs,k", [(1, 15), (64, 3)])
def test_single_and_long_sequences_are_byte_identical(n_sigs, k):
    """One signature: the sequences degenerate to single values; 64
    signatures of 32 rows: sequences of 64 values (the interpolation and
    evaluation past 64 points)."""
    jproof, tproof, jpub, tpub = _agg_case(n_sigs, k, "blake3_256", CHEAP)
    assert tproof.to_bytes() == jproof.to_bytes()
    assert T.verify(ta.Lamport128AggAir, tproof, tpub, T.Blake3_256)


def test_padded_wallet_proves_byte_identically():
    messages, pub_keys, sigs = ta.make_wallet(3, 15, seed=9)
    padded = ta.pad_wallet(messages, pub_keys, sigs, bucket=4, k=15)
    assert padded[0][:3] == messages and len(padded[0]) == 4
    jtrace = ja.build_lamport128_agg_trace(padded[0], padded[2], 15, device_builder=False)
    ttrace = ta.build_lamport128_agg_trace(padded[0], padded[2], 15)
    jproof = ja.Lamport128AggProver(J.ProofOptions(*CHEAP), J.Blake3_256).prove(1, [jtrace])
    tprover = ta.Lamport128AggProver(T.ProofOptions(*CHEAP), T.Blake3_256)
    tproof = tprover.prove(1, [ttrace], device="cpu")
    assert tproof.to_bytes() == jproof.to_bytes()
    assert tprover.get_pub_inputs(ttrace).pub_keys == padded[1]


def test_lamport128_two_instances_are_byte_identical():
    jtraces, ttraces = [], []
    for i in range(2):
        secrets, pk_hashes, pub_key = tl.keygen(15, seed=i)
        assert (secrets, pk_hashes, pub_key) == jl.keygen(15, seed=i)
        sig = tl.sign(secrets, pk_hashes, 0x1234 + i, 15)
        jtraces.append(jl.build_lamport128_trace(0x1234 + i, sig, 15))
        ttraces.append(tl.build_lamport128_trace(0x1234 + i, sig, 15))
    jprover = jl.Lamport128Prover(J.ProofOptions(*CHEAP), J.Sha3_256)
    tprover = tl.Lamport128Prover(T.ProofOptions(*CHEAP), T.Sha3_256)
    jproof, tproof = jprover.prove(2, jtraces), tprover.prove(2, ttraces, device="cpu")
    assert tproof.to_bytes() == jproof.to_bytes()
    tpub = [tprover.get_pub_inputs(t) for t in ttraces]
    assert tpub[1].pub_key == pub_key
    assert T.verify(tl.Lamport128Air, tproof, tpub, T.Sha3_256)
    assert J.verify(jl.Lamport128Air, jproof.from_bytes(tproof.to_bytes()),
                    [jprover.get_pub_inputs(t) for t in jtraces], J.Sha3_256)


# tests/test_golden_transcript.py: (example, n, length) -> (proof bytes,
# blake3-256 of the proof), SHA3-256, ProofOptions(16, 8, 0, NONE, 4, 31)
GOLDEN_SHA3 = [
    (("fib-f128", 2, 64), 8635,
     "73aab7f884ad44c2fe320c4632d60223459fc5f0bd77006e63bd5846e0ed736b"),
    (("lamport128", 1, 128), 14553,
     "3f6228806d9ff414e269bf279efdcf75f3f2e86f621fd476ea7c302b6b3908e8"),
    (("lamport128-agg", 1, 2048), 27424,
     "6856c605f2d5d6de8f48490cf94b5d9f14dbce31b7e659c2d53c13be62c11b35"),
]


@pytest.mark.parametrize("cfg,size,digest", GOLDEN_SHA3, ids=[c[0][0] for c in GOLDEN_SHA3])
def test_sha3_golden_matrix_rows(cfg, size, digest):
    example, n, length = cfg
    air_class, prover_class, build = get_example(example)
    traces = [build(i, length) for i in range(n)]
    prover = prover_class(T.ProofOptions(16, 8, 0, 1, 4, 31), T.Sha3_256)
    proof = prover.prove(n, traces, device="cpu")
    data = proof.to_bytes()
    assert len(data) == size and jb3.hash_bytes(data).hex() == digest
    pub = [prover.get_pub_inputs(t) for t in traces]
    assert T.verify(air_class, proof.from_bytes(data), pub, T.Sha3_256)
