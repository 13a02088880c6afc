"""The plain reference verifier agrees with the program's proofs at tiny
sizes on the host, and rejects what is not a proof of the statement: bytes
altered, a statement changed, and options other than the configuration's
(the program at one bit of grinding less)."""

import json
import os

import pytest

from benchmark.reference.airs import rescue128_digest
from benchmark.reference.proof import Rejected
from benchmark.reference.verifier import verify

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN = json.load(open(os.path.join(BENCH, "configs", "rescue_chain_f64.json")))
LAMPORT = json.load(open(os.path.join(BENCH, "configs", "lamport_agg_f128.json")))


def options(config, grinding=None):
    from starkpack_winterfell_tpu_torch import ProofOptions

    o = list(config["options"])
    if grinding is not None:
        o[2] = grinding
    return ProofOptions(*o)


def chain_proof(n, rows=256, grinding=None):
    from starkpack_winterfell_tpu_torch import Blake3_256
    from starkpack_winterfell_tpu_torch.models.rescue_chain import (
        RescueChainProver,
        build_chain_trace,
    )

    seeds = [[i + 1, 2, 3, 4, 5, 6, 7, 8 + i] for i in range(n)]
    traces = [build_chain_trace(s, rows // 8) for s in seeds]
    prover = RescueChainProver(options(CHAIN, grinding), Blake3_256)
    proof = prover.prove(n, traces, device="cpu").to_bytes()
    statements = [{"seed": s, "result": prover.get_pub_inputs(t).result}
                  for s, t in zip(seeds, traces)]
    return proof, statements


@pytest.fixture(scope="module")
def lamport():
    from starkpack_winterfell_tpu_torch import Blake3_192
    from starkpack_winterfell_tpu_torch.models import lamport128_agg as lagg

    messages, pub_keys, sigs = lagg.make_wallet(2, LAMPORT["message_bits"], seed=7)
    trace = lagg.build_lamport128_agg_trace(messages, sigs, LAMPORT["message_bits"])
    prover = lagg.Lamport128AggProver(options(LAMPORT), Blake3_192)
    proof = prover.prove(1, [trace], device="cpu").to_bytes()
    return proof, [{"messages": messages, "pub_keys": pub_keys}]


@pytest.mark.parametrize("n", [1, 2])
def test_chain_proofs_verify(n):
    proof, statements = chain_proof(n)
    verify(CHAIN, statements, proof)


def test_lamport_proof_verifies(lamport):
    verify(LAMPORT, *reversed(lamport))


@pytest.mark.parametrize("where", [0.1, 0.5, 0.9, -1])
def test_altered_bytes_are_rejected(where):
    proof, statements = chain_proof(1)
    bad = bytearray(proof)
    bad[int(where * len(bad))] ^= 4
    with pytest.raises(Rejected):
        verify(CHAIN, statements, bytes(bad))


def test_another_statement_is_rejected(lamport):
    proof, statements = lamport
    wrong = [dict(statements[0], messages=[statements[0]["messages"][0] ^ 2,
                                           statements[0]["messages"][1]])]
    with pytest.raises(Rejected):
        verify(LAMPORT, wrong, proof)
    proof, statements = chain_proof(1)
    with pytest.raises(Rejected):
        verify(CHAIN, [dict(statements[0], result=[1, 2, 3, 4])], proof)


def test_other_options_are_rejected():
    """The program proving at 15 bits of grinding where the configuration
    states 16."""
    proof, statements = chain_proof(1, grinding=CHAIN["options"][2] - 1)
    with pytest.raises(Rejected, match="options"):
        verify(CHAIN, statements, proof)


def test_public_key_digest_matches_the_wallet():
    from starkpack_winterfell_tpu_torch.models.lamport128 import keygen

    secrets, _, pub_key = keygen(3, seed=11)
    digests = [rescue128_digest(secrets[i][side]) for i in range(3) for side in range(2)]
    assert rescue128_digest([e for d in digests for e in d]) == list(pub_key)


def test_conjectured_security():
    """The reference's formula gives the program's reading of a proof, and
    the configurations' stated security at their cells' 2^20 rows."""
    from starkpack_winterfell_tpu_torch import Blake3_256
    from starkpack_winterfell_tpu_torch.models.rescue_chain import (
        RescueChainProver,
        build_chain_trace,
    )

    from benchmark.reference.field import F64, F128
    from benchmark.reference.proof import Options
    from benchmark.reference.verifier import conjectured_security

    trace = build_chain_trace([1, 2, 3, 4, 5, 6, 7, 8], 32)
    proof = RescueChainProver(options(CHAIN), Blake3_256).prove(1, [trace], device="cpu")
    assert conjectured_security(F64, Options(CHAIN["options"]), 256, 32) == \
        proof.security_level_conjectured(128)
    assert conjectured_security(F64, Options(CHAIN["options"]), 1 << 20, 32) == \
        CHAIN["security_bits_conjectured"] == 99
    assert conjectured_security(F128, Options(LAMPORT["options"]), 1 << 20, 24) == \
        LAMPORT["security_bits_conjectured"] == 96
