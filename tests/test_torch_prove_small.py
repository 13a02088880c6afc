"""PyTorch port, the small-trace f64 path as a whole: ``Prover.prove`` of
starkpack_winterfell_tpu_torch for traces shorter than 2^14 rows
(prover/device.py ``_generate_proof_device``) on the CPU, byte-identical to
the JAX package's host proofs (numpy, no jit) and verified by both packages'
verifiers, for do-work, fib and rescue-chain with both BLAKE3 hashers.  The
do-work 2 x 64 proof is tied to the JAX package's golden transcript matrix
and pinned by its sha256."""

import hashlib
import importlib.util
import logging
import os

import numpy as np
import pytest
import torch

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.crypto.hashers import get_hasher as jget_hasher
from starkpack_winterfell_tpu.models.cli import get_example as jget_example
from starkpack_winterfell_tpu.ops import blake3 as jb3, gl64 as jgl
from starkpack_winterfell_tpu.prover import device as jdevice
from starkpack_winterfell_tpu.prover.domain import StarkDomain as JStarkDomain

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.models.cli import get_example as tget_example
from starkpack_winterfell_tpu_torch.ops import gl64 as tgl
from starkpack_winterfell_tpu_torch.prover import device as tdevice
from starkpack_winterfell_tpu_torch.prover.domain import StarkDomain as TStarkDomain
from starkpack_winterfell_tpu_torch.utils.convert import trace_from_u64_columns

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PIN = os.path.join(os.path.dirname(T.__file__), "golden", "do_work_2x64.sha256")

# name -> (example, hasher, n, -l, (queries, blowup, grinding, ext, folding,
# remainder)); the two do-work 2 x 64 configs are rows 1 and 3 of the JAX
# package's golden matrix; do-work 1 x 8 has L = 64: FRI with no layer
CASES = {
    "do-work-b256": ("do-work", "blake3_256", 2, 64, (16, 8, 0, 1, 4, 31)),
    "do-work-b192": ("do-work", "blake3_192", 2, 64, (16, 8, 0, 1, 8, 31)),
    "fib": ("fib", "blake3_256", 1, 256, (16, 8, 0, 1, 4, 31)),
    "rescue-chain": ("rescue-chain", "blake3_256", 2, 64, (16, 8, 4, 1, 4, 31)),
    "do-work-tiny-b192": ("do-work", "blake3_192", 1, 8, (8, 8, 3, 1, 4, 31)),
}
_PROVED = {}


def _case(name):
    """Both packages' provers, traces, public inputs and proofs of a case:
    traces made once by the JAX package's trace functions and carried across as
    numpy columns.  Proved once per test process."""
    if name not in _PROVED:
        example, hname, n, length, options = CASES[name]
        jair, jprover_cls, jbuild = jget_example(example)
        tair, tprover_cls, _ = tget_example(example)
        jtraces = [jbuild(i, length) for i in range(n)]
        ttraces = [trace_from_u64_columns(t.main_columns_u64()) for t in jtraces]
        jhasher, thasher = jget_hasher(hname), T.get_hasher(hname)
        jprover = jprover_cls(J.ProofOptions(*options), jhasher)
        tprover = tprover_cls(T.ProofOptions(*options), thasher)
        _PROVED[name] = {
            "jair": jair, "tair": tair, "jhasher": jhasher, "thasher": thasher,
            "jpub": [jprover.get_pub_inputs(t) for t in jtraces],
            "tpub": [tprover.get_pub_inputs(t) for t in ttraces],
            "jproof": jprover.prove(n, jtraces),
            "tproof": tprover.prove(n, ttraces, device="cpu"),
        }
    return _PROVED[name]


@pytest.mark.parametrize("name", list(CASES))
def test_proof_is_byte_identical_to_the_host_proof(name):
    c = _case(name)
    assert c["tproof"].to_bytes() == c["jproof"].to_bytes()


@pytest.mark.parametrize("name", list(CASES))
def test_each_verifier_accepts_the_other_proof(name):
    c = _case(name)
    tdata, jdata = c["tproof"].to_bytes(), c["jproof"].to_bytes()
    assert J.verify(c["jair"], c["jproof"].from_bytes(tdata), c["jpub"], c["jhasher"])
    assert T.verify(c["tair"], c["tproof"].from_bytes(jdata), c["tpub"], c["thasher"])


def _golden_matrix():
    spec = importlib.util.spec_from_file_location(
        "golden_transcript", os.path.join(HERE, "test_golden_transcript.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GOLDEN


@pytest.mark.parametrize("name,row", [("do-work-b256", 0), ("do-work-b192", 2)])
def test_do_work_proof_equals_the_golden_matrix_row(name, row):
    example, hname, n, length, options = CASES[name]
    cfg, size, digest = _golden_matrix()[row]
    assert cfg == (example, hname, n, length) + options
    data = _case(name)["tproof"].to_bytes()
    assert len(data) == size
    assert jb3.hash_bytes(data).hex() == digest


def test_do_work_proof_digest_is_pinned():
    with open(GOLDEN_PIN) as f:
        pinned = f.read().strip()
    data = _case("do-work-b256")["tproof"].to_bytes()
    assert hashlib.sha256(data).hexdigest() == pinned


@pytest.mark.parametrize("where", [0.1, 0.5, 0.9])
def test_flipped_byte_is_rejected(where):
    c = _case("do-work-b192")
    data = bytearray(c["tproof"].to_bytes())
    data[int(len(data) * where)] ^= 0x01
    with pytest.raises((T.VerifierError, T.DeserializationError)):
        T.verify(c["tair"], c["tproof"].from_bytes(bytes(data)), c["tpub"], c["thasher"])


def test_wrong_public_input_is_rejected():
    c = _case("rescue-chain")
    pub = list(c["tpub"])
    bad = type(pub[1])([(pub[1].seed[0] + 1) % tgl.P] + pub[1].seed[1:], pub[1].result)
    with pytest.raises(T.VerifierError):
        T.verify(c["tair"], c["tproof"], [pub[0], bad], c["thasher"])


def test_phase_walls_are_logged():
    example, hname, n, length, options = CASES["fib"]
    _, prover_cls, build = tget_example(example)
    records = []

    class Collect(logging.Handler):
        def emit(self, record):
            records.append(record.args)

    logger = logging.getLogger("starkpack_winterfell_tpu_torch.prover.device")
    handler, level = Collect(level=logging.DEBUG), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.DEBUG)
    try:
        prover_cls(T.ProofOptions(*options), T.get_hasher(hname)).prove(
            1, [build(0, 64)], device="cpu")
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    assert [name.split()[0] for name, _ in records] == ["P1", "P2+3", "P4", "P5+6", "P7", "P8"]
    assert all(ms >= 0 for _, ms in records)


@pytest.mark.parametrize("case", ["cubic", "sha3", "limb-b192"])
def test_unported_configs_raise_naming_the_config(case):
    """SHA3-256 is ported on the limb path only; the limb path takes
    BLAKE3-192 and the quadratic extension, and the cubic one over f62
    (tests/test_torch_prove_limb_ext.py), but not f128 at cubic, which the
    reference does not have either (its assertion).  Auxiliary segments are
    ported (tests/test_torch_prove_aux.py); a trace that claims one its AIR's
    layout does not have (here a fib-f62 trace) is refused."""
    expected = NotImplementedError
    if case == "cubic":
        _, prover_cls, build = tget_example("fib-f128")
        prover = prover_cls(T.ProofOptions(8, 8, 0, T.FieldExtension.CUBIC, 4, 31), T.Blake3_256)
        trace, match = build(0, 64), "f128 does not support degree 3"
        expected = AssertionError
    elif case == "sha3":
        _, prover_cls, build = tget_example("do-work")
        prover = prover_cls(T.ProofOptions(8, 8, 0, 1, 4, 31), T.Sha3_256)
        trace, match = build(1, 64), "sha3_256"
    else:
        _, prover_cls, build = tget_example("fib-f62")
        prover = prover_cls(T.ProofOptions(8, 8, 0, T.FieldExtension.QUADRATIC, 4, 31),
                            T.Blake3_192)
        trace, match = build(0, 64), "builds 1 auxiliary segments, its layout has 0"
        trace.num_aux_segments = lambda: 1
        expected = T.ProverError
    with pytest.raises(expected, match=match):
        prover.prove(1, [trace], device="cpu")


# ---------------------------------------------------------------------------
# sequence assertions: the do-work chain with column 0 asserted at four
# evenly spaced steps starting from step 1
# ---------------------------------------------------------------------------


def _sequence_family(pkg, base_prover, do_work_air):
    class SeqInputs:
        def __init__(self, values, result):
            self.values, self.result = list(values), result

        def to_elements(self):
            return self.values + [self.result]

    class SeqAir(do_work_air):
        def __init__(self, trace_info, pub_inputs, options):
            self.context = pkg.AirContext(
                trace_info, [pkg.TransitionConstraintDegree(3)], 2, options)
            self.values, self.result = pub_inputs.values, pub_inputs.result

        def get_assertions(self):
            n = self.trace_length()
            return [pkg.Assertion.sequence(0, 1, n // 4, self.values),
                    pkg.Assertion.single(0, n - 1, self.result)]

    class SeqProver(base_prover):
        air_class = SeqAir

        def get_pub_inputs(self, trace):
            n = trace.length
            return SeqInputs([trace.get(0, 1 + k * (n // 4)) for k in range(4)],
                             trace.get(0, n - 1))

    return SeqAir, SeqProver


@pytest.fixture(scope="module")
def sequence_case():
    from starkpack_winterfell_tpu.models import do_work as jdw
    from starkpack_winterfell_tpu_torch.models import do_work as tdw

    jair, jprover_cls = _sequence_family(J, jdw.DoWorkProver, jdw.DoWorkAir)
    tair, tprover_cls = _sequence_family(T, tdw.DoWorkProver, tdw.DoWorkAir)
    options = (8, 8, 0, 1, 4, 31)
    jtraces = [jdw.build_do_work_trace(s, 64) for s in (3, 5)]
    ttraces = [trace_from_u64_columns(t.main_columns_u64()) for t in jtraces]
    jprover = jprover_cls(J.ProofOptions(*options), J.Blake3_256)
    tprover = tprover_cls(T.ProofOptions(*options), T.Blake3_256)
    return jair, tair, jprover, tprover, jtraces, ttraces


def test_stack_boundary_values_with_a_sequence_match_reference(sequence_case):
    jair, tair, jprover, tprover, jtraces, ttraces = sequence_case

    def stacked(pkg_device, domain_cls, air_cls, prover, traces):
        airs = [air_cls(t.get_info(), prover.get_pub_inputs(t), prover.options())
                for t in traces]
        dummy = [0] * airs[0].context.num_assertions()
        per_instance = [a.get_boundary_constraints(None, dummy) for a in airs]
        domain = domain_cls(airs[0])
        return domain.ce_size, pkg_device._stack_boundary_values(
            per_instance[0], per_instance, domain, airs[0])

    _, (jsingles, jseqs) = stacked(jdevice, JStarkDomain, jair, jprover, jtraces)
    ce, (tsingles, tseqs) = stacked(tdevice, TStarkDomain, tair, tprover, ttraces)
    assert len(tsingles) == len(jsingles) == 1 and len(tseqs) == len(jseqs) == 1
    assert np.array_equal(tgl.to_u64(tsingles[0]), jgl.to_u64(jsingles[0]))
    assert tseqs[0].shape == (2, ce)
    assert np.array_equal(tgl.to_u64(tseqs[0]), jgl.to_u64(jseqs[0]))


def test_sequence_assertion_proof_is_byte_identical(sequence_case):
    jair, tair, jprover, tprover, jtraces, ttraces = sequence_case
    jproof = jprover.prove(2, jtraces)
    tproof = tprover.prove(2, ttraces, device="cpu")
    assert tproof.to_bytes() == jproof.to_bytes()
    tpub = [tprover.get_pub_inputs(t) for t in ttraces]
    assert T.verify(tair, tproof, tpub, T.Blake3_256)
    bad = [tpub[0], type(tpub[1])([tpub[1].values[0]] + [7] + tpub[1].values[2:],
                                  tpub[1].result)]
    with pytest.raises(T.VerifierError):
        T.verify(tair, tproof, bad, T.Blake3_256)
