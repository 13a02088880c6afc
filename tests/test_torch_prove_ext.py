"""PyTorch port, the extension fields on both f64 pipelines: ``Prover.prove``
of starkpack_winterfell_tpu_torch with ``field_extension`` 2 and 3 on the CPU,
byte-identical to the JAX package's host proofs (numpy + C, no jit) and
verified by both packages' verifiers.

* the small-trace pipeline (prover/device.py): rows 2 (do-work 1 x 64,
  quadratic, grinding 4) and 4 (fib 2 x 256, cubic, folding 16) of the JAX
  package's golden transcript matrix, and do-work 2 x 64 at cubic with
  BLAKE3-192; a sequence assertion at quadratic and cubic; a periodic
  assertion at quadratic and cubic (and at 2^14 rows, big-trace);
* the big-trace pipeline (prover/device_big.py): a Rescue hash chain of 2^14
  rows with the 128-bit options ProofOptions(38, 8, 16, CUBIC, 4, 31), and
  two such chains aggregated with ProofOptions(28, 8, 16, QUADRATIC, 4, 31)
  with the ce domain walked in four chunks.

The proofs' sha256 are pinned under starkpack_winterfell_tpu_torch/golden/,
which ``chip_smoke.py`` checks on the card."""

import hashlib
import importlib.util
import os

import pytest

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.crypto.hashers import get_hasher as jget_hasher
from starkpack_winterfell_tpu.models import rescue_chain as jrc
from starkpack_winterfell_tpu.models.cli import get_example as jget_example
from starkpack_winterfell_tpu.ops import blake3 as jb3

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.models import rescue_chain as trc
from starkpack_winterfell_tpu_torch.models.cli import get_example as tget_example
from starkpack_winterfell_tpu_torch.prover import device_big
from starkpack_winterfell_tpu_torch.utils.convert import trace_from_u64_columns

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(os.path.dirname(T.__file__), "golden")
ROWS = 1 << 14

# name -> (example, hasher, n, -l or chain seeds, options, golden matrix row
# (from 0) or None, pin or None)
CASES = {
    "do-work-quad": ("do-work", "blake3_256", 1, 64, (16, 8, 4, 2, 4, 31), 1,
                     "do_work_1x64_quad"),
    "fib-cubic": ("fib", "blake3_256", 2, 256, (16, 8, 0, 3, 16, 31), 3, "fib_2x256_cubic"),
    # BLAKE3-192: a 24-byte digest is exactly one cubic draw
    "do-work-cubic-b192": ("do-work", "blake3_192", 2, 64, (16, 8, 2, 3, 8, 31), None, None),
    "chain-cubic128": ("rescue-chain", "blake3_256", 1, [[7] * 8], (38, 8, 16, 3, 4, 31),
                       None, "rescue14_cubic128"),
    # two instances at the bench options with quadratic, the ce domain in
    # four chunks (``_case``)
    "chain-quad-chunked": ("rescue-chain", "blake3_256", 2, [[3] * 8, list(range(1, 9))],
                           (28, 8, 16, 2, 4, 31), None, None),
}
_PROVED = {}


def _case(name):
    """Both packages' AIRs, hashers, public inputs and proofs of a case:
    traces made once by the JAX package's builders and carried across as
    numpy columns.  Proved once per test process."""
    if name not in _PROVED:
        example, hname, n, length, options, _, _ = CASES[name]
        jair, jprover_cls, jbuild = jget_example(example)
        tair, tprover_cls, _ = tget_example(example)
        if example == "rescue-chain":
            jtraces = [jrc._build_chain_trace_host(s, ROWS // 8) for s in length]
        else:
            jtraces = [jbuild(i, length) for i in range(n)]
        ttraces = [trace_from_u64_columns(t.main_columns_u64()) for t in jtraces]
        jhasher, thasher = jget_hasher(hname), T.get_hasher(hname)
        jprover = jprover_cls(J.ProofOptions(*options), jhasher)
        tprover = tprover_cls(T.ProofOptions(*options), thasher)
        old_chunk = device_big.CHUNK_SIZE
        if name == "chain-quad-chunked":
            # the ce domain (2^17) in four chunks: the per-chunk carries and the
            # end-of-domain wrap of the next-row frame run at quadratic
            device_big.CHUNK_SIZE = 1 << 15
        try:
            tproof = tprover.prove(n, ttraces, device="cpu")
        finally:
            device_big.CHUNK_SIZE = old_chunk
        _PROVED[name] = {
            "jair": jair, "tair": tair, "jhasher": jhasher, "thasher": thasher,
            "jpub": [jprover.get_pub_inputs(t) for t in jtraces],
            "tpub": [tprover.get_pub_inputs(t) for t in ttraces],
            "jproof": jprover.prove(n, jtraces),
            "tproof": tproof,
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


def test_big_trace_cases_take_the_big_trace_pipeline():
    """The chains are 2^14 rows: ``prove_device`` sends them to prove_big at
    every extension degree."""
    prover = trc.RescueChainProver(T.ProofOptions(*CASES["chain-cubic128"][4]), T.Blake3_256)
    trace = trc.build_chain_trace([1] * 8, ROWS // 8)
    air = trc.RescueChainAir(trace.get_info(), prover.get_pub_inputs(trace), prover.options())
    bt = air.get_boundary_constraints(None, [0] * air.context.num_assertions())
    for deg in (1, 2, 3):
        assert device_big.supported(air, bt, ROWS, deg)
    assert not device_big.supported(air, bt, ROWS, 4)


def _golden_matrix():
    spec = importlib.util.spec_from_file_location(
        "golden_transcript", os.path.join(HERE, "test_golden_transcript.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.GOLDEN


@pytest.mark.parametrize("name", ["do-work-quad", "fib-cubic"])
def test_proof_equals_the_golden_matrix_row(name):
    example, hname, n, length, options, row, _ = CASES[name]
    cfg, size, digest = _golden_matrix()[row]
    assert cfg == (example, hname, n, length) + options
    data = _case(name)["tproof"].to_bytes()
    assert len(data) == size
    assert jb3.hash_bytes(data).hex() == digest


@pytest.mark.parametrize("name", ["do-work-quad", "fib-cubic", "chain-cubic128"])
def test_proof_digest_is_pinned(name):
    """The pins ``chip_smoke.py`` checks on the card are the sha256 of the
    JAX package's host proofs."""
    with open(os.path.join(GOLDEN_DIR, CASES[name][6] + ".sha256")) as f:
        pinned = f.read().strip()
    assert hashlib.sha256(_case(name)["jproof"].to_bytes()).hexdigest() == pinned
    assert hashlib.sha256(_case(name)["tproof"].to_bytes()).hexdigest() == pinned


def test_cubic128_reaches_128_bits_conjectured():
    assert _case("chain-cubic128")["tproof"].security_level_conjectured() == 128


@pytest.mark.parametrize("name,where", [
    ("chain-cubic128", 0.1), ("chain-cubic128", 0.5), ("chain-cubic128", 0.9),
    ("fib-cubic", 0.5), ("do-work-quad", 0.5),
])
def test_flipped_byte_is_rejected(name, where):
    c = _case(name)
    data = bytearray(c["jproof"].to_bytes())
    data[int(len(data) * where)] ^= 0x01
    with pytest.raises((T.VerifierError, T.DeserializationError)):
        T.verify(c["tair"], c["tproof"].from_bytes(bytes(data)), c["tpub"], c["thasher"])


@pytest.mark.parametrize("name", ["chain-cubic128", "chain-quad-chunked", "do-work-quad"])
def test_wrong_public_input_is_rejected(name):
    c = _case(name)
    pub = list(c["tpub"])
    last = pub[-1]
    if name == "do-work-quad":
        pub[-1] = type(last)((last.start + 1) % T.crypto.rescue.P, last.result)
    else:
        pub[-1] = type(last)([(last.seed[0] + 1) % T.crypto.rescue.P] + last.seed[1:],
                             last.result)
    with pytest.raises(T.VerifierError):
        T.verify(c["tair"], c["tproof"], pub, c["thasher"])


@pytest.mark.parametrize("deg", [2, 3])
def test_sequence_assertion_proof_is_byte_identical(deg):
    """The do-work chain with column 0 asserted at four evenly spaced steps
    (the sequence family of tests/test_torch_prove_small.py), at quadratic
    and cubic: the sequence values stay base-field, their composition
    coefficients are extension elements."""
    from starkpack_winterfell_tpu.models import do_work as jdw
    from starkpack_winterfell_tpu_torch.models import do_work as tdw
    from test_torch_prove_small import _sequence_family

    jair, jprover_cls = _sequence_family(J, jdw.DoWorkProver, jdw.DoWorkAir)
    tair, tprover_cls = _sequence_family(T, tdw.DoWorkProver, tdw.DoWorkAir)
    options = (8, 8, 0, deg, 4, 31)
    jtraces = [jdw.build_do_work_trace(s, 64) for s in (3, 5)]
    ttraces = [trace_from_u64_columns(t.main_columns_u64()) for t in jtraces]
    jproof = jprover_cls(J.ProofOptions(*options), J.Blake3_256).prove(2, jtraces)
    tprover = tprover_cls(T.ProofOptions(*options), T.Blake3_256)
    tproof = tprover.prove(2, ttraces, device="cpu")
    assert tproof.to_bytes() == jproof.to_bytes()
    tpub = [tprover.get_pub_inputs(t) for t in ttraces]
    assert T.verify(tair, tproof, tpub, T.Blake3_256)
    bad = [tpub[0], type(tpub[1])([tpub[1].values[0]] + [7] + tpub[1].values[2:],
                                  tpub[1].result)]
    with pytest.raises(T.VerifierError):
        T.verify(tair, tproof, bad, T.Blake3_256)


def _periodic_family(pkg, base_prover, do_work_air):
    """do-work with a periodic assertion besides its two single ones:
    column 1 holds the start value on every row, asserted every 4 steps
    from step 1."""

    class PeriodicAir(do_work_air):
        def __init__(self, trace_info, pub_inputs, options):
            self.context = pkg.AirContext(
                trace_info, [pkg.TransitionConstraintDegree(3)], 3, options)
            self.start, self.result = pub_inputs.start, pub_inputs.result

        def get_assertions(self):
            return super().get_assertions() + [pkg.Assertion.periodic(1, 1, 4, self.start)]

    class PeriodicProver(base_prover):
        air_class = PeriodicAir

    return PeriodicAir, PeriodicProver


@pytest.mark.parametrize("deg,rows", [(2, 64), (3, 64), (3, ROWS)])
def test_periodic_assertion_proof_is_byte_identical(deg, rows):
    """A periodic assertion at quadratic and cubic, on the small-trace
    pipeline (64 rows) and on the big-trace one (2^14 rows)."""
    from starkpack_winterfell_tpu.models import do_work as jdw
    from starkpack_winterfell_tpu_torch.models import do_work as tdw

    jair, jprover_cls = _periodic_family(J, jdw.DoWorkProver, jdw.DoWorkAir)
    tair, tprover_cls = _periodic_family(T, tdw.DoWorkProver, tdw.DoWorkAir)
    options = (8, 8, 0, deg, 4, 31)
    jtraces = [jdw.build_do_work_trace(s, rows) for s in (3, 5)]
    ttraces = [trace_from_u64_columns(t.main_columns_u64()) for t in jtraces]
    jproof = jprover_cls(J.ProofOptions(*options), J.Blake3_256).prove(2, jtraces)
    tprover = tprover_cls(T.ProofOptions(*options), T.Blake3_256)
    tproof = tprover.prove(2, ttraces, device="cpu")
    assert tproof.to_bytes() == jproof.to_bytes()
    tpub = [tprover.get_pub_inputs(t) for t in ttraces]
    assert T.verify(tair, tproof, tpub, T.Blake3_256)
    bad = [tpub[0], type(tpub[1])(tpub[1].start + 1, tpub[1].result)]
    with pytest.raises(T.VerifierError):
        T.verify(tair, tproof, bad, T.Blake3_256)
