"""PyTorch port, the limb-field slice as a whole: f128 proofs through
parallel/full_pipeline.py prove_mesh on the CPU, byte-identical to the JAX
package's HOST proofs (numpy + native C; XLA:CPU cannot compile the
Rescue128 constraint graph in reasonable time), verified by both packages'
verifiers.  Tolerance zero."""

import hashlib
import os

import numpy as np
import pytest
import torch

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.models import fib_multifield as jfib
from starkpack_winterfell_tpu.models import rescue128_chain as jr

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.models import fib_multifield as tfib
from starkpack_winterfell_tpu_torch.models import rescue128_chain as tr
from starkpack_winterfell_tpu_torch.parallel import streamed
from starkpack_winterfell_tpu_torch.prover.trace import TraceTable

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

BENCH = (28, 8, 16, 1, 4, 31)
CHEAP = (8, 8, 0, 1, 4, 31)
GOLDEN = os.path.join(os.path.dirname(T.__file__), "golden", "rescue128_12_bench.sha256")


def _rescue_case(seeds, rows, options):
    """The same statement in both packages; each builds its own trace (the
    builders are held against each other below)."""
    jtraces = [jr.build_rescue128_chain_trace(s, rows // 8) for s in seeds]
    ttraces = [tr.build_rescue128_chain_trace(s, rows // 8) for s in seeds]
    jprover = jr.Rescue128ChainProver(J.ProofOptions(*options), J.Blake3_256)
    tprover = tr.Rescue128ChainProver(T.ProofOptions(*options), T.Blake3_256)
    jproof = jprover.prove(len(seeds), jtraces)
    tproof = tprover.prove(len(seeds), ttraces, device="cpu")
    jpub = [jprover.get_pub_inputs(t) for t in jtraces]
    tpub = [tprover.get_pub_inputs(t) for t in ttraces]
    return jproof, tproof, jpub, tpub


@pytest.fixture(scope="module")
def bench_case():
    return _rescue_case([[7, 9]], 1 << 12, BENCH)


def test_rescue128_bench_proof_is_byte_identical(bench_case):
    jproof, tproof, _, _ = bench_case
    assert tproof.to_bytes() == jproof.to_bytes()


def test_each_verifier_accepts_the_other_proof(bench_case):
    jproof, tproof, jpub, tpub = bench_case
    assert J.verify(jr.Rescue128ChainAir, jproof.from_bytes(tproof.to_bytes()), jpub,
                    J.Blake3_256)
    assert T.verify(tr.Rescue128ChainAir, tproof.from_bytes(jproof.to_bytes()), tpub,
                    T.Blake3_256)


def test_tampered_public_input_is_rejected(bench_case):
    _, tproof, _, tpub = bench_case
    bad = tr.Rescue128ChainInputs([(tpub[0].seed[0] + 1) % tr.P, tpub[0].seed[1]],
                                  tpub[0].result)
    with pytest.raises(T.VerifierError):
        T.verify(tr.Rescue128ChainAir, tproof, [bad], T.Blake3_256)


@pytest.mark.parametrize("where", [0.2, 0.8])
def test_flipped_byte_is_rejected(bench_case, where):
    _, tproof, _, tpub = bench_case
    data = bytearray(tproof.to_bytes())
    data[int(len(data) * where)] ^= 0x01
    with pytest.raises((T.VerifierError, T.DeserializationError)):
        T.verify(tr.Rescue128ChainAir, tproof.from_bytes(bytes(data)), tpub, T.Blake3_256)


def test_bench_proof_digest_is_pinned(bench_case):
    _, tproof, _, _ = bench_case
    with open(GOLDEN) as f:
        assert hashlib.sha256(tproof.to_bytes()).hexdigest() == f.read().strip()


def test_two_instances_aggregate_byte_identically():
    jproof, tproof, jpub, tpub = _rescue_case([[1, 9], [2, 9]], 1 << 10, CHEAP)
    assert tproof.to_bytes() == jproof.to_bytes()
    assert T.verify(tr.Rescue128ChainAir, tproof, tpub, T.Blake3_256)
    assert J.verify(jr.Rescue128ChainAir, jproof.from_bytes(tproof.to_bytes()), jpub,
                    J.Blake3_256)
    with pytest.raises(T.VerifierError):
        T.verify(tr.Rescue128ChainAir, tproof, tpub[::-1], T.Blake3_256)


@pytest.mark.parametrize("field", ["f128", "f62"])
def test_fib_two_instances_byte_identical_and_cross_verified(field):
    jair, jbuild, jprover_cls, _ = jfib.get_fib_family(field)
    tair, tbuild, tprover_cls, _ = tfib.get_fib_family(field)
    jtraces, ttraces = [jbuild(512)] * 2, [tbuild(512)] * 2
    jprover = jprover_cls(J.ProofOptions(*CHEAP), J.Blake3_256)
    tprover = tprover_cls(T.ProofOptions(*CHEAP), T.Blake3_256)
    jproof = jprover.prove(2, jtraces)
    tproof = tprover.prove(2, ttraces, device="cpu")
    assert tproof.to_bytes() == jproof.to_bytes()
    assert J.verify(jair, jproof.from_bytes(tproof.to_bytes()),
                    [jprover.get_pub_inputs(t) for t in jtraces], J.Blake3_256)
    assert T.verify(tair, tproof.from_bytes(jproof.to_bytes()),
                    [tprover.get_pub_inputs(t) for t in ttraces], T.Blake3_256)


def test_native_chain_builder_matches_the_python_builders():
    want = jr.build_rescue128_chain_trace([3, 5], 16)
    native = tr._build_chain_trace_native([3, 5], 16)
    python = tr._build_chain_trace_python([3, 5], 16)
    for col in range(6):
        for step in range(128):
            assert native.get(col, step) == python.get(col, step) == want.get(col, step)
    assert [native.get(c, 127) for c in (0, 1)] == tr.chain_digest([3, 5], 16)


def test_trace_table_stages_f128_words():
    t = TraceTable.init([[tr.P - 1, tr.P + 5] * 4] * 3, field="f128")
    assert t.get(2, 0) == tr.P - 1 and t.get(2, 1) == 5 and t.width == 3
    t8 = TraceTable.init([[1, 2, 3, 4, 5, 6, 7, (1 << 100)]], field="f128")
    assert t8.get(0, 7) == 1 << 100 and t8.read_row(7) == [1 << 100]
    lo, hi = t8.main_segment_limbs()[0]
    assert tuple(lo.shape) == (1, 8) and int(hi[0, 7]) == 1 << 36
    pair = TraceTable.from_u64_pairs(np.array([[1] * 8], dtype=np.uint64),
                                     np.array([[2] * 8], dtype=np.uint64), "f128")
    assert pair.get(0, 3) == (2 << 64) + 1


@pytest.mark.parametrize("case", ["quadratic", "streaming", "unequal"])
def test_unsupported_limb_configs_raise(case, monkeypatch):
    """f128 proves up to quadratic (tests/test_torch_prove_limb_ext.py): the
    "quadratic" case asks for the degree above it, cubic, which f128 does
    not have, and gets the reference's assertion."""
    options = T.ProofOptions(*CHEAP)
    traces = [tr.build_rescue128_chain_trace([1, 2], 8)]
    expected = NotImplementedError
    if case == "quadratic":
        options = T.ProofOptions(8, 8, 0, T.FieldExtension.CUBIC, 4, 31)
        expected = AssertionError
    elif case == "streaming":
        monkeypatch.setattr(streamed, "budget_bytes", lambda device: 1 << 20)
    else:
        traces.append(tr.build_rescue128_chain_trace([1, 2], 16))
        expected = T.ProverError
    prover = tr.Rescue128ChainProver(options, T.Blake3_256)
    with pytest.raises(expected) as err:
        prover.prove(len(traces), traces, device="cpu")
    if case == "streaming":
        assert "queue 1(f)" in str(err.value) and "Rescue128" not in str(err.value)
        assert streamed.should_stream(1, 6, 64, 8, 16, "cpu")
