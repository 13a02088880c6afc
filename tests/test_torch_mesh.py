"""PyTorch port, the multi-rank prover: ``prove_mesh(..., mesh=)`` over 4 and
2 gloo ranks on the CPU (parallel/mesh.py; one process a rank, spawned with
a ``file://`` rendezvous under the test's temporary directory), held against
the JAX package's host proofs of the same statements and the port's
one-device proofs, byte for byte, and verified by both packages' verifiers
(the counterparts of JAX tests/test_full_pipeline_mesh.py and
tests/test_parallel.py).  Tolerance zero.

Each spawn proves every case of its list in one group; the ranks write
their bytes (tests/_torch_mesh_ranks.py) and the tests read them."""

import functools
import os
import pickle
import sys

import pytest
import torch
import torch.multiprocessing as mp

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.air import AirContext, Assertion, TransitionConstraintDegree
from starkpack_winterfell_tpu.models import do_work as jdw
from starkpack_winterfell_tpu.models import fib_multifield as jfib
from starkpack_winterfell_tpu.models import permutation as jperm
from starkpack_winterfell_tpu.ops.limb_field import F128 as JF128

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.crypto.merkle import MerkleTree
from starkpack_winterfell_tpu_torch.ops import ntt
from starkpack_winterfell_tpu_torch.ops.backend import get_backend
from starkpack_winterfell_tpu_torch.parallel import full_pipeline

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_mesh_ranks as ranks  # noqa: E402

# the counterparts of every test of JAX tests/test_full_pipeline_mesh.py
# that proves on the CPU, and a folding factor of 2 (FRI layers on every
# rank alike), over 4 ranks; a subset over 2, n = 3 among them
FOUR_RANK_CASES = ["do_work_8", "do_work_8_quad", "do_work_3", "perm_2_quad",
                   "fib_f128_sha3", "fib_f62", "fib_f128_four_step", "seq_do_work",
                   "do_work_fold2"]
TWO_RANK_CASES = ["do_work_3", "perm_2_quad", "fib_f128_sha3", "do_work_fold2"]


class SeqPub:
    def __init__(self, start, result, seq):
        self.start, self.result, self.seq = start, result, list(seq)

    def to_elements(self):
        return [self.start, self.result] + self.seq


class JSeqDoWorkAir(jdw.DoWorkAir):
    def __init__(self, trace_info, pub_inputs, options):
        self.context = AirContext(trace_info, [TransitionConstraintDegree(3)], 3, options)
        self.start = pub_inputs.start
        self.result = pub_inputs.result
        self.seq = pub_inputs.seq

    def get_assertions(self):
        last = self.trace_length() - 1
        return [Assertion.single(0, 0, self.start), Assertion.single(0, last, self.result),
                Assertion.sequence(0, 1, ranks.SEQ_STRIDE, self.seq)]


class JSeqDoWorkProver(jdw.DoWorkProver):
    air_class = JSeqDoWorkAir

    def get_pub_inputs(self, trace):
        last = trace.length - 1
        seq = [trace.get(0, 1 + i * ranks.SEQ_STRIDE)
               for i in range(trace.length // ranks.SEQ_STRIDE)]
        return SeqPub(trace.get(0, 0), trace.get(0, last), seq)


def _jfib(field, hasher, options, rows, n=2):
    air, build, prover_cls, _ = jfib.get_fib_family(field)
    return air, prover_cls(J.ProofOptions(*options), hasher), [build(rows) for _ in range(n)]


# the same statements in the JAX package: name -> () -> (AIR, prover, traces)
J_CASES = {
    "do_work_8": lambda: (jdw.DoWorkAir,
                          jdw.DoWorkProver(J.ProofOptions(16, 8, 0, 1, 4, 7), J.Blake3_256),
                          [jdw.build_do_work_trace(i + 1, 16) for i in range(8)]),
    "do_work_8_quad": lambda: (jdw.DoWorkAir,
                               jdw.DoWorkProver(J.ProofOptions(16, 8, 0, 2, 4, 7), J.Blake3_256),
                               [jdw.build_do_work_trace(i + 5, 16) for i in range(8)]),
    "do_work_3": lambda: (jdw.DoWorkAir,
                          jdw.DoWorkProver(J.ProofOptions(16, 8, 0, 1, 4, 7), J.Blake3_256),
                          [jdw.build_do_work_trace(i + 2, 16) for i in range(3)]),
    "perm_2_quad": lambda: (jperm.PermAir,
                            jperm.PermProver(J.ProofOptions(16, 8, 0, 2, 4, 7), J.Blake3_256),
                            [jperm.build_perm_trace(i + 1, 16) for i in range(2)]),
    "fib_f128_sha3": lambda: _jfib("f128", J.Sha3_256, (16, 8, 0, 1, 4, 3), 16),
    "fib_f62": lambda: _jfib("f62", J.Blake3_256, (16, 8, 0, 1, 4, 3), 16),
    "fib_f128_four_step": lambda: _jfib("f128", J.Sha3_256, (8, 8, 0, 1, 4, 3), 256),
    "do_work_fold2": lambda: (jdw.DoWorkAir,
                              jdw.DoWorkProver(J.ProofOptions(16, 8, 0, 1, 2, 7), J.Blake3_256),
                              [jdw.build_do_work_trace(i + 7, 32) for i in range(4)]),
    "seq_do_work": lambda: (JSeqDoWorkAir,
                            JSeqDoWorkProver(J.ProofOptions(16, 8, 0, 1, 4, 7), J.Blake3_256),
                            [jdw.build_do_work_trace(i + 3, 16) for i in range(2)]),
}


@functools.lru_cache(maxsize=None)
def references(name):
    """(the JAX host proof, the port's (AIR, prover, traces, one-device
    proof)) of a case."""
    jair, jprover, jtraces = J_CASES[name]()
    old = JF128.MAX_NTT_TILE
    if name == "fib_f128_four_step":  # as the JAX package's own test (:104)
        JF128.MAX_NTT_TILE = ranks.FOUR_STEP_CAP
    try:
        jproof = jprover.prove(len(jtraces), jtraces)
    finally:
        JF128.MAX_NTT_TILE = old
    return jproof, ranks.prove_case(name)


def _spawn(tmp_path, size, cases, pieces):
    init = "file://" + str(tmp_path / "rendezvous")
    mp.spawn(ranks.rank_main, args=(size, init, cases, str(tmp_path), pieces),
             nprocs=size, join=True)
    out = []
    for r in range(size):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mesh4"), 4, FOUR_RANK_CASES, False)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mesh2"), 2, TWO_RANK_CASES, True)


def _check(results, name):
    """Every rank's bytes are equal, equal the JAX host proof and the port's
    one-device proof, and both packages' verifiers accept them."""
    got = [r[name] for r in results]
    assert all(g == got[0] for g in got)
    jproof, (air, prover, traces, tproof) = references(name)
    assert got[0] == jproof.to_bytes() == tproof.to_bytes()
    assert T.verify(air, tproof.from_bytes(got[0]),
                    [prover.get_pub_inputs(t) for t in traces], prover.hasher)
    jair, jprover, jtraces = J_CASES[name]()
    assert J.verify(jair, jproof.from_bytes(got[0]),
                    [jprover.get_pub_inputs(t) for t in jtraces], jprover.hasher)


@pytest.mark.parametrize("name", FOUR_RANK_CASES)
def test_four_ranks_prove_the_jax_host_bytes(four_ranks, name):
    _check(four_ranks, name)


@pytest.mark.parametrize("name", TWO_RANK_CASES)
def test_two_ranks_prove_the_jax_host_bytes(two_ranks, name):
    _check(two_ranks, name)


def test_a_rank_holds_its_share_of_the_p1_commit(two_ranks):
    """JAX :278: a rank's P1 shard holds n_pad/d instances of coefficients
    and L/d rows of every instance's LDE, and its leaves are its L/d rows;
    the root equals the one-device commit's."""
    n, w, length, blowup = ranks.SHARD
    d, L = len(two_ranks), length * blowup
    B = get_backend("f64")
    _, _, levels = full_pipeline.sharded_segment_commit(
        B, T.Blake3_256, ((ranks.shard_inputs(),),), blowup, 7, 1)
    want = MerkleTree(levels, T.Blake3_256).root()
    for r in two_ranks:
        p = r["pieces"]
        assert p["polys_shape"] == (n // d, w, length)
        assert p["rows_shape"] == (n, w, L // d)
        assert p["leaves_shape"][0] == L // d
        assert p["root"] == want


def test_sharded_trace_commitment_matches_the_one_device_root(two_ranks):
    """JAX tests/test_parallel.py: the combined-row commitment of traces
    split by instance over the ranks is the one-device root."""
    _, _, length, blowup = ranks.SHARD
    B = get_backend("f64")
    _, _, levels = full_pipeline.sharded_segment_commit(
        B, T.Blake3_256, ((ranks.shard_inputs(),),), blowup, 7, 1)
    want = MerkleTree(levels, T.Blake3_256).root()
    assert [r["pieces"]["commitment"] for r in two_ranks] == [want] * len(two_ranks)


def test_sharded_ntt_matches_the_one_device_transform(two_ranks):
    """JAX tests/test_parallel.py: the six-step transform over the ranks,
    its output's row-major flattening (rank r holding columns
    [r*n1/d, (r+1)*n1/d) of the (n2, n1) view) is the natural-order NTT."""
    n1, n2 = ranks.NTT
    got = torch.cat([r["pieces"]["ntt"] for r in two_ranks], dim=1).reshape(-1)
    want = ntt.ntt_components((ranks.ntt_input(),))[0]
    assert torch.equal(got, want)


def test_a_mesh_never_streams_and_checks_each_rank_share(monkeypatch):
    """JAX parallel/streamed.py:73, :84: over d > 1 ranks the gate keeps the
    one-shot path, and the preflight holds each rank's 1/d share of the
    estimate against the budget."""
    from starkpack_winterfell_tpu_torch.parallel import streamed

    args = (1, 14, 1 << 22, 8, 16, "cpu")
    demand = streamed.oneshot_peak_estimate(*args[:5])
    monkeypatch.setenv("STARKPACK_HBM_BUDGET", str(demand // 2))
    assert streamed.should_stream(*args) and streamed.should_stream(*args, d=1)
    assert not streamed.should_stream(*args, d=2)
    streamed.preflight_check(*args, d=2)  # half the estimate fits
    with pytest.raises(T.ProverError, match="a rank over 4 ranks"):
        monkeypatch.setenv("STARKPACK_HBM_BUDGET", str(demand // 8))
        streamed.preflight_check(*args, d=4)


def test_a_mesh_must_divide_blowup_and_length():
    """JAX :211: the coset LDE gives each rank blowup/d cosets of length/d
    points."""
    full_pipeline.check_mesh_divides(4, 8, 16)
    for blowup, length in ((2, 16), (8, 2)):
        with pytest.raises(T.ProverError, match="mesh size 4"):
            full_pipeline.check_mesh_divides(4, blowup, length)


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo group of this process alone (a ``file://`` rendezvous)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "rendezvous"),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_a_one_rank_mesh_is_the_one_device_pipeline(one_rank_group):
    from starkpack_winterfell_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    _, prover, traces = ranks.CASES["do_work_3"]()
    proof = full_pipeline.prove_mesh(prover, len(traces), traces, "cpu", mesh=mesh)
    assert proof.to_bytes() == references("do_work_3")[1][3].to_bytes()


def test_a_rank_on_the_default_device_raises_without_a_card(one_rank_group):
    """No CPU fallback: ``make_mesh()`` asks for the card."""
    from starkpack_winterfell_tpu_torch.parallel.mesh import make_mesh

    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
