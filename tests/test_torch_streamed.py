"""PyTorch port, the coset-streamed pipeline (parallel/streamed.py): proofs
forced down the streamed phases of parallel/full_pipeline.py prove_mesh with
``STARKPACK_HBM_BUDGET=1`` (as the JAX package's tests/test_streamed.py
forces them), on the CPU, byte-identical to the JAX package's HOST proofs
(``Prover.prove``: numpy + native C; never its device proofs, whose
streamed agg-512 proof is invalid, ROADMAP.md §3) and to the port's own
one-shot proofs, and verified by both packages.  The streamed phase
functions are held against the JAX package's on the same numpy-seeded
stacks.  Tolerance zero."""

import hashlib
import logging
import os

import numpy as np
import pytest
import torch

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.ops.backend import get_backend as jget_backend
from starkpack_winterfell_tpu.parallel import full_pipeline as j_fp
from starkpack_winterfell_tpu.parallel import streamed as j_st
from starkpack_winterfell_tpu.prover.domain import StarkDomain as JDomain

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.air import (
    Air,
    AirContext,
    Assertion,
    TransitionConstraintDegree,
)
from starkpack_winterfell_tpu_torch.air.trace_info import TraceInfo, TraceLayout
from starkpack_winterfell_tpu_torch.math.fieldspec import F128_SPEC
from starkpack_winterfell_tpu_torch.models import lamport128_agg as ta
from starkpack_winterfell_tpu_torch.models.fib_multifield import get_fib_family
from starkpack_winterfell_tpu_torch.ops import cons_kernel
from starkpack_winterfell_tpu_torch.ops.backend import get_backend
from starkpack_winterfell_tpu_torch.parallel import full_pipeline as t_fp
from starkpack_winterfell_tpu_torch.parallel import streamed
from starkpack_winterfell_tpu_torch.prover.domain import StarkDomain as TDomain
from starkpack_winterfell_tpu_torch.prover.trace import TraceTable

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)
import test_streamed as jt  # the JAX package's streamed AIRs

CHEAP = (16, 8, 0, 1, 4, 3)
LAMPORT = os.path.join(os.path.dirname(T.__file__), "golden", "lamport_agg_4x512_b192.sha256")
FP = F128_SPEC.P


# ---------------------------------------------------------------------------
# port copies of the JAX tests' AIRs (tests/test_streamed.py)
# ---------------------------------------------------------------------------


class StreamTestAir(Air):
    """Width-2 f128 AIR with every table kind of the streamed constraint
    phase: a periodic column, a sequence assertion at first step 1, and
    singles (JAX ``StreamTestAir``)."""

    def __init__(self, trace_info, pub_inputs, options):
        degrees = [TransitionConstraintDegree.with_cycles(1, [8]),
                   TransitionConstraintDegree(1)]
        self.context = AirContext(trace_info, degrees, 3, options, field=F128_SPEC)
        self.pub = pub_inputs

    def evaluate_transition(self, frame, periodic_values, result):
        cur, nxt = frame.current(), frame.next()
        result[0] = nxt[0] - cur[0] - periodic_values[0]
        result[1] = nxt[1] - cur[1]

    def get_assertions(self):
        L = self.trace_length()
        return [Assertion.single(0, 0, self.pub.start), Assertion.single(1, 0, self.pub.c1),
                Assertion.sequence(0, 1, L // jt.STRIDE, self.pub.seq)]

    def get_periodic_column_values(self):
        return [jt.PVALS]


def build_stream_trace(start, c1, length):
    col0 = [start % FP]
    for i in range(length - 1):
        col0.append((col0[-1] + jt.PVALS[i % 8]) % FP)
    return TraceTable.init([col0, [c1 % FP] * length], field="f128")


class StreamTestProver(T.Prover):
    air_class = StreamTestAir

    def __init__(self, options, hasher):
        self._options = options
        self.hasher = hasher

    def get_pub_inputs(self, trace):
        L = trace.length
        return jt.StreamPub(trace.get(0, 0), trace.get(1, 0),
                            [trace.get(0, 1 + i * (L // jt.STRIDE)) for i in range(jt.STRIDE)])

    def options(self):
        return self._options


class StreamAuxAir(Air):
    """f128 grand-product permutation AIR, one aux segment with one random
    element (JAX ``StreamAuxAir``)."""

    def __init__(self, trace_info, pub_inputs, options):
        self.context = AirContext(
            trace_info, [TransitionConstraintDegree(1)], 2, options,
            aux_transition_constraint_degrees=[TransitionConstraintDegree(2)],
            num_aux_assertions=2, field=F128_SPEC)
        self.a0, self.b0 = pub_inputs.a0, pub_inputs.b0

    def evaluate_transition(self, frame, periodic_values, result):
        result[0] = frame.next()[1] - frame.current()[0]

    def get_assertions(self):
        return [Assertion.single(0, 0, self.a0), Assertion.single(1, 0, self.b0)]

    def evaluate_aux_transition(self, main_frame, aux_frame, periodic_values,
                                aux_rand_elements, result):
        g = aux_rand_elements.get_segment_elements(0)[0]
        a_next, b_next = main_frame.next()[0], main_frame.next()[1]
        p, p_next = aux_frame.current()[0], aux_frame.next()[0]
        result[0] = p_next * (b_next + g) - p * (a_next + g)

    def get_aux_assertions(self, aux_rand_elements):
        gamma = aux_rand_elements.get_segment_elements(0)[0]
        fs = F128_SPEC
        first = fs.fdiv(fs.fadd(self.a0, gamma), fs.fadd(self.b0, gamma))
        return [Assertion.single(0, 0, first), Assertion.single(0, self.trace_length() - 1, 1)]


class StreamAuxTrace(TraceTable):
    def get_info(self):
        return TraceInfo.new_multi_segment(TraceLayout(2, (1,), (1,)), self.length, self.meta)

    def num_aux_segments(self):
        return 1

    def build_aux_segment(self, seg_idx, rand_elements, backend, device):
        assert seg_idx == 0
        gamma, fs = rand_elements[0], F128_SPEC
        a = [self.get(0, i) for i in range(self.length)]
        b = [self.get(1, i) for i in range(self.length)]
        p, acc = [], 1
        for i in range(self.length):
            acc = fs.fmul(acc, fs.fdiv(fs.fadd(a[i], gamma), fs.fadd(b[i], gamma)))
            p.append(acc)
        comps = backend.elems_to_limbs(p, fs.deg_of(gamma), device)
        return backend.emap(lambda l: l.reshape(1, self.length), comps)


def build_aux_trace(start, length):
    a, x = [], start % FP
    for _ in range(length):
        a.append(x)
        x = (x * x + 1) % FP
    return StreamAuxTrace.init([a, [a[-1]] + a[:-1]], field="f128")


class StreamAuxProver(T.Prover):
    air_class = StreamAuxAir

    def __init__(self, options, hasher):
        self._options = options
        self.hasher = hasher

    def get_pub_inputs(self, trace):
        return jt.AuxPub(trace.get(0, 0), trace.get(1, 0))

    def options(self):
        return self._options


# ---------------------------------------------------------------------------
# whole proves
# ---------------------------------------------------------------------------


def _case(name):
    """(JAX AIR, JAX prover, JAX traces, port AIR, port prover, port traces,
    JAX hasher, port hasher) of a named case."""
    if name in ("stream", "stream_quad"):
        opts = CHEAP if name == "stream" else CHEAP[:3] + (2,) + CHEAP[4:]
        return (jt.StreamTestAir, jt.StreamTestProver(J.ProofOptions(*opts), J.Sha3_256),
                [jt.build_stream_trace(7 + i, 11 + i, 32) for i in range(2)],
                StreamTestAir, StreamTestProver(T.ProofOptions(*opts), T.Sha3_256),
                [build_stream_trace(7 + i, 11 + i, 32) for i in range(2)],
                J.Sha3_256, T.Sha3_256)
    if name == "aux":
        return (jt.StreamAuxAir, jt.StreamAuxProver(J.ProofOptions(*CHEAP), J.Sha3_256),
                [jt.build_aux_trace(5 + i, 32) for i in range(2)],
                StreamAuxAir, StreamAuxProver(T.ProofOptions(*CHEAP), T.Sha3_256),
                [build_aux_trace(5 + i, 32) for i in range(2)], J.Sha3_256, T.Sha3_256)
    assert name == "fib62_cubic"
    from starkpack_winterfell_tpu.models.fib_multifield import get_fib_family as jfib

    opts = (16, 8, 0, 3, 4, 31)
    jair, jbuild, jprover, _ = jfib("f62")
    tair, tbuild, tprover, _ = get_fib_family("f62")
    return (jair, jprover(J.ProofOptions(*opts), J.Blake3_256), [jbuild(64)] * 2,
            tair, tprover(T.ProofOptions(*opts), T.Blake3_256), [tbuild(64)] * 2,
            J.Blake3_256, T.Blake3_256)


_PROOFS: dict = {}


def _proved(name, monkeypatch):
    """(JAX host proof, port one-shot proof, port streamed proof, the paths
    the port's two proves logged, JAX pub inputs, port pub inputs)."""
    if name not in _PROOFS:
        jair, jprover, jtraces, tair, tprover, ttraces, jh, th = _case(name)
        paths = []

        class Paths(logging.Handler):
            def emit(self, record):
                if record.msg.startswith("prove_mesh path"):
                    paths.append(record.args[0])

        logger = logging.getLogger("starkpack_winterfell_tpu_torch.prover.device")
        handler, level = Paths(), logger.level
        logger.addHandler(handler)
        logger.setLevel(logging.DEBUG)
        try:
            oneshot = tprover.prove(len(ttraces), ttraces, device="cpu")
            with monkeypatch.context() as m:
                m.setenv("STARKPACK_HBM_BUDGET", "1")
                stream = tprover.prove(len(ttraces), ttraces, device="cpu")
        finally:
            logger.removeHandler(handler)
            logger.setLevel(level)
        _PROOFS[name] = (jprover.prove(len(jtraces), jtraces), oneshot, stream, paths,
                         [jprover.get_pub_inputs(t) for t in jtraces],
                         [tprover.get_pub_inputs(t) for t in ttraces])
    return _PROOFS[name]


CASES = ["stream", "aux", "stream_quad", "fib62_cubic"]


@pytest.mark.parametrize("name", CASES)
def test_streamed_proof_is_byte_identical(name, monkeypatch):
    """stream: the kernel-5 branch per coset (degree 1, main segment; its
    plain version here); aux: the eager branch with the aux frames;
    stream_quad and fib62_cubic: the eager branch in the extensions, f128
    and f62.  The budget variable sends the prove down the streamed path,
    and only it."""
    jproof, oneshot, stream, paths = _proved(name, monkeypatch)[:4]
    assert paths == ["one-shot", "streamed"]
    assert stream.to_bytes() == jproof.to_bytes() == oneshot.to_bytes()


@pytest.mark.parametrize("name", ["stream", "aux"])
def test_each_verifier_accepts_the_other_proof(name, monkeypatch):
    jproof, _, stream, _, jpub, tpub = _proved(name, monkeypatch)
    jair, _, _, tair, _, _, jh, th = _case(name)
    assert J.verify(jair, jproof.from_bytes(stream.to_bytes()), jpub, jh)
    assert T.verify(tair, stream.from_bytes(jproof.to_bytes()), tpub, th)


def test_four_lamport_signatures_streamed_match_the_pin(monkeypatch):
    """4 Lamport+ signatures at k = 15 (512 rows x 14 f128 columns), BLAKE3-192
    and the bench options: kernel 5's branch per coset with Lamport's
    periodic columns (periods 8 and 128 over each coset) and its three
    sequence assertions, against the digest chip_smoke.py pins."""
    messages, _, sigs = ta.make_wallet(4, 15, seed=0)
    trace = ta.build_lamport128_agg_trace(messages, sigs, 15)
    prover = ta.Lamport128AggProver(T.ProofOptions(28, 8, 16, 1, 4, 31), T.Blake3_192)
    monkeypatch.setenv("STARKPACK_HBM_BUDGET", "1")
    proof = prover.prove(1, [trace], device="cpu")
    with open(LAMPORT) as f:
        assert hashlib.sha256(proof.to_bytes()).hexdigest() == f.read().strip()
    assert T.verify(ta.Lamport128AggAir, proof, [prover.get_pub_inputs(trace)], T.Blake3_192)


# ---------------------------------------------------------------------------
# the phases alone, on numpy-seeded stacks
# ---------------------------------------------------------------------------

N, LEN, W = 2, 32, 2


def _seeded(B, deg, pkg, seed=5):
    """comps (N, W, LEN) of ``deg`` from one numpy seed, as either package
    holds them."""
    rng = np.random.default_rng(seed)
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=N * W * LEN * deg, dtype=np.uint64)]
    elems = vals if deg == 1 else [tuple(vals[i * deg:(i + 1) * deg])
                                   for i in range(N * W * LEN)]
    if pkg == "jax":
        return tuple(tuple(np.asarray(l).reshape(N, W, LEN) for l in c)
                     for c in B.elems_to_limbs(elems, deg))
    return B.emap(lambda l: l.reshape(N, W, LEN), B.elems_to_limbs(elems, deg, "cpu"))


def _constraint_inputs(seed=7):
    """Port and JAX (AIRs, boundary constraints, domain, t_main, final
    powers) of StreamTestAir at N x LEN with random composition
    coefficients and final powers from one numpy seed."""
    rng = np.random.default_rng(seed)
    opts = (16, 8, 0, 1, 4, 3)
    out = {}
    for pkg, mod, prover in (("jax", jt, jt.StreamTestProver(J.ProofOptions(*opts), J.Sha3_256)),
                             ("torch", None, StreamTestProver(T.ProofOptions(*opts), T.Sha3_256))):
        build = jt.build_stream_trace if pkg == "jax" else build_stream_trace
        air_cls = jt.StreamTestAir if pkg == "jax" else StreamTestAir
        traces = [build(7 + i, 11 + i, LEN) for i in range(N)]
        out[pkg] = [air_cls(t.get_info(), prover.get_pub_inputs(t), prover.options())
                    for t in traces]
    air0 = out["torch"][0]
    cc = [[int(v) for v in rng.integers(0, 1 << 62, size=air0.context.num_assertions(),
                                      dtype=np.uint64)] for _ in range(N)]
    k = air0.context.num_main_transition_constraints()
    tm = [[int(v) for v in rng.integers(0, 1 << 62, size=k, dtype=np.uint64)] for _ in range(N)]
    fpw = [int(v) for v in rng.integers(0, 1 << 62, size=N, dtype=np.uint64)]
    return out, cc, tm, fpw


def _port_constraint_args(B, airs, cc, tm, fpw):
    domain = TDomain(airs[0])
    bounds = [a.get_boundary_constraints(None, c) for a, c in zip(airs, cc)]
    plan = t_fp._build_plan(airs[0], bounds[0], domain, B, "cpu")
    singles, seq_specs, ccs = t_fp._stack_group_values(bounds, domain, airs[0], B, 1, "cpu")
    t_main = t_fp._stack_elems(B, tm, 1, "cpu")
    fp = B.emap(lambda l: l[:, 0], t_fp._stack_elems(B, [[p] for p in fpw], 1, "cpu"))
    scal = cons_kernel.pack_scalar_bank(B, t_main, singles, ccs, fp, N, plan["K"])
    return domain, plan, singles, seq_specs, ccs, t_main, fp, scal


@pytest.mark.parametrize("deg", [1, 2])
def test_segment_commit_equals_the_one_shot_commit(deg):
    """Per-coset leaves (levels[0][r::blowup]) and every level of
    ``streamed_segment_commit`` equal ``sharded_segment_commit``'s (the
    one-shot commit the JAX package's is held against), main (degree 1)
    and aux-like (degree 2) stacks."""
    B = get_backend("f128")
    comps = _seeded(B, deg, "torch")
    polys, levels = streamed.streamed_segment_commit(B, T.Sha3_256, comps, 8, 3, deg)
    want_polys, _, want = t_fp.sharded_segment_commit(B, T.Sha3_256, comps, 8, 3, deg)
    assert all(torch.equal(a, b) for ca, cb in zip(polys, want_polys) for a, b in zip(ca, cb))
    assert len(levels) == len(want) and all(torch.equal(a, b) for a, b in zip(levels, want))


def test_constraint_kernel_equals_the_one_shot_phases():
    """The (ce,) output of ``streamed_constraint_kernel``, kernel-5 branch
    (its plain version here) and eager branch, equals the one-shot
    ``pallas_constraint_phase`` on the LDE rows of the same polys."""
    B = get_backend("f128")
    airs, cc, tm, fpw = _constraint_inputs()
    domain, plan, singles, seq_specs, ccs, t_main, fp, scal = _port_constraint_args(
        B, airs["torch"], cc, tm, fpw)
    polys, rows, _ = t_fp.sharded_segment_commit(B, T.Sha3_256, _seeded(B, 1, "torch"),
                                                 domain.trace_to_lde_blowup,
                                                 domain.domain_offset, 1)
    seq_tabs = t_fp.sequence_tables(B, seq_specs, domain.ce_size)
    want = B.limbs_to_elems(t_fp.pallas_constraint_phase(B, airs["torch"][0], domain, plan,
                                                          rows, scal, [t[0] for t in seq_tabs]), 1)
    for s in (scal, None):
        got = streamed.streamed_constraint_kernel(B, airs["torch"][0], domain, plan, polys,
                                                  t_main, singles, seq_specs, ccs, fp, scal=s)
        assert B.limbs_to_elems(got, 1) == want


@pytest.mark.slow
def test_phases_equal_the_jax_streamed_phases():
    """The port's ``streamed_segment_commit`` leaves and levels and its
    ``streamed_constraint_kernel`` output equal the JAX package's
    ``streamed_segment_commit`` and ``streamed_constraint_kernel`` on the
    same numpy-seeded stacks.  Slow: XLA:CPU compiles the JAX phases for
    about two minutes."""
    JB, TB = jget_backend("f128"), get_backend("f128")
    jcall = j_st.streamed_segment_commit(JB, J.Sha3_256, N, W, LEN, 8, 3, 1, j_fp._cached)
    jpolys, jlevels, joffs = jcall(_seeded(JB, 1, "jax"))
    tpolys, tlevels = streamed.streamed_segment_commit(TB, T.Sha3_256, _seeded(TB, 1, "torch"),
                                                       8, 3, 1)
    assert len(jlevels) == len(tlevels)
    for j, t in zip(jlevels, tlevels):
        assert np.array_equal(np.asarray(j).astype(np.int64), t.numpy())

    airs, cc, tm, fpw = _constraint_inputs()
    jair = airs["jax"][0]
    jdom = JDomain(jair, JB)
    jb = [a.get_boundary_constraints(None, c) for a, c in zip(airs["jax"], cc)]
    jplan = j_fp._build_plan(jair, jb[0], jdom, 1, JB, compact_periodic=True)
    jplan["w_main"], jplan["w_aux"] = W, None
    jsingles, jseq, jccs = j_fp._stack_group_values(jplan, jb, jdom, jair, JB, 1, seq_coeffs=True)
    jfp = tuple(tuple(l[:, 0] for l in c)
                for c in j_fp._stack_elems(JB, [[p] for p in fpw], 1))
    call = j_st.streamed_constraint_kernel(JB, jair, jdom, 1, N, jplan,
                                           [(s[1], s[2]) for s in jseq], j_fp._cached)
    want = call(jpolys, joffs, j_fp._stack_elems(JB, tm, 1), jsingles, [s[0] for s in jseq],
                jccs, jfp, jplan["div_tables"], jplan["periodic_tabs"])
    domain, plan, singles, seq_specs, ccs, t_main, fp, scal = _port_constraint_args(
        TB, airs["torch"], cc, tm, fpw)
    got = streamed.streamed_constraint_kernel(TB, airs["torch"][0], domain, plan, tpolys,
                                              t_main, singles, seq_specs, ccs, fp, scal=scal)
    assert TB.limbs_to_elems(got, 1) == JB.limbs_to_elems(
        tuple(tuple(np.asarray(l) for l in c) for c in want), 1)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------


def test_stream_gate_calibration(monkeypatch):
    """JAX ``test_stream_gate_calibration`` for the port's factor, against
    an H100's 80 GiB: Lamport+ 4096 (2^22 x 14 f128, a 7.5 GB main LDE)
    streams; Lamport+ 1024 (2^20 rows, 75 GB projected) and 64 (2^16) take
    the one-shot path.  The budget variable overrides the card's, and the
    host has no budget of its own."""
    monkeypatch.setenv("STARKPACK_HBM_BUDGET", str(80 << 30))
    assert streamed.budget_bytes("cpu") == 80 << 30
    assert streamed.should_stream(1, 14, 1 << 22, 8, 16, "cpu")
    assert not streamed.should_stream(1, 14, 1 << 20, 8, 16, "cpu")
    assert not streamed.should_stream(1, 14, 1 << 16, 8, 16, "cpu")
    assert streamed.oneshot_peak_estimate(1, 14, 1 << 20, 8, 16) == \
        streamed.ONESHOT_PEAK_FACTOR * 14 * (1 << 23) * 16
    monkeypatch.delenv("STARKPACK_HBM_BUDGET")
    assert streamed.budget_bytes("cpu") == 1 << 62
