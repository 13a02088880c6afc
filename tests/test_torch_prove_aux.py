"""PyTorch port, auxiliary trace segments on f64 as a whole: perm proofs (the
permutation AIR, one aux column of a grand product in the extension field)
through parallel/full_pipeline.py prove_mesh on the CPU, byte-identical to
the JAX package's host proofs at degree 1, 2 and 3 and verified by both
packages' verifiers; golden row 5 of the JAX package's transcript matrix and
the smoke's 128-bit perm proof against their pinned digests; the device aux
builder against the JAX ``build_aux_segment``; the eager constraint phase
with aux frames, in several chunks, against the JAX
``sharded_constraint_phase`` on a one-device CPU mesh; the routing, the
memory plan's aux columns and the CLI.  Tolerance zero."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.air.air import AuxTraceRandElements as JAuxRand
from starkpack_winterfell_tpu.air.trace_info import TraceLayout as JLayout
from starkpack_winterfell_tpu.models import permutation as jperm
from starkpack_winterfell_tpu.ops import blake3 as jb3
from starkpack_winterfell_tpu.ops.backend import get_backend as j_backend
from starkpack_winterfell_tpu.parallel import full_pipeline as j_fp
from starkpack_winterfell_tpu.prover.domain import StarkDomain as JDomain

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.air.air import AuxTraceRandElements as TAuxRand
from starkpack_winterfell_tpu_torch.air.trace_info import TraceLayout as TLayout
from starkpack_winterfell_tpu_torch.models import permutation as tperm
from starkpack_winterfell_tpu_torch.ops.backend import get_backend as t_backend
from starkpack_winterfell_tpu_torch.parallel import full_pipeline as t_fp
from starkpack_winterfell_tpu_torch.parallel import streamed
from starkpack_winterfell_tpu_torch.prover.domain import StarkDomain as TDomain

import _torch_one_thread
from test_golden_transcript import GOLDEN as GOLDEN_MATRIX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINS = os.path.join(os.path.dirname(T.__file__), "golden")
JB, TB = j_backend("f64"), t_backend("f64")
P = TB.P

# name -> (instances, rows, ProofOptions); traces build_perm_trace(i + 3, rows)
# as the CLI's perm example builds them
CASES = {
    "golden-row5": (2, 64, (16, 8, 0, 2, 4, 31)),
    "deg1-2x256": (2, 256, (16, 8, 0, 1, 4, 31)),
    "quad-2x4096": (2, 4096, (16, 8, 0, 2, 4, 31)),
    "cubic-1x1024": (1, 1024, (16, 8, 0, 3, 4, 31)),
    # chip_smoke.py's aux_cubic: the 128-bit options (38 queries, grinding 16)
    "cubic128-2x4096": (2, 4096, (38, 8, 16, 3, 4, 31)),
}
# the cases pinned under starkpack_winterfell_tpu_torch/golden/
PINNED = {"golden-row5": "perm_2x64_quad", "cubic128-2x4096": "perm_2x4096_cubic128"}
_PROOFS: dict = {}


def proofs(name):
    """(JAX host proof, port proof, JAX public inputs, port public inputs),
    proved once."""
    if name not in _PROOFS:
        n, rows, opts = CASES[name]
        jtraces = [jperm.build_perm_trace(i + 3, rows) for i in range(n)]
        ttraces = [tperm.build_perm_trace(i + 3, rows) for i in range(n)]
        jprover = jperm.PermProver(J.ProofOptions(*opts), J.Blake3_256)
        tprover = tperm.PermProver(T.ProofOptions(*opts), T.Blake3_256)
        _PROOFS[name] = (jprover.prove(n, jtraces), tprover.prove(n, ttraces, device="cpu"),
                         [jprover.get_pub_inputs(t) for t in jtraces],
                         [tprover.get_pub_inputs(t) for t in ttraces])
    return _PROOFS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_proof_is_byte_identical_to_the_jax_host_proof(name):
    jproof, tproof = proofs(name)[:2]
    assert tproof.to_bytes() == jproof.to_bytes()


@pytest.mark.parametrize("name", list(CASES))
def test_each_verifier_accepts_the_other_proof(name):
    jproof, tproof, jpub, tpub = proofs(name)
    assert J.verify(jperm.PermAir, jproof.from_bytes(tproof.to_bytes()), jpub, J.Blake3_256)
    assert T.verify(tperm.PermAir, tproof.from_bytes(jproof.to_bytes()), tpub, T.Blake3_256)


@pytest.mark.parametrize("name", list(PINNED))
def test_pinned_digest_is_the_jax_host_proof(name):
    """Each pin is the sha256 of the JAX host proof's bytes, and the port's
    proof has it; golden row 5 also carries the matrix's own BLAKE3 digest
    and size."""
    jproof, tproof = proofs(name)[:2]
    data = tproof.to_bytes()
    with open(os.path.join(PINS, f"{PINNED[name]}.sha256")) as f:
        pinned = f.read().strip()
    assert hashlib.sha256(jproof.to_bytes()).hexdigest() == pinned
    assert hashlib.sha256(data).hexdigest() == pinned
    if name == "golden-row5":
        n, rows, opts = CASES[name]
        (cfg, size, digest), = [g for g in GOLDEN_MATRIX
                                if g[0][:4] == ("perm", "blake3_256", n, rows) and g[0][4:] == opts]
        assert len(data) == size and jb3.hash_bytes(data).hex() == digest


def test_tampered_a0_is_rejected_by_both_verifiers():
    jproof, tproof, jpub, tpub = proofs("quad-2x4096")
    tbad = [tpub[0], tperm.PermInputs((tpub[1].a0 + 1) % P, tpub[1].b0)]
    jbad = [jpub[0], jperm.PermInputs((jpub[1].a0 + 1) % P, jpub[1].b0)]
    with pytest.raises(T.VerifierError):
        T.verify(tperm.PermAir, tproof, tbad, T.Blake3_256)
    with pytest.raises(J.VerifierError):
        J.verify(jperm.PermAir, jproof.from_bytes(tproof.to_bytes()), jbad, J.Blake3_256)


def _gamma(deg, seed):
    vals = [int(v) for v in np.random.default_rng(seed).integers(0, P, size=deg, dtype=np.uint64)]
    return vals[0] if deg == 1 else tuple(vals)


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_aux_builder_matches_the_jax_build_aux_segment(deg):
    """The device build (sums, one batch inversion, a log-depth prefix
    product) gives the JAX host loop's column, one division a row."""
    gamma = _gamma(deg, deg)
    want = jperm.build_perm_trace(5, 256).build_aux_segment(0, [gamma])
    got = tperm.build_perm_trace(5, 256).build_aux_segment(0, [gamma], TB, "cpu")
    assert len(got) == deg and tuple(got[0][0].shape) == (1, 256)
    assert TB.limbs_to_elems(TB.emap(lambda l: l.reshape(-1), got), deg) == \
        JB.limbs_to_elems(JB.emap(lambda l: np.asarray(l).reshape(-1), want), deg)


def _stack(B, elems, shape, deg, pkg):
    comps = B.elems_to_limbs(elems, deg) if pkg == "jax" else B.elems_to_limbs(elems, deg, "cpu")
    if pkg == "jax":
        return B.emap(lambda l: np.asarray(l).reshape(shape), comps)
    return B.emap(lambda l: l.reshape(shape), comps)


def _rand(count, deg, rng):
    flat = [int(v) for v in rng.integers(0, P, size=count * deg, dtype=np.uint64)]
    return flat if deg == 1 else [tuple(flat[i * deg:(i + 1) * deg]) for i in range(count)]


@pytest.mark.parametrize("deg", [1, 2])
def test_eager_phase_with_aux_matches_the_jax_sharded_constraint_phase(deg, monkeypatch):
    """perm, 2 instances of 64 rows: ``eager_constraint_phase`` with aux
    rows, aux coefficients and the random elements, in 4 chunks
    (``EAGER_POINTS`` lowered: the next-row index of the main and the aux
    rows crosses each chunk's end and wraps at the last), against JAX
    ``sharded_constraint_phase`` on a one-device CPU mesh, on random LDE
    rows, coefficients, boundary values and final powers.  The aux groups
    merge into the main group of an equal divisor (step 0) or follow."""
    from starkpack_winterfell_tpu.parallel.mesh import make_mesh

    n, length = 2, 64
    opts = (8, 8, 0, deg, 4, 31)
    gamma = _gamma(deg, 7)
    jair = jperm.PermAir(J.TraceInfo.new_multi_segment(JLayout(2, (1,), (1,)), length),
                         jperm.PermInputs(3, 4), J.ProofOptions(*opts))
    tair = tperm.PermAir(T.TraceInfo.new_multi_segment(TLayout(2, (1,), (1,)), length),
                         tperm.PermInputs(3, 4), T.ProofOptions(*opts))
    jrand, trand = JAuxRand(), TAuxRand()
    jrand.add_segment_elements([gamma])
    trand.add_segment_elements([gamma])
    jdom, tdom = JDomain(jair, JB), TDomain(tair)
    jtemplate = jair.get_boundary_constraints(jrand, [0] * jair.context.num_assertions())
    ttemplate = tair.get_boundary_constraints(trand, [0] * tair.context.num_assertions())
    jplan = j_fp._build_plan(jair, jtemplate, jdom, deg, JB)
    jplan["w_main"], jplan["w_aux"] = 2, 1
    tplan = t_fp._build_plan(tair, ttemplate, tdom, TB, "cpu")
    assert tplan["groups"] == jplan["groups"] == [
        [("main", 0, 1), ("main", 1, 1), ("aux", 0, 1)], [("aux", 0, 1)]]
    L, ce = tdom.lde_size, tdom.ce_size
    segs = [seg for g in tplan["groups"] for seg, _, _ in g]

    rng = np.random.default_rng(13)
    rows, aux_rows = _rand(n * 2 * L, 1, rng), _rand(n * L, deg, rng)
    t_main, t_aux = _rand(n, deg, rng), _rand(n, deg, rng)
    singles = [_rand(n, 1 if seg == "main" else deg, rng) for seg in segs]
    ccs = [_rand(n, deg, rng) for _ in segs]
    gammas, fp = _rand(n, deg, rng), _rand(n, deg, rng)

    def args(B, pkg):
        return (_stack(B, rows, (n, 2, L), 1, pkg), _stack(B, aux_rows, (n, 1, L), deg, pkg),
                _stack(B, t_main, (n, 1), deg, pkg), _stack(B, t_aux, (n, 1), deg, pkg),
                [_stack(B, s, (n, 1), 1 if seg == "main" else deg, pkg)
                 for s, seg in zip(singles, segs)],
                [_stack(B, c, (n, 1), deg, pkg) for c in ccs],
                [[_stack(B, gammas, (n, 1), deg, pkg)]], _stack(B, fp, (n,), deg, pkg))

    j_rows, j_aux, j_t, j_ta, j_singles, j_ccs, j_rand, j_fp_stack = args(JB, "jax")
    call = j_fp.sharded_constraint_phase(make_mesh(1), JB, jair, jdom, deg, n, jplan)
    want = call(j_rows, j_aux, j_t, j_ta, j_singles, [], j_ccs, j_rand, j_fp_stack,
                jplan["div_tables"], jplan["periodic_tabs"])
    t_rows, t_aux_rows, t_t, t_ta, t_singles, t_ccs, t_rand, t_fp_stack = args(TB, "torch")
    monkeypatch.setattr(t_fp, "EAGER_POINTS", n * ce // 4)
    got = t_fp.eager_constraint_phase(TB, tair, tdom.ce_to_lde_blowup,
                                      tdom.trace_to_lde_blowup, tplan, t_rows, t_t,
                                      t_singles, [], t_ccs, t_fp_stack,
                                      aux=(t_aux_rows, t_ta, t_rand))
    assert len(got) == deg and tuple(got[0][0].shape) == (ce,)
    assert TB.limbs_to_elems(got, deg) == JB.limbs_to_elems(
        JB.emap(lambda l: np.asarray(l), want), deg)


def test_prove_device_routes_aux_traces_to_prove_mesh(monkeypatch):
    """Every trace with an aux segment goes to ``prove_mesh``, and the
    memory plan counts the aux column once per extension component."""
    seen = {}

    def preflight(n, w, length, blowup, el_bytes, device, d=1):
        seen["preflight"] = (n, w, length, blowup, el_bytes, d)
        raise RuntimeError("stop after the plan")

    monkeypatch.setattr(streamed, "preflight_check", preflight)
    traces = [tperm.build_perm_trace(i + 3, 64) for i in range(2)]
    prover = tperm.PermProver(T.ProofOptions(8, 8, 0, 3, 4, 31), T.Blake3_256)
    with pytest.raises(RuntimeError, match="stop after the plan"):
        prover.prove(2, traces, device="cpu")
    assert seen["preflight"] == (2, 2 + 1 * 3, 64, 8, 8, 1)


def test_default_device_raises_without_a_card():
    traces = [tperm.build_perm_trace(3, 64)]
    prover = tperm.PermProver(T.ProofOptions(8, 8, 0, 2, 4, 31), T.Blake3_256)
    with pytest.raises(RuntimeError, match="cuda"):
        prover.prove(1, traces)


def test_perm_cli_round_trip_on_the_cpu():
    cmd = [sys.executable, "-m", "starkpack_winterfell_tpu_torch.models.cli", "perm",
           "-n", "2", "-l", "64", "-e", "2", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=ROOT, **_torch_one_thread.ENV)
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "Proof verified" in r.stdout, r.stderr
