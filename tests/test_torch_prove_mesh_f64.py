"""PyTorch port, kernel 5 on Goldilocks: f64 main-segment proofs through
parallel/full_pipeline.py ``prove_mesh`` on the CPU, where the constraint
kernel's gate (``_pcons_gate``) admits f64 at one rank, no aux segment and
extension degree 1, as the JAX package's does.  On CPU tensors the wrapper
``constraint_eval`` takes its plain version and launches nothing.  Each
proof is byte-identical to the JAX package's host proof and to the port's
``prove_device`` proof (the two f64 pipelines), and both packages'
verifiers accept it.  Tolerance zero.  The CUDA bodies themselves are held
against the plain version by test_torch_kernel_sources.py (g++ rehearsal)
and on the card by chip_smoke.py."""

import random

import pytest

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.models import merkle as jmerkle
from starkpack_winterfell_tpu.models import rescue_chain as jrc
from starkpack_winterfell_tpu.models.cli import get_example as jget_example

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.math.fieldspec import FIELDS
from starkpack_winterfell_tpu_torch.models import merkle as tmerkle
from starkpack_winterfell_tpu_torch.models import rescue_chain as trc
from starkpack_winterfell_tpu_torch.models.cli import get_example as tget_example
from starkpack_winterfell_tpu_torch.ops import cons_kernel
from starkpack_winterfell_tpu_torch.parallel import full_pipeline

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

P64 = (1 << 64) - (1 << 32) + 1


def _rescue(pkg):
    """JAX tests/test_cons_kernel.py:43's statement: two chains of 32
    permutations (256 rows x 12 columns, 25 periodic columns)."""
    mod = jrc if pkg == "jax" else trc
    return (mod.RescueChainAir, mod.RescueChainProver,
            lambda i, l: mod.build_chain_trace([i + 1] * 8, l // 8))


def _merkle(pkg):
    """A Merkle path of depth 4 (32 rows x 13 columns)."""
    mod = jmerkle if pkg == "jax" else tmerkle
    rng = random.Random(7)
    leaf = [rng.randrange(P64) for _ in range(4)]
    sibs = [[rng.randrange(P64) for _ in range(4)] for _ in range(4)]
    return (mod.MerklePathAir, mod.MerklePathProver,
            lambda i, l: mod.build_merkle_path_trace(leaf, sibs, 0b1011))


def _example(pkg, example):
    if example == "rescue-chain":
        return _rescue(pkg)
    if example == "merkle":
        return _merkle(pkg)
    return (jget_example if pkg == "jax" else tget_example)(example)


# name -> (example, hasher, instances, rows, ProofOptions)
CASES = {
    "rescue-chain 2x256": ("rescue-chain", "blake3_256", 2, 256, (16, 8, 0, 1, 4, 3)),
    "do-work 4x64": ("do-work", "blake3_256", 4, 64, (16, 8, 0, 1, 4, 31)),
    "lamport k7 2x64": ("lamport", "sha3_256", 2, 64, (16, 8, 0, 1, 4, 31)),
    "merkle depth4": ("merkle", "blake3_256", 1, 32, (16, 8, 0, 1, 4, 31)),
}
# the gate refuses these: (instances, rows, ProofOptions) of do-work
REFUSED_QUADRATIC = (2, 64, (16, 8, 0, 2, 4, 31))

_PROOFS: dict = {}


class _Spy:
    """Counts the calls of the constraint kernel's wrapper and of the eager
    constraint phase while it is entered."""

    def __enter__(self):
        self.kernel = self.eager = 0
        self.saved = (cons_kernel.constraint_eval, full_pipeline.eager_constraint_phase)
        kernel, eager = self.saved

        def counted_kernel(*args, **kwargs):
            self.kernel += 1
            return kernel(*args, **kwargs)

        def counted_eager(*args, **kwargs):
            self.eager += 1
            return eager(*args, **kwargs)

        cons_kernel.constraint_eval = counted_kernel
        full_pipeline.eager_constraint_phase = counted_eager
        cons_kernel.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        cons_kernel.constraint_eval, full_pipeline.eager_constraint_phase = self.saved


def _prove(example, hname, n, rows, opts):
    """(JAX host proof, port prove_mesh proof, port prove_device proof, the
    spy of the prove_mesh call, JAX and port public inputs, AIRs, hashers)."""
    jair, jprover_cls, jbuild = _example("jax", example)
    tair, tprover_cls, tbuild = _example("torch", example)
    jtraces = [jbuild(i, rows) for i in range(n)]
    ttraces = [tbuild(i, rows) for i in range(n)]
    jh, th = J.get_hasher(hname), T.get_hasher(hname)
    jprover = jprover_cls(J.ProofOptions(*opts), jh)
    tprover = tprover_cls(T.ProofOptions(*opts), th)
    with _Spy() as spy:
        mesh_proof = full_pipeline.prove_mesh(tprover, n, ttraces, "cpu")
        spy.launches = cons_kernel.LAUNCHES
    device_proof = tprover.prove(n, ttraces, device="cpu")
    return (jprover.prove(n, jtraces), mesh_proof, device_proof, spy,
            [jprover.get_pub_inputs(t) for t in jtraces],
            [tprover.get_pub_inputs(t) for t in ttraces], jair, tair, jh, th)


def proofs(name):
    if name not in _PROOFS:
        _PROOFS[name] = _prove(*CASES[name])
    return _PROOFS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_prove_mesh_runs_kernel_5_plain_and_matches_both_proofs(name):
    """The gate sent P2 to the constraint kernel's wrapper once, which took
    its plain version (no launch on the CPU) and no eager phase; the bytes
    are the JAX host proof's and ``prove_device``'s."""
    jproof, mesh_proof, device_proof, spy = proofs(name)[:4]
    assert (spy.kernel, spy.eager, spy.launches) == (1, 0, 0)
    assert mesh_proof.to_bytes() == jproof.to_bytes() == device_proof.to_bytes()


@pytest.mark.parametrize("name", list(CASES))
def test_each_verifier_accepts_the_other_proof(name):
    jproof, mesh_proof, _, _, jpub, tpub, jair, tair, jh, th = proofs(name)
    assert J.verify(jair, jproof.from_bytes(mesh_proof.to_bytes()), jpub, jh)
    assert T.verify(tair, mesh_proof.from_bytes(jproof.to_bytes()), tpub, th)


def test_quadratic_f64_prove_takes_the_eager_phase():
    """Above extension degree 1 the gate refuses f64: do-work at quadratic
    through ``prove_mesh`` runs the eager phase and not the kernel, with
    the JAX host proof's bytes."""
    jproof, mesh_proof, device_proof, spy = _prove("do-work", "blake3_256",
                                                   *REFUSED_QUADRATIC)[:4]
    assert (spy.kernel, spy.eager) == (0, 1)
    assert mesh_proof.to_bytes() == jproof.to_bytes() == device_proof.to_bytes()


@pytest.mark.parametrize("field", ["f64", "f62", "f128"])
@pytest.mark.parametrize("case", ["one rank", "aux segment", "quadratic", "two ranks"])
def test_gate_takes_f64_at_one_rank_main_segment_degree_1(case, field):
    """The JAX gate's conditions on every field it names: one rank, no aux
    segment, extension degree 1; JAX's ce % 1024 tiling is not one."""
    plan = {"has_aux": case == "aux segment"}
    ext_deg = 2 if case == "quadratic" else 1
    d = 2 if case == "two ranks" else 1
    assert full_pipeline._pcons_gate(plan, ext_deg, FIELDS[field], d) == (case == "one rank")
