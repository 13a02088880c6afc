"""PyTorch port, the Jive hashers RpJive64_256 and GriffinJive64_256 end to
end on the three f64 paths: do-work 1 x 32 at ProofOptions(16, 8, 0, NONE,
4, 31) with each hasher (the small-trace path; the statements of JAX
tests/test_rescue.py:130-145 and :174-188), perm 2 x 64 at quadratic with
GriffinJive64_256 (``prove_mesh`` with an auxiliary segment), each
byte-identical to the JAX package's host proof proved live, accepted by
both packages' verifiers, a tampered public input rejected by both, the
do-work digests pinned; the routing; the CLI's examples for both hashers.

The Rescue chain of 2^14 rows with the bench options, ``ProofOptions(28, 8,
16, NONE, 4, 31)``, through ``prove_big`` in two ce chunks with each hasher
(``big``, ``check_big``, ``pin_is_the_jax_host_proof`` here) is held in
test_torch_prove_rpjive_big.py and test_torch_prove_griffin_big.py, one
file a hasher (20–35 s each on one CPU thread).

The in-process proofs run with the plain sponge replaced by the port's
host C sponge, the same function (test_torch_prove_rp.py says why;
test_torch_jive_hashers.py holds the plain sponge against the JAX
package's); the CLI proves with the plain sponge itself.  Tolerance zero."""

import hashlib
import os
import re

import pytest

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.models import do_work as jdw
from starkpack_winterfell_tpu.models import permutation as jperm
from starkpack_winterfell_tpu.models import rescue_chain as jrc
from starkpack_winterfell_tpu.models.cli import get_example as jget_example
from starkpack_winterfell_tpu.ops import blake3 as jb3

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.models import do_work as tdw
from starkpack_winterfell_tpu_torch.models import permutation as tperm
from starkpack_winterfell_tpu_torch.models import rescue_chain as trc
from starkpack_winterfell_tpu_torch.models.cli import get_example as tget_example
from starkpack_winterfell_tpu_torch.prover import device as tdevice
from starkpack_winterfell_tpu_torch.prover import device_big

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)
from test_torch_prove_rp import host_sponge_and

PINS = os.path.join(os.path.dirname(T.__file__), "golden")
P64 = (1 << 64) - (1 << 32) + 1
JIVE = ("rp_jive64_256", "griffin_jive64_256")

# name -> (example, hasher, the builder's first arguments, -l, ProofOptions)
CASES = {
    "do-work-rpjive": ("do-work", "rp_jive64_256", [5], 32, (16, 8, 0, 1, 4, 31)),
    "do-work-griffin": ("do-work", "griffin_jive64_256", [9], 32, (16, 8, 0, 1, 4, 31)),
    "perm-griffin-quad": ("perm", "griffin_jive64_256", [0, 1], 64, (16, 8, 0, 2, 4, 31)),
}
PINNED = {"do-work-rpjive": "do_work_1x32_rpjive", "do-work-griffin": "do_work_1x32_griffin"}
# the 2^14 chain through prove_big: hasher -> pin
BIG_PINS = {"rp_jive64_256": "rescue14_bench_rpjive", "griffin_jive64_256": "rescue14_bench_griffin"}
BIG_OPTIONS = (28, 8, 16, 1, 4, 31)
CHAIN = 2048  # permutations: 2^14 rows
CHUNK = 1 << 16  # the ce domain of 2^17 points in two chunks
_PROOFS: dict = {}
_BIG: dict = {}


def proofs(name):
    """(JAX host proof, port proof, JAX public inputs, port public inputs,
    JAX AIR, port AIR, JAX hasher, port hasher) of a case, proved once."""
    if name not in _PROOFS:
        example, hname, args, l, opts = CASES[name]
        jair, jprover_cls, jbuild = jget_example(example)
        tair, tprover_cls, tbuild = tget_example(example)
        jtraces = [jbuild(a, l) for a in args]
        ttraces = [tbuild(a, l) for a in args]
        jh, th = J.get_hasher(hname), T.get_hasher(hname)
        jprover = jprover_cls(J.ProofOptions(*opts), jh)
        tprover = tprover_cls(T.ProofOptions(*opts), th)
        with host_sponge_and():
            tproof = tprover.prove(len(args), ttraces, device="cpu")
        _PROOFS[name] = (jprover.prove(len(args), jtraces), tproof,
                         [jprover.get_pub_inputs(t) for t in jtraces],
                         [tprover.get_pub_inputs(t) for t in ttraces], jair, tair, jh, th)
    return _PROOFS[name]


def _tamper(name, pub, pkg):
    """A public input of the case changed by one."""
    p = pub[-1]
    if name.startswith("do-work"):
        mod = jdw if pkg == "jax" else tdw
        return pub[:-1] + [mod.PublicInputs(p.start, (p.result + 1) % P64)]
    mod = jperm if pkg == "jax" else tperm
    return pub[:-1] + [mod.PermInputs((p.a0 + 1) % P64, p.b0)]


@pytest.mark.parametrize("name", list(CASES))
def test_proof_is_byte_identical_to_the_jax_host_proof(name):
    jproof, tproof = proofs(name)[:2]
    assert tproof.to_bytes() == jproof.to_bytes()


@pytest.mark.parametrize("name", list(CASES))
def test_each_verifier_accepts_the_other_proof(name):
    jproof, tproof, jpub, tpub, jair, tair, jh, th = proofs(name)
    assert J.verify(jair, jproof.from_bytes(tproof.to_bytes()), jpub, jh)
    assert T.verify(tair, tproof.from_bytes(jproof.to_bytes()), tpub, th)


@pytest.mark.parametrize("name", list(CASES))
def test_tampered_public_inputs_are_rejected_by_both_verifiers(name):
    jproof, tproof, jpub, tpub, jair, tair, jh, th = proofs(name)
    with pytest.raises(T.VerifierError):
        T.verify(tair, tproof, _tamper(name, tpub, "torch"), th)
    with pytest.raises(J.VerifierError):
        J.verify(jair, jproof, _tamper(name, jpub, "jax"), jh)


@pytest.mark.parametrize("name", list(PINNED))
def test_pinned_digest_is_the_jax_host_proof(name):
    jproof, tproof = proofs(name)[:2]
    with open(os.path.join(PINS, f"{PINNED[name]}.sha256")) as f:
        pinned = f.read().strip()
    assert hashlib.sha256(jproof.to_bytes()).hexdigest() == pinned
    assert hashlib.sha256(tproof.to_bytes()).hexdigest() == pinned


def big(hname):
    """(port proof, port public inputs, prove_big calls) of the 2^14 chain
    with a Jive hasher, proved once."""
    if hname not in _BIG:
        calls = []

        def prove_big(*args, _inner=device_big.prove_big):
            calls.append(args[1])
            return _inner(*args)

        traces = [trc.build_chain_trace([1] * 8, CHAIN)]
        prover = trc.RescueChainProver(T.ProofOptions(*BIG_OPTIONS), T.get_hasher(hname))
        with host_sponge_and(CHUNK_SIZE=CHUNK, prove_big=prove_big):
            proof = prover.prove(1, traces, device="cpu")
        _BIG[hname] = (proof, [prover.get_pub_inputs(t) for t in traces], calls)
    return _BIG[hname]


def _jax_parse(data: bytes, n: int):
    shell = J.StarkProof.__new__(J.StarkProof)
    shell.contexts, shell.ood_frames = [None] * n, [None] * n
    return shell.from_bytes(data)


def check_big(hname):
    """prove_big in two ce chunks: the pinned bytes (a grinding-16 nonce from
    the C search among them), accepted by both verifiers."""
    proof, pub, calls = big(hname)
    assert calls == [1] and (8 * 8 * (CHAIN * 8)) // CHUNK > 1
    data = proof.to_bytes()
    with open(os.path.join(PINS, f"{BIG_PINS[hname]}.sha256")) as f:
        assert hashlib.sha256(data).hexdigest() == f.read().strip()
    th, jh = T.get_hasher(hname), J.get_hasher(hname)
    jpub = [jrc.ChainInputs(p.seed, p.result) for p in pub]
    assert T.verify(trc.RescueChainAir, proof.from_bytes(data), pub, th)
    assert J.verify(jrc.RescueChainAir, _jax_parse(data, 1), jpub, jh)


def pin_is_the_jax_host_proof(hname):
    """The JAX package's host prove of the 2^14 chain: its bytes are the
    port's, and their sha256 is the pin."""
    _, jprover, jbuild = jget_example("rescue-chain")
    data = jprover(J.ProofOptions(*BIG_OPTIONS), J.get_hasher(hname)).prove(
        1, [jbuild(0, CHAIN)]).to_bytes()
    assert data == big(hname)[0].to_bytes()
    with open(os.path.join(PINS, f"{BIG_PINS[hname]}.sha256")) as f:
        assert hashlib.sha256(data).hexdigest() == f.read().strip()


def test_prove_device_routes_the_jive_hashers(monkeypatch):
    """Both hashers take the small-trace path below 2^14 rows, the big-trace
    path from there up and prove_mesh with an auxiliary segment; the limb
    path refuses them."""
    from starkpack_winterfell_tpu_torch.parallel import full_pipeline

    seen = []
    monkeypatch.setattr(tdevice, "_generate_proof_device", lambda *a: seen.append("small"))
    monkeypatch.setattr(device_big, "prove_big", lambda *a: seen.append("big"))
    monkeypatch.setattr(full_pipeline, "prove_mesh", lambda *a: seen.append("mesh"))
    _, dw_prover, dw_build = tget_example("do-work")
    _, chain_prover, chain_build = tget_example("rescue-chain")
    _, perm_prover, perm_build = tget_example("perm")
    _, fib_prover, fib_build = tget_example("fib-f62")
    opts = T.ProofOptions(16, 8, 0, 1, 4, 31)
    for hname in JIVE:
        h = T.get_hasher(hname)
        dw_prover(opts, h).prove(1, [dw_build(1, 32)], device="cpu")
        chain_prover(opts, h).prove(1, [chain_build(0, CHAIN)], device="cpu")
        perm_prover(opts, h).prove(1, [perm_build(0, 64)], device="cpu")
        with pytest.raises(NotImplementedError, match="rp62_248"):
            fib_prover(opts, h).prove(1, [fib_build(0, 64)], device="cpu")
    assert seen == ["small", "big", "mesh"] * 2


# the CLI's examples of the two hashers, proved with the plain sponge
CLI_RUNS = [["do-work", "-n", "1", "-l", "32", "--hash", h] for h in JIVE]


def test_cli_examples_on_the_cpu_prove_what_the_c_sponge_proves(capsys):
    """The port's CLI example of each hasher (do-work 1 x 32), proving on
    the CPU with the plain sponge, round-tripping and verifying; each
    printed proof digest is that of the port's proof of the same
    configuration (the CLI's defaults: 32 queries, folding 8) with the host
    C sponge, the sponge whose proofs the cases above hold against the JAX
    package's."""
    from starkpack_winterfell_tpu_torch.models.cli import main

    for args in CLI_RUNS:
        main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("Proof verified") == len(CLI_RUNS)
    want = []
    _, prover_cls, build = tget_example("do-work")
    for args in CLI_RUNS:
        with host_sponge_and():
            proof = prover_cls(T.ProofOptions(32, 8, 0, 1, 8, 31), T.get_hasher(args[-1])).prove(
                1, [build(0, 32)], device="cpu")
        want.append(jb3.hash_bytes(proof.to_bytes()).hex())
    assert re.findall(r"Proof hash \(blake3\): ([0-9a-f]{64})", out) == want
