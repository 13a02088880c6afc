"""PyTorch port, the algebraic hashers end to end: proofs under Rp64_256
(f64: the small-trace path and ``prove_big``) and Rp62_248 (f62:
``prove_mesh``), and the f64 models that use Rescue-Prime (rescue-chain-pad,
lamport, merkle) and SHA3-256 on f64, each byte-identical to the JAX
package's host proof and accepted by both packages' verifiers (the 2^14
chain through ``prove_big`` is test_torch_prove_rp_big.py); golden rows
6, 7 and 8 against their pins; tampered public inputs rejected by both
verifiers; the routing; the CLI.  Tolerance zero.

The words API on CPU tensors is the plain sponge
(``ops/rescue_sponge.py:rescue_sponge_plain``): ~30k eager tensor ops a call,
~0.2 s on one CPU thread, ~100 calls a small proof.  So the in-process
proofs run with the plain sponge replaced by the port's host C sponge
(``_host_sponge``), the same function: test_torch_rescue_hashers.py holds
the plain sponge against the JAX package's, and the CLI round trips below
prove with the plain sponge itself, their proof digests held against the
JAX host proofs of the same configurations."""

import contextlib
import hashlib
import os
import random
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.models import lamport as jlam
from starkpack_winterfell_tpu.models import merkle as jmerkle
from starkpack_winterfell_tpu.models import rescue_chain as jrc
from starkpack_winterfell_tpu.models import rescue_chain_pad as jpad
from starkpack_winterfell_tpu.models.cli import get_example as jget_example
from starkpack_winterfell_tpu.ops import blake3 as jb3

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.crypto.rescue import Rp64_256
from starkpack_winterfell_tpu_torch.crypto.rescue62 import Rp62_248
from starkpack_winterfell_tpu_torch.models import lamport as tlam
from starkpack_winterfell_tpu_torch.models import merkle as tmerkle
from starkpack_winterfell_tpu_torch.models import rescue_chain as trc
from starkpack_winterfell_tpu_torch.models import rescue_chain_pad as tpad
from starkpack_winterfell_tpu_torch.models.cli import get_example as tget_example
from starkpack_winterfell_tpu_torch.ops import rescue_sponge as rsp
from starkpack_winterfell_tpu_torch.prover import device as tdevice
from starkpack_winterfell_tpu_torch.prover import device_big

import _torch_one_thread
from test_golden_transcript import GOLDEN as GOLDEN_MATRIX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PINS = os.path.join(os.path.dirname(T.__file__), "golden")
P64 = (1 << 64) - (1 << 32) + 1
MERKLE_PATH = (7, 0b1011, 4)  # (seed, leaf index, depth)


def _host_sponge(layout, x, n_elems=None, y=None):
    """``rescue_sponge_plain`` computed by the hashers' host C sponge."""
    H = T.get_hasher(layout.name)
    if y is None:
        out = H.hash_words(x.numpy()[:, : 2 * n_elems], 8 * n_elems)
    else:
        out = H.merge_words(x.numpy(), y.numpy())
    return torch.from_numpy(np.asarray(out).astype(np.int64))


@contextlib.contextmanager
def host_sponge_and(**patches):
    """The host sponge in place of the plain one, and ``patches`` of
    prover/device_big.py (``CHUNK_SIZE``, ``prove_big``), for one prove
    (test_torch_prove_rp_big.py uses the patches)."""
    saved = {k: getattr(device_big, k) for k in patches}
    plain = rsp.rescue_sponge_plain
    rsp.rescue_sponge_plain = _host_sponge
    for k, v in patches.items():
        setattr(device_big, k, v)
    try:
        yield
    finally:
        rsp.rescue_sponge_plain = plain
        for k, v in saved.items():
            setattr(device_big, k, v)


def _merkle_builders(pkg):
    mod = jmerkle if pkg == "jax" else tmerkle
    seed, index, depth = MERKLE_PATH
    rng = random.Random(seed)
    leaf = [rng.randrange(P64) for _ in range(4)]
    sibs = [[rng.randrange(P64) for _ in range(4)] for _ in range(depth)]
    return (mod.MerklePathAir, mod.MerklePathProver,
            lambda i, l: mod.build_merkle_path_trace(leaf, sibs, index))


def _pad_builders(pkg):
    """rescue-chain-pad with l live permutations in a bucket of 8."""
    mod = jpad if pkg == "jax" else tpad
    holder = {}

    def build(i, l):
        holder["n_live"] = l
        return mod.build_padded_chain_trace([i + 1] * 8, l, 8)

    return (mod.RescueChainPadAir,
            lambda options, hasher: mod.RescueChainPadProver(options, hasher, holder["n_live"]),
            build)


def _example(pkg, example):
    if example == "merkle":
        return _merkle_builders(pkg)
    if example == "rescue-chain-pad":
        return _pad_builders(pkg)
    return (jget_example if pkg == "jax" else tget_example)(example)


# name -> (example, hasher, instances, -l as the CLI takes it, ProofOptions)
CASES = {
    "golden-row6": ("rescue-chain", "rp64_256", 1, 64, (16, 8, 0, 1, 4, 31)),
    "golden-row7": ("fib-f62", "rp62_248", 2, 64, (16, 8, 0, 1, 4, 31)),
    "golden-row8": ("fib-f62", "rp62_248", 1, 64, (16, 8, 2, 3, 4, 31)),
    "f64-sha3": ("rescue-chain", "sha3_256", 2, 16, (16, 8, 4, 1, 4, 31)),
    "pad-5-in-8": ("rescue-chain-pad", "rp64_256", 1, 5, (16, 8, 0, 1, 4, 31)),
    "lamport-k7": ("lamport", "sha3_256", 2, 64, (16, 8, 0, 1, 4, 31)),
    "merkle-depth4": ("merkle", "rp64_256", 1, 32, (16, 8, 0, 1, 4, 31)),
}
PINNED = {"golden-row6": "rescue_chain_1x64_rp64", "golden-row7": "fib62_2x64_rp62",
          "golden-row8": "fib62_1x64_cubic_rp62"}

_PROOFS: dict = {}


def proofs(name):
    """(JAX host proof, port proof, JAX public inputs, port public inputs,
    JAX AIR, port AIR, JAX hasher, port hasher) of a case, proved once."""
    if name not in _PROOFS:
        example, hname, n, l, opts = CASES[name]
        jair, jprover_cls, jbuild = _example("jax", example)
        tair, tprover_cls, tbuild = _example("torch", example)
        jtraces = [jbuild(i, l) for i in range(n)]
        ttraces = [tbuild(i, l) for i in range(n)]
        jh, th = J.get_hasher(hname), T.get_hasher(hname)
        jprover = jprover_cls(J.ProofOptions(*opts), jh)
        tprover = tprover_cls(T.ProofOptions(*opts), th)
        with host_sponge_and():
            tproof = tprover.prove(n, ttraces, device="cpu")
        _PROOFS[name] = (jprover.prove(n, jtraces), tproof,
                         [jprover.get_pub_inputs(t) for t in jtraces],
                         [tprover.get_pub_inputs(t) for t in ttraces], jair, tair, jh, th)
    return _PROOFS[name]


@pytest.mark.parametrize("name", list(CASES))
def test_proof_is_byte_identical_to_the_jax_host_proof(name):
    jproof, tproof = proofs(name)[:2]
    assert tproof.to_bytes() == jproof.to_bytes()


@pytest.mark.parametrize("name", list(CASES))
def test_each_verifier_accepts_the_other_proof(name):
    jproof, tproof, jpub, tpub, jair, tair, jh, th = proofs(name)
    assert J.verify(jair, jproof.from_bytes(tproof.to_bytes()), jpub, jh)
    assert T.verify(tair, tproof.from_bytes(jproof.to_bytes()), tpub, th)


@pytest.mark.parametrize("name", list(PINNED))
def test_pinned_digest_is_the_jax_host_proof(name):
    """Each pin is the sha256 of the JAX host proof's bytes, the port's
    proof has it, and both carry the golden matrix's size and BLAKE3
    digest."""
    jproof, tproof = proofs(name)[:2]
    data = tproof.to_bytes()
    with open(os.path.join(PINS, f"{PINNED[name]}.sha256")) as f:
        pinned = f.read().strip()
    assert hashlib.sha256(jproof.to_bytes()).hexdigest() == pinned
    assert hashlib.sha256(data).hexdigest() == pinned
    example, hname, n, l, opts = CASES[name]
    (cfg, size, digest), = [g for g in GOLDEN_MATRIX
                            if g[0][:4] == (example, hname, n, l) and g[0][4:] == opts]
    assert len(data) == size and jb3.hash_bytes(data).hex() == digest


def _tamper(name, pub, pkg):
    """A public input of the case changed by one."""
    p = pub[-1]
    if name == "golden-row6":
        mod = jrc if pkg == "jax" else trc
        return pub[:-1] + [mod.ChainInputs([(p.seed[0] + 1) % P64] + p.seed[1:], p.result)]
    if name == "golden-row7":
        return pub[:-1] + [type(p)((p.result + 1) % 4611624995532046337)]
    if name == "pad-5-in-8":
        return [type(p)(p.seed, p.result, p.n_live + 1)]
    if name == "lamport-k7":
        return pub[:-1] + [type(p)(p.message ^ 1, p.pub_key)]
    return [type(p)([(p.root[0] + 1) % P64] + p.root[1:])]


@pytest.mark.parametrize("name", ["golden-row6", "golden-row7", "pad-5-in-8", "lamport-k7",
                                  "merkle-depth4"])
def test_tampered_public_inputs_are_rejected_by_both_verifiers(name):
    jproof, tproof, jpub, tpub, jair, tair, jh, th = proofs(name)
    with pytest.raises(T.VerifierError):
        T.verify(tair, tproof, _tamper(name, tpub, "torch"), th)
    with pytest.raises(J.VerifierError):
        J.verify(jair, jproof, _tamper(name, jpub, "jax"), jh)


def test_models_build_the_jax_traces():
    """The port's builders give the JAX builders' traces word for word: the
    padded chain, the Merkle path (and its root oracle), Lamport+ (the
    batched builder on the C permutation)."""
    assert np.array_equal(tpad.build_padded_chain_trace([3] * 8, 5, 8).main_columns_u64(),
                          jpad.build_padded_chain_trace([3] * 8, 5, 8).main_columns_u64())
    tb, jb = _merkle_builders("torch")[2], _merkle_builders("jax")[2]
    assert np.array_equal(tb(0, 0).main_columns_u64(), jb(0, 0).main_columns_u64())
    seed, index, depth = MERKLE_PATH
    rng = random.Random(seed)
    leaf = [rng.randrange(P64) for _ in range(4)]
    sibs = [[rng.randrange(P64) for _ in range(4)] for _ in range(depth)]
    assert tmerkle.compute_root(leaf, sibs, index) == jmerkle.compute_root(leaf, sibs, index)
    k, messages, sigs, want = 7, [], [], []
    for i in range(3):
        secrets, pk_hashes, pub_key = tlam.keygen(k, seed=i)
        assert pub_key == jlam.keygen(k, seed=i)[2]
        message = (5 * i + 1) % (1 << k)
        messages.append(message)
        sigs.append(tlam.sign(secrets, pk_hashes, message, k))
        want.append(jlam.build_lamport_trace(message, sigs[-1], k).main_columns_u64())
    batched = [t.main_columns_u64() for t in tlam.build_lamport_traces(messages, sigs, k)]
    assert all(np.array_equal(b, w) for b, w in zip(batched, want))


def test_prove_device_routes_the_algebraic_hashers(monkeypatch):
    """Rp64_256 takes the f64 pipelines (small-trace below 2^14 rows),
    Rp62_248 the limb pipeline; f62 refuses Rp64_256 and f64 Rp62_248."""
    from starkpack_winterfell_tpu_torch.parallel import full_pipeline

    seen = []
    monkeypatch.setattr(tdevice, "_generate_proof_device", lambda *a: seen.append("small"))
    monkeypatch.setattr(full_pipeline, "prove_mesh", lambda *a: seen.append("mesh"))
    _, chain_prover, chain_build = tget_example("rescue-chain")
    _, fib_prover, fib_build = tget_example("fib-f62")
    opts = T.ProofOptions(16, 8, 0, 1, 4, 31)
    chain_prover(opts, Rp64_256).prove(1, [chain_build(0, 8)], device="cpu")
    fib_prover(opts, Rp62_248).prove(1, [fib_build(0, 64)], device="cpu")
    assert seen == ["small", "mesh"]
    with pytest.raises(NotImplementedError, match="rp62_248"):
        chain_prover(opts, Rp62_248).prove(1, [chain_build(0, 8)], device="cpu")
    with pytest.raises(NotImplementedError, match="rp64_256"):
        fib_prover(opts, Rp64_256).prove(1, [fib_build(0, 64)], device="cpu")


def test_default_device_raises_without_a_card():
    _, fib_prover, fib_build = tget_example("fib-f62")
    with pytest.raises(RuntimeError, match="cuda"):
        fib_prover(T.ProofOptions(16, 8, 0, 1, 4, 31), Rp62_248).prove(1, [fib_build(0, 64)])


# CLI round trips, proved with the plain sponge: (arguments, environment)
CLI_RUNS = [
    ["rescue-chain", "-n", "1", "-l", "1", "--hash", "rp64_256"],
    ["fib-f62", "-n", "1", "-l", "8", "--hash", "rp62_248"],
    ["rescue-chain-pad", "-n", "1", "-l", "3"],
    ["lamport", "-n", "1", "-l", "16", "--hash", "sha3_256"],
]


def _jax_cli_digest(args):
    """BLAKE3 of the JAX host proof of a CLI run's configuration (the CLI's
    defaults: 32 queries, blowup 8, no grinding, degree 1, folding 8,
    remainder 31)."""
    example, n, l, hname = args[0], int(args[2]), int(args[4]), "blake3_256"
    if "--hash" in args:
        hname = args[args.index("--hash") + 1]
    air, prover_cls, build = jget_example(example)
    traces = [build(i, l) for i in range(n)]
    proof = prover_cls(J.ProofOptions(32, 8, 0, 1, 8, 31), J.get_hasher(hname)).prove(n, traces)
    return jb3.hash_bytes(proof.to_bytes()).hex()


def test_cli_round_trips_on_the_cpu_equal_the_jax_proofs():
    """One interpreter runs the port's CLI four times (rescue-chain with
    Rp64_256, fib-f62 with Rp62_248, rescue-chain-pad, lamport with
    SHA3-256), each proving on the CPU with the plain sponge, round-tripping
    and verifying; each printed proof digest is the JAX host proof's."""
    code = ("import sys\nfrom starkpack_winterfell_tpu_torch.models.cli import main\n"
            + "".join(f"main({args + ['--device', 'cpu']!r})\n" for args in CLI_RUNS))
    env = dict(os.environ, PYTHONPATH=ROOT, **_torch_one_thread.ENV)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("Proof verified") == len(CLI_RUNS)
    digests = re.findall(r"Proof hash \(blake3\): ([0-9a-f]{64})", r.stdout)
    assert digests == [_jax_cli_digest(args) for args in CLI_RUNS]
