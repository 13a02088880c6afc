"""PyTorch port, the limb path at extension degree 2 and 3 as a whole:
f128 and f62 proofs through parallel/full_pipeline.py prove_mesh on the CPU
(the eager constraint phase wherever the constraint kernel does not apply),
byte-identical to the JAX package's host proofs and verified by both
packages' verifiers; golden rows 10 (rescue128-chain, SHA3-256, quadratic)
and 12 (merkle128, SHA3-256, quadratic) of the JAX package's transcript
matrix and the smoke's fib-f62 cubic proof against their pinned digests; the
merkle128 model and its native trace builder against the JAX model.
Tolerance zero."""

import hashlib
import os
import random

import pytest

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.models import merkle128 as jmk
from starkpack_winterfell_tpu.models import rescue128_chain as jrc
from starkpack_winterfell_tpu.models.cli import get_example as jget_example
from starkpack_winterfell_tpu.ops import blake3 as jb3

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.models import merkle128 as tmk
from starkpack_winterfell_tpu_torch.models import rescue128_chain as trc
from starkpack_winterfell_tpu_torch.models.cli import get_example as tget_example

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)
from test_golden_transcript import GOLDEN as GOLDEN_MATRIX

PINS = os.path.join(os.path.dirname(T.__file__), "golden")


def _chain_builders(pkg):
    """rescue128-chain traces with the JAX CLI's seeds [i + 1, i + 2]."""
    mod = jrc if pkg == "jax" else trc
    return lambda i, chain: mod.build_rescue128_chain_trace([i + 1, i + 2], chain)


def _builders(example):
    if example == "rescue128-chain":
        return _chain_builders("jax"), _chain_builders("torch")
    return jget_example(example)[2], tget_example(example)[2]


# name -> (example, hasher, instances, -l as the CLI takes it, ProofOptions)
CASES = {
    "golden-row10": ("rescue128-chain", "sha3_256", 1, 8, (16, 8, 0, 2, 4, 31)),
    "golden-row12": ("merkle128", "sha3_256", 1, 64, (16, 8, 0, 2, 4, 31)),
    "fib62-2x512-cubic": ("fib-f62", "blake3_256", 2, 512, (28, 8, 16, 3, 4, 31)),
    "rescue128-2x1024-quad": ("rescue128-chain", "blake3_256", 2, 128, (16, 8, 0, 2, 4, 31)),
    "fib62-2x256-cubic": ("fib-f62", "blake3_256", 2, 256, (16, 8, 0, 3, 4, 31)),
    # a 24-byte digest under a 32-byte quadratic f128 draw: the coin's short read
    "fib128-2x64-quad-b192": ("fib-f128", "blake3_192", 2, 64, (16, 8, 0, 2, 4, 31)),
    "lamport128-2x128-quad-sha3": ("lamport128", "sha3_256", 2, 128, (16, 8, 0, 2, 4, 31)),
    "merkle128-4x64": ("merkle128", "blake3_256", 4, 64, (16, 8, 0, 1, 4, 31)),
    "merkle128-4x64-quad": ("merkle128", "blake3_256", 4, 64, (16, 8, 0, 2, 4, 31)),
}
# the cases pinned under starkpack_winterfell_tpu_torch/golden/
PINNED = {"golden-row10": "rescue128_chain_1x64_quad_sha3",
          "golden-row12": "merkle128_1x64_quad_sha3",
          "fib62-2x512-cubic": "fib62_2x512_cubic"}
_PROOFS: dict = {}


def proofs(name):
    """(JAX host proof, port proof, JAX public inputs, port public inputs,
    JAX AIR, port AIR, JAX hasher, port hasher) of a case, proved once."""
    if name not in _PROOFS:
        example, hname, n, l, opts = CASES[name]
        jbuild, tbuild = _builders(example)
        jair, jprover_cls, _ = jget_example(example)
        tair, tprover_cls, _ = tget_example(example)
        jtraces = [jbuild(i, l) for i in range(n)]
        ttraces = [tbuild(i, l) for i in range(n)]
        jh, th = J.get_hasher(hname), T.get_hasher(hname)
        jprover = jprover_cls(J.ProofOptions(*opts), jh)
        tprover = tprover_cls(T.ProofOptions(*opts), th)
        _PROOFS[name] = (jprover.prove(n, jtraces), tprover.prove(n, ttraces, device="cpu"),
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
    """Each pin is the sha256 of the JAX host proof's bytes, and the port's
    proof has it; golden rows 10 and 12 also carry the matrix's own BLAKE3
    digest and size."""
    jproof, tproof = proofs(name)[:2]
    data = tproof.to_bytes()
    with open(os.path.join(PINS, f"{PINNED[name]}.sha256")) as f:
        pinned = f.read().strip()
    assert hashlib.sha256(jproof.to_bytes()).hexdigest() == pinned
    assert hashlib.sha256(data).hexdigest() == pinned
    example, hname, n, l, opts = CASES[name]
    if name.startswith("golden-row"):
        (cfg, size, digest), = [g for g in GOLDEN_MATRIX
                                if g[0][:4] == (example, hname, n, l) and g[0][4:] == opts]
        assert len(data) == size and jb3.hash_bytes(data).hex() == digest


def test_tampered_root_is_rejected():
    _, tproof, _, tpub, _, tair, _, th = proofs("merkle128-4x64-quad")
    bad = list(tpub)
    bad[2] = tmk.Merkle128Inputs([(bad[2].root[0] + 1) % tmk.P, bad[2].root[1]])
    with pytest.raises(T.VerifierError):
        T.verify(tair, tproof, bad, th)


def test_tampered_seed_is_rejected():
    _, tproof, _, tpub, _, tair, _, th = proofs("rescue128-2x1024-quad")
    bad = [tpub[0], trc.Rescue128ChainInputs([tpub[1].seed[0], tpub[1].seed[1] + 1],
                                             tpub[1].result)]
    with pytest.raises(T.VerifierError):
        T.verify(tair, tproof, bad, th)


def test_merkle128_builders_match_the_jax_model():
    """The port's python builder and its native batch builder give the JAX
    model's trace word for word, and the path's last row holds the root
    that ``compute_root128`` folds."""
    rng = random.Random(3)
    paths = []
    for index in (0b1011, 0b0110):
        leaf = [rng.randrange(tmk.P) for _ in range(2)]
        sibs = [[rng.randrange(tmk.P) for _ in range(2)] for _ in range(4)]
        paths.append((leaf, sibs, index))
    native = tmk.build_merkle128_traces(paths)
    for (leaf, sibs, index), nat in zip(paths, native):
        want = jmk.build_merkle128_trace(leaf, sibs, index)
        python = tmk.build_merkle128_trace(leaf, sibs, index)
        for col in range(tmk.TRACE_WIDTH):
            for step in range(want.length):
                assert nat.get(col, step) == python.get(col, step) == want.get(col, step)
        assert [nat.get(c, want.length - 1) for c in (0, 1)] == tmk.compute_root128(
            leaf, sibs, index) == jmk.compute_root128(leaf, sibs, index)
