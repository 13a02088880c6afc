"""PyTorch port, the verifier's C tier (native/verify_scalar.c through
verifier/native_scalar.py, with the BLAKE3 of native/blake3_compress.c):

* the field core, Horner and barycentric evaluation, for the eight (field,
  extension degree) configurations, held against the port's python ints
  and against the JAX package's own C on the same numpy-seeded inputs;
* the FRI fold and remainder check on a proof of the port's FRI prover:
  accepted, and a tampered query and a tampered layer rejected with the
  JAX package's messages, by the C path and its plain version alike;
* the C DEEP composition against the python-int composition, on a
  main-only proof and on proofs with an auxiliary segment at degree 2
  and 3;
* ``verify`` carried by the C tier: with the plain versions patched to
  raise, small proofs of every field and path still verify, as the JAX
  verifier verifies them; tampers are rejected with the JAX package's
  exception class and message; a failing C library raises.

Tolerance zero: every comparison is of exact field elements or bytes."""

import numpy as np
import pytest

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.math import fieldspec as jfieldspec
from starkpack_winterfell_tpu.models import lamport128_agg as jagg
from starkpack_winterfell_tpu.models.cli import get_example as jget_example
from starkpack_winterfell_tpu.verifier import native_scalar as jns

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.air import boundary
from starkpack_winterfell_tpu_torch.crypto import merkle
from starkpack_winterfell_tpu_torch.crypto.random_coin import RandomCoin
from starkpack_winterfell_tpu_torch.fri import (
    DefaultProverChannel,
    FriOptions,
    FriVerificationError,
    FriVerifier,
    VerifierChannelFri,
)
from starkpack_winterfell_tpu_torch.fri import verifier as fri_verifier
from starkpack_winterfell_tpu_torch.fri.prover import LimbFriProver
from starkpack_winterfell_tpu_torch.math.fieldspec import FIELDS
from starkpack_winterfell_tpu_torch.models import lamport128_agg as tagg
from starkpack_winterfell_tpu_torch.models.cli import get_example as tget_example
from starkpack_winterfell_tpu_torch.ops import blake3 as b3, gl64 as tgl
from starkpack_winterfell_tpu_torch.ops.backend import get_backend
from starkpack_winterfell_tpu_torch.utils.serde import ByteWriter
from starkpack_winterfell_tpu_torch.verifier import native_scalar as ns, verifier as tverifier
from starkpack_winterfell_tpu_torch.verifier.verifier import DeepComposer

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

CONFIGS = [("f128", 1), ("f128", 2), ("f64", 1), ("f64", 2), ("f64", 3),
           ("f62", 1), ("f62", 2), ("f62", 3)]
IDS = [f"{f}-d{d}" for f, d in CONFIGS]


def _jspec(name):
    return {"f64": jfieldspec.GL64_SPEC, "f62": jfieldspec.F62_SPEC,
            "f128": jfieldspec.F128_SPEC}[name]


def _rand(rng, spec, d):
    def one():
        return (int(rng.integers(0, 1 << 63)) << 65 | int(rng.integers(1, 1 << 63))) % spec.P

    return one() if d == 1 else tuple(one() for _ in range(d))


# -- the field core ------------------------------------------------------------


@pytest.mark.parametrize("field,d", CONFIGS, ids=IDS)
def test_field_core_matches_python_ints_and_the_jax_c(field, d):
    spec = FIELDS[field]
    rng = np.random.default_rng(77 + d)
    ctx, jctx = ns.get_ctx(spec, d), jns.get_ctx(_jspec(field), d)
    edge = [1, spec.P - 1, 2]
    for i in range(12):
        a = _rand(rng, spec, d) if i >= len(edge) else spec.embed(edge[i], d) if d > 1 else edge[i]
        b = _rand(rng, spec, d)
        e = int(rng.integers(1, 1 << 62)) << int(rng.integers(0, 64))
        got = ns.test_ops(ctx, a, b, e)
        assert got == [spec.fmul(a, b), spec.fadd(a, b), spec.fsub(a, b), spec.finv(a),
                       spec.fexp(a, e)]
        assert got == jns.test_ops(jctx, a, b, e)


@pytest.mark.parametrize("field,d", CONFIGS, ids=IDS)
def test_poly_eval_matches_horner_and_the_jax_c(field, d):
    spec = FIELDS[field]
    rng = np.random.default_rng(5 + d)
    ctx, jctx = ns.get_ctx(spec, d), jns.get_ctx(_jspec(field), d)
    for n in (1, 7, 64, 1024):
        coeffs = [_rand(rng, spec, 1) for _ in range(n)]
        x = _rand(rng, spec, d)
        got = ns.poly_eval(ctx, ns.pack_base_cached(ctx, coeffs), x)
        assert got == tverifier._periodic_value_plain(coeffs, x, spec)
        assert got == jns.poly_eval(jctx, jns.pack_base_cached(jctx, coeffs), x)


@pytest.mark.parametrize("field,d", CONFIGS, ids=IDS)
def test_barycentric_eval_matches_interpolation_and_the_jax_c(field, d):
    spec = FIELDS[field]
    rng = np.random.default_rng(9 + d)
    ctx, jctx = ns.get_ctx(spec, d), jns.get_ctx(_jspec(field), d)
    for logn in (3, 8):
        n = 1 << logn
        vals = [_rand(rng, spec, 1) for _ in range(n)]
        w = spec.get_root_of_unity(logn)
        x = _rand(rng, spec, d)
        got = ns.barycentric_eval(ctx, ns.pack_base_cached(ctx, vals), w, x)
        coeffs = boundary._interpolate_subgroup(vals, spec)
        assert got == tverifier._periodic_value_plain(coeffs, x, spec)
        assert got == jns.barycentric_eval(jctx, jns.pack_base_cached(jctx, vals), w, x)
        # on a subgroup point the value itself (the degenerate divisor)
        i = int(rng.integers(0, n))
        xi = pow(w, i, spec.P)
        want = vals[i] if d == 1 else (vals[i],) + (0,) * (d - 1)
        assert ns.barycentric_eval(ctx, ns.pack_base_cached(ctx, vals), w,
                                   xi if d == 1 else spec.embed(xi, d)) == want


def test_a_parameter_error_raises():
    ctx = ns.get_ctx(FIELDS["f64"], 1)
    with pytest.raises(RuntimeError, match="vs_barycentric_eval"):
        ns.barycentric_eval(ctx, np.zeros((0, 2), dtype=np.uint64), 1, 5)


# -- the FRI fold ----------------------------------------------------------------


def _fri_roundtrip(tamper=None, plain=False):
    """A degree-127 polynomial over f64 on a 512-point coset, committed by
    the port's FRI prover on the CPU (folding 4, remainder degree 7), then
    verified through VerifierChannelFri by the C path or its plain version
    (tests/test_native_verify.py of the JAX package, on the port)."""
    trace_length, blowup = 128, 4
    options = FriOptions(blowup, 4, 7)
    domain_size = trace_length * blowup
    B = get_backend("f64")
    p = np.random.default_rng(77).integers(0, tgl.P, size=trace_length, dtype=np.uint64)
    evaluations = B.evaluate_poly_with_offset(((tgl.from_u64(p),),), 7, blowup)
    channel = DefaultProverChannel(T.Blake3_256, domain_size, 16)
    prover = LimbFriProver(options, T.Blake3_256, B)
    prover.build_layers(channel, evaluations)
    positions = channel.draw_query_positions()
    proof = prover.build_proof(positions)
    values = tgl.to_u64(evaluations[0][0])
    queried = [int(values[pos]) for pos in positions]
    if tamper == "queried":
        queried[0] = (queried[0] + 1) % tgl.P
    if tamper == "layer_bytes":
        v = bytearray(proof.layers[1].values)
        v[0] ^= 1
        proof.layers[1].values = bytes(v)
    vchannel = VerifierChannelFri(proof, channel.layer_commitments(), T.Blake3_256,
                                  domain_size, 4, 1)
    verifier = FriVerifier(vchannel, RandomCoin(T.Blake3_256, []), options,
                           trace_length - 1, 1)
    (verifier.verify_plain if plain else verifier.verify)(vchannel, queried, positions)


@pytest.mark.parametrize("plain", [False, True], ids=["c", "plain"])
def test_fri_fold_accepts(plain, monkeypatch):
    if not plain:
        monkeypatch.setattr(FriVerifier, "verify_plain",
                            lambda *a: pytest.fail("the C gate sent the fold to python"))
    _fri_roundtrip(plain=plain)


@pytest.mark.parametrize("plain", [False, True], ids=["c", "plain"])
def test_fri_fold_rejects_a_tampered_query(plain):
    with pytest.raises(FriVerificationError, match="invalid layer folding at depth 0"):
        _fri_roundtrip(tamper="queried", plain=plain)


@pytest.mark.parametrize("plain", [False, True], ids=["c", "plain"])
def test_fri_fold_rejects_a_tampered_layer(plain):
    # a flipped layer value byte breaks the Merkle opening first
    with pytest.raises(FriVerificationError, match="layer 1 Merkle verification failed"):
        _fri_roundtrip(tamper="layer_bytes", plain=plain)


# -- whole proofs ------------------------------------------------------------------

# name -> (example, hasher, instances, rows, ProofOptions); lamport128-agg
# is two signatures of 7-bit messages (128 rows)
PROOFS = {
    "do-work-b256": ("do-work", "blake3_256", 4, 64, (16, 8, 0, 1, 4, 31)),
    "do-work-b192": ("do-work", "blake3_192", 4, 64, (16, 8, 0, 1, 8, 31)),
    "fib-f128": ("fib-f128", "blake3_256", 2, 64, (16, 8, 0, 1, 4, 31)),
    "fib-f62-cubic": ("fib-f62", "blake3_256", 2, 64, (16, 8, 0, 3, 4, 31)),
    "perm-quad": ("perm", "blake3_256", 2, 64, (16, 8, 0, 2, 4, 31)),
    "perm-cubic": ("perm", "blake3_256", 2, 64, (16, 8, 0, 3, 4, 31)),
    "lamport128-agg": ("lamport128-agg", "blake3_192", 1, 128, (16, 8, 0, 1, 4, 31)),
}
_PROVED: dict = {}


def _proof(name):
    """(port AIR, port proof bytes, port pub inputs, JAX AIR, JAX pub inputs,
    instances): proved once per test process by the port on the CPU."""
    if name not in _PROVED:
        example, hname, n, rows, options = PROOFS[name]
        if example == "lamport128-agg":
            messages, _, sigs = tagg.make_wallet(2, 7, seed=3)
            ttraces = [tagg.build_lamport128_agg_trace(messages, sigs, 7)]
            jtraces = [jagg.build_lamport128_agg_trace(messages, sigs, 7,
                                                       device_builder=False)]
            tair, tprover_cls = tagg.Lamport128AggAir, tagg.Lamport128AggProver
            jair, jprover_cls = jagg.Lamport128AggAir, jagg.Lamport128AggProver
        else:
            tair, tprover_cls, tbuild = tget_example(example)
            jair, jprover_cls, jbuild = jget_example(example)
            ttraces = [tbuild(i, rows) for i in range(n)]
            jtraces = [jbuild(i, rows) for i in range(n)]
        tprover = tprover_cls(T.ProofOptions(*options), T.get_hasher(hname))
        jprover = jprover_cls(J.ProofOptions(*options), J.get_hasher(hname))
        proof = tprover.prove(n, ttraces, device="cpu")
        _PROVED[name] = (tair, proof, [tprover.get_pub_inputs(t) for t in ttraces],
                         jair, [jprover.get_pub_inputs(t) for t in jtraces], n)
    return _PROVED[name]


def _jax_verify(name, data):
    _, _, _, jair, jpub, n = _proof(name)
    shell = J.StarkProof([None] * n, None, None, None, [None] * n, None, 0)
    return J.verify(jair, shell.from_bytes(data), jpub, J.get_hasher(PROOFS[name][1]))


def _port_verify(name, data):
    tair, proof, tpub, _, _, _ = _proof(name)
    return T.verify(tair, proof.from_bytes(data), tpub, T.get_hasher(PROOFS[name][1]))


def _raise(what):
    def plain(*args, **kwargs):
        raise AssertionError(f"verify reached the plain version: {what}")

    return plain


@pytest.mark.parametrize("name", list(PROOFS))
def test_the_c_tier_carries_verify(name, monkeypatch):
    """Every plain version the C tier replaces raises; the port still
    verifies, through the C fold and the C composition, and the JAX
    verifier accepts the same bytes."""
    data = _proof(name)[1].to_bytes()
    monkeypatch.setattr(b3, "compress", _raise("the numpy BLAKE3 compression"))
    monkeypatch.setattr(merkle.BatchMerkleProof, "get_root_plain", _raise("python Merkle root"))
    monkeypatch.setattr(FriVerifier, "verify_plain", _raise("python FRI fold"))
    monkeypatch.setattr(DeepComposer, "compose_trace_columns_plain", _raise("python DEEP"))
    monkeypatch.setattr(DeepComposer, "compose_constraint_evaluations_plain",
                        _raise("python DEEP"))
    monkeypatch.setattr(tverifier, "_periodic_value_plain", _raise("python Horner"))
    monkeypatch.setattr(boundary.BoundaryConstraint, "sequence_value_plain",
                        _raise("python sequence interpolation"))
    calls = {"fold": 0, "deep": 0}

    def counted(key, fn):
        def wrap(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)

        return wrap

    monkeypatch.setattr(ns, "fold_layer", counted("fold", ns.fold_layer))
    monkeypatch.setattr(ns, "deep_combine", counted("deep", ns.deep_combine))
    assert _port_verify(name, data)
    assert calls["fold"] >= 1 and calls["deep"] == 1
    assert _jax_verify(name, data)


@pytest.mark.parametrize("name", ["fib-f62-cubic", "perm-quad", "perm-cubic",
                                  "lamport128-agg", "do-work-b256"])
def test_deep_composition_equals_the_python_composition(name, monkeypatch):
    """The C composition ``verify`` takes against the python-int one on
    the same queries."""
    seen = []
    orig = DeepComposer.compose_deep_native

    def wrap(self, main, aux, ood_main, ood_aux, cons, ood_cons):
        out = orig(self, main, aux, ood_main, ood_aux, cons, ood_cons)
        spec, d = self.fs, self.ext_deg
        t = self.compose_trace_columns_plain(main, aux, ood_main, ood_aux)
        c = self.compose_constraint_evaluations_plain(cons, ood_cons)
        want = [spec.fadd(a, b) for a, b in zip(t, c)]
        seen.append((ns.get_ctx(spec, d).unpack_elems(out) == want, len(want)))
        return out

    monkeypatch.setattr(DeepComposer, "compose_deep_native", wrap)
    assert _port_verify(name, _proof(name)[1].to_bytes())
    assert seen == [(True, PROOFS[name][4][0])]


def _ood_offset(proof):
    """The byte offset of the first OOD trace state in the proof's bytes:
    after the contexts, commitments and queries, the frame's u16 length and
    its states' u8 count."""
    w = ByteWriter()
    for part in (*proof.contexts, proof.commitments, *proof.trace_queries,
                 proof.constraint_queries):
        part.write_into(w)
    return len(w.to_bytes()) + 3


@pytest.mark.parametrize("name", ["do-work-b256", "fib-f62-cubic", "perm-quad"])
@pytest.mark.parametrize("where", ["ood", 0.35, 0.6, 0.9])
def test_a_tamper_is_rejected_as_the_jax_package_rejects_it(name, where):
    """An OOD trace state (the OOD check fails) and a byte at three places
    (query openings, FRI layers): both packages raise the same exception
    class with the same message."""
    proof = _proof(name)[1]
    data = bytearray(proof.to_bytes())
    data[_ood_offset(proof) if where == "ood" else int(len(data) * where)] ^= 0x04
    errors = []
    for check in (_port_verify, _jax_verify):
        with pytest.raises(Exception) as info:
            check(name, bytes(data))
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("name", ["do-work-b256", "fib-f62-cubic"])
def test_a_failing_c_library_raises(name, monkeypatch):
    def broken():
        raise RuntimeError("host build of verify_scalar.c failed")

    monkeypatch.setattr(ns, "get_verify_scalar", broken)
    with pytest.raises(RuntimeError, match="verify_scalar.c"):
        _port_verify(name, _proof(name)[1].to_bytes())


def test_over_1024_queries_take_the_plain_fold(monkeypatch):
    """The C library's limit of 1024 positions is a gate, decided before the
    channel is read: more go to the python loop."""
    monkeypatch.setattr(fri_verifier, "_native_verify",
                        _raise("the C fold at more than 1024 positions"))
    fv = FriVerifier.__new__(FriVerifier)
    fv.options, fv.ext_deg, fv.field = FriOptions(8, 4, 7), 1, FIELDS["f64"]
    taken = []
    monkeypatch.setattr(FriVerifier, "verify_plain", lambda self, *a: taken.append(len(a[2])))
    fv.verify(None, [0] * 1025, list(range(1025)))
    assert taken == [1025]
