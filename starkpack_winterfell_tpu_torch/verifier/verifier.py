# Copy of starkpack_winterfell_tpu/verifier/verifier.py; cut: the FieldBackend limb-array paths (the batched f64 transition evaluations, the shared OOD structure, the word-backed DEEP composer): every instance's OOD evaluation runs on python ints, and the DEEP composition runs in C at every field and degree, with the python-int one as its plain version.
"""Proof verification — equivalent of verifier/src/lib.rs + composer.rs +
evaluator.rs.  Mirrors the prover transcript step for step.

The verifier runs on the host.  Its scalar loops go through the C tier
(verifier/native_scalar.py over native/verify_scalar.c): the periodic
columns' Horner, the DEEP composition at the query points, and, in
fri/verifier.py, the FRI fold.  The AIR's vectorized ``evaluate_transition``
runs on ``ScalarFelt`` wrappers of python ints, one instance at a time."""

from __future__ import annotations

from ..air.air import AuxTraceRandElements
from ..crypto.random_coin import RandomCoin
from ..fri.verifier import FriVerificationError, FriVerifier
from ..math import polynom
from . import native_scalar as ns
from .channel import VerifierChannel, VerifierError


def verify(air_class, proof, pub_inputs_vec, hasher):
    """winterfell::verify (verifier/src/lib.rs:83) — one aggregated proof,
    a vector of public inputs."""
    ext_deg = proof.contexts[0].options.field_extension

    # Only contexts[0] is bound into the Fiat-Shamir seed (matching the
    # reference fork, verifier/src/lib.rs:95) — reject proofs whose other
    # per-instance contexts were altered after the challenges were fixed
    # (free post-challenge malleability otherwise; honest bytes unchanged).
    for i, ctx in enumerate(proof.contexts[1:], start=1):
        if not (
            ctx.trace_layout == proof.contexts[0].trace_layout
            and ctx.trace_length == proof.contexts[0].trace_length
            and ctx.field_modulus_bytes == proof.contexts[0].field_modulus_bytes
            and ctx.options == proof.contexts[0].options
        ):
            raise VerifierError(f"proof context {i} differs from context 0")
    airs = []
    for i, pub_inputs in enumerate(pub_inputs_vec):
        trace_info = proof.contexts[i].get_trace_info()
        airs.append(air_class(trace_info, pub_inputs, proof.contexts[i].options))

    spec = airs[0].field_spec()
    if proof.contexts[0].field_modulus_bytes != spec.get_modulus_le_bytes():
        raise VerifierError("proof base field does not match the AIR's field")

    # seed = context[0] elements ++ all public input elements (lib.rs:95-98)
    seed_elements = list(proof.contexts[0].to_elements())
    for pub_inputs in pub_inputs_vec:
        seed_elements.extend(pub_inputs.to_elements())
    public_coin = RandomCoin(hasher, seed_elements, field=spec)

    channel = VerifierChannel(airs, proof, hasher, ext_deg, spec)
    return _perform_verification(airs, channel, public_coin, hasher, ext_deg, spec)


def _perform_verification(airs, channel, public_coin, hasher, ext_deg, spec):
    fs = spec
    trace_commitments = channel.read_trace_commitments()

    # 1. trace commitment + aux rand elements (lib.rs:162-178)
    #
    # NOTE — fork inconsistency resolved in the prover's favor: the reference
    # PROVER draws aux randomness for ALL instances and then reseeds the
    # shared aux-segment root once, while the reference VERIFIER keeps
    # upstream Winterfell's single-trace shape (per air, draw then reseed).
    # We mirror the prover (segment-outer, one reseed per shared
    # commitment); for n == 1 the two orders coincide.
    public_coin.reseed(trace_commitments[0])
    aux_traces_rand_elements = [AuxTraceRandElements() for _ in airs]
    for i, commitment in enumerate(trace_commitments[1:]):
        for aux_rand, air in zip(aux_traces_rand_elements, airs):
            rand_elements = air.get_aux_trace_segment_random_elements(
                i, public_coin, ext_deg
            )
            aux_rand.add_segment_elements(rand_elements)
        public_coin.reseed(commitment)

    constraints_coeffs = [
        air.get_constraint_composition_coefficients(public_coin, ext_deg)
        for air in airs
    ]
    # final_coeff drawn BEFORE reseeding the constraint commitment (lib.rs:193)
    final_coeff = public_coin.draw(ext_deg)
    constraint_commitment = channel.read_constraint_commitment()
    public_coin.reseed(constraint_commitment)
    z = public_coin.draw(ext_deg)

    # 2. OOD consistency (lib.rs:210-257)
    ood_traces_frame = channel.read_ood_traces_frame()
    ood_main_frames = [f.main_frame() for f in ood_traces_frame]
    ood_aux_frames = [f.aux_frame() for f in ood_traces_frame]
    ood_constraint_evaluation = fs.zero(ext_deg)
    # periodic columns/values are identical across instances (same AIR class,
    # same z) — evaluate once
    shared_pv = _periodic_values_at(airs[0], z, spec)
    # all frame digests in one batched hash call; reseed order is unchanged
    frame_digests = hasher.hash_elements_many(
        [f.values() for f in ood_traces_frame], spec.ELEMENT_BYTES
    )
    coeff_pow = fs.one(ext_deg)
    for i in range(len(ood_traces_frame)):
        ev = _evaluate_constraints(
            airs[i],
            constraints_coeffs[i],
            ood_main_frames[i],
            ood_aux_frames[i],
            aux_traces_rand_elements[i],
            z,
            shared_pv,
        )
        public_coin.reseed(frame_digests[i])
        ood_constraint_evaluation = fs.fadd(
            ood_constraint_evaluation, fs.fmul(ev, coeff_pow)
        )
        coeff_pow = fs.fmul(coeff_pow, final_coeff)

    ood_constraint_evaluations = channel.read_ood_constraint_evaluations()
    ood2 = fs.zero(ext_deg)
    for i, value in enumerate(ood_constraint_evaluations):
        ood2 = fs.fadd(
            ood2, fs.fmul(fs.fexp(z, i * airs[0].trace_length()), value)
        )
    public_coin.reseed(
        hasher.hash_elements(ood_constraint_evaluations, spec.ELEMENT_BYTES)
    )

    if ood_constraint_evaluation != ood2:
        raise VerifierError("inconsistent OOD constraint evaluations")

    # 3. DEEP coefficients + FRI verifier setup (lib.rs:263-278)
    deep_coefficients = airs[0].get_deep_composition_coefficients(
        airs, public_coin, ext_deg
    )
    fri_verifier = FriVerifier(
        channel,
        public_coin,
        airs[0].options().to_fri_options(),
        airs[0].trace_poly_degree(),
        ext_deg,
        field=spec,
    )

    # 4. PoW + query positions (lib.rs:283-303)
    pow_nonce = channel.read_pow_nonce()
    public_coin.reseed_with_int(pow_nonce)
    if public_coin.leading_zeros() < airs[0].options().grinding_factor:
        raise VerifierError("query seed proof-of-work verification failed")
    query_positions = public_coin.draw_integers(
        airs[0].options().num_queries, airs[0].lde_domain_size()
    )

    queried_main_vec, queried_aux = channel.read_queried_trace_states(query_positions)
    queried_constraints = channel.read_constraint_evaluations(query_positions)

    # 5. DEEP composition at the query points (composer.rs)
    composer = DeepComposer(airs[0], query_positions, z, deep_coefficients, ext_deg,
                            spec)
    deep_evaluations = composer.compose_deep_native(
        queried_main_vec, queried_aux, ood_main_frames, ood_aux_frames,
        queried_constraints, ood_constraint_evaluations
    )

    # 6. FRI verification
    try:
        fri_verifier.verify(channel, deep_evaluations, query_positions)
    except FriVerificationError as e:
        raise VerifierError(f"FRI verification failed: {e}")
    return True


def _periodic_values_at(air, x, spec):
    """The periodic columns at x: by C Horner (native_scalar.poly_eval) for
    base-field coefficients, on f64 from 32 of them, else by
    ``_periodic_value_plain``."""
    values = []
    for poly in air.get_periodic_column_polys():
        num_cycles = air.trace_length() // len(poly)
        xp = spec.fexp(x, num_cycles)
        if poly and isinstance(poly[0], int) and (spec.name != "f64" or len(poly) >= 32):
            # the word pack is identity-cached per poly object (AIRs cache
            # their periodic polys class-level)
            ctx = ns.get_ctx(spec, spec.deg_of(xp))
            values.append(ns.poly_eval(ctx, ns.pack_base_cached(ctx, poly), xp))
        else:
            values.append(_periodic_value_plain(poly, xp, spec))
    return values


def _periodic_value_plain(poly, xp, spec):
    """Horner on python ints: the plain version of the C Horner."""
    return polynom.eval_at(poly, xp, None if spec.name == "f64" else spec)


def _evaluate_constraints(air, coeffs, main_frame, aux_frame, aux_rand_elements, x,
                          periodic_values):
    """verifier/src/evaluator.rs:14-82 — symbolic evaluation at z."""
    spec = air.field_spec()
    t_constraints = air.get_transition_constraints(coeffs.transition)

    t1 = [None] * t_constraints.num_main_constraints()
    air.evaluate_transition(
        _ScalarFrame(main_frame, spec),
        [ScalarFelt(v, spec) for v in periodic_values], t1,
    )
    t1 = [_unfelt(v) for v in t1]

    t2 = []
    if aux_frame is not None:
        t2 = [None] * t_constraints.num_aux_constraints()
        air.evaluate_aux_transition(
            _ScalarFrame(main_frame, spec), _ScalarFrame(aux_frame, spec),
            [ScalarFelt(v, spec) for v in periodic_values], aux_rand_elements, t2,
        )
        t2 = [_unfelt(v) for v in t2]

    result = t_constraints.combine_evaluations(t1, t2, x)

    b_constraints = air.get_boundary_constraints(aux_rand_elements, coeffs.boundary)
    for group in b_constraints.main_constraints:
        result = spec.fadd(result, group.evaluate_at(main_frame.current(), x))
    if aux_frame is not None:
        for group in b_constraints.aux_constraints:
            result = spec.fadd(result, group.evaluate_at(aux_frame.current(), x))
    return result


class ScalarFelt:
    """Python-int field element with Felt's operator surface, so the AIR's
    vectorized ``evaluate_transition`` runs on the verifier's scalar OOD
    values (a python mulmod is far cheaper than a shape-(1,) tensor
    multiply)."""

    __slots__ = ("v", "spec")

    def __init__(self, v, spec):
        self.v = v
        self.spec = spec

    def _coerce(self, o):
        if isinstance(o, ScalarFelt):
            return o.v
        if isinstance(o, (int, tuple)):
            return o
        return NotImplemented

    def __add__(self, o):
        w = self._coerce(o)
        if w is NotImplemented:
            return NotImplemented
        return ScalarFelt(self.spec.fadd(self.v, w), self.spec)

    __radd__ = __add__

    def __sub__(self, o):
        w = self._coerce(o)
        if w is NotImplemented:
            return NotImplemented
        return ScalarFelt(self.spec.fsub(self.v, w), self.spec)

    def __rsub__(self, o):
        w = self._coerce(o)
        if w is NotImplemented:
            return NotImplemented
        return ScalarFelt(self.spec.fsub(w, self.v), self.spec)

    def __mul__(self, o):
        w = self._coerce(o)
        if w is NotImplemented:
            return NotImplemented
        return ScalarFelt(self.spec.fmul(self.v, w), self.spec)

    __rmul__ = __mul__

    def __neg__(self):
        return ScalarFelt(self.spec.fneg(self.v), self.spec)

    def __pow__(self, e: int):
        return ScalarFelt(self.spec.fexp(self.v, int(e)), self.spec)

    def square(self):
        return ScalarFelt(self.spec.fmul(self.v, self.v), self.spec)

    def double(self):
        return ScalarFelt(self.spec.fadd(self.v, self.v), self.spec)

    def inverse(self):
        return ScalarFelt(self.spec.finv(self.v), self.spec)

    def __truediv__(self, o):
        w = self._coerce(o)
        if w is NotImplemented:
            return NotImplemented
        return self * ScalarFelt(w, self.spec).inverse()

    def __eq__(self, o):
        w = self._coerce(o)
        return self.v == w


class _ScalarFrame:
    def __init__(self, frame, spec):
        self._current = [ScalarFelt(v, spec) for v in frame.current()]
        self._next = [ScalarFelt(v, spec) for v in frame.next()]

    def current(self):
        return self._current

    def next(self):
        return self._next


def _unfelt(f):
    return f.v if isinstance(f, ScalarFelt) else f


def _batch_inv(xs, spec):
    """Montgomery batch inversion (one field inversion in total)."""
    k = len(xs)
    pref = [spec.one(spec.deg_of(xs[0]))] * (k + 1)
    for i, x in enumerate(xs):
        pref[i + 1] = spec.fmul(pref[i], x)
    inv = spec.finv(pref[k])
    out = [None] * k
    for i in range(k - 1, -1, -1):
        out[i] = spec.fmul(pref[i], inv)
        inv = spec.fmul(inv, xs[i])
    return out


class DeepComposer:
    """verifier/src/composer.rs:55-217, at all query points at once:

      sum_ij k_ij (T_ij(x) - T_ij(z)) / (x - z)
      + sum_ij k_ij (T_ij(x) - T_ij(z g)) / (x - z g)
      + sum_k  c_k  (H_k(x) - H_k(z)) / (x - z)

    through the C tier (``compose_deep_native``); the ``*_plain`` methods
    are the same sums on python ints."""

    def __init__(self, air, query_positions, z, cc, ext_deg, spec):
        self.fs = spec
        g_lde = air.lde_domain_generator()
        offset = air.domain_offset()
        self.g_lde = g_lde
        self.offset = offset
        self.positions = list(query_positions)
        self.x_coordinates = [
            pow(g_lde, p, spec.P) * offset % spec.P for p in query_positions
        ]
        self.cc = cc
        self.z = [z, spec.fmul(z, air.trace_domain_generator())]
        self.ext_deg = ext_deg

    def compose_deep_native(self, queried_main_vec, queried_aux_vec,
                            ood_main_frames, ood_aux_frames,
                            queried_constraints, ood_evaluations):
        """Full DEEP composition (trace + constraint parts fused, one
        batch-inversion chain) through the native scalar kernels
        (verify_scalar.c).  Returns a packed (q, d, 2) u64 array the FRI
        verifier's native path consumes directly.  The parsed query tables
        are word-backed, the degree is at most 3 and the queries at most
        255 (``ProofOptions``), all within the C library's limits."""
        import numpy as np

        d = self.ext_deg
        q = len(self.positions)
        ctx = ns.get_ctx(self.fs, d)
        n = len(queried_main_vec)
        Tm = np.stack([t.words for t in queried_main_vec])  # (n, q, w, nl)
        w = Tm.shape[2]
        ood_cur = ctx.pack_elems([v for f in ood_main_frames for v in f.current()])
        ood_nxt = ctx.pack_elems([v for f in ood_main_frames for v in f.next()])
        cc = ctx.pack_elems([c for kk in self.cc.traces for c in kk[:w]])
        t1 = np.zeros((q, d, 2), dtype=np.uint64)
        t2 = np.zeros_like(t1)
        rc = ns.deep_trace(ctx, Tm, n, q, w, 1, ood_cur, ood_nxt, cc, t1, t2,
                           False)
        if rc != 0:
            raise RuntimeError(f"vs_deep_trace failed (rc={rc})")
        if queried_aux_vec is not None:
            wa = len(ood_aux_frames[0].current())
            Ta = np.stack([t.words for t in queried_aux_vec])
            a0 = ctx.pack_elems(
                [v for f in ood_aux_frames for v in f.current()]
            )
            a1 = ctx.pack_elems([v for f in ood_aux_frames for v in f.next()])
            ka = ctx.pack_elems(
                [c for kk in self.cc.traces for c in kk[w : w + wa]]
            )
            rc = ns.deep_trace(ctx, Ta, n, q, wa, d, a0, a1, ka, t1, t2, True)
            if rc != 0:
                raise RuntimeError(f"vs_deep_trace failed (rc={rc})")
        m = queried_constraints.words.shape[1]
        ood_c = ctx.pack_elems(list(ood_evaluations))
        cc2 = ctx.pack_elems(list(self.cc.constraints))
        rc, out = ns.deep_combine(
            ctx, q, self.positions, self.g_lde, self.offset, self.z[0],
            self.z[1], t1, t2, queried_constraints.words, m, ood_c, cc2,
        )
        if rc != 0:
            raise RuntimeError(f"vs_deep_combine failed (rc={rc})")
        return out

    # -- the plain versions, on python ints ---------------------------------

    def _inv_dens_plain(self):
        spec = self.fs
        z, zg = self.z
        return (_batch_inv([spec.fsub(x, z) for x in self.x_coordinates], spec),
                _batch_inv([spec.fsub(x, zg) for x in self.x_coordinates], spec))

    def compose_trace_columns_plain(self, queried_main_vec, queried_aux_vec,
                                    ood_main_frames, ood_aux_frames):
        """The trace part of the composition on python ints: the plain
        version of ``compose_deep_native``'s trace part."""
        spec = self.fs
        inv_z, inv_zg = self._inv_dens_plain()
        q = len(inv_z)
        zero = spec.zero(spec.deg_of(inv_z[0]))
        t1 = [zero] * q
        t2 = [zero] * q

        def accumulate(table, frame, coeffs):
            cur, nxt = frame.current(), frame.next()
            for qi, row in enumerate(table.rows()):
                a, b = t1[qi], t2[qi]
                for v, c0, c1, k in zip(row, cur, nxt, coeffs):
                    a = spec.fadd(a, spec.fmul(spec.fsub(v, c0), k))
                    b = spec.fadd(b, spec.fmul(spec.fsub(v, c1), k))
                t1[qi], t2[qi] = a, b

        for i, table in enumerate(queried_main_vec):
            w = table.num_columns()
            accumulate(table, ood_main_frames[i], self.cc.traces[i][:w])
            if queried_aux_vec is not None:
                accumulate(queried_aux_vec[i], ood_aux_frames[i],
                           self.cc.traces[i][w:])
        return [
            spec.fadd(spec.fmul(a, iz), spec.fmul(b, izg))
            for a, b, iz, izg in zip(t1, t2, inv_z, inv_zg)
        ]

    def compose_constraint_evaluations_plain(self, queried_evaluations, ood_evaluations):
        """The constraint part of the composition on python ints: the plain
        version of ``compose_deep_native``'s constraint part."""
        spec = self.fs
        out = []
        for row, iz in zip(queried_evaluations.rows(), self._inv_dens_plain()[0]):
            num = spec.zero(spec.deg_of(iz))
            for v, o, k in zip(row, ood_evaluations, self.cc.constraints):
                num = spec.fadd(num, spec.fmul(spec.fsub(v, o), k))
            out.append(spec.fmul(num, iz))
        return out
