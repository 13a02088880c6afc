# Copy of starkpack_winterfell_tpu/fri/verifier.py; cut: nothing; the python-int loop is verify_plain, the plain version of the C fold.
"""FRI verifier — equivalent of fri/src/verifier/mod.rs (host-side; all
work here is O(num_queries · folding_factor) scalar math)."""

from __future__ import annotations

from .prover import fold_positions


def _spec(field):
    if field is None:
        from ..math.fieldspec import GL64_SPEC as field
    return field


class VerifierChannelFri:
    """Default verifier channel semantics (fri/src/verifier/channel.rs):
    parses layer queries, batch-verifies Merkle openings lazily, checks the
    remainder hash against the last commitment."""

    def __init__(self, fri_proof, layer_commitments, hasher, domain_size: int,
                 folding_factor: int, ext_deg: int, field=None):
        field = _spec(field)
        self.field = field
        layer_queries, layer_proofs = fri_proof.parse_layers(
            hasher, domain_size, folding_factor, ext_deg, field
        )
        # raw per-layer value bytes + remainder bytes for the native fold
        # (already canonicity-validated by parse_layers/parse_remainder)
        self.layer_value_bytes = [l.values for l in fri_proof.layers]
        self.remainder_bytes = fri_proof.remainder
        self.layer_commitments = layer_commitments
        self.layer_queries = layer_queries
        self.layer_proofs = layer_proofs
        self.remainder = fri_proof.parse_remainder(ext_deg, field)
        self.num_partitions = fri_proof.num_partitions()
        self.hasher = hasher
        self.folding_factor = folding_factor
        self._layer_idx = 0

    def fri_layer_value_bytes(self, idx):
        return self.layer_value_bytes[idx]

    def fri_remainder_bytes(self):
        return self.remainder_bytes

    def read_fri_num_partitions(self) -> int:
        return self.num_partitions

    def read_fri_layer_commitments(self):
        return list(self.layer_commitments)

    def read_layer_queries(self, positions, commitment):
        from ..crypto.merkle import verify_batch

        idx = self._layer_idx
        self._layer_idx += 1
        proof = self.layer_proofs[idx]
        if not verify_batch(commitment, positions, proof):
            raise FriVerificationError(f"layer {idx} Merkle verification failed")
        qv = self.layer_queries[idx]
        N = self.folding_factor
        # row counts in FriProofLayer.parse are derived from the proof byte
        # length, not from the expected query count — reject layers whose row
        # count disagrees with the verifier-computed folded positions.
        if len(qv) != len(positions) * N:
            raise FriVerificationError(f"layer {idx} query row count mismatch")
        return [qv[i * N : (i + 1) * N] for i in range(len(qv) // N)]

    def read_remainder(self):
        commitment = self.layer_commitments[-1]
        if self.hasher.hash_elements(self.remainder, self.field.ELEMENT_BYTES) != commitment:
            raise FriVerificationError("remainder commitment mismatch")
        return self.remainder


class FriVerificationError(Exception):
    pass


class FriVerifier:
    def __init__(self, channel, public_coin, options, max_poly_degree: int,
                 ext_deg: int, field=None):
        """Reads layer commitments, reseeds, draws alphas
        (fri/src/verifier/mod.rs:102-148)."""
        self.field = _spec(field)
        self.options = options
        self.max_poly_degree = max_poly_degree
        self.ext_deg = ext_deg
        self.domain_size = _next_pow2(max_poly_degree) * options.blowup_factor
        self.domain_generator = self.field.get_root_of_unity(self.domain_size.bit_length() - 1)
        self.num_partitions = channel.read_fri_num_partitions()

        self.layer_commitments = channel.read_fri_layer_commitments()
        self.layer_alphas = []
        max_degree_plus_1 = max_poly_degree + 1
        for depth, commitment in enumerate(self.layer_commitments):
            public_coin.reseed(commitment)
            alpha = public_coin.draw(ext_deg)
            self.layer_alphas.append(alpha)
            if (
                depth != len(self.layer_commitments) - 1
                and max_degree_plus_1 % options.folding_factor != 0
            ):
                raise FriVerificationError("degree truncation")
            max_degree_plus_1 //= options.folding_factor

    def verify(self, channel, evaluations, positions):
        """fri/src/verifier/mod.rs:204-330, through the C layer fold and
        remainder check (native/verify_scalar.c, ``_native_verify``) for
        extension degree <= 3, folding factor <= 16 and at most 1024 query
        positions, else through ``verify_plain``.  ``evaluations``: a list
        of elements, or the (q, d, 2) u64 words of the C DEEP composition
        (which ``verify`` always takes: its proofs are within the gate)."""
        if len(evaluations) != len(positions):
            raise FriVerificationError("position/evaluation count mismatch")
        N = self.options.folding_factor
        if self.ext_deg <= 3 and N <= 16 and len(positions) <= 1024:
            _native_verify(self, channel, evaluations, list(positions))
            return
        self.verify_plain(channel, evaluations, positions)

    def verify_plain(self, channel, evaluations, positions):
        """The plain version of ``verify``'s C path, on python ints.

        The reference interpolates each queried row with scalar Lagrange
        (polynom::interpolate_batch) — here the rows' x-coordinates form
        cosets x_e * <w_N>, so row interpolation is one size-N inverse DFT
        per row (identical coefficients — the interpolant is unique), and
        the row evaluation at alpha collapses to one Horner in
        beta_e = alpha / x_e (since p_row coeff j = q_row coeff j * x_e^-j).

        All math here is python-int mulmod: the working set is only
        num_queries x folding_factor elements per layer, where numpy limb
        kernels pay ~300 array-op dispatches per multiply and lose by ~20x
        (same finding as the verifier's ScalarFelt OOD path)."""
        if len(evaluations) != len(positions):
            raise FriVerificationError("position/evaluation count mismatch")
        P = self.field.P
        N = self.options.folding_factor
        spec = self.field
        d = self.ext_deg

        domain_generator = self.domain_generator
        domain_size = self.domain_size
        max_degree_plus_1 = self.max_poly_degree + 1
        positions = list(positions)
        evaluations = list(evaluations)

        # inverse DFT matrix for the size-N subgroup: M[j, i] = w_N^{-ij}/N
        w_inv = pow(self.field.get_root_of_unity(N.bit_length() - 1), P - 2, P)
        n_inv = pow(N, P - 2, P)
        idft = [
            [pow(w_inv, i * j, P) * n_inv % P for i in range(N)] for j in range(N)
        ]

        for depth in range(self.options.num_fri_layers(self.domain_size)):
            folded_positions = fold_positions(positions, domain_size, N)
            # num_partitions == 1 -> tree positions == folded positions
            layer_commitment = self.layer_commitments[depth]
            layer_values = channel.read_layer_queries(folded_positions, layer_commitment)
            query_values = _get_query_values(
                layer_values, positions, folded_positions, domain_size, N
            )
            if evaluations != query_values:
                raise FriVerificationError(f"invalid layer folding at depth {depth}")

            offs = self.field.GENERATOR
            alpha = self.layer_alphas[depth]
            xe = [
                pow(domain_generator, i, P) * offs % P for i in folded_positions
            ]
            xinv = _batch_inv_int(xe, P)
            if d == 1:
                # beta_e = alpha * x_e^-1; ev_e = sum_j cq[e][j] beta_e^j
                evaluations = []
                for row, xi in zip(layer_values, xinv):
                    beta = alpha * xi % P
                    acc = 0
                    for j in range(N - 1, -1, -1):
                        c = 0
                        mj = idft[j]
                        for i in range(N):
                            c += row[i] * mj[i]
                        acc = (acc * beta + c) % P
                    evaluations.append(acc)
            else:
                # component-wise idft row-sum with ONE mod per component
                # (spec.mul_base/fadd per term costs ~4x in call overhead)
                evaluations = []
                rng_n, rng_d = range(N), range(d)
                for row, xi in zip(layer_values, xinv):
                    beta = spec.mul_base(alpha, xi)
                    rowc = [spec.components(e) for e in row]
                    acc = spec.zero(d)
                    for j in range(N - 1, -1, -1):
                        mj = idft[j]
                        c = tuple(
                            sum(rowc[i][t] * mj[i] for i in rng_n) % P
                            for t in rng_d
                        )
                        acc = spec.fadd(spec.fmul(acc, beta), c)
                    evaluations.append(acc)

            if max_degree_plus_1 % N != 0:
                raise FriVerificationError("degree truncation")
            domain_generator = pow(domain_generator, N, P)
            max_degree_plus_1 //= N
            domain_size //= N
            positions = folded_positions

        remainder_poly = channel.read_remainder()
        if len(remainder_poly) > max_degree_plus_1:
            raise FriVerificationError("remainder degree mismatch")
        offset = self.field.GENERATOR
        if positions:
            xs = [
                offset * pow(domain_generator, position, P) % P
                for position in positions
            ]
            if d == 1:
                got = []
                for x in xs:
                    acc = 0
                    for c in reversed(remainder_poly):
                        acc = (acc * x + c) % P
                    got.append(acc)
            else:
                rem_c = [spec.components(c) for c in reversed(remainder_poly)]
                got = []
                for x in xs:
                    acc = [0] * d
                    for c in rem_c:
                        acc = [(acc[t] * x + c[t]) % P for t in range(d)]
                    got.append(tuple(acc))
            if got != evaluations:
                raise FriVerificationError("invalid remainder folding")


_IDFT_CACHE: dict = {}


def _idft_words(field, N):
    """(N*N, 2) u64 canonical idft matrix M[j,i] = w_N^{-ij}/N (row-major,
    cached per (field, N))."""
    import numpy as np

    key = (field.name, N)
    hit = _IDFT_CACHE.get(key)
    if hit is None:
        P = field.P
        w_inv = pow(field.get_root_of_unity(N.bit_length() - 1), P - 2, P)
        n_inv = pow(N, P - 2, P)
        flat = [
            pow(w_inv, i * j, P) * n_inv % P
            for j in range(N)
            for i in range(N)
        ]
        hit = np.array(
            [(v & 0xFFFFFFFFFFFFFFFF, v >> 64) for v in flat], dtype=np.uint64
        )
        _IDFT_CACHE[key] = hit
    return hit


def _native_verify(fv, channel, evaluations, positions):
    """Run the whole layer-fold loop + remainder check through the native
    scalar kernels (verify_scalar.c), reading the channel's raw layer and
    remainder bytes; raises FriVerificationError exactly like
    ``verify_plain``.  The caller's gate keeps ``positions`` within the C
    library's 1024 (decided before the channel is consumed)."""
    from ..verifier import native_scalar as ns

    get_bytes = channel.fri_layer_value_bytes
    get_rem = channel.fri_remainder_bytes

    spec = fv.field
    P = spec.P
    N = fv.options.folding_factor
    d = fv.ext_deg
    ctx = ns.get_ctx(spec, d)
    idft = _idft_words(spec, N)

    domain_generator = fv.domain_generator
    domain_size = fv.domain_size
    max_degree_plus_1 = fv.max_poly_degree + 1
    evals_arr = (
        evaluations
        if not isinstance(evaluations, list)
        else ctx.pack_elems(evaluations)
    )

    for depth in range(fv.options.num_fri_layers(fv.domain_size)):
        folded_positions = fold_positions(positions, domain_size, N)
        layer_commitment = fv.layer_commitments[depth]
        # Merkle + row-count checks (unchanged error order); the returned
        # rows are ignored — the native kernel re-reads the raw bytes
        channel.read_layer_queries(folded_positions, layer_commitment)
        row_length = domain_size // N
        fp_index = {pp: i for i, pp in enumerate(folded_positions)}
        qmap_row = [fp_index[pp % row_length] for pp in positions]
        qmap_col = [pp // row_length for pp in positions]
        rc, out = ns.fold_layer(
            ctx, N, get_bytes(depth), len(folded_positions), evals_arr,
            qmap_row, qmap_col, folded_positions, domain_generator,
            spec.GENERATOR, fv.layer_alphas[depth], idft,
        )
        if rc == 1:
            raise FriVerificationError(f"invalid layer folding at depth {depth}")
        if rc != 0:
            raise RuntimeError(f"native FRI fold failed (rc={rc})")
        if max_degree_plus_1 % N != 0:
            raise FriVerificationError("degree truncation")
        evals_arr = out
        domain_generator = pow(domain_generator, N, P)
        max_degree_plus_1 //= N
        domain_size //= N
        positions = folded_positions

    remainder_poly = channel.read_remainder()
    if len(remainder_poly) > max_degree_plus_1:
        raise FriVerificationError("remainder degree mismatch")
    if positions:
        rc = ns.remainder_check(
            ctx, get_rem(), len(remainder_poly), positions,
            domain_generator, spec.GENERATOR, evals_arr,
        )
        if rc == 1:
            raise FriVerificationError("invalid remainder folding")
        if rc != 0:
            raise RuntimeError(f"native remainder check failed (rc={rc})")


def _batch_inv_int(xs, P):
    """Montgomery batch inversion over python ints (one fermat pow total)."""
    k = len(xs)
    pref = [1] * (k + 1)
    for i, x in enumerate(xs):
        pref[i + 1] = pref[i] * x % P
    inv = pow(pref[k], P - 2, P)
    out = [0] * k
    for i in range(k - 1, -1, -1):
        out[i] = pref[i] * inv % P
        inv = inv * xs[i] % P
    return out


def _get_query_values(values, positions, folded_positions, domain_size, N):
    row_length = domain_size // N
    result = []
    for position in positions:
        idx = folded_positions.index(position % row_length)
        result.append(values[idx][position // row_length])
    return result


def _next_pow2(v: int) -> int:
    return 1 if v <= 1 else 1 << (v - 1).bit_length()
