"""A plain STARK verifier for the benchmark's configurations: the
Fiat-Shamir transcript of Winterfell's StarkPack fork replayed from the
statement and the proof bytes, every Merkle opening checked against its
root, the constraints evaluated at the out-of-domain point, the DEEP
composition at the query positions and FRI down to its remainder.  The
base field or its quadratic extension (``field.ExtensionField``), BLAKE3
commitments, no auxiliary segment.

It imports nothing of the program: it judges the proof a prover produced
for a statement that the benchmark made."""

from __future__ import annotations

from .airs import AIRS
from .field import ExtensionField
from .proof import HASHERS, Rejected, StarkProof, elements, merkle_root


class Coin:
    """The public coin: a digest reseeded by merges, drawn by counter."""

    def __init__(self, hasher, field, seed_elements):
        self.h, self.field = hasher, field
        self.seed = hasher.hash_elements(seed_elements, field.ELEMENT_BYTES)
        self.counter = 0

    def reseed(self, data: bytes):
        self.seed = self.h.merge(self.seed, data)
        self.counter = 0

    def reseed_with_int(self, value: int):
        self.seed = self.h.merge_with_int(self.seed, value)
        self.counter = 0

    def _next(self) -> bytes:
        self.counter += 1
        return self.h.merge_with_int(self.seed, self.counter)

    def draw(self, E: ExtensionField):
        """An element of E from one digest: its components in turn, each
        canonical, or the next digest."""
        eb = self.field.ELEMENT_BYTES
        for _ in range(1000):
            digest = self._next()
            v = [int.from_bytes(digest[i * eb:(i + 1) * eb], "little") for i in range(E.DEGREE)]
            if all(c < self.field.P for c in v):
                return E.element(v)
        raise Rejected("no field element in 1000 draws")

    def draw_many(self, k: int, E: ExtensionField):
        return [self.draw(E) for _ in range(k)]

    def trailing_zeros(self) -> int:
        head = int.from_bytes(self.seed[:8], "little")
        return 64 if head == 0 else (head & -head).bit_length() - 1

    def draw_positions(self, count: int, domain_size: int):
        out = []
        for _ in range(1000):
            v = int.from_bytes(self._next()[:8], "little") & (domain_size - 1)
            if v not in out:
                out.append(v)
                if len(out) == count:
                    return out
        raise Rejected("too few distinct query positions")


def _evaluation_degree(degree, trace_length: int) -> int:
    base, cycles = degree
    return base * (trace_length - 1) + sum((trace_length // c) * (c - 1) for c in cycles)


def num_composition_columns(air) -> int:
    L = air.trace_length
    highest = max(_evaluation_degree(d, L) for d in air.degrees)
    return max((highest - (L - 1) + L - 1) // L, 1)


def num_fri_layers(options, domain_size: int) -> int:
    n = 0
    while domain_size > (options.fri_remainder_max_degree + 1) * options.blowup_factor:
        domain_size //= options.fri_folding_factor
        n += 1
    return n


def conjectured_security(field, options, trace_length: int, digest_bytes: int) -> int:
    """Winterfell's conjectured security of a proof, in bits: the field's
    term (its bits less log2 of the trace length) and the queries' (log2 of
    the blowup a query, and the grinding once those reach 80), the lesser
    less one, under the hash's collision resistance (half its digest)."""
    field_term = field.P.bit_length() * options.field_extension - (trace_length.bit_length() - 1)
    query_term = options.num_queries * (options.blowup_factor.bit_length() - 1)
    if query_term >= 80:
        query_term += options.grinding_factor
    return min(min(field_term, query_term) - 1, digest_bytes * 4)


def _boundary_groups(air):
    """Assertions sorted by (stride, first step, column), grouped by
    (stride, first step): the order their composition coefficients take."""
    assertions = sorted(air.assertions(), key=lambda a: a.key())
    groups = {}
    for i, a in enumerate(assertions):
        groups.setdefault((a.stride, a.first_step), []).append((i, a))
    return [groups[k] for k in sorted(groups)]


def evaluate_constraints(air, coeffs, cur, nxt, z, periodic, E: ExtensionField):
    """The composition of the AIR's transition and boundary constraints at
    z, from the out-of-domain frame (all in E)."""
    f, P, L = air.field, air.field.P, air.trace_length
    nt = len(air.degrees)
    t = air.transition(cur, nxt, periodic)
    g = f.root_of_unity(L.bit_length() - 1)
    divisor = (pow(z, L, P) - 1) * E.inv(z - pow(g, L - 1, P)) % P  # one exemption
    result = sum(c * e for c, e in zip(coeffs[:nt], t)) * E.inv(divisor) % P
    bcoeffs = coeffs[nt:]
    inv_g = f.inv(g)
    for group in _boundary_groups(air):
        first = group[0][1]
        steps = 1 if first.stride == 0 else L // first.stride
        offset = 1 if first.first_step == 0 else pow(g, steps * first.first_step, P)
        numerator = 0
        for i, a in group:
            if len(a.values) == 1:
                value = a.values[0]
            else:
                poly = f.interpolate_subgroup(a.values)
                value = f.horner(poly, z * pow(inv_g, a.first_step, P) % P)
            numerator += (cur[a.column] - value) * bcoeffs[i]
        result = (result + numerator * E.inv(pow(z, steps, P) - offset)) % P
    return result


def verify(config: dict, statements, proof_bytes: bytes) -> None:
    """Raises Rejected unless ``proof_bytes`` prove ``statements`` (one
    public-input dict an instance, as ``airs.AIRS[config["air"]]`` takes
    them) under the configuration's options, field and hasher."""
    air_class = AIRS[config["air"]]
    field = air_class.field
    hasher = HASHERS[config["hasher"]]
    n = len(statements)
    proof = StarkProof(proof_bytes, n)
    ctx = proof.contexts[0]
    if any(c.key() != ctx.key() for c in proof.contexts[1:]):
        raise Rejected("the instances' contexts differ")
    options = ctx.options
    if list(options.as_tuple()) != list(config["options"]):
        raise Rejected(f"proof options {options.as_tuple()} are not the configuration's "
                       f"{tuple(config['options'])}")
    if ctx.modulus_bytes != field.modulus_bytes():
        raise Rejected("the proof's field is not the configuration's")
    if ctx.main_width != config["trace_width"] or air_class.width != config["trace_width"]:
        raise Rejected("the proof's trace width is not the configuration's")
    try:
        E = ExtensionField(field, options.field_extension)
    except ValueError as e:
        raise Rejected(str(e)) from None
    L = ctx.trace_length
    security = conjectured_security(field, options, L, hasher.DIGEST_BYTES)
    if security < config["security_bits_conjectured"]:
        raise Rejected(f"the proof's conjectured security is {security} bits, under the "
                       f"configuration's {config['security_bits_conjectured']}")
    airs = [air_class(L, **s) for s in statements]
    P = field.P
    lde_size = L * options.blowup_factor
    depth = lde_size.bit_length() - 1
    N = options.fri_folding_factor
    nc = num_composition_columns(airs[0])
    layers = num_fri_layers(options, lde_size)
    D = hasher.DIGEST_BYTES
    eb, Eb = field.ELEMENT_BYTES, E.ELEMENT_BYTES

    seed = ctx.to_elements(field)
    for air in airs:
        seed += air.pub_elements()
    coin = Coin(hasher, field, seed)

    if len(proof.commitments) != D * (2 + layers + 1):
        raise Rejected("commitment bytes do not match the configuration")
    roots = [proof.commitments[i:i + D] for i in range(0, len(proof.commitments), D)]
    trace_root, constraint_root, fri_roots = roots[0], roots[1], roots[2:]

    # constraint composition coefficients, then the out-of-domain point
    coin.reseed(trace_root)
    coeffs = [coin.draw_many(len(air.degrees) + len(air.assertions()), E) for air in airs]
    final_coeff = coin.draw(E)
    coin.reseed(constraint_root)
    z = coin.draw(E)

    # out-of-domain consistency
    g_trace = field.root_of_unity(L.bit_length() - 1)
    periodic = []
    for col in airs[0].periodic_columns():
        poly = field.interpolate_subgroup(col)
        periodic.append(field.horner(poly, pow(z, L // len(col), P)))
    frames, combined, power = [], 0, 1
    for i, (air, (states, evals)) in enumerate(zip(airs, proof.ood)):
        if not states or states[0] != 2:
            raise Rejected("an out-of-domain frame is not two rows")
        values = elements(states[1:], E)
        if len(values) != 2 * air.width:
            raise Rejected("an out-of-domain frame has the wrong width")
        cur, nxt = values[0::2], values[1::2]
        frames.append((cur, nxt))
        combined = (combined + evaluate_constraints(air, coeffs[i], cur, nxt, z, periodic, E)
                    * power) % P
        power = power * final_coeff % P
        coin.reseed(hasher.hash_elements(values, eb))
        evaluations = elements(evals, E)
        if len(evaluations) != nc:
            raise Rejected("wrong number of composition columns out of domain")
        if i == 0:
            ood_evaluations = evaluations
        elif evaluations != ood_evaluations:
            raise Rejected("the instances' composition values differ")
    composed = sum(pow(z, k * L, P) * h for k, h in enumerate(ood_evaluations)) % P
    coin.reseed(hasher.hash_elements(ood_evaluations, eb))
    if combined != composed:
        raise Rejected("the out-of-domain constraint evaluations are inconsistent")

    # DEEP coefficients and FRI layer challenges
    trace_cc = [coin.draw_many(air.width, E) for air in airs]
    constraint_cc = coin.draw_many(nc, E)
    max_degree_plus_1 = L
    alphas = []
    for depth_i, root in enumerate(fri_roots):
        coin.reseed(root)
        alphas.append(coin.draw(E))
        if depth_i != len(fri_roots) - 1 and max_degree_plus_1 % N:
            raise Rejected("FRI degree truncation")
        max_degree_plus_1 //= N
    if proof.fri_partitions_log != 0 or len(proof.fri_layers) != layers:
        raise Rejected("FRI layout does not match the configuration")

    # proof of work and query positions
    coin.reseed_with_int(proof.pow_nonce)
    if coin.trailing_zeros() < options.grinding_factor:
        raise Rejected("the proof-of-work nonce does not meet the grinding factor")
    q = options.num_queries
    positions = coin.draw_positions(q, lde_size)

    # openings of the trace and of the composition columns
    width = sum(air.width for air in airs)
    trace_rows = elements(proof.trace_values, field)
    if len(trace_rows) != q * width:
        raise Rejected("wrong number of queried trace values")
    leaves = [hasher.hash(proof.trace_values[i * width * eb:(i + 1) * width * eb]) for i in range(q)]
    if merkle_root(hasher, leaves, positions, proof.trace_paths, depth) != trace_root:
        raise Rejected("trace openings do not match the trace commitment")
    comp_rows = elements(proof.constraint_values, E)
    if len(comp_rows) != q * nc:
        raise Rejected("wrong number of queried composition values")
    leaves = [hasher.hash(proof.constraint_values[i * nc * Eb:(i + 1) * nc * Eb]) for i in range(q)]
    if merkle_root(hasher, leaves, positions, proof.constraint_paths, depth) != constraint_root:
        raise Rejected("composition openings do not match the constraint commitment")

    # DEEP composition at the query positions
    g_lde = field.root_of_unity(depth)
    xs = [pow(g_lde, p, P) * field.GENERATOR % P for p in positions]
    zg = z * g_trace % P
    inv_z = E.batch_inv([(x - z) % P for x in xs])
    inv_zg = E.batch_inv([(x - zg) % P for x in xs])
    deep = []
    for qi in range(q):
        row = trace_rows[qi * width:(qi + 1) * width]
        t1 = t2 = 0
        off = 0
        for air, (cur, nxt), kk in zip(airs, frames, trace_cc):
            for j in range(air.width):
                v = row[off + j]
                t1 += (v - cur[j]) * kk[j]
                t2 += (v - nxt[j]) * kk[j]
            off += air.width
        c = sum((h - o) * k for h, o, k in zip(comp_rows[qi * nc:(qi + 1) * nc],
                                                 ood_evaluations, constraint_cc))
        deep.append(((t1 + c) * inv_z[qi] + t2 * inv_zg[qi]) % P)

    _verify_fri(field, E, hasher, options, proof, fri_roots, alphas, positions, deep,
                lde_size, L)


def _verify_fri(field, E, hasher, options, proof, roots, alphas, positions, evaluations,
                domain_size, max_degree_plus_1):
    P, N, eb, Eb = field.P, options.fri_folding_factor, field.ELEMENT_BYTES, E.ELEMENT_BYTES
    generator = field.root_of_unity(domain_size.bit_length() - 1)
    w_inv = field.inv(field.root_of_unity(N.bit_length() - 1))
    n_inv = field.inv(N)
    idft = [[pow(w_inv, i * j, P) * n_inv % P for i in range(N)] for j in range(N)]
    for depth, (values, paths) in enumerate(proof.fri_layers):
        row_length = domain_size // N
        folded = []
        for p in positions:
            if p % row_length not in folded:
                folded.append(p % row_length)
        flat = elements(values, E)
        if len(flat) != len(folded) * N:
            raise Rejected(f"FRI layer {depth} has the wrong number of values")
        rows = [flat[i * N:(i + 1) * N] for i in range(len(folded))]
        leaves = [hasher.hash(values[i * N * Eb:(i + 1) * N * Eb]) for i in range(len(folded))]
        if merkle_root(hasher, leaves, folded, paths, row_length.bit_length() - 1) != roots[depth]:
            raise Rejected(f"FRI layer {depth} openings do not match its commitment")
        for p, e in zip(positions, evaluations):
            if rows[folded.index(p % row_length)][p // row_length] != e:
                raise Rejected(f"FRI layer {depth} does not fold the previous layer")
        xs = [pow(generator, i, P) * field.GENERATOR % P for i in folded]
        evaluations = []
        for row, x_inv in zip(rows, E.batch_inv(xs)):
            beta = alphas[depth] * x_inv % P
            acc = 0
            for j in range(N - 1, -1, -1):
                acc = (acc * beta + sum(r * m for r, m in zip(row, idft[j]))) % P
            evaluations.append(acc)
        if max_degree_plus_1 % N:
            raise Rejected("FRI degree truncation")
        generator = pow(generator, N, P)
        max_degree_plus_1 //= N
        domain_size //= N
        positions = folded
    remainder = elements(proof.fri_remainder, E)
    n = len(remainder)
    if n == 0 or n & (n - 1):
        raise Rejected("the FRI remainder is not a power of two of values")
    if hasher.hash_elements(remainder, eb) != roots[-1]:
        raise Rejected("the FRI remainder does not match its commitment")
    if n > max_degree_plus_1:
        raise Rejected("the FRI remainder's degree is too high")
    for p, e in zip(positions, evaluations):
        x = field.GENERATOR * pow(generator, p, P) % P
        if field.horner(remainder, x) != e:
            raise Rejected("the FRI remainder does not fold the last layer")
