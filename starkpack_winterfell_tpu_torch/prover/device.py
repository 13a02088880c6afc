"""Device proving: routing, the small-trace pipeline, and the phases shared
by the device pipelines.

Counterpart of starkpack_winterfell_tpu/prover/device.py.  ``prove_device``
(:400) routes a prove: a trace with auxiliary segments, on any field, and
every field other than f64 go to parallel/full_pipeline.py ``prove_mesh``
(:410-418); an f64 config the big-trace pipeline supports goes to
``prove_big`` (prover/device_big.py), every other f64 config — traces
shorter than 2^14 rows, sequence assertions — to the small-trace pipeline
``_generate_proof_device`` (:437) below; what is not ported raises.

The small-trace pipeline keeps all instances stacked on a leading axis and
every bulk array on the device; the Fiat-Shamir channel stays on the host,
so device and host meet only where the transcript does (roots, OOD values,
FRI layer roots).  Its phases — ``trace_commit_kernel`` (:52),
``build_constraint_kernel`` (:99), ``ood_eval_kernel`` (:266),
``deep_kernel`` (:285), then ``run_fri_phase`` (:562) and ``assemble_proof``
(:600), which the big-trace pipeline borrows — are plain functions on
tensors: there is no jit cache, static tables are cached per device, and
every transform is an ``ops/ntt.py:ntt_components`` call, which on the card
runs the DIT kernels of ops/ntt_kernel.py.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..air.divisors import ConstraintDivisor
from ..air.transition import EvaluationFrame
from ..errors import ProverError
from ..math import scalar as fs
from ..ops import gl64 as gl, ntt, vec
from ..ops.felt import Felt
from ..utils.convert import limbs_to_elems, rows_to_words, scalar_to_limbs
from ..utils.device import resolve_device
from .constraints import (
    PeriodicValueTable,
    _exemptions_eval,
    _inv_divisor_numerator,
    tile_period,
)

PORTED_HASHERS = ("blake3_256", "blake3_192")  # the f64 paths
LIMB_HASHERS = ("blake3_256", "blake3_192", "sha3_256")  # the limb path
HOST_DIV_TABLE = 4096  # divisor periods up to this are inverted on the host

_logger = logging.getLogger("starkpack_winterfell_tpu_torch.prover.device")
_DIV_CACHE: dict = {}


def phase_marker():
    """Returns ``phase(name)``: logs, at DEBUG level, the wall time since the
    previous mark with ``(phase name, milliseconds)`` as the record's
    arguments.  Each phase of a device prove ends at a channel interaction
    that brings bytes to the host (a root, OOD values, the nonce), which
    waits for the device, so the walls are real phase costs."""
    t0 = time.perf_counter()

    def phase(name):
        nonlocal t0
        now = time.perf_counter()
        _logger.debug("%s in %.0f ms", name, (now - t0) * 1e3)
        t0 = now

    return phase


def merkle_levels(rows, hasher, row_elems: int, ext_deg: int):
    """rows: ext tuple of tensors shaped (L, row_elems) -> list of digest
    levels, leaves first."""
    words = rows_to_words(rows, ext_deg)
    leaves = hasher.hash_words(words, row_elems * ext_deg * 8)
    del words
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        cur = hasher.merge_words(cur[0::2], cur[1::2])
        levels.append(cur)
    return levels


# ---------------------------------------------------------------------------
# Phase 1: batched trace interpolation + LDE + combined-row commitment
# ---------------------------------------------------------------------------


def trace_commit_kernel(seg, blowup: int, offset: int, hasher):
    """seg: base tuple of one (n, w, length) tensor.  Returns (polys, lde,
    levels): the trace polynomials (n, w, length), the LDE (n, w, L) and the
    Merkle levels over its rows, laid out (L, n*w) instance-major."""
    n, w, length = seg[0].shape
    L = length * blowup
    polys = ntt.interpolate_poly(seg)
    lde = ntt.evaluate_poly_with_offset(polys, offset, blowup)
    rows = tuple(c.permute(2, 0, 1).reshape(L, n * w) for c in lde)
    return polys, lde, merkle_levels(rows, hasher, n * w, 1)


# ---------------------------------------------------------------------------
# Phase 2+3: constraint evaluation -> combined composition poly -> commitment
# ---------------------------------------------------------------------------


def _divisor_table(d, domain, device):
    """(ce,) tensor 1/(x^a - b) * prod (x - e_j) over the ce domain for the
    divisor (x^a - b) / prod (x - e_j): the inverted numerator over its
    period (python ints on the host for short periods, one Fermat inversion
    on the device for long ones), repeated, times the exemptions.  Static per
    config: cached per device."""
    ce = domain.ce_size
    key = (tuple(d.numerator), tuple(d.exemptions), ce, domain.domain_offset,
           str(device))
    if key not in _DIV_CACHE:
        a, b = d.numerator[0]
        m = ce // a
        if m <= HOST_DIV_TABLE:
            z = gl.from_u64(_inv_divisor_numerator(d, domain), device)
        else:
            # x^a over the ce domain has period m: offset^a * g^(i*a)
            g_a = pow(domain.ce_domain_generator(), a, gl.P)
            xs = gl.mul(ntt.power_series(g_a, m, device),
                        gl.from_int(pow(domain.domain_offset, a, gl.P), (), device))
            z = gl.inv(gl.sub(xs, gl.from_int(b, (), device)))
        zfull = tile_period(z, ce)
        if d.exemptions:
            zfull = gl.mul(zfull, _exemptions_eval(d, domain, device))
        _DIV_CACHE[key] = zfull
    return _DIV_CACHE[key]


def build_constraint_kernel(air0, domain, ext_deg, hasher, boundary_template,
                            main_lde, t_coeffs, b_single_vals, b_seq_vals,
                            b_coeffs, final_powers):
    """Evaluate every instance's constraints over the ce domain, combine,
    divide, interpolate, weight by final_coeff^i, sum over instances, split
    into composition columns and commit.

    main_lde: base tuple of (n, w, L); t_coeffs / b_coeffs: ext tuples of
    (n, K) / (n, A) composition coefficients; b_single_vals: list of (n, 1)
    single assertion values; b_seq_vals: list of (n, ce) sequence assertion
    values over the ce domain; final_powers: ext tuple of (n,).  Returns
    (composition column coefficients (num_cols, trace_length), composition
    LDE (num_cols, L), Merkle levels)."""
    ce = domain.ce_size
    L = domain.lde_size
    shift = domain.ce_to_lde_blowup
    blowup = domain.trace_to_lde_blowup
    trace_length = domain.trace_length
    num_cols = air0.context.num_constraint_composition_columns()
    K = air0.context.num_transition_constraints()
    lde0 = main_lde[0]
    n, w, _ = lde0.shape
    device = lde0.device

    divisors = [
        ConstraintDivisor.from_transition(
            trace_length, air0.context.num_transition_exemptions
        )
    ] + [g.divisor for g in boundary_template.main_constraints]
    div_tables = [_divisor_table(d, domain, device) for d in divisors]

    # frames over the instance axis, Felt arrays shaped (n, ce): ce step i
    # reads LDE position i*shift, the next row ``blowup`` positions further
    # on, wrapping at the end of the domain
    nxt_lde = torch.roll(lde0, -blowup, dims=2)
    cur = [Felt((lde0[:, j, ::shift],)) for j in range(w)]
    nxt = [Felt((nxt_lde[:, j, ::shift],)) for j in range(w)]
    pv = [Felt((c.unsqueeze(0).expand(n, ce),))
          for c in PeriodicValueTable(air0, device).columns]

    t_result = [None] * K
    air0.evaluate_transition(EvaluationFrame(cur, nxt), pv, t_result)
    combined = vec.vzeros((n, ce), ext_deg, device)
    for k_i, ev in enumerate(t_result):
        coef = tuple(c[:, k_i : k_i + 1] for c in t_coeffs)
        combined = vec.vadd(combined, vec.vmul(coef, ev.c))
    del t_result, nxt, nxt_lde, pv

    columns = [combined]
    sv_idx = sq_idx = a_idx = 0
    for g in boundary_template.main_constraints:
        acc = vec.vzeros((n, ce), ext_deg, device)
        for c in g.constraints:
            if len(c.poly) == 1:
                val = b_single_vals[sv_idx]  # (n, 1)
                sv_idx += 1
            else:
                val = b_seq_vals[sq_idx]  # (n, ce)
                sq_idx += 1
            diff = vec.vsub(cur[c.column].c, (val,))
            cc = tuple(x[:, a_idx : a_idx + 1] for x in b_coeffs)
            a_idx += 1
            acc = vec.vadd(acc, vec.vmul(cc, diff))
        columns.append(acc)
    del cur

    # divide by the divisors, sum the columns
    acc = vec.vzeros((n, ce), ext_deg, device)
    for col, zt in zip(columns, div_tables):
        acc = vec.vadd(acc, vec.vmul(vec.promote(col, ext_deg), (zt,)))
    del columns

    # interpolate each instance's combined evaluations, weight by the final
    # coefficient's powers, sum over the instances
    coeffs = ntt.interpolate_poly_with_offset(acc, domain.domain_offset)
    del acc
    fp = tuple(c[:, None] for c in final_powers)
    final_comb = vec.vsum(vec.vmul(coeffs, fp), axis=0)  # (ce,)
    del coeffs

    comp_columns = tuple(
        c.reshape(ce // trace_length, trace_length)[:num_cols]
        for c in vec.promote(final_comb, ext_deg)
    )
    comp_lde = ntt.evaluate_poly_with_offset(
        comp_columns, domain.domain_offset, L // trace_length
    )
    rows = tuple(c.T for c in comp_lde)
    return comp_columns, comp_lde, merkle_levels(rows, hasher, num_cols, ext_deg)


# ---------------------------------------------------------------------------
# Phase 4: OOD evaluation + DEEP composition + LDE
# ---------------------------------------------------------------------------


def ood_eval_kernel(polys, comp_columns, z, zg):
    """Evaluate all trace polys (n, w, length) at z and z*g and the
    composition columns (num_cols, length) at z.  Returns T(z), T(z*g) as
    ext tuples of (n, w) and H_k(z) as an ext tuple of (num_cols,)."""
    length = polys[0].shape[-1]
    powz = vec.power_series_elem(z, length)
    powzg = vec.power_series_elem(zg, length)
    tz = vec.vsum(vec.vmul(powz, polys), axis=-1)
    tzg = vec.vsum(vec.vmul(powzg, polys), axis=-1)
    hz = vec.vsum(vec.vmul(powz, vec.promote(comp_columns, len(z))), axis=-1)
    return tz, tzg, hz


def deep_kernel(polys, comp_columns, z, zg, tz, tzg, hz, cc_traces,
                cc_constraints, blowup: int, offset: int, ext_deg: int):
    """DEEP composition polynomial in coefficient form, then its LDE -> ext
    tuple of (L,)."""
    num_cols = comp_columns[0].shape[0]
    # T1 = sum_{i,j} k_ij P_ij(x): weight polys (n, w, len) by k (n, w)
    k = tuple(c[..., None] for c in cc_traces)
    weighted = vec.vmul(k, vec.promote(polys, ext_deg))
    t_poly = vec.vsum(vec.vsum(weighted, axis=0), axis=0)  # (len,)
    del weighted
    # constants: sum_{i,j} k_ij * T_ij(z) (resp. z*g)
    c1 = vec.vsum(vec.vsum(vec.vmul(cc_traces, tz), axis=-1), axis=-1)
    c2 = vec.vsum(vec.vsum(vec.vmul(cc_traces, tzg), axis=-1), axis=-1)
    length = t_poly[0].shape[-1]
    z_tables = vec.syn_div_tables(z, length)  # shared by every division by (x - z)
    q1 = vec.syn_div_binomial(_sub_const_dev(t_poly, c1), z, z_tables)
    q2 = vec.syn_div_binomial(_sub_const_dev(t_poly, c2), zg)
    total = vec.vadd(q1, q2)
    for i in range(num_cols):
        col = vec.promote(tuple(c[i] for c in comp_columns), ext_deg)
        col = _sub_const_dev(col, tuple(c[i : i + 1] for c in hz))
        q = vec.syn_div_binomial(col, z, z_tables)
        kc = tuple(c[i : i + 1] for c in cc_constraints)
        total = vec.vadd(total, vec.vmul(q, kc))
    return ntt.evaluate_poly_with_offset(total, offset, blowup)


def _sub_const_dev(poly, value):
    """Subtract a one-element value from coefficient 0."""
    d = max(len(poly), len(value))
    poly = vec.promote(poly, d)
    value = vec.promote(value, d)
    return tuple(
        torch.cat([gl.sub(c[:1], v.reshape(1)), c[1:]])
        for c, v in zip(poly, value)
    )


# ---------------------------------------------------------------------------
# Phase 5: FRI layer step
# ---------------------------------------------------------------------------


def fri_hash_kernel(evals, N: int, ext_deg: int, hasher):
    """Transpose + row-hash + Merkle levels for one FRI layer (the root must
    reach the transcript before alpha is drawn, so folding is separate).
    evals: ext tuple of (L,) tensors.  Returns (transposed (L/N, N), levels)."""
    L = evals[0].shape[-1]
    m = L // N
    transposed = tuple(c.reshape(N, m).T for c in evals)
    return transposed, merkle_levels(transposed, hasher, N, ext_deg)


def fri_fold_kernel(transposed, alpha_l, offset: int, ext_deg: int):
    from ..fri.prover import apply_drp_limbs

    return apply_drp_limbs(transposed, offset, alpha_l, ext_deg)


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def prove_device(prover, n: int, traces, device="cuda"):
    """Route a prove to the pipeline that supports its config: traces with
    auxiliary segments and the limb fields to ``prove_mesh`` (with the
    hashers of ``PORTED_HASHERS`` on f64, of ``LIMB_HASHERS`` on the limb
    fields), other f64 traces to the big-trace pipeline where it applies and
    to the small-trace pipeline otherwise.  A config none of them covers
    raises NotImplementedError naming it (there is no host pipeline to fall
    back to)."""
    from . import device_big

    dev = resolve_device(device)
    options = prover.options()
    ext_deg = options.field_extension
    hasher = prover.hasher
    pub0 = prover.get_pub_inputs(traces[0])
    air0 = prover.air_class(traces[0].get_info(), pub0, options)
    length = traces[0].length
    field = air0.field_spec().name
    hname = getattr(hasher, "NAME", None)
    num_aux = traces[0].num_aux_segments()

    def refuse(why):
        raise NotImplementedError(
            f"config not ported yet ({why}): air={type(air0).__name__}, "
            f"field={field}, extension degree={ext_deg}, "
            f"hasher={hname or hasher}, trace length={length}, "
            f"aux segments={num_aux}"
        )

    layout_aux = air0.trace_info().layout.num_aux_segments
    if num_aux != layout_aux:
        raise ProverError(
            f"the trace builds {num_aux} auxiliary segments, its layout has "
            f"{layout_aux}: air={type(air0).__name__}, field={field}")
    if field not in ("f64", "f128", "f62"):
        refuse("no backend for this field")
    if not air0.field_spec().supports_extension(ext_deg):
        # the reference's own refusal (FieldSpec.fmul), raised before any
        # work instead of at the OOD point: f128 has no cubic extension
        raise AssertionError(f"{field} does not support degree {ext_deg}")
    hashers = PORTED_HASHERS if field == "f64" else LIMB_HASHERS
    if hname not in hashers:
        path = "the f64 pipelines are" if field == "f64" else "the limb pipeline is"
        refuse(f"{path} ported with {', '.join(hashers)}")
    if num_aux > 0 or field != "f64":
        from ..parallel.full_pipeline import prove_mesh

        return prove_mesh(prover, n, traces, dev)
    if length >= device_big.MIN_TRACE_LENGTH:
        dummy_ccs = [0] * air0.context.num_assertions()
        bt = air0.get_boundary_constraints(None, dummy_ccs)
        if device_big.supported(air0, bt, length, ext_deg):
            return device_big.prove_big(prover, n, traces, dev)
    return _generate_proof_device(prover, n, traces, dev)


def _generate_proof_device(prover, n, traces, device):
    """Small-trace device prove — same transcript and bytes as the JAX
    package's host pipeline.  Phase walls are logged as ``phase_marker``
    describes."""
    from ..crypto.merkle import MerkleTree
    from .channel import ProverChannel
    from .domain import StarkDomain

    phase = phase_marker()
    options = prover.options()
    ext_deg = options.field_extension
    hasher = prover.hasher

    pub_inputs_vec = [prover.get_pub_inputs(t) for t in traces]
    pub_elements_vec = [p.to_elements() for p in pub_inputs_vec]
    airs = [
        prover.air_class(t.get_info(), p, options)
        for t, p in zip(traces, pub_inputs_vec)
    ]
    channel = ProverChannel(n, airs, pub_elements_vec, hasher, ext_deg, device=device)
    domain = StarkDomain(airs[0])
    w = traces[0].width
    length = traces[0].length
    blowup = domain.trace_to_lde_blowup
    offset = domain.domain_offset

    # ---- Phase 1: batched trace commitment ----
    stacked = np.stack([t.main_columns_u64() for t in traces])  # (n, w, len)
    seg = (gl.from_u64(stacked, device),)
    polys, lde, levels = trace_commit_kernel(seg, blowup, offset, hasher)
    del seg
    main_tree = MerkleTree(levels, hasher)
    channel.commit_trace(main_tree.root())
    phase("P1 trace interpolate+LDE+commit")

    # ---- Phase 2+3: constraints -> composition commitment ----
    t_coeffs_list, b_coeffs_list = [], []
    for _ in range(n):
        cc = channel.get_constraint_composition_coeffs()
        t_coeffs_list.append(cc.transition)
        b_coeffs_list.append(cc.boundary)
    final_coeff = channel.get_final_polynomial_coeffs()
    final_powers = [fs.fexp(final_coeff, i) for i in range(n)]

    # boundary structure + per-instance values
    dummy_ccs = [0] * airs[0].context.num_assertions()
    boundary_template = airs[0].get_boundary_constraints(None, dummy_ccs)
    per_instance = [air.get_boundary_constraints(None, dummy_ccs) for air in airs]
    b_single_vals, b_seq_vals = _stack_boundary_values(
        boundary_template, per_instance, domain, airs[0], device
    )

    comp_columns, comp_lde, clevels = build_constraint_kernel(
        airs[0], domain, ext_deg, hasher, boundary_template,
        lde,
        _stack_scalars(t_coeffs_list, ext_deg, device=device),
        b_single_vals, b_seq_vals,
        _stack_scalars(b_coeffs_list, ext_deg, device=device),
        _stack_scalars([[p] for p in final_powers], ext_deg, squeeze=True,
                       device=device),
    )
    constraint_tree = MerkleTree(clevels, hasher)
    channel.commit_constraints(constraint_tree.root())
    phase("P2+3 constraint eval+composition+commit")

    # ---- Phase 4: OOD + DEEP ----
    num_cols = airs[0].context.num_constraint_composition_columns()
    z = channel.get_ood_point()
    g_trace = fs.get_root_of_unity(length.bit_length() - 1)
    zg = fs.fmul(z, g_trace)
    z_l = scalar_to_limbs(z, ext_deg, device=device)
    zg_l = scalar_to_limbs(zg, ext_deg, device=device)
    tz, tzg, hz = ood_eval_kernel(polys, comp_columns, z_l, zg_l)
    tz_h = np.stack([gl.to_u64(c) for c in tz])  # (deg, n, w)
    tzg_h = np.stack([gl.to_u64(c) for c in tzg])
    hz_h = np.stack([gl.to_u64(c) for c in hz])
    ood_traces_states = []
    for i in range(n):
        at_z = [_elem_from(tz_h[:, i, j], ext_deg) for j in range(w)]
        at_zg = [_elem_from(tzg_h[:, i, j], ext_deg) for j in range(w)]
        ood_traces_states.append([at_z, at_zg])
    channel.send_ood_trace_states(ood_traces_states)
    ood_evaluations = [_elem_from(hz_h[:, j], ext_deg) for j in range(num_cols)]
    channel.send_ood_constraint_evaluations(ood_evaluations)
    phase("P4 OOD")

    cc = channel.get_deep_composition_coeffs()
    cc_traces = _stack_scalars(cc.traces, ext_deg, device=device)  # (n, w)
    cc_constraints = _stack_scalars([cc.constraints], ext_deg, squeeze=False,
                                    device=device)
    cc_constraints = tuple(c[0] for c in cc_constraints)  # (num_cols,)
    deep_evals = deep_kernel(polys, comp_columns, z_l, zg_l, tz, tzg, hz,
                             cc_traces, cc_constraints, blowup, offset, ext_deg)
    del polys

    # ---- Phase 5-6: FRI ----
    fri_layers, remainder_elements = run_fri_phase(
        channel, deep_evals, options, domain, ext_deg, hasher
    )
    del deep_evals
    phase("P5+6 DEEP+FRI")

    # ---- Phase 7-8: PoW + queries + assembly ----
    channel.grind_query_seed()
    positions = channel.get_query_positions()
    phase("P7 PoW+positions")
    out = assemble_proof(
        channel, positions, lde, comp_lde, main_tree, constraint_tree,
        fri_layers, remainder_elements, options, domain, n, ext_deg
    )
    phase("P8 queries+assembly")
    return out


def run_fri_phase(channel, deep_evals, options, domain, ext_deg, hasher):
    """Phase 5: FRI layer commit/fold loop + remainder.  Returns
    ([(transposed, MerkleTree)], remainder_elements)."""
    from ..crypto.merkle import MerkleTree

    device = deep_evals[0].device
    L = deep_evals[0].shape[-1]
    fri_options = options.to_fri_options()
    N = fri_options.folding_factor
    evals = deep_evals
    fri_layers = []
    for _ in range(fri_options.num_fri_layers(L)):
        transposed, flevels = fri_hash_kernel(evals, N, ext_deg, hasher)
        tree = MerkleTree(flevels, hasher)
        channel.commit_fri_layer(tree.root())
        alpha = channel.draw_fri_alpha()
        evals = fri_fold_kernel(
            transposed, scalar_to_limbs(alpha, ext_deg, device=device),
            domain.domain_offset, ext_deg,
        )
        fri_layers.append((transposed, tree))

    # the final layer (at most a few hundred elements) is interpolated on
    # the host, as the JAX package does at this step (its prover/device.py
    # run_fri_phase): the coefficients go straight into the host transcript
    evals = tuple(c.cpu() for c in evals)
    coeffs = ntt.interpolate_poly_with_offset(evals, domain.domain_offset)
    rem_size = evals[0].shape[-1] // fri_options.blowup_factor
    remainder_elements = limbs_to_elems(
        tuple(c[:rem_size] for c in coeffs), ext_deg
    )
    channel.commit_fri_layer(hasher.hash_elements(remainder_elements))
    return fri_layers, remainder_elements


def _gather_host(comps, positions, axis: int):
    """Queried slices of each component, gathered on the device and brought
    to the host in one copy per component (numpy uint64)."""
    idx = torch.as_tensor(list(positions), dtype=torch.int64, device=comps[0].device)
    return tuple(gl.to_u64(c.index_select(axis, idx)) for c in comps)


def assemble_proof(channel, positions, lde, comp_lde, main_tree, constraint_tree,
                   fri_layers, remainder_elements, options, domain, n, ext_deg):
    """Phase 8: gather ONLY the queried rows off the device and build the
    StarkProof."""
    from ..air.proof import JointTraceQueries, Queries
    from ..crypto.merkle import MerkleTree
    from ..fri.proof import FriProof, FriProofLayer
    from ..fri.prover import fold_positions

    fri_options = options.to_fri_options()
    N = fri_options.folding_factor
    L = domain.lde_size

    layer_pos = []
    pos = list(positions)
    dsize = L
    for _ in fri_layers:
        pos = fold_positions(pos, dsize, N)
        layer_pos.append(pos)
        dsize //= N
    MerkleTree.prefetch_trees(
        [(tree, lp) for (_, tree), lp in zip(fri_layers, layer_pos)]
        + [(main_tree, positions), (constraint_tree, positions)]
    )

    proof_layers = []
    for (transposed, tree), pos in zip(fri_layers, layer_pos):
        gathered = _gather_host(transposed, pos, 0)  # ext tuple of (q, N)
        mp = tree.prove_batch(pos)
        rows = [
            _row_elems(tuple(c[i] for c in gathered), ext_deg)
            for i in range(len(pos))
        ]
        proof_layers.append(FriProofLayer.new(rows, mp, ext_deg))
    fri_proof = FriProof.new(proof_layers, remainder_elements, 1)

    main_rows = _gather_host(lde, positions, 2)  # (n, w, q)
    traces_states = []
    for i in range(n):
        rows = []
        for qi in range(len(positions)):
            rows.append(_row_elems(tuple(c[i, :, qi] for c in main_rows), 1))
        traces_states.append(rows)
    comb_states = []
    for qi in range(len(positions)):
        row = []
        for ts in traces_states:
            row.extend(ts[qi])
        comb_states.append(row)
    trace_queries = [
        JointTraceQueries.new(main_tree.prove_batch(positions), comb_states, traces_states)
    ]

    comp_rows = _gather_host(comp_lde, positions, 1)  # (num_cols, q)
    crows = [
        _row_elems(tuple(c[:, qi] for c in comp_rows), ext_deg)
        for qi in range(len(positions))
    ]
    constraint_queries = Queries.new(constraint_tree.prove_batch(positions), crows, ext_deg)

    return channel.build_proof(trace_queries, constraint_queries, fri_proof)


def _row_elems(comps_u64, deg: int):
    """Tuple of ``deg`` numpy uint64 rows -> list of ints/tuples."""
    if deg == 1:
        return [int(v) for v in comps_u64[0]]
    k = comps_u64[0].shape[0]
    return [tuple(int(comps_u64[c][i]) for c in range(deg)) for i in range(k)]


def _stack_scalars(rows, ext_deg, squeeze=False, device="cpu"):
    """rows: list (n) of lists (k) of elements -> ext tuple of (n, k) tensors
    (or (n,) when squeeze and k == 1)."""
    n = len(rows)
    k = len(rows[0])
    arr = np.zeros((ext_deg, n, k), dtype=np.uint64)
    for i, row in enumerate(rows):
        for j, e in enumerate(row):
            comps = fs.components(fs.embed(e, ext_deg))
            for c in range(ext_deg):
                arr[c, i, j] = comps[c]
    if squeeze:
        arr = arr[:, :, 0]
    return tuple(gl.from_u64(arr[c], device) for c in range(ext_deg))


def _stack_boundary_values(template, per_instance, domain, air0, device="cpu"):
    """Stack per-instance boundary constraint values.

    Returns (b_single_vals, b_seq_vals): lists in group/constraint order —
    single values as (n, 1) tensors, sequence/periodic polys as (n, ce)
    tensors of their ce-domain evaluations."""
    n = len(per_instance)
    ce = domain.ce_size
    singles, seqs = [], []
    for gi, g in enumerate(template.main_constraints):
        for ci, c in enumerate(g.constraints):
            polys = [per_instance[i].main_constraints[gi].constraints[ci].poly
                     for i in range(n)]
            if len(c.poly) == 1:
                vals = np.array([p[0] for p in polys], dtype=np.uint64).reshape(n, 1)
                singles.append(gl.from_u64(vals, device))
                continue
            coeffs = (gl.from_u64(np.array(polys, dtype=np.uint64), device),)
            m = len(c.poly)
            if m < ce:
                evals = ntt.evaluate_poly_with_offset(
                    coeffs, air0.domain_offset(), ce // m)[0]
            else:
                evals = ntt.evaluate_poly(coeffs)[0]
            step_offset = c.poly_offset[0] * air0.ce_blowup_factor()
            seqs.append(torch.roll(evals, step_offset, dims=-1))
    return singles, seqs


def _elem_from(comps_u64, ext_deg):
    if ext_deg == 1:
        return int(comps_u64[0])
    return tuple(int(comps_u64[c]) for c in range(ext_deg))
