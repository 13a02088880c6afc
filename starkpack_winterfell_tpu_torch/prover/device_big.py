"""Gather-free device pipeline for large traces (length >= 2^14).

Counterpart of starkpack_winterfell_tpu/prover/device_big.py: every phase is
cut on the four-step tile transforms of ``ops/ntt4.py`` so the whole prove
is permutation-free.

* Phase 1  trace interpolate+LDE through the DIF/DIT tile kernel; the
  permuted K2 intermediates (offset^j-scaled coefficients) are kept for
  out-of-domain evaluation.
* Phase 2  constraint frames are strided slices; the ce domain is walked in
  chunks by a python loop (the JAX package's ``lax.scan``), each chunk's
  divisor inverses computed in place; the composition polynomial is
  interpolated with ``intt_permuted``, split into columns with a strided
  slice (``slice_columns_permuted``) and re-evaluated with
  ``lde_from_permuted`` — no natural-order coefficient array materializes.
* Phase 4  OOD values are dot products of the permuted coefficients with
  ``permuted_power_series``; the DEEP composition is evaluated POINTWISE
  over the LDE domain, (T(x)-T(z))*inv(x-z) — algebraically identical to
  coefficient-space synthetic division since both agree with the quotient
  polynomial on every domain point, and word-identical because field
  arithmetic is exact.
* Phases 5-6 reuse the FRI/assembly helpers of device.py.

Ported: f64 AIRs at extension degree 1, 2 or 3 (the composition, DEEP and
FRI arrays are then extension elements, one tensor a component), main
segment only, single-value and periodic boundary assertions, the hashers
of ``device.PORTED_HASHERS`` (BLAKE3, SHA3-256 and the algebraic Rp64_256,
RpJive64_256 and GriffinJive64_256, whose Merkle trees run on the sponge
kernel of ops/rescue_sponge.py).  ``device.prove_device``
sends every other f64 config to the small-trace pipeline or refuses it.

Apart from the tile transform (a CUDA kernel on the card) everything here is
plain eager tensor code, and runs unchanged on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..air.divisors import ConstraintDivisor
from ..air.transition import EvaluationFrame
from ..crypto.merkle import MerkleTree
from ..math import scalar as fs
from ..ops import gl64 as gl, ntt, ntt4, vec
from ..ops.felt import Felt
from ..utils.convert import scalar_to_limbs
from .channel import ProverChannel
from .constraints import _inv_divisor_numerator, tile_period as _tile
from .device import (
    _elem_from,
    _stack_boundary_values,
    _stack_scalars,
    assemble_proof,
    merkle_levels as _merkle_levels,
    phase_marker,
    run_fri_phase,
)
from .domain import StarkDomain

SMALL_DIV_TABLE = 4096  # divisor periods up to this are host tables
CHUNK_SIZE = 1 << 20  # ce-domain chunk for the constraint loop (memory bound)
MIN_TRACE_LENGTH = 1 << 14  # shorter traces take the small-trace pipeline


def supported(air0, boundary_template, length, ext_deg) -> bool:
    """True when the gather-free pipeline can prove this config."""
    if air0.field_spec().name != "f64":
        return False
    if ext_deg not in (1, 2, 3):
        return False
    domain_ce = air0.ce_domain_size()
    L = air0.lde_domain_size()
    if not (ntt4.supported(length, L) and ntt4.supported(domain_ce, L)):
        return False
    nc_total = domain_ce // length
    # the column split must divide the permuted row dimension
    b_ce = ntt4._pick_factors(domain_ce, L)[1]
    if nc_total > 1 and b_ce % nc_total != 0:
        return False
    for g in boundary_template.main_constraints:
        for c in g.constraints:
            if len(c.poly) != 1:
                return False
    return True


# ---------------------------------------------------------------------------
# Phase 1: trace interpolate + LDE + commitment
# ---------------------------------------------------------------------------


def trace_commit_big(seg, blowup: int, offset: int, hasher):
    """seg: base tuple of one (n, w, length) tensor.  Returns (pc1, lde,
    levels): the permuted offset^j-scaled coefficients (n, w, b, a), the LDE
    (n, w, L) and the Merkle levels over its rows, laid out (L, n*w)
    instance-major."""
    n, w, length = seg[0].shape
    L = length * blowup
    lde, pc = ntt4.interpolate_lde(seg, blowup, offset, return_permuted=True)
    rows = tuple(c.permute(2, 0, 1).reshape(L, n * w) for c in lde)
    return pc[0], lde, _merkle_levels(rows, hasher, n * w, 1)


# ---------------------------------------------------------------------------
# Phase 2+3: constraints -> composition columns (permuted) -> commitment
# ---------------------------------------------------------------------------


def _small_periodic_columns(air, device):
    """Per-column periodic evaluations over ONE period (m = cycle *
    ce_blowup), to be tiled over a chunk — without materializing (ce,)
    arrays.  Columns of one cycle length are evaluated in one batched
    transform, as ``prover/constraints.py:PeriodicValueTable`` does."""
    polys = air.get_periodic_column_polys()
    cols = [None] * len(polys)
    by_len = {}
    for j, poly in enumerate(polys):
        by_len.setdefault(len(poly), []).append(j)
    for poly_size, js in by_len.items():
        num_cycles = air.trace_length() // poly_size
        offset = pow(air.domain_offset(), num_cycles, gl.P)
        coeffs = gl.from_u64(np.array([polys[j] for j in js], dtype=np.uint64), device)
        evals = ntt.evaluate_poly_with_offset((coeffs,), offset, air.ce_blowup_factor())[0]
        for row, j in enumerate(js):
            cols[j] = evals[row]
    return cols


def _batch_inverse(dens):
    """1/d for every tensor of ``dens`` behind ONE Fermat inversion (the
    Montgomery trick: 1 exp + 3(k-1) muls instead of k exps)."""
    prefix = [dens[0]]
    for d in dens[1:]:
        prefix.append(gl.mul(prefix[-1], d))
    inv_all = gl.inv(prefix[-1])
    invs = []
    for i in range(len(dens) - 1, 0, -1):
        invs.append(gl.mul(inv_all, prefix[i - 1]))
        inv_all = gl.mul(inv_all, dens[i])
    invs.append(inv_all)
    invs.reverse()
    return invs


def constraint_kernel_big(air0, domain, ext_deg, hasher, boundary_template,
                          main_lde, t_coeffs, b_single_vals, b_coeffs,
                          final_powers):
    """Evaluate every instance's constraints over the ce domain, combine,
    divide, interpolate, weight by final_coeff^i, sum over instances, split
    into composition columns and commit.

    main_lde: base tuple of (n, w, L); t_coeffs / b_coeffs: ext tuples of
    (n, K) / (n, A) composition coefficients; b_single_vals: list of (n, 1)
    assertion values; final_powers: ext tuple of (n,).  Returns (stacked
    permuted column coefficients (num_cols, rows_col, a), composition LDE
    (num_cols, L), Merkle levels)."""
    ce = domain.ce_size
    L = domain.lde_size
    shift = domain.ce_to_lde_blowup
    blowup = domain.trace_to_lde_blowup
    trace_length = domain.trace_length
    num_cols = air0.context.num_constraint_composition_columns()
    nc_total = ce // trace_length
    K = air0.context.num_transition_constraints()
    offset = domain.domain_offset
    lde0 = main_lde[0]
    n, w, _ = lde0.shape
    device = lde0.device

    # chunk the ce domain so frame/constraint temporaries stay bounded
    CHUNK = min(ce, CHUNK_SIZE)
    C = ce // CHUNK

    # --- static divisor data: (a_exp, b_val, exemptions, tiled host table) ---
    divisors = [
        ConstraintDivisor.from_transition(
            trace_length, air0.context.num_transition_exemptions
        )
    ] + [g.divisor for g in boundary_template.main_constraints]
    g_ce = domain.ce_domain_generator()
    div_static = []
    for d in divisors:
        a_exp, b_val = d.numerator[0]
        table = None
        if ce // a_exp <= SMALL_DIV_TABLE:
            # short period: host table, chunk-invariant once tiled
            table = _tile(gl.from_u64(_inv_divisor_numerator(d, domain), device), CHUNK)
        div_static.append((a_exp, b_val, tuple(d.exemptions), table))
    groups_static = [
        [c.column for c in g.constraints] for g in boundary_template.main_constraints
    ]
    need_x = any(ex for (_, _, ex, _) in div_static)

    pv_chunk = [
        Felt((_tile(c, CHUNK).unsqueeze(0),))
        for c in _small_periodic_columns(air0, device)
    ]

    # carried per-chunk scalars: a series over one chunk is computed once;
    # chunk c's values are base_series * carry, and the carry (a python int)
    # advances by a static factor per chunk
    x_series = ntt.power_series(g_ce, CHUNK, device) if need_x else None
    x_carry, x_factor = offset, pow(g_ce, CHUNK, gl.P)
    div_series, div_carry, div_factor = [], [], []
    for a_exp, _, _, table in div_static:
        if table is not None:
            continue
        g_a = pow(g_ce, a_exp, gl.P)
        div_series.append(ntt.power_series(g_a, CHUNK, device))
        div_carry.append(pow(offset, a_exp, gl.P))
        div_factor.append(pow(g_a, CHUNK, gl.P))

    acc = tuple(gl.zeros((n, ce), device) for _ in range(ext_deg))
    span = CHUNK * shift + blowup
    for ci in range(C):
        start = ci * CHUNK * shift
        # the next-row frame is ``blowup`` positions ahead and wraps at the
        # end of the domain (only the last chunk reaches past it)
        if start + span <= L:
            sl = lde0[..., start : start + span]
        else:
            sl = torch.cat([lde0[..., start:], lde0[..., : start + span - L]], dim=-1)
        cur = [Felt((sl[:, j, : CHUNK * shift : shift],)) for j in range(w)]
        nxt = [Felt((sl[:, j, blowup::shift][:, :CHUNK],)) for j in range(w)]

        t_result = [None] * K
        air0.evaluate_transition(EvaluationFrame(cur, nxt), pv_chunk, t_result)
        combined = vec.vzeros((n, CHUNK), ext_deg, device)
        for k_i, ev in enumerate(t_result):
            coef = tuple(c[:, k_i : k_i + 1] for c in t_coeffs)
            combined = vec.vadd(combined, vec.vmul(coef, ev.c))
        del t_result, nxt

        columns = [combined]
        sv_idx = 0
        for cons in groups_static:
            acc_g = vec.vzeros((n, CHUNK), ext_deg, device)
            for column in cons:
                diff = vec.vsub(cur[column].c, (b_single_vals[sv_idx],))
                cc = tuple(c[:, sv_idx : sv_idx + 1] for c in b_coeffs)
                sv_idx += 1
                acc_g = vec.vadd(acc_g, vec.vmul(cc, diff))
            columns.append(acc_g)
        del cur, sl

        # divisors: (x^a - b) per device-computed divisor, inverted together
        x_chunk = gl.mul(x_series, gl.from_int(x_carry, (), device)) if need_x else None
        dens = []
        di = 0
        for a_exp, b_val, _, table in div_static:
            if table is not None:
                continue
            xs = gl.mul(div_series[di], gl.from_int(div_carry[di], (), device))
            dens.append(gl.sub(xs, gl.from_int(b_val, (), device)))
            di += 1
        invs = _batch_inverse(dens) if dens else []

        acc_c = vec.vzeros((n, CHUNK), ext_deg, device)
        di = 0
        for a_exp, b_val, exemptions, table in div_static:
            if table is not None:
                z = table
            else:
                z = invs[di]
                di += 1
            for e in exemptions:
                z = gl.mul(z, gl.sub(x_chunk, gl.from_int(e, (), device)))
            col = columns.pop(0)
            acc_c = vec.vadd(acc_c, vec.vmul(vec.promote(col, ext_deg), (z,)))
        for a, part in zip(acc, acc_c):
            a[:, ci * CHUNK : (ci + 1) * CHUNK] = part
        del columns, acc_c, invs, dens

        x_carry = x_carry * x_factor % gl.P
        div_carry = [c * f % gl.P for c, f in zip(div_carry, div_factor)]

    # interpolate (permuted), weight by final powers, sum instances
    pc = ntt4.intt_permuted(acc, offset, L)  # ext tuple of (n, b, a)
    del acc
    fp = tuple(c[:, None, None] for c in final_powers)
    final_pc = vec.vsum(vec.vmul(pc, fp), axis=0)  # ext tuple of (b, a)

    cols_perm = ntt4.slice_columns_permuted(final_pc, nc_total, keep=num_cols)
    stacked = tuple(
        torch.stack([col[c] for col in cols_perm]) for c in range(ext_deg)
    )  # ext tuple of (num_cols, rows_col, a)
    comp_lde = ntt4.lde_from_permuted(stacked, L, offset)
    rows = tuple(c.T for c in comp_lde)
    levels = _merkle_levels(rows, hasher, num_cols, ext_deg)
    return stacked, comp_lde, levels


# ---------------------------------------------------------------------------
# Phase 4: OOD via permuted dot products + pointwise DEEP over the LDE
# ---------------------------------------------------------------------------


def _dot_last2(a, b):
    return vec.vsum(vec.vsum(vec.vmul(a, b), axis=-1), axis=-1)


def ood_kernel_big(pc1, pc_cols, z_over_o, zg_over_o, z, length: int, tl: int):
    """pc1: base tensor (n, w, b1, a1) holding offset^j * c_j; pc_cols: ext
    tuple of (num_cols, b2, a2) true column coefficients.  Returns T(z),
    T(z*g) as ext tuples of (n, w) and H_k(z) as an ext tuple of
    (num_cols,)."""
    b1, a1 = pc1.shape[-2:]
    b2, a2 = pc_cols[0].shape[-2:]
    tz = _dot_last2((pc1,), ntt4.permuted_power_series(z_over_o, length, a1, b1))
    tzg = _dot_last2((pc1,), ntt4.permuted_power_series(zg_over_o, length, a1, b1))
    hz = _dot_last2(pc_cols, ntt4.permuted_power_series(z, tl, a2, b2))
    return tz, tzg, hz


def deep_kernel_big(lde, comp_lde, z, zg, tz, tzg, hz, cc_traces, cc_constraints,
                    offset: int, ext_deg: int):
    """DEEP composition evaluated pointwise over the LDE domain -> ext tuple
    of (L,)."""
    n, w, L = lde[0].shape
    num_cols = comp_lde[0].shape[0]
    device = lde[0].device
    w_L = gl.get_root_of_unity(L.bit_length() - 1)
    x = gl.mul(ntt.power_series(w_L, L, device), gl.from_int(offset, (), device))
    inv_z = vec.vinv(vec.vsub((x,), z))
    inv_zg = vec.vinv(vec.vsub((x,), zg))
    del x

    # accumulate W = sum_ij k_ij * T_ij(x) column by column so the peak
    # temporary is O(L), not O(n*w*L) (order-independent: exact modular adds)
    W = vec.vzeros((L,), ext_deg, device)
    for i in range(n):
        for j in range(w):
            kij = tuple(c[i, j : j + 1] for c in cc_traces)
            tij = tuple(c[i, j] for c in lde)
            W = vec.vadd(W, vec.vmul(kij, tij))
    c1 = vec.vsum(vec.vsum(vec.vmul(cc_traces, tz), axis=-1), axis=-1)
    c2 = vec.vsum(vec.vsum(vec.vmul(cc_traces, tzg), axis=-1), axis=-1)
    total = vec.vadd(
        vec.vmul(vec.vsub(W, c1), inv_z),
        vec.vmul(vec.vsub(W, c2), inv_zg),
    )
    for i in range(num_cols):
        col = tuple(c[i] for c in comp_lde)
        hz_i = tuple(c[i : i + 1] for c in hz)
        q = vec.vmul(vec.vsub(vec.promote(col, ext_deg), hz_i), inv_z)
        kc = tuple(c[i : i + 1] for c in cc_constraints)
        total = vec.vadd(total, vec.vmul(q, kc))
    return total


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def prove_big(prover, n, traces, device):
    """Gather-free device prove — same transcript and bytes as the JAX
    package's host pipeline.

    Each phase ends at a Fiat-Shamir channel interaction that brings bytes
    to the host (a root, OOD values, the nonce), which waits for the device,
    so the phase walls logged at DEBUG level (``phase_marker``) are real
    phase costs."""
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
    tl = domain.trace_length
    offset = domain.domain_offset

    # ---- Phase 1 ----
    stacked = np.stack([t.main_columns_u64() for t in traces])  # (n, w, len)
    seg = (gl.from_u64(stacked, device),)
    pc1, lde, levels = trace_commit_big(seg, blowup, offset, hasher)
    del seg
    main_tree = MerkleTree(levels, hasher)
    channel.commit_trace(main_tree.root())
    phase("P1 trace interpolate+LDE+commit")

    # ---- Phase 2+3 ----
    t_coeffs_list, b_coeffs_list = [], []
    for _ in range(n):
        cc = channel.get_constraint_composition_coeffs()
        t_coeffs_list.append(cc.transition)
        b_coeffs_list.append(cc.boundary)
    final_coeff = channel.get_final_polynomial_coeffs()
    final_powers = [fs.fexp(final_coeff, i) for i in range(n)]

    dummy_ccs = [0] * airs[0].context.num_assertions()
    boundary_template = airs[0].get_boundary_constraints(None, dummy_ccs)
    per_instance = [air.get_boundary_constraints(None, dummy_ccs) for air in airs]
    b_single_vals, _ = _stack_boundary_values(
        boundary_template, per_instance, domain, airs[0], device)

    pc_cols, comp_lde, clevels = constraint_kernel_big(
        airs[0], domain, ext_deg, hasher, boundary_template,
        lde,
        _stack_scalars(t_coeffs_list, ext_deg, device=device),
        b_single_vals,
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
    inv_o = pow(offset, fs.P - 2, fs.P)
    z_l = scalar_to_limbs(z, ext_deg, device=device)
    zg_l = scalar_to_limbs(zg, ext_deg, device=device)
    z_over_o = scalar_to_limbs(fs.fmul(z, inv_o), ext_deg, device=device)
    zg_over_o = scalar_to_limbs(fs.fmul(zg, inv_o), ext_deg, device=device)

    tz, tzg, hz = ood_kernel_big(pc1, pc_cols, z_over_o, zg_over_o, z_l, length, tl)
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
    cc_constraints = tuple(c[0] for c in cc_constraints)
    deep_evals = deep_kernel_big(lde, comp_lde, z_l, zg_l, tz, tzg, hz, cc_traces,
                                 cc_constraints, offset, ext_deg)
    del pc1, pc_cols

    # ---- Phase 5-6 ----
    fri_layers, remainder_elements = run_fri_phase(
        channel, deep_evals, options, domain, ext_deg, hasher
    )
    del deep_evals
    phase("P5+6 DEEP+FRI")
    channel.grind_query_seed()
    positions = channel.get_query_positions()
    phase("P7 PoW+positions")
    out = assemble_proof(
        channel, positions, lde, comp_lde, main_tree, constraint_tree,
        fri_layers, remainder_elements, options, domain, n, ext_deg
    )
    phase("P8 queries+assembly")
    return out
