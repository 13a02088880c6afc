"""The limb-field proving pipeline on one device.

Counterpart of starkpack_winterfell_tpu/parallel/full_pipeline.py
(``prove_mesh`` :682) for a mesh of ONE device: no mesh object, no
``shard_map``, no collectives and no jit cache — every phase is eager tensor
code around the two CUDA kernels of the path (the limb NTT tile,
ops/limb_ntt.py, and the whole-AIR constraint evaluation,
ops/cons_kernel.py).

  P1   main-trace commitment: interpolate, coset LDE, row words, BLAKE3
       leaves, Merkle levels (``sharded_segment_commit`` :118).
  P2   constraint evaluation over the ce domain, all instances combined
       with final_coeff^i, in the constraint kernel
       (``pallas_constraint_phase`` :442; its frame slicing happens by index
       inside the kernel).  Sequence assertions enter as (n, ce) tables,
       evaluated on the device from their (n, m) coefficient stacks (:846).
  P3   composition polynomial: interpolate, split into columns, coset LDE
       coset by coset against an offsets table, commit
       (``sharded_lde_blocks`` :191).
  P4-8 ``prover/pipeline.finish_proof`` with the device hooks of
       ``_limb_tail_kernels`` :1353 (OOD dots, DEEP composition) at every
       trace length (the JAX package keeps a host tail below 4096 rows; the
       values are the same), the DEEP LDE and ``fri/prover.LimbFriProver``
       (what ``MeshFriProver`` :1215 does on one device), and one gather of
       the queried rows.

Ported: limb-field AIRs (f128, f62) at extension degree 1, main segment only,
single-value and sequence boundary assertions, BLAKE3-256, BLAKE3-192 and
SHA3-256.  Aux segments, extensions, other hashers and configs that would
need the coset-streamed kernels raise NotImplementedError
(``prover/device.py``, ``parallel/streamed.py``).  Proof bytes equal the JAX
package's host pipeline.
"""

from __future__ import annotations

import logging
import time

import torch

from ..air.divisors import ConstraintDivisor
from ..crypto.merkle import MerkleTree, build_levels
from ..errors import ProverError
from ..fri.prover import LimbFriProver
from ..ops import cons_kernel
from ..ops.backend import get_backend
from ..prover.channel import ProverChannel
from ..prover.domain import StarkDomain
from ..prover.pipeline import finish_proof
from . import streamed

# the phase records go to the logger chip_smoke.py and the CLI's --verbose
# listen to, as prove_big's do
logger = logging.getLogger("starkpack_winterfell_tpu_torch.prover.device")

# per-config device tables (coset offsets, divisor and periodic tables):
# they depend on the configuration, not on the traces or the transcript
_TABLE_CACHE: dict = {}


def _cached(key, make):
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = make()
    return _TABLE_CACHE[key]


def _row_levels(B, rows, hasher, row_elems: int, deg: int):
    """rows: comps shaped (L, row_elems) -> Merkle levels, leaves first."""
    words = B.rows_to_words(rows, deg)
    leaves = hasher.hash_words(words, row_elems * deg * B.ELEMENT_BYTES)
    del words
    return build_levels(leaves, hasher)


# ---------------------------------------------------------------------------
# P1: interpolate + LDE + combined-row commitment
# ---------------------------------------------------------------------------


def sharded_segment_commit(B, hasher, comps, blowup: int, offset: int, deg: int):
    """comps shaped (n, w, length) -> (polys (n, w, length), lde_rows
    (n, w, L), Merkle levels over the combined rows (L, n*w))."""
    n, w, length = comps[0][0].shape
    L = length * blowup
    polys = B.interpolate_poly(comps)
    lde = B.evaluate_poly_with_offset(polys, offset, blowup)
    rows = B.emap(lambda l: l.permute(2, 0, 1).reshape(L, n * w), lde)
    return polys, lde, _row_levels(B, rows, hasher, n * w, deg)


# ---------------------------------------------------------------------------
# P3: coset LDE of coefficient columns (composition / DEEP)
# ---------------------------------------------------------------------------


def _coset_offsets(B, length: int, blowup: int, offset: int, device):
    """T[r, j] = (offset * g_L^r)^j as one component shaped (blowup, length),
    log-doubled on the device and kept there across proves."""

    def build():
        g_L = B.get_root_of_unity((length * blowup).bit_length() - 1)
        bases = B.b_from_ints(
            [(offset * pow(g_L, r, B.P)) % B.P for r in range(blowup)], device
        )
        return B.F._pow_series(B.cmap(lambda l: l.reshape(blowup, 1), bases), length)

    return _cached(("offs", B.name, length, blowup, offset, str(device)), build)


def sharded_lde_blocks(B, comps, blowup: int, offset: int, hasher=None, deg=1):
    """Coefficient columns (C, length) comps -> evals (C, L) comps in natural
    order: coset r (natural index i = q*blowup + r) is the length-sized NTT
    of the coefficients scaled by (offset*g_L^r)^j.  With ``hasher`` also
    row-hashes the evaluations into Merkle levels."""
    C, length = comps[0][0].shape
    L = length * blowup
    offs = _coset_offsets(B, length, blowup, offset, comps[0][0].device)
    offs_b = B.cmap(lambda o: o[:, None, :], offs)
    scaled = tuple(B.bmul(B.cmap(lambda l: l[None, :, :], c), offs_b) for c in comps)
    evals = B.evaluate_poly_with_offset(scaled, 1, 1)  # plain NTT, last axis
    # natural-order rows: out[c, q*blowup + r] = evals[r, c, q]
    out = B.emap(lambda a: a.permute(1, 2, 0).reshape(C, L), evals)
    if hasher is None:
        return out
    rows = B.emap(lambda a: a.T, out)
    return out, _row_levels(B, rows, hasher, C, deg)


# ---------------------------------------------------------------------------
# P2: constraint evaluation
# ---------------------------------------------------------------------------


def _pcons_gate(plan, ext_deg, spec):
    """What the constraint kernel takes: main segment only, no field
    extension, a limb field; single-value and sequence assertions."""
    return not plan["has_aux"] and ext_deg == 1 and spec.name in ("f62", "f128")


def _inv_divisor_numerator(B, divisor, domain, device):
    """Batch-inverted evaluations of (x^a - b) over its period on the ce
    domain, one component shaped (ce/a,)."""
    a, b = divisor.numerator[0]
    n = domain.ce_size // a
    # x^a over the ce domain has period n: (offset*g^i)^a = offset^a * g^(ia)
    g_a = pow(domain.ce_domain_generator(), a, B.P)
    offs_a = pow(domain.domain_offset, a, B.P)
    xs = B.bmul(B.power_series(g_a, n, device), B.b_from_int(offs_a, (1,), device))
    return B.b_batch_inv(B.bsub(xs, B.b_from_int(b, (1,), device)))


def _exemptions_eval(B, divisor, domain, device):
    """prod (x - e_j) over the ce domain (one component, shape (ce,))."""
    x = B.bmul(B.power_series(domain.ce_domain_generator(), domain.ce_size, device),
               B.b_from_int(domain.domain_offset, (1,), device))
    result = None
    for e in divisor.exemptions:
        term = B.bsub(x, B.b_from_int(e, (1,), device))
        result = term if result is None else B.bmul(result, term)
    return result


def _periodic_tables(B, air0, device):
    """One period of every periodic column over the ce domain: a list of
    components shaped (cycle * ce_blowup,) (the value at ce step i is
    table[i % len(table)]).  Columns of different periods (Lamport-agg: 8
    and the signature block) stay at their own lengths here; the kernel's
    wrapper tiles them all to the longest period, which every period
    divides, so tab[i % longest] read from a tiled table is tab[i % len]."""
    tabs = []
    for poly in air0.get_periodic_column_polys():
        num_cycles = air0.trace_length() // len(poly)
        offset = pow(air0.domain_offset(), num_cycles, B.P)
        limbs = B.elems_to_limbs(poly, 1, device)
        tabs.append(
            B.evaluate_poly_with_offset(limbs, offset, air0.ce_blowup_factor())[0]
        )
    return tabs


def plan_groups(template):
    """Boundary groups of a BoundaryConstraints template in host-evaluator
    order: per group a list of (segment, column, value-poly length)."""
    return [[("main", c.column, len(c.poly)) for c in g.constraints]
            for g in template.main_constraints]


def _build_plan(air0, template, domain, B, device):
    """Static constraint structure shared by all instances: boundary groups
    in host-evaluator order, plus divisor tables over the ce domain and
    periodic tables over one period, on the device."""
    ce = domain.ce_size
    divisors = [
        ConstraintDivisor.from_transition(
            domain.trace_length, air0.context.num_transition_exemptions, B.spec
        )
    ]
    groups = plan_groups(template)
    divisors += [g.divisor for g in template.main_constraints]

    div_tables = []
    for dv in divisors:
        z = _inv_divisor_numerator(B, dv, domain, device)
        zfull = B.cmap(lambda l: l.repeat(ce // l.shape[0]), z)
        if dv.exemptions:
            zfull = B.bmul(zfull, _exemptions_eval(B, dv, domain, device))
        div_tables.append(zfull)

    return {
        "groups": groups,
        "div_tables": div_tables,
        "periodic_tabs": _periodic_tables(B, air0, device),
        "has_aux": bool(template.aux_constraints),
        "K": air0.context.num_transition_constraints(),
    }


def _stack_elems(B, rows, deg, device):
    """rows: list (n) of lists (k) of field elements -> comps shaped (n, k)."""
    n, k = len(rows), len(rows[0])
    comps = B.elems_to_limbs([e for row in rows for e in row], deg, device)
    return B.emap(lambda l: l.reshape(n, k), comps)


def _stack_group_values(per_instance, domain, air0, B, ext_deg, device):
    """Per-instance boundary values and composition coefficients stacked in
    kernel walk order (JAX ``_stack_group_values(seq_coeffs=True)`` :585):
    singles and ccs as lists of (n, 1) comps; each sequence as (coefficient
    comps (n, m), off_eff, m), to be evaluated over the ce domain at the
    offset off_eff = offset * g_ce^-(first step * ce blowup), which is the
    host's evaluate-then-roll."""
    singles, seqs, ccs = [], [], []
    ce = domain.ce_size
    g_ce = B.get_root_of_unity(ce.bit_length() - 1)
    template = per_instance[0]
    for gi, g in enumerate(template.main_constraints):
        for ci in range(len(g.constraints)):
            cons = [b.main_constraints[gi].constraints[ci] for b in per_instance]
            c0 = cons[0]
            if len(c0.poly) == 1:
                singles.append(_stack_elems(B, [[c.poly[0]] for c in cons], 1, device))
            else:
                m = len(c0.poly)
                base_off = air0.domain_offset() if m < ce else 1
                so = c0.poly_offset[0] * air0.ce_blowup_factor()
                off_eff = base_off * pow(g_ce, -so, B.P) % B.P
                seqs.append((_stack_elems(B, [list(c.poly) for c in cons], 1, device),
                             off_eff, m))
            ccs.append(_stack_elems(B, [[c.cc] for c in cons], ext_deg, device))
    return singles, seqs, ccs


def sequence_tables(B, seq_specs, ce: int):
    """Each sequence's (n, ce) table over the ce domain, on the device of
    its coefficients (JAX :846-859): m points a coset, ce / m cosets, kernel
    4 under ``evaluate_poly_with_offset``."""
    return [B.evaluate_poly_with_offset(coeffs, off_eff, ce // m)[0]
            for coeffs, off_eff, m in seq_specs]


def pallas_constraint_phase(B, air0, domain, plan, main_rows, scal, seq_tabs=()):
    """The whole constraint body as ONE kernel launch: frames by index from
    the (n, w, L) LDE rows, transition, boundary groups (sequence values
    from ``seq_tabs``), divisors and the cross-instance combination -> comps
    (ce,)."""
    return cons_kernel.constraint_eval(
        B, air0, plan["groups"], plan["K"], domain.ce_to_lde_blowup,
        domain.trace_to_lde_blowup, main_rows, plan["periodic_tabs"],
        plan["div_tables"], scal, seq_tabs,
    )


# ---------------------------------------------------------------------------
# tail: device OOD evaluation + DEEP composition
# ---------------------------------------------------------------------------


def _limb_tail_kernels(B, spec, ext_deg, n, polys, comp_columns, domain, device):
    """Device OOD evaluation + DEEP composition: the (n, w, length)
    coefficient tables never leave the device, only the OOD values do.
    Returns (ood_fn, deep_fn) for ``finish_proof``."""
    length = domain.trace_length
    d = ext_deg
    w = polys[0][0].shape[1]

    def _sub0_batch(t, vals):
        # subtract (k,)-shaped scalars from coefficient 0 of (k, length) tables
        out = []
        for c, v in zip(t, vals):
            first = B.bsub(B.cmap(lambda l: l[:, :1], c), B.cmap(lambda l: l[:, None], v))
            out.append(tuple(torch.cat([f, l[:, 1:]], dim=1) for f, l in zip(first, c)))
        return tuple(out)

    def ood_fn(z, zg):
        powz = B.power_series_elem(B.scalar_to_limbs(z, d, device=device), length)
        powzg = B.power_series_elem(B.scalar_to_limbs(zg, d, device=device), length)
        pm = B.promote(polys, d)
        tz = B.vsum(B.vmul(powz, pm), axis=-1)  # (n, w)
        tzg = B.vsum(B.vmul(powzg, pm), axis=-1)
        hz = B.vsum(B.vmul(powz, B.promote(comp_columns, d)), axis=-1)

        def rows(comps):  # (n, w) comps -> per-instance element lists
            elems = B.limbs_to_elems(B.emap(lambda l: l.reshape(-1), comps), d)
            return [elems[i * w : (i + 1) * w] for i in range(n)]

        at_z, at_zg = rows(tz), rows(tzg)
        states = [[at_z[i], at_zg[i]] for i in range(n)]
        return states, B.limbs_to_elems(hz, d)

    def deep_fn(z, cc, ood_states, ood_evaluations):
        z_l = B.scalar_to_limbs(z, d, device=device)
        g_trace = B.get_root_of_unity(length.bit_length() - 1)
        zg_l = B.scalar_to_limbs(spec.fmul(z, g_trace), d, device=device)
        ccs = B.emap(
            lambda l: l.reshape(n, w, 1),
            B.elems_to_limbs([cc.traces[i][j] for i in range(n) for j in range(w)],
                             d, device),
        )
        cc_cons = B.elems_to_limbs(list(cc.constraints), d, device)

        def consts(row):  # sum_j T_ij(z) * cc_ij per instance, host scalars
            vals = []
            for i in range(n):
                acc = spec.zero(d)
                for j in range(w):
                    acc = spec.fadd(acc, spec.fmul(ood_states[i][row][j], cc.traces[i][j]))
                vals.append(acc)
            return B.elems_to_limbs(vals, d, device)

        hz_c = B.elems_to_limbs(list(ood_evaluations), d, device)
        t = B.vsum(B.vmul(ccs, B.promote(polys, d)), axis=1)  # (n, length)
        q1 = B.syn_div_binomial(_sub0_batch(t, consts(0)), z_l)
        q2 = B.syn_div_binomial(_sub0_batch(t, consts(1)), zg_l)
        total = B.vsum(B.vadd(q1, q2), axis=0)  # (length,)
        cols = _sub0_batch(B.promote(comp_columns, d), hz_c)  # (num_cols, length)
        qc = B.syn_div_binomial(cols, z_l)
        kw = B.emap(lambda l: l[:, None], cc_cons)
        return B.vadd(total, B.vsum(B.vmul(qc, kw), axis=0))

    return ood_fn, deep_fn


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def prove_mesh(prover, n: int, traces, device):
    """One aggregated proof of ``n`` limb-field traces with every heavy phase
    on ``device``; byte-identical to the JAX package's host ``Prover.prove``.

    The phase walls logged at DEBUG level are real phase costs: on a CUDA
    device each mark waits for the device first (P2 ends in a kernel launch,
    not in a channel interaction that would).  Each record carries ``(phase
    name, milliseconds)`` as its arguments."""
    device = torch.device(device)
    t0 = time.perf_counter()

    def _mark(phase):
        nonlocal t0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        logger.debug("%s in %.0f ms", phase, (now - t0) * 1e3)
        t0 = now

    options = prover.options()
    ext_deg = options.field_extension
    hasher = prover.hasher
    pub_inputs_vec = [prover.get_pub_inputs(t) for t in traces]
    pub_elements_vec = [p.to_elements() for p in pub_inputs_vec]
    airs = [
        prover.air_class(t.get_info(), p, options)
        for t, p in zip(traces, pub_inputs_vec)
    ]
    spec = airs[0].field_spec()
    B = get_backend(spec.name)
    channel = ProverChannel(n, airs, pub_elements_vec, hasher, ext_deg, spec,
                            device=device)
    domain = StarkDomain(airs[0])
    w, length = traces[0].width, traces[0].length
    if any(t.length != length for t in traces):
        raise ProverError("prove_mesh requires equal trace lengths")
    blowup = domain.trace_to_lde_blowup
    L = domain.lde_size
    offset = domain.domain_offset
    ce = domain.ce_size
    trace_length = domain.trace_length

    # fail fast when the one-shot pipeline cannot fit the card
    streamed.preflight_check(n, w, length, blowup, B.ELEMENT_BYTES, device)

    # ---- P1: main-trace commitment ----
    segments = [t.main_segment_limbs(B, device)[0] for t in traces]
    stacked = (tuple(torch.stack([s[l] for s in segments])
                     for l in range(len(segments[0]))),)
    del segments
    polys, lde_rows, levels = sharded_segment_commit(B, hasher, stacked, blowup, offset, 1)
    del stacked
    main_tree = MerkleTree(levels, hasher)
    channel.commit_trace(main_tree.root())
    _mark("P1 main-trace commit")

    # ---- P2: constraint evaluation ----
    tc_list, boundary_list = [], []
    for i in range(n):
        cc = channel.get_constraint_composition_coeffs()
        tc_list.append(airs[i].get_transition_constraints(cc.transition))
        boundary_list.append(airs[i].get_boundary_constraints(None, cc.boundary))
    final_coeff = channel.get_final_polynomial_coeffs()
    final_powers = [spec.fexp(final_coeff, i) for i in range(n)]

    # the plan's groups and tables depend on the configuration (AIR type,
    # sizes and, for Lamport-agg, the signature block: periodic_cache_key),
    # not on the public inputs or the transcript
    plan = _cached(
        ("plan", B.name, type(airs[0]).__qualname__, w, trace_length, ce, L,
         airs[0].periodic_cache_key(), str(device)),
        lambda: _build_plan(airs[0], boundary_list[0], domain, B, device),
    )
    if not _pcons_gate(plan, ext_deg, spec):
        raise NotImplementedError(
            f"config not ported yet (outside the constraint kernel: aux "
            f"segments or an extension field; ROADMAP slice iii, rest): "
            f"air={type(airs[0]).__name__}, field={spec.name}, "
            f"extension degree={ext_deg}"
        )
    singles, seq_specs, ccs = _stack_group_values(boundary_list, domain, airs[0], B,
                                                  ext_deg, device)
    seq_tabs = sequence_tables(B, seq_specs, ce)
    del seq_specs
    t_main = _stack_elems(B, [t.main_constraint_coef for t in tc_list], ext_deg, device)
    fp_stack = B.emap(lambda l: l[:, 0],
                      _stack_elems(B, [[p] for p in final_powers], ext_deg, device))
    scal = cons_kernel.pack_scalar_bank(B, t_main, singles, ccs, fp_stack, n, plan["K"])
    final_comb = pallas_constraint_phase(B, airs[0], domain, plan, lde_rows, scal,
                                         seq_tabs)
    del seq_tabs
    _mark("P2 constraint evaluation")

    # ---- P3: composition poly + LDE + commitment ----
    num_cols = airs[0].context.num_constraint_composition_columns()
    coeffs = B.interpolate_poly_with_offset(final_comb, offset)
    del final_comb
    comp_columns = B.emap(
        lambda l: l.reshape(ce // trace_length, trace_length)[:num_cols].contiguous(),
        B.promote(coeffs, ext_deg),
    )
    del coeffs
    comp_lde_rows, clevels = sharded_lde_blocks(
        B, comp_columns, L // trace_length, offset, hasher=hasher, deg=ext_deg
    )
    constraint_tree = MerkleTree(clevels, hasher)
    channel.commit_constraints(constraint_tree.root())
    _mark("P3 composition LDE + commit")

    # ---- tail: OOD + DEEP + FRI + queries ----
    ood_fn, deep_fn = _limb_tail_kernels(
        B, spec, ext_deg, n, polys, comp_columns, domain, device
    )

    def query_rows(positions):
        idx = torch.as_tensor(list(positions), dtype=torch.int64, device=device)
        main_g = B.emap(lambda l: l.index_select(2, idx).cpu(), lde_rows)  # (n, w, q)
        comp_g = B.emap(lambda l: l.index_select(1, idx).cpu(), comp_lde_rows)
        return [B.emap(lambda l: l[i], main_g) for i in range(n)], comp_g

    def deep_fri(deep_coefficients):
        cols = B.emap(lambda l: l.reshape(1, trace_length), deep_coefficients)
        deep_rows = sharded_lde_blocks(B, cols, L // trace_length, offset)
        deep_evals = B.emap(lambda a: a.reshape(L), deep_rows)
        fri = LimbFriProver(options.to_fri_options(field=spec), hasher, B, ext_deg)
        fri.build_layers(channel, deep_evals)
        return fri

    return finish_proof(
        channel, airs, domain, options, ext_deg, B, spec, main_tree,
        constraint_tree, ood_fn, deep_fn, deep_fri, query_rows, mark=_mark,
    )
