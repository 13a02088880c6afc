"""The multi-field proving pipeline on one device.

Counterpart of starkpack_winterfell_tpu/parallel/full_pipeline.py
(``prove_mesh`` :682) for a mesh of ONE device: no mesh object, no
``shard_map``, no collectives and no jit cache — every phase is eager tensor
code around the CUDA kernels of the path (for f128 and f62 the limb NTT
tile, ops/limb_ntt.py, and the whole-AIR constraint evaluation,
ops/cons_kernel.py; for f64 the DIT transforms of ops/ntt_kernel.py under
ops/ntt.py).  It proves every limb-field config, and every f64 config with
auxiliary trace segments (the randomized AIRs; ``GL64Backend``), as the JAX
package's ``prover/device.py:410-418`` routes them.

  P1   main-trace commitment: interpolate, coset LDE, row words, leaves,
       Merkle levels (``sharded_segment_commit`` :118).
  P1b  auxiliary segments (:778-815): per segment, each instance's random
       elements drawn in instance order, its segment built, ONE tree over
       all instances' extension rows committed.
  P2   constraint evaluation over the ce domain, all instances combined
       with final_coeff^i: at extension degree 1 on a main-segment limb AIR
       in the constraint kernel (``pallas_constraint_phase`` :442; its frame
       slicing happens by index inside the kernel), otherwise in eager
       tensor code, chunk by chunk of the ce domain, aux frames and aux
       transition included (``eager_constraint_phase``, the counterpart of
       ``sharded_constraint_phase`` :325).  Sequence assertions enter as
       (n, ce) tables, evaluated on the device from their (n, m) coefficient
       stacks (:846).
  P3   composition polynomial: interpolate, split into columns, coset LDE
       coset by coset against an offsets table, commit
       (``sharded_lde_blocks`` :191).
  P4-8 ``prover/pipeline.finish_proof`` with the device hooks of
       ``_tail_kernels`` (JAX ``_limb_tail_kernels`` :1353: OOD dots, DEEP
       composition over main and aux columns) at every trace length and on
       every field (the JAX package keeps a host tail below 4096 rows and on
       f64; the values are the same), the DEEP LDE and
       ``fri/prover.LimbFriProver`` through the field's backend (what
       ``MeshFriProver`` :1215 does on one device), and one gather of the
       queried rows.

Memory plan (JAX :725-736): a limb-field config whose one-shot peak
estimate is above the budget runs P1, P1b, P2, P3 and the query gather of
P8 coset by coset through parallel/streamed.py, from the coefficient tables,
and never holds an LDE; the tail is the same.  An f64 config (it reaches
this pipeline only with aux segments) does not stream: above the budget it
fails fast with ProverError (``streamed.preflight_check``).  The DEBUG
record "prove_mesh path: %s" names the path a prove took.

Ported: every field at every extension degree it has, main and auxiliary
segments, single-value and sequence boundary assertions, BLAKE3-256,
BLAKE3-192 and SHA3-256 (``prover/device.py`` names the hashers each field
takes), the one-shot and the coset-streamed phases.  Proof bytes equal the
JAX package's host pipeline on both.
"""

from __future__ import annotations

import logging
import time

import torch

from ..air.air import AuxTraceRandElements
from ..air.divisors import ConstraintDivisor
from ..air.transition import EvaluationFrame
from ..crypto.merkle import MerkleTree, build_levels
from ..errors import ProverError
from ..fri.prover import LimbFriProver
from ..ops import cons_kernel
from ..ops.backend import get_backend
from ..ops.felt import Felt
from ..prover.channel import ProverChannel
from ..prover.domain import StarkDomain
from ..prover.pipeline import finish_proof
from . import streamed

# the phase records go to the logger chip_smoke.py and the CLI's --verbose
# listen to, as prove_big's do
logger = logging.getLogger("starkpack_winterfell_tpu_torch.prover.device")

# instance points (instances x ce points) the eager constraint phase takes at
# once: it bounds the peak of its temporaries (one f128 value over 2^20
# points is 16 MB) and keeps each eager op long enough to cover its launch
EAGER_POINTS = 1 << 20

# per-config device tables (coset offsets, divisor and periodic tables):
# they depend on the configuration, not on the traces or the transcript
_TABLE_CACHE: dict = {}


def _cached(key, make):
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = make()
    return _TABLE_CACHE[key]


class BatchedAuxRand:
    """JAX ``BatchedAuxRand`` :100: an AuxTraceRandElements stand-in whose
    segment elements are Felts shaped (n, 1), one row an instance, so AIR
    code written against scalar rand elements (air/src/air/mod.rs:470)
    runs unchanged on the instance-batched arrays of the eager phase."""

    def __init__(self, segments):
        self._segments = segments

    def get_segment_elements(self, idx):
        return self._segments[idx]


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
        return B.pow_series_rows(B.cmap(lambda l: l.reshape(blowup, 1), bases), length)

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
    extension, a limb field; single-value and sequence assertions.  The
    rest goes to ``eager_constraint_phase``."""
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


def _group_walk(template):
    """Boundary groups in host-evaluator order: the main groups, then each
    aux group merged into the group of an equal divisor or appended (JAX
    ``_build_plan`` :517-527, prover/src/constraints/boundary.rs:30-39).
    Returns (each group's divisor, each group's (segment, group index,
    constraint index) triples)."""
    divisors, walk = [], []
    for gi, g in enumerate(template.main_constraints):
        divisors.append(g.divisor)
        walk.append([("main", gi, ci) for ci in range(len(g.constraints))])
    for gi, g in enumerate(template.aux_constraints):
        entry = [("aux", gi, ci) for ci in range(len(g.constraints))]
        for di, dv in enumerate(divisors):
            if dv == g.divisor:
                walk[di].extend(entry)
                break
        else:
            divisors.append(g.divisor)
            walk.append(entry)
    return divisors, walk


def _constraint(boundary, seg, gi, ci):
    groups = boundary.main_constraints if seg == "main" else boundary.aux_constraints
    return groups[gi].constraints[ci]


def plan_groups(template):
    """Boundary groups of a BoundaryConstraints template in host-evaluator
    order: per group a list of (segment, column, value-poly length)."""
    groups = []
    for group in _group_walk(template)[1]:
        cons = [(seg, _constraint(template, seg, gi, ci)) for seg, gi, ci in group]
        groups.append([(seg, c.column, len(c.poly)) for seg, c in cons])
    return groups


def _build_plan(air0, template, domain, B, device):
    """Static constraint structure shared by all instances: boundary groups
    in host-evaluator order, plus divisor tables over the ce domain and
    periodic tables over one period, on the device."""
    ce = domain.ce_size
    divisors = [
        ConstraintDivisor.from_transition(
            domain.trace_length, air0.context.num_transition_exemptions, B.spec
        )
    ] + _group_walk(template)[0]

    div_tables = []
    for dv in divisors:
        z = _inv_divisor_numerator(B, dv, domain, device)
        zfull = B.cmap(lambda l: l.repeat(ce // l.shape[0]), z)
        if dv.exemptions:
            zfull = B.bmul(zfull, _exemptions_eval(B, dv, domain, device))
        div_tables.append(zfull)

    return {
        "groups": plan_groups(template),
        "div_tables": div_tables,
        "periodic_tabs": _periodic_tables(B, air0, device),
        "has_aux": bool(template.aux_constraints),
        "K": air0.context.num_main_transition_constraints(),
        "K_aux": air0.context.num_aux_transition_constraints(),
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
    host's evaluate-then-roll.  Main-segment values are base elements, aux
    values elements of the extension (:629)."""
    singles, seqs, ccs = [], [], []
    ce = domain.ce_size
    g_ce = B.get_root_of_unity(ce.bit_length() - 1)
    for group in _group_walk(per_instance[0])[1]:
        for seg, gi, ci in group:
            cons = [_constraint(b, seg, gi, ci) for b in per_instance]
            val_deg = 1 if seg == "main" else ext_deg
            c0 = cons[0]
            if len(c0.poly) == 1:
                singles.append(_stack_elems(B, [[c.poly[0]] for c in cons], val_deg, device))
            else:
                m = len(c0.poly)
                base_off = air0.domain_offset() if m < ce else 1
                so = c0.poly_offset[0] * air0.ce_blowup_factor()
                off_eff = base_off * pow(g_ce, -so, B.P) % B.P
                seqs.append((_stack_elems(B, [list(c.poly) for c in cons], val_deg, device),
                             off_eff, m))
            ccs.append(_stack_elems(B, [[c.cc] for c in cons], ext_deg, device))
    return singles, seqs, ccs


def sequence_tables(B, seq_specs, ce: int):
    """Each sequence's (n, ce) table over the ce domain, an element of its
    values' degree, on the device of its coefficients (JAX :846-859): m
    points a coset, ce / m cosets, through ``evaluate_poly_with_offset``."""
    return [B.evaluate_poly_with_offset(coeffs, off_eff, ce // m)
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


def _felt_columns(comps, w, B):
    """JAX ``_felt_columns`` :317: (n, w, pts) comps -> one Felt a column,
    shaped (n, pts)."""
    return [Felt(B.emap(lambda l: l[:, wi], comps), B=B) for wi in range(w)]


def eager_constraint_phase(B, air0, shift: int, blowup: int, plan, main_rows, t_main,
                           singles, seq_tabs, ccs, fp_stack, aux=None):
    """JAX ``sharded_constraint_phase`` :325 (with ``_frames_from_rows``
    :298) on one device, as eager tensor code: the transition (and the aux
    transition), the boundary groups, the divisor tables and the
    cross-instance ``final_powers`` combination, at any extension degree.

    shift: LDE rows a ce point (the domain's ``ce_to_lde_blowup``); blowup:
    LDE rows a trace step (``trace_to_lde_blowup``); the ce points are
    L // shift.  The streamed pipeline passes one LDE coset's rows with
    shift 1 and blowup 1, and a plan whose periodic and divisor tables are
    that coset's slices (parallel/streamed.py).
    main_rows: comps (n, w, L) LDE rows; t_main: comps (n, K) and ccs a list
    of comps (n, 1), in the extension; singles: comps (n, 1), base elements
    for the main segment's assertions and extension ones for the aux
    segment's; seq_tabs: one element (n, ce) a sequence assertion; fp_stack:
    comps (n,), final_coeff^i; aux: for an AIR with auxiliary segments
    (aux LDE rows, comps (n, w_aux, L) in the extension; t_aux, comps
    (n, K_aux); per aux segment the list of its random elements, each comps
    (n, 1)), else None.  The current frame of ce point j is LDE row
    j*shift, the next row j*shift + blowup (mod L: the d = 1 case of the JAX
    ``ppermute``), for main and aux rows alike.  The ce domain goes in
    chunks of ``EAGER_POINTS`` // n points; every step is pointwise in ce,
    so chunking changes no value.  Returns comps (ce,)."""
    n, w, L = main_rows[0][0].shape
    ce = L // shift
    K = plan["K"]
    device = main_rows[0][0].device
    t_coefs = [B.emap(lambda l: l[:, k : k + 1], t_main) for k in range(K)]
    fp = B.emap(lambda l: l[:, None], fp_stack)
    if aux is not None:
        aux_rows, t_aux, rand_stacks = aux
        w_aux = aux_rows[0][0].shape[1]
        t_aux_coefs = [B.emap(lambda l: l[:, k : k + 1], t_aux) for k in range(plan["K_aux"])]
        rand = BatchedAuxRand([[Felt(e, B=B) for e in seg] for seg in rand_stacks])
    chunk = min(ce, 1 << max(0, (EAGER_POINTS // n).bit_length() - 1))
    parts = []
    for j0 in range(0, ce, chunk):
        pts = torch.arange(j0, j0 + chunk, device=device)
        nxt_idx = (pts * shift + blowup) % L

        def frame_of(rows, width):
            cur = B.emap(lambda l: l[:, :, j0 * shift : (j0 + chunk) * shift : shift], rows)
            nxt = B.emap(lambda l: l.index_select(2, nxt_idx), rows)
            return EvaluationFrame(_felt_columns(cur, width, B), _felt_columns(nxt, width, B))

        frame = frame_of(main_rows, w)
        aux_block = None if aux is None else (frame_of(aux_rows, w_aux), rand, t_aux_coefs)
        pv = [Felt((B.cmap(lambda l: l.index_select(0, pts % l.shape[0]), tab),), B=B)
              for tab in plan["periodic_tabs"]]
        seqs = [B.emap(lambda l: l[:, j0 : j0 + chunk], t) for t in seq_tabs]
        divs = [(B.cmap(lambda l: l[j0 : j0 + chunk], t),) for t in plan["div_tables"]]
        acc = cons_kernel.eval_block(B, air0, plan["groups"], K, frame, pv, t_coefs,
                                     singles, seqs, ccs, divs, aux=aux_block)
        parts.append(B.vsum(B.vmul(acc, fp), axis=0))
        del frame, aux_block, pv, seqs, divs, acc
    return tuple(tuple(torch.cat([p[c][l] for p in parts]) for l in range(len(parts[0][c])))
                 for c in range(len(parts[0])))


# ---------------------------------------------------------------------------
# tail: device OOD evaluation + DEEP composition
# ---------------------------------------------------------------------------


def _tail_kernels(B, spec, ext_deg, n, polys, aux_polys, comp_columns, domain, device):
    """Device OOD evaluation + DEEP composition (JAX ``_limb_tail_kernels``
    :1353): the (n, w, length) coefficient tables of the main segment and
    of each aux segment (``aux_polys``, in the extension) never leave the
    device, only the OOD values do.  An instance's OOD states are its main
    columns then its aux columns, W of them in all, and the DEEP sum runs
    over all W (:1370-1404).  Returns (ood_fn, deep_fn) for
    ``finish_proof``."""
    length = domain.trace_length
    d = ext_deg
    segments = [polys] + list(aux_polys)
    widths = [p[0][0].shape[1] for p in segments]
    W = sum(widths)

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

        def rows(comps, width):  # (n, width) comps -> per-instance element lists
            elems = B.limbs_to_elems(B.emap(lambda l: l.reshape(-1), comps), d)
            return [elems[i * width : (i + 1) * width] for i in range(n)]

        states = [[[], []] for _ in range(n)]
        for seg, width in zip(segments, widths):
            pm = B.promote(seg, d)
            at_z = rows(B.vsum(B.vmul(powz, pm), axis=-1), width)  # (n, width)
            at_zg = rows(B.vsum(B.vmul(powzg, pm), axis=-1), width)
            for i in range(n):
                states[i][0].extend(at_z[i])
                states[i][1].extend(at_zg[i])
        hz = B.vsum(B.vmul(powz, B.promote(comp_columns, d)), axis=-1)
        return states, B.limbs_to_elems(hz, d)

    def deep_fn(z, cc, ood_states, ood_evaluations):
        z_l = B.scalar_to_limbs(z, d, device=device)
        g_trace = B.get_root_of_unity(length.bit_length() - 1)
        zg_l = B.scalar_to_limbs(spec.fmul(z, g_trace), d, device=device)
        ccs = B.emap(
            lambda l: l.reshape(n, W, 1),
            B.elems_to_limbs([cc.traces[i][j] for i in range(n) for j in range(W)],
                             d, device),
        )
        cc_cons = B.elems_to_limbs(list(cc.constraints), d, device)

        def consts(row):  # sum_j T_ij(z) * cc_ij per instance, host scalars
            vals = []
            for i in range(n):
                acc = spec.zero(d)
                for j in range(W):
                    acc = spec.fadd(acc, spec.fmul(ood_states[i][row][j], cc.traces[i][j]))
                vals.append(acc)
            return B.elems_to_limbs(vals, d, device)

        hz_c = B.elems_to_limbs(list(ood_evaluations), d, device)
        # sum_j cc_ij T_ij over the W columns, segment by segment: (n, length)
        t, j0 = None, 0
        for seg, width in zip(segments, widths):
            part = B.vsum(B.vmul(B.emap(lambda l: l[:, j0 : j0 + width], ccs),
                                 B.promote(seg, d)), axis=1)
            t = part if t is None else B.vadd(t, part)
            j0 += width
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
    """One aggregated proof of ``n`` traces with every heavy phase on
    ``device``; byte-identical to the JAX package's host ``Prover.prove``.

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
    num_aux = traces[0].num_aux_segments()

    # the memory plan (JAX :725-736): a limb-field config whose one-shot peak
    # estimate is above the budget streams the LDE coset by coset; another
    # that cannot fit fails fast.  The aux columns count once per extension
    # component
    w_eff = w + sum(traces[0].get_info().layout.aux_segment_widths) * ext_deg
    stream = spec.name != "f64" and streamed.should_stream(
        n, w_eff, length, blowup, B.ELEMENT_BYTES, device)
    if not stream:
        streamed.preflight_check(n, w_eff, length, blowup, B.ELEMENT_BYTES, device)
    logger.debug("prove_mesh path: %s", "streamed" if stream else "one-shot")

    def stack(segments):  # per-instance comps (w, length) -> comps (n, w, length)
        return tuple(tuple(torch.stack([s[c][l] for s in segments])
                           for l in range(len(segments[0][c])))
                     for c in range(len(segments[0])))

    # ---- P1: main-trace commitment ----
    stacked = stack([t.main_segment_limbs(B, device) for t in traces])
    if stream:
        polys, levels = streamed.streamed_segment_commit(B, hasher, stacked, blowup, offset, 1)
        lde_rows = None
    else:
        polys, lde_rows, levels = sharded_segment_commit(B, hasher, stacked, blowup, offset, 1)
    del stacked
    main_tree = MerkleTree(levels, hasher)
    channel.commit_trace(main_tree.root())
    _mark("P1 main-trace commit")

    # ---- P1b: auxiliary segments, one tree a segment over all instances ----
    aux_rand_objs = [AuxTraceRandElements() for _ in range(n)]
    aux_polys, aux_rows, aux_trees = [], [], []
    for seg_idx in range(num_aux):
        segments = []
        for i, trace in enumerate(traces):
            rand_elements = channel.get_aux_trace_segment_rand_elements(seg_idx)
            aux_rand_objs[i].add_segment_elements(rand_elements)
            segments.append(trace.build_aux_segment(seg_idx, rand_elements, B, device))
        stacked = B.promote(stack(segments), ext_deg)
        del segments
        if stream:
            apolys, alevels = streamed.streamed_segment_commit(B, hasher, stacked, blowup,
                                                               offset, ext_deg)
            arows = None
        else:
            apolys, arows, alevels = sharded_segment_commit(B, hasher, stacked, blowup,
                                                            offset, ext_deg)
        del stacked
        aux_trees.append(MerkleTree(alevels, hasher))
        aux_polys.append(apolys)
        aux_rows.append(arows)
        channel.commit_trace(aux_trees[-1].root())
        _mark("P1b aux commit")

    # ---- P2: constraint evaluation ----
    tc_list, boundary_list = [], []
    for i in range(n):
        cc = channel.get_constraint_composition_coeffs()
        tc_list.append(airs[i].get_transition_constraints(cc.transition))
        boundary_list.append(airs[i].get_boundary_constraints(
            aux_rand_objs[i] if num_aux else None, cc.boundary))
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
    singles, seq_specs, ccs = _stack_group_values(boundary_list, domain, airs[0], B,
                                                  ext_deg, device)
    t_main = _stack_elems(B, [t.main_constraint_coef for t in tc_list], ext_deg, device)
    fp_stack = B.emap(lambda l: l[:, 0],
                      _stack_elems(B, [[p] for p in final_powers], ext_deg, device))
    scal = aux = None
    if _pcons_gate(plan, ext_deg, spec):
        scal = cons_kernel.pack_scalar_bank(B, t_main, singles, ccs, fp_stack, n,
                                            plan["K"])
    elif plan["has_aux"]:
        rand_stacks = [
            [_stack_elems(B, [[r.get_segment_elements(s)[e]] for r in aux_rand_objs],
                          ext_deg, device)
             for e in range(len(aux_rand_objs[0].get_segment_elements(s)))]
            for s in range(num_aux)
        ]
        t_aux = _stack_elems(B, [t.aux_constraint_coef for t in tc_list], ext_deg, device)
        if stream:
            aux = (aux_polys, t_aux, rand_stacks)
        else:
            # the aux frame spans every aux segment's columns
            rows = tuple(tuple(torch.cat([r[c][l] for r in aux_rows], dim=1)
                               for l in range(len(aux_rows[0][c])))
                         for c in range(ext_deg))
            aux = (rows, t_aux, rand_stacks)
    if stream:
        # per ce coset, from the coefficient tables (JAX :903-915); the
        # sequences are evaluated coset by coset from their (n, m)
        # coefficients, never as (n, ce) tables
        final_comb = streamed.streamed_constraint_kernel(
            B, airs[0], domain, plan, polys, t_main, singles, seq_specs, ccs, fp_stack,
            scal=scal, aux=aux)
    else:
        seq_tabs = sequence_tables(B, seq_specs, ce)
        if scal is not None:
            final_comb = pallas_constraint_phase(B, airs[0], domain, plan, lde_rows, scal,
                                                 [t[0] for t in seq_tabs])
        else:
            final_comb = eager_constraint_phase(
                B, airs[0], domain.ce_to_lde_blowup, blowup, plan, lde_rows, t_main, singles,
                seq_tabs, ccs, fp_stack, aux=aux)
        del seq_tabs
    del seq_specs, aux
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
    if stream:
        # the composition columns share the main trace's length and blowup
        # (JAX :991-1000)
        clevels = streamed.streamed_comp_commit(B, hasher, comp_columns, L // trace_length,
                                                offset, ext_deg)
        comp_lde_rows = None
    else:
        comp_lde_rows, clevels = sharded_lde_blocks(
            B, comp_columns, L // trace_length, offset, hasher=hasher, deg=ext_deg
        )
    constraint_tree = MerkleTree(clevels, hasher)
    channel.commit_constraints(constraint_tree.root())
    _mark("P3 composition LDE + commit")

    # ---- tail: OOD + DEEP + FRI + queries ----
    ood_fn, deep_fn = _tail_kernels(
        B, spec, ext_deg, n, polys, aux_polys, comp_columns, domain, device
    )

    def query_rows(positions):
        idx = torch.as_tensor(list(positions), dtype=torch.int64, device=device)

        def per_instance(rows):  # comps (n, w, L) -> per instance comps (w, q)
            g = B.emap(lambda l: l.index_select(2, idx).cpu(), rows)
            return [B.emap(lambda l: l[i], g) for i in range(n)]

        comp_g = B.emap(lambda l: l.index_select(1, idx).cpu(), comp_lde_rows)
        return (per_instance(lde_rows), [per_instance(r) for r in aux_rows], comp_g)

    if stream:
        # the queried rows re-derived coset by coset (JAX :1051-1058)
        query_rows = streamed.streamed_query_rows(B, n, blowup, offset, polys, aux_polys,
                                                  comp_columns)

    def deep_fri(deep_coefficients):
        cols = B.emap(lambda l: l.reshape(1, trace_length), deep_coefficients)
        deep_rows = sharded_lde_blocks(B, cols, L // trace_length, offset)
        deep_evals = B.emap(lambda a: a.reshape(L), deep_rows)
        # f64 folds over the options' default coset (its generator, 7),
        # the limb fields over their own generator (JAX :1103-1108)
        fri_options = options.to_fri_options(field=None if spec.name == "f64" else spec)
        fri = LimbFriProver(fri_options, hasher, B, ext_deg)
        fri.build_layers(channel, deep_evals)
        return fri

    return finish_proof(
        channel, airs, domain, options, ext_deg, B, spec, main_tree, aux_trees,
        constraint_tree, ood_fn, deep_fn, deep_fri, query_rows, mark=_mark,
    )
