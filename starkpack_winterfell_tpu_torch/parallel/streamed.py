"""Copy of starkpack_winterfell_tpu/parallel/streamed.py; cut: its jit cache and P8 padding.

The coset-streamed proving phases of parallel/full_pipeline.py:prove_mesh.
The one-shot pipeline holds the whole blowup-fold LDE of every segment, and the
temporaries of its transforms, at once: Lamport+ 1024 peaks at 11.27 x its
main LDE on the card (PERF.md).  A limb-field config whose one-shot peak
estimate exceeds the budget streams instead, one LDE coset at a time:

  x_i at natural LDE index i = q*blowup + r lies on coset r, element q, so
  the LDE is ``blowup`` length-sized transforms of the coefficients scaled
  by (offset * g_L^r)^t (``LimbBackend.evaluate_coset``, the scale in the
  transform's launch), and an evaluation frame's next step (x * g_trace)
  stays on the same coset (element q + 1).

  P1 / P1b  interpolate once, then per coset the row words and that coset's
            leaves; the leaves interleaved to natural order, the Merkle
            levels over them (``streamed_segment_commit``).
  P2        per ce coset rc (LDE coset rc * shift) the constraint evaluation
            on that coset's rows with shift 1 and blowup 1: the constraint
            kernel where ``full_pipeline._pcons_gate`` holds, else
            ``full_pipeline.eager_constraint_phase``; periodic and divisor
            tables sliced ``rc::cb``, each sequence's values evaluated from
            its (n, m) coefficients scaled by (g_ce^rc)^j; the cb outputs
            interleaved to (ce,) (``streamed_constraint_kernel``).
  P3        the composition columns' cosets, leaves and levels as P1
            (``streamed_comp_commit``).
  P8        the queried rows of every segment re-derived coset by coset from
            the coefficient tables by the same transform as the commit
            (``streamed_query_rows``).

The LDE is never held: the peak is the coefficient tables, one coset's
working set and the Merkle levels.  Every value is the same canonical field
element as the one-shot pipeline's, so the proof bytes are too.

The budget (``budget_bytes``) is ``STARKPACK_HBM_BUDGET`` bytes where that is
set, as in the JAX package; else on a CUDA device what the card has free
plus what torch's caching allocator holds unused, and no limit on the host.
``preflight_check`` fails fast, before anything is allocated, for a config
that cannot stream (f64) and whose one-shot estimate is above the budget;
``STARKPACK_HBM_PREFLIGHT=0`` attempts it anyway.  The peak factor is the
port's own: peak ``torch.cuda.max_memory_allocated`` of a prove over the
bytes of its main LDE, measured by chip_smoke.py (PERF.md has the runs).
"""

from __future__ import annotations

import os

import torch

from ..crypto.merkle import build_levels
from ..errors import ProverError
from ..ops import cons_kernel
from . import full_pipeline

#: peak demand of the one-shot pipeline in units of main-LDE bytes: twice the
#: ratio chip_smoke.py measured on an NVIDIA H100 80GB HBM3 at the sizes where
#: the estimate matters (20.3 at 2^20 rows x 6 f128 columns, 20.3 at 4 x 2^14
#: x 6, 21.6 at 2^12 x 6; the eager f128 multiply keeps tens of temporaries of
#: its operands' size alive, so the ratio is far above the handful of tables
#: the pipeline holds).  Proves of a few MB read higher (29 and 57 at 2 x 512
#: x 2) because their fixed tables dominate; no budget is near them.
ONESHOT_PEAK_FACTOR = 40


def budget_bytes(device) -> int:
    """Bytes the one-shot path may demand on ``device``."""
    env = os.environ.get("STARKPACK_HBM_BUDGET")
    if env is not None:
        return int(env)
    device = torch.device(device)
    if device.type != "cuda":
        # host runs (the tests): no card to protect
        return 1 << 62
    free, _total = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return int(free + cached)


def oneshot_peak_estimate(n: int, w: int, length: int, blowup: int,
                          el_bytes: int) -> int:
    """Upper-bound estimate of the one-shot pipeline's peak device memory.
    ``w``: the main width plus each aux column once per extension
    component."""
    return ONESHOT_PEAK_FACTOR * n * w * length * blowup * el_bytes


def should_stream(n, w, length, blowup, el_bytes, device) -> bool:
    return oneshot_peak_estimate(n, w, length, blowup, el_bytes) > budget_bytes(device)


def preflight_check(n, w, length, blowup, el_bytes, device):
    """Fail fast, before anything is allocated, when a config that takes
    the one-shot pipeline cannot fit the budget (``prove_mesh`` calls it for
    the configs that do not stream)."""
    if os.environ.get("STARKPACK_HBM_PREFLIGHT") == "0":
        return
    if should_stream(n, w, length, blowup, el_bytes, device):
        demand = oneshot_peak_estimate(n, w, length, blowup, el_bytes)
        raise ProverError(
            f"the one-shot pipeline projects ~{demand / 1e9:.1f} GB peak device memory "
            f"(n={n}, width={w}, trace length={length}, blowup={blowup}) against a "
            f"{budget_bytes(device) / 1e9:.1f} GB budget, and the coset-streamed "
            f"pipeline takes the limb fields only; raise STARKPACK_HBM_BUDGET, or set "
            f"STARKPACK_HBM_PREFLIGHT=0 to attempt it anyway"
        )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _coset_slice(comp, rc: int, cb: int):
    """A table over the ce domain at period m (value at ce index i:
    tab[i % m]) -> coset rc's values at period m / cb: ce index q*cb + rc
    reads tab[rc::cb][q % (m / cb)].  One component, on its device."""
    m = comp[0].shape[0]
    assert m % cb == 0, "table period must be a multiple of the ce blowup"
    return tuple(l[rc::cb].contiguous() for l in comp)


def _seq_scale_tables(B, ce: int, cb: int, m: int, device):
    """One component (cb, m): row rc = (g_ce^rc)^j for j < m.  Scaling a
    sequence's coefficients by row rc and evaluating at the offset o is
    evaluating at o * g_ce^rc, the points of ce coset rc."""

    def build():
        g_ce = B.get_root_of_unity(ce.bit_length() - 1)
        bases = B.b_from_ints([pow(g_ce, rc, B.P) for rc in range(cb)], device)
        return B.pow_series_rows(B.cmap(lambda l: l.reshape(cb, 1), bases), m)

    return full_pipeline._cached(("seqscale", B.name, ce, cb, m, str(device)), build)


def _commit_cosets(B, hasher, coeffs, blowup: int, offset: int, deg: int):
    """Coefficient comps (..., length) -> Merkle levels over the rows of
    their coset LDE, one row an LDE point holding every leading index (row
    element e = the flat leading index), as ``full_pipeline._row_levels``
    hashes the one-shot rows.  One coset at a time: its evaluations, row
    words and leaves; the leaves go to natural order (q*blowup + r)."""
    length = coeffs[0][0].shape[-1]
    row_elems = coeffs[0][0].numel() // length
    leaves = None
    for r in range(blowup):
        ev = B.evaluate_coset(coeffs, offset, blowup, r)
        rows = B.emap(lambda l: l.reshape(row_elems, length).T, ev)
        del ev
        words = B.rows_to_words(rows, deg)
        del rows
        part = hasher.hash_words(words, row_elems * deg * B.ELEMENT_BYTES)
        del words
        if leaves is None:
            leaves = part.new_empty((length, blowup) + tuple(part.shape[1:]))
        leaves[:, r] = part
        del part
    return build_levels(leaves.reshape((length * blowup,) + tuple(leaves.shape[2:])), hasher)


# ---------------------------------------------------------------------------
# P1, P1b: streamed segment commitment
# ---------------------------------------------------------------------------


def streamed_segment_commit(B, hasher, comps, blowup: int, offset: int, deg: int):
    """comps (n, w, length) of degree ``deg`` -> (polys (n, w, length),
    Merkle levels): the leaves and levels of
    ``full_pipeline.sharded_segment_commit`` (rows (L, n*w), instance-major),
    without its LDE."""
    polys = B.interpolate_poly(comps)
    return polys, _commit_cosets(B, hasher, polys, blowup, offset, deg)


# ---------------------------------------------------------------------------
# P2: streamed constraint evaluation
# ---------------------------------------------------------------------------


def streamed_constraint_kernel(B, air0, domain, plan, polys, t_main, singles, seq_specs,
                               ccs, fp_stack, scal=None, aux=None):
    """The (ce,) combined constraint evaluations of
    ``full_pipeline.pallas_constraint_phase`` / ``eager_constraint_phase``,
    ce coset by ce coset.

    polys: main coefficient comps (n, w, length); seq_specs: as
    ``full_pipeline._stack_group_values`` gives them, (coefficient comps
    (n, m), off_eff, m); scal: the ``cons_kernel.pack_scalar_bank`` tensor
    when the constraint kernel runs (``full_pipeline._pcons_gate``), else
    None for the eager phase; aux: (per aux segment its coefficient comps
    (n, w_seg, length) in the extension, t_aux, random-element stacks) for
    an AIR with aux segments, else None.  Ce coset rc is LDE coset
    rc * shift: its frames are that coset's rows, shift 1 and blowup 1 (the
    next row is element q + 1 of the coset)."""
    ce = domain.ce_size
    length = domain.trace_length
    cb = ce // length
    shift = domain.ce_to_lde_blowup
    blowup = domain.trace_to_lde_blowup
    offset = domain.domain_offset
    device = polys[0][0].device
    out = None
    for rc in range(cb):
        k = rc * shift
        rows = B.evaluate_coset(polys, offset, blowup, k)
        per = [_coset_slice(t, rc, cb) for t in plan["periodic_tabs"]]
        divs = [_coset_slice(t, rc, cb) for t in plan["div_tables"]]
        seqs = []
        for coeffs, off_eff, m in seq_specs:
            scale = B.cmap(lambda l: l[rc], _seq_scale_tables(B, ce, cb, m, device))
            scaled = tuple(B.bmul(c, scale) for c in coeffs)
            seqs.append(B.evaluate_poly_with_offset(scaled, off_eff, length // m))
        if scal is not None:
            part = cons_kernel.constraint_eval(B, air0, plan["groups"], plan["K"], 1, 1, rows,
                                               per, divs, scal, [t[0] for t in seqs])
        else:
            coset_aux = None
            if aux is not None:
                aux_polys, t_aux, rand_stacks = aux
                segs = [B.evaluate_coset(p, offset, blowup, k) for p in aux_polys]
                # the aux frame spans every aux segment's columns
                joined = tuple(tuple(torch.cat([s[c][l] for s in segs], dim=1)
                                     for l in range(len(segs[0][c])))
                               for c in range(len(segs[0])))
                del segs
                coset_aux = (joined, t_aux, rand_stacks)
            part = full_pipeline.eager_constraint_phase(
                B, air0, 1, 1, dict(plan, periodic_tabs=per, div_tables=divs), rows, t_main,
                singles, seqs, ccs, fp_stack, aux=coset_aux)
            del coset_aux
        del rows, per, divs, seqs
        if out is None:
            out = B.emap(lambda l: l.new_empty((ce,)), part)
        for oc, pc in zip(out, part):
            for o, p in zip(oc, pc):
                o.view(length, cb)[:, rc] = p
        del part
    return out


# ---------------------------------------------------------------------------
# P3, P8: streamed composition commitment, query re-derivation
# ---------------------------------------------------------------------------


def streamed_comp_commit(B, hasher, comp_columns, blowup: int, offset: int, deg: int):
    """Composition coefficient comps (num_cols, length) -> the Merkle levels
    ``full_pipeline.sharded_lde_blocks(hasher=...)`` builds over their rows
    (L, num_cols), without their LDE."""
    return _commit_cosets(B, hasher, comp_columns, blowup, offset, deg)


def streamed_query_rows(B, n: int, blowup: int, offset: int, polys, aux_polys, comp_columns):
    """query_rows(positions) with the ``finish_proof`` contract of the
    one-shot path's: (per instance the main rows comps (w, q), per aux
    segment its rows per instance, the composition rows comps
    (num_cols, q)), on the host.  The positions go by coset (r = position
    % blowup); each coset asked for is re-derived from the coefficient
    tables of each segment by the transform of the commit, and only its
    queried elements (position // blowup) are kept."""

    def gather(coeffs, positions):
        pos = torch.as_tensor(list(positions), dtype=torch.int64)
        out = None
        for r in sorted({p % blowup for p in positions}):
            sel = torch.nonzero(pos % blowup == r).flatten()
            idx = (pos[sel] // blowup).to(coeffs[0][0].device)
            ev = B.evaluate_coset(coeffs, offset, blowup, r)
            got = B.emap(lambda l: l.index_select(-1, idx).cpu(), ev)
            del ev
            if out is None:
                out = B.emap(lambda l: l.new_empty(l.shape[:-1] + (len(pos),)), got)
            for oc, gc in zip(out, got):
                for o, g in zip(oc, gc):
                    o[..., sel] = g
        return out

    def per_instance(rows):  # comps (n, w, q) -> per instance comps (w, q)
        return [B.emap(lambda l: l[i], rows) for i in range(n)]

    def query_rows(positions):
        return (per_instance(gather(polys, positions)),
                [per_instance(gather(p, positions)) for p in aux_polys],
                gather(comp_columns, positions))

    return query_rows
