"""Query openings of the trace and constraint commitments — equivalent of
prover/src/trace/commitment.rs and prover/src/constraints/commitment.rs.

Counterpart of starkpack_winterfell_tpu/prover/commitment.py cut to
``build_segment_queries`` (:60) and ``build_constraint_queries`` (:86) in
their ``gathered`` form: the LDEs stay on the device and the caller hands
over only the queried columns, already aligned with the positions.  The
host commit functions (``interpolate_and_lde``, ``commit_to_comb_rows``) are
not ported: parallel/full_pipeline.py commits on the device.
"""

from __future__ import annotations

from ..air.proof import JointTraceQueries, Queries


def build_segment_queries(segments_lde, segment_tree, positions, ext_deg: int, B):
    """Joint rows + per-trace rows.  segments_lde: per instance, comps
    shaped (w, len(positions)) holding the queried columns."""
    traces_states = []
    for lde in segments_lde:
        rows = []
        for pos in range(len(positions)):
            row = tuple(B.cmap(lambda l: l[:, pos], c) for c in lde)
            rows.append(B.limbs_to_elems(row, ext_deg))
        traces_states.append(rows)
    comb_states = []
    for i in range(len(positions)):
        row = []
        for ts in traces_states:
            row.extend(ts[i])
        comb_states.append(row)
    proof = segment_tree.prove_batch(positions)
    return JointTraceQueries.new(proof, comb_states, traces_states, B.spec)


def build_constraint_queries(lde, tree, positions, ext_deg: int, B) -> Queries:
    """lde: comps shaped (num_cols, len(positions))."""
    rows = []
    for pos in range(len(positions)):
        row = tuple(B.cmap(lambda l: l[:, pos], c) for c in lde)
        rows.append(B.limbs_to_elems(row, ext_deg))
    proof = tree.prove_batch(positions)
    return Queries.new(proof, rows, ext_deg, B.spec)
