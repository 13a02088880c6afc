"""The StarkPack batched proving entry point — equivalent of
prover/src/lib.rs's ``Prover`` trait.

Counterpart of starkpack_winterfell_tpu/prover/pipeline.py cut to the
``Prover`` base class — subclasses provide the AIR class, proof options,
hash function and public-input extraction; ``prove(n, traces)`` produces
one aggregated StarkProof for all traces sharing a single Fiat-Shamir
transcript — and ``finish_proof`` (:190) with its device hooks only.  The
host (numpy) pipeline ``_generate_proof`` is not ported: every prove runs a
tensor pipeline (prover/device_big.py, parallel/full_pipeline.py) on the
device the caller names.
"""

from __future__ import annotations

from ..errors import ProverError


class Prover:
    """Subclass interface (prover/src/lib.rs:124):
    - ``air_class``: the Air subclass
    - ``hasher``: a hasher from crypto.hashers
    - ``get_pub_inputs(trace)``: public inputs object with ``to_elements()``
    - ``options()``: ProofOptions
    """

    air_class = None
    hasher = None

    def get_pub_inputs(self, trace):
        raise NotImplementedError

    def options(self):
        raise NotImplementedError

    def prove(self, n: int, traces, device="cuda"):
        """One aggregated proof for ``n`` traces, computed on ``device``
        (default the CUDA card; raises if there is none).  The proof bytes do
        not depend on the device."""
        from .device import prove_device

        if n != len(traces):
            raise ProverError(f"expected {n} traces, got {len(traces)}")
        return prove_device(self, n, traces, device=device)


def finish_proof(channel, airs, domain, options, ext_deg, B, spec,
                 main_tree, aux_trees, constraint_tree, ood_fn, deep_fn,
                 deep_lde_and_fri, query_rows_fn, mark=None):
    """Phases 4-8 of generate_proof (OOD + DEEP + FRI + queries + assembly,
    prover/src/lib.rs:476-603) for a pipeline that keeps its tables on the
    device and hands over four hooks:

    ood_fn(z, zg) -> (ood_traces_states, ood_evaluations) as host elements;
    deep_fn(z, cc, ood_traces_states, ood_evaluations) -> DEEP coefficient
    comps; deep_lde_and_fri(deep_coeffs) runs the LDE and the FRI layer
    commits against ``channel`` and returns the FRI prover;
    query_rows_fn(positions) -> (main rows per instance, per aux segment its
    rows per instance, composition rows), holding ONLY the queried columns;
    ``aux_trees``: one commitment per aux segment.  ``mark(phase name)`` is
    called as each phase ends."""
    from ..crypto.merkle import MerkleTree
    from .commitment import build_constraint_queries, build_segment_queries

    mark = mark or (lambda name: None)
    trace_length = domain.trace_length

    # Phase 4: OOD evaluation + DEEP (lib.rs:476-535)
    z = channel.get_ood_point()
    g_trace = spec.get_root_of_unity(trace_length.bit_length() - 1)
    zg = spec.fmul(z, g_trace)
    ood_traces_states, ood_evaluations = ood_fn(z, zg)
    channel.send_ood_trace_states(ood_traces_states)
    channel.send_ood_constraint_evaluations(ood_evaluations)
    mark("P4 OOD")

    deep_coefficients = channel.get_deep_composition_coeffs()
    deep_coeffs = deep_fn(z, deep_coefficients, ood_traces_states, ood_evaluations)

    # Phase 5-6: DEEP evaluation over the LDE domain + FRI (lib.rs:543-561)
    fri_prover = deep_lde_and_fri(deep_coeffs)
    mark("P5+6 DEEP+FRI")

    # Phase 7: PoW + query positions (lib.rs:574-577)
    channel.grind_query_seed()
    query_positions = channel.get_query_positions()
    mark("P7 PoW+positions")

    # Phase 8: proof assembly (lib.rs:585-603)
    MerkleTree.prefetch_trees(
        [(t, query_positions) for t in [main_tree, *aux_trees, constraint_tree]]
    )
    fri_proof = fri_prover.build_proof(query_positions)
    main_rows, aux_rows, comp_rows = query_rows_fn(query_positions)
    trace_queries = [
        build_segment_queries(main_rows, main_tree, query_positions, 1, B)
    ] + [
        build_segment_queries(rows, tree, query_positions, ext_deg, B)
        for rows, tree in zip(aux_rows, aux_trees)
    ]
    constraint_queries = build_constraint_queries(
        comp_rows, constraint_tree, query_positions, ext_deg, B
    )
    proof = channel.build_proof(trace_queries, constraint_queries, fri_proof)
    mark("P8 queries+assembly")
    return proof
