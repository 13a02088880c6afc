# Copy of starkpack_winterfell_tpu/verifier/channel.py; cut: nothing.
"""Verifier channel — equivalent of verifier/src/channel.rs.

Parses the StarkProof into typed pieces and verifies Merkle openings against
the shared per-segment roots; joint rows are re-split into per-trace tables
by widths (channel.rs:301-397)."""

from __future__ import annotations

from ..crypto.merkle import verify_batch
from ..fri.verifier import FriVerificationError


class VerifierError(Exception):
    pass


class TraceOodFrame:
    """channel.rs:439-523 — un-interleaves current/next rows."""

    def __init__(self, interleaved, main_width: int, aux_width: int):
        # interleaved layout: for each column i: [current_i, next_i]
        self.main_width = main_width
        self.aux_width = aux_width
        width = main_width + aux_width
        self.current_row = [interleaved[2 * i] for i in range(width)]
        self.next_row = [interleaved[2 * i + 1] for i in range(width)]

    def values(self):
        out = []
        for i in range(self.main_width + self.aux_width):
            out.append(self.current_row[i])
            out.append(self.next_row[i])
        return out

    def main_frame(self):
        from ..air.transition import EvaluationFrame

        return EvaluationFrame(
            self.current_row[: self.main_width], self.next_row[: self.main_width]
        )

    def aux_frame(self):
        from ..air.transition import EvaluationFrame

        if self.aux_width == 0:
            return None
        return EvaluationFrame(
            self.current_row[self.main_width :], self.next_row[self.main_width :]
        )


class VerifierChannel:
    def __init__(self, airs, proof, hasher, ext_deg: int, field=None):
        air0 = airs[0]
        self.hasher = hasher
        self.ext_deg = ext_deg
        if field is None:
            from ..math.fieldspec import GL64_SPEC as field
        self.field = field
        context0 = proof.contexts[0]
        num_trace_segments = context0.trace_layout.num_segments()
        self.lde_domain_size = air0.lde_domain_size()
        fri_options = air0.options().to_fri_options()
        self.num_fri_layers = fri_options.num_fri_layers(self.lde_domain_size)
        self.folding_factor = fri_options.folding_factor

        # commitments (channel.rs:84-95)
        try:
            trace_roots, constraint_root, fri_roots = proof.commitments.parse(
                hasher.DIGEST_BYTES, num_trace_segments, self.num_fri_layers
            )
        except ValueError as e:
            raise VerifierError(f"commitment parsing failed: {e}")
        self.trace_roots = trace_roots
        self.constraint_root = constraint_root
        self.fri_roots = fri_roots

        # trace queries: main (base field) + aux segments (extension field)
        num_queries = air0.options().num_queries
        main_widths = [air.trace_info().main_trace_width() for air in airs]
        self.trace_queries = []
        tq = proof.trace_queries
        try:
            main_proof, main_joint, main_tables = tq[0].parse(
                hasher, self.lde_domain_size, num_queries, main_widths, 1,
                self.field,
            )
        except ValueError as e:
            raise VerifierError(f"main trace query parsing failed: {e}")
        self.main_proof = main_proof
        self.main_tables = main_tables
        self.aux_proofs = []
        self.aux_tables = []
        for seg_idx in range(1, num_trace_segments):
            widths = [
                air.trace_info().layout.get_aux_segment_width(seg_idx - 1)
                for air in airs
            ]
            try:
                proof_a, joint_a, tables_a = tq[seg_idx].parse(
                    hasher, self.lde_domain_size, num_queries, widths, ext_deg,
                    self.field,
                )
            except ValueError as e:
                raise VerifierError(f"aux trace query parsing failed: {e}")
            self.aux_proofs.append(proof_a)
            self.aux_tables.append(tables_a)

        # constraint queries
        num_constraint_cols = air0.context.num_constraint_composition_columns()
        try:
            c_proof, c_table = proof.constraint_queries.parse(
                hasher, self.lde_domain_size, num_queries, num_constraint_cols,
                ext_deg, self.field,
            )
        except ValueError as e:
            raise VerifierError(f"constraint query parsing failed: {e}")
        self.constraint_proof = c_proof
        self.constraint_table = c_table

        # OOD frames
        self.ood_frames = []
        self.ood_constraint_evaluations = None
        for i, air in enumerate(airs):
            main_w = air.trace_info().main_trace_width()
            aux_w = air.trace_info().layout.aux_trace_width()
            try:
                trace, evaluations = proof.ood_frames[i].parse(
                    main_w, aux_w, num_constraint_cols, ext_deg, self.field
                )
            except ValueError as e:
                raise VerifierError(f"OOD frame parsing failed: {e}")
            self.ood_frames.append(TraceOodFrame(trace, main_w, aux_w))
            # The reference uses frame 0's copy (channel.rs:144); the copies
            # in frames 1..n-1 are redundant — reject proofs where they
            # disagree so aggregated proof bytes are not malleable.
            if i == 0:
                self.ood_constraint_evaluations = evaluations
            elif evaluations != self.ood_constraint_evaluations:
                raise VerifierError(
                    "OOD constraint evaluations differ across instance frames"
                )

        # FRI proof
        self.fri_proof = proof.fri_proof
        self._fri_channel = None
        self.pow_nonce = proof.pow_nonce

    # -- reads ---------------------------------------------------------------

    def read_trace_commitments(self):
        return self.trace_roots

    def read_constraint_commitment(self):
        return self.constraint_root

    def read_ood_traces_frame(self):
        return self.ood_frames

    def read_ood_constraint_evaluations(self):
        return self.ood_constraint_evaluations

    def read_pow_nonce(self) -> int:
        return self.pow_nonce

    def read_queried_trace_states(self, positions):
        """channel.rs:211-240 — batch-verify openings against the shared
        roots, return (main per-trace tables, aux per-trace tables or None)."""
        if not verify_batch(self.trace_roots[0], positions, self.main_proof):
            raise VerifierError("main trace query verification failed")
        for seg_idx, proof in enumerate(self.aux_proofs):
            if not verify_batch(self.trace_roots[seg_idx + 1], positions, proof):
                raise VerifierError("aux trace query verification failed")
        aux = self.aux_tables[0] if self.aux_tables else None
        return self.main_tables, aux

    def read_constraint_evaluations(self, positions):
        if not verify_batch(self.constraint_root, positions, self.constraint_proof):
            raise VerifierError("constraint query verification failed")
        return self.constraint_table

    # -- FRI channel interface ----------------------------------------------

    def _fri(self):
        if self._fri_channel is None:
            from ..fri.verifier import VerifierChannelFri

            self._fri_channel = VerifierChannelFri(
                self.fri_proof,
                self.fri_roots,
                self.hasher,
                self.lde_domain_size,
                self.folding_factor,
                self.ext_deg,
                field=self.field,
            )
        return self._fri_channel

    def fri_layer_value_bytes(self, idx):
        """Raw canonical value bytes of FRI layer idx (native fold path)."""
        return self._fri().layer_value_bytes[idx]

    def fri_remainder_bytes(self):
        return self._fri().remainder_bytes

    def read_fri_num_partitions(self):
        return self._fri().read_fri_num_partitions()

    def read_fri_layer_commitments(self):
        return self._fri().read_fri_layer_commitments()

    def read_layer_queries(self, positions, commitment):
        return self._fri().read_layer_queries(positions, commitment)

    def read_remainder(self):
        return self._fri().read_remainder()
