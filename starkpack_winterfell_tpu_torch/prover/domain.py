# Copy of starkpack_winterfell_tpu/prover/domain.py; cut: the FieldBackend handle and the cached ce-domain power series (ce_powers, ce_x).
"""Evaluation domains — equivalent of prover/src/domain.rs (sizes, offset
and generators of the trace, constraint-evaluation and LDE domains)."""

from __future__ import annotations


class StarkDomain:
    def __init__(self, air):
        self.field = air.field_spec()
        self.trace_length = air.trace_length()
        self.ce_size = air.ce_domain_size()
        self.lde_size = air.lde_domain_size()
        self.domain_offset = air.domain_offset()
        self.ce_to_lde_blowup = self.lde_size // self.ce_size
        self.trace_to_lde_blowup = self.lde_size // self.trace_length
        self.trace_to_ce_blowup = self.ce_size // self.trace_length

    def ce_domain_generator(self) -> int:
        return self.field.get_root_of_unity(self.ce_size.bit_length() - 1)

    def lde_domain_generator(self) -> int:
        return self.field.get_root_of_unity(self.lde_size.bit_length() - 1)
