"""The StarkPack batched proving entry point — equivalent of
prover/src/lib.rs's ``Prover`` trait.

Counterpart of starkpack_winterfell_tpu/prover/pipeline.py cut to the
``Prover`` base class: subclasses provide the AIR class, proof options,
hash function and public-input extraction; ``prove(n, traces)`` produces
one aggregated StarkProof for all traces sharing a single Fiat-Shamir
transcript.  The host (numpy) pipeline ``_generate_proof`` / ``finish_proof``
is not ported: every prove runs the tensor pipeline of prover/device.py on
the device the caller names.
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
