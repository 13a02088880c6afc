"""starkpack_winterfell_tpu_torch — the PyTorch/CUDA port of the StarkPack
prover/verifier (counterpart of the JAX package starkpack_winterfell_tpu).

Imports torch, numpy and the standard library only.  Every public entry
point takes an explicit ``device`` argument that defaults to ``"cuda"``;
asking for the default on a machine without a CUDA device raises — nothing
carries on silently on the CPU.  Pass ``device="cpu"`` to run the plain
tensor code on the host (the tests do).

Ported so far: the big-trace path (prover/device_big.py) for f64 base-field
AIRs with BLAKE3-256, driven through ``Prover.prove`` and ``verify``.
"""

from .air import (
    Air,
    AirContext,
    Assertion,
    FieldExtension,
    ProofOptions,
    StarkProof,
    TraceInfo,
    TraceLayout,
    TransitionConstraintDegree,
)
from .crypto.hashers import Blake3_256, get_hasher
from .crypto.random_coin import RandomCoin
from .errors import DeserializationError, ProverError
from .prover import Prover, TraceTable
from .verifier import VerifierError, verify

__version__ = "0.1.0"
