"""starkpack_winterfell_tpu_torch — the PyTorch/CUDA port of the StarkPack
prover/verifier (counterpart of the JAX package starkpack_winterfell_tpu).

Imports torch, numpy and the standard library only.  Every public entry
point takes an explicit ``device`` argument that defaults to ``"cuda"``;
asking for the default on a machine without a CUDA device raises — nothing
carries on silently on the CPU.  Pass ``device="cpu"`` to run the plain
tensor code on the host (the tests do).

Ported so far, all driven through ``Prover.prove`` and ``verify``, main
segment only: f64 traces of 2^14 rows and more through the big-trace path
(prover/device_big.py), shorter f64 traces through the small-trace path
(prover/device.py), both at extension degree 1, 2 or 3 with BLAKE3-256 or
BLAKE3-192, and f128/f62 traces at extension degree 1, with single-value and
sequence assertions, through the limb path (parallel/full_pipeline.py) with
BLAKE3-256, BLAKE3-192 or SHA3-256.
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
from .crypto.hashers import Blake3_192, Blake3_256, Sha3_256, get_hasher
from .crypto.random_coin import RandomCoin
from .errors import DeserializationError, ProverError
from .prover import Prover, TraceTable
from .verifier import VerifierError, verify

__version__ = "0.1.0"
