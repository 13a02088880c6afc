# Copy of starkpack_winterfell_tpu/errors.py; cut: nothing.
"""Typed error surface — equivalents of the reference's error enums.

- ``ProverError``            <- prover/src/errors.rs
- ``DeserializationError``   <- utils/core/src/errors.rs
- ``VerifierError``          <- verifier/src/errors.rs
  (lives in verifier/channel.py; re-exported here)

``DeserializationError`` subclasses ``ValueError`` so every existing
``except ValueError`` rejection path around untrusted proof bytes keeps
working, while callers can also catch the typed error precisely.  Unlike
bare ``assert`` (stripped under ``python -O``), these raises fire
unconditionally on hostile inputs.
"""

from __future__ import annotations


class ProverError(Exception):
    """Raised when proof generation cannot proceed (prover/src/errors.rs)."""


class DeserializationError(ValueError):
    """Raised when untrusted bytes fail to parse into a valid structure
    (utils/core/src/errors.rs)."""
