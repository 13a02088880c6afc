# Copy of starkpack_winterfell_tpu/verifier/__init__.py; cut: nothing.
from .channel import VerifierChannel, VerifierError
from .verifier import verify
