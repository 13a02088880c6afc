from .channel import DefaultProverChannel
from .options import FriOptions
from .proof import FriProof, FriProofLayer
from .prover import apply_drp_limbs, fold_positions
from .verifier import FriVerificationError, FriVerifier, VerifierChannelFri
