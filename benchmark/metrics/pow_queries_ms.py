"""Host protocol: the proof-of-work nonce search, the query positions, the openings and the proof's assembly, in ms a prove: the program's phase records, mean over the window's
proofs.  The phase names of every pipeline: prove_big and the small-trace
pipeline (prover/device_big.py, prover/device.py), prove_mesh one-shot or
streamed (parallel/full_pipeline.py, prover/pipeline.py:finish_proof)."""

from . import phase_mean_ms

PHASES = {"P7 PoW+positions", "P8 queries+assembly"}


def read(run):
    return phase_mean_ms(run, PHASES)
