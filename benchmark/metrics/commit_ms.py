"""Trace commit: interpolation, LDE, leaf hashes and Merkle levels of the trace (and of an auxiliary segment), in ms a prove: the program's phase records, mean over the window's
proofs.  The phase names of every pipeline: prove_big and the small-trace
pipeline (prover/device_big.py, prover/device.py), prove_mesh one-shot or
streamed (parallel/full_pipeline.py, prover/pipeline.py:finish_proof)."""

from . import phase_mean_ms

PHASES = {"P1 trace interpolate+LDE+commit", "P1 main-trace commit", "P1b aux commit"}


def read(run):
    return phase_mean_ms(run, PHASES)
