"""Constraint phase: evaluation over the constraint domain, the composition polynomial and its commitment, in ms a prove: the program's phase records, mean over the window's
proofs.  The phase names of every pipeline: prove_big and the small-trace
pipeline (prover/device_big.py, prover/device.py), prove_mesh one-shot or
streamed (parallel/full_pipeline.py, prover/pipeline.py:finish_proof)."""

from . import phase_mean_ms

PHASES = {"P2+3 constraint eval+composition+commit", "P2 constraint evaluation",
          "P3 composition LDE + commit"}


def read(run):
    return phase_mean_ms(run, PHASES)
