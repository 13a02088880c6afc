"""Set-up shared by the port's test modules (``tests/test_torch_*.py``),
imported by each of them: one intra-op torch thread in every pytest-xdist
worker.  The suite runs in several worker processes at once, and torch's
default of one thread per core in each of them oversubscribes the host many
times over.  Run without xdist, the tests keep torch's default.  ``ENV`` is
the same limit for the CLI subprocesses a test starts."""

import os

import torch

ENV = {"OMP_NUM_THREADS": "1"} if "PYTEST_XDIST_WORKER" in os.environ else {}

if ENV:
    torch.set_num_threads(1)
