"""pytest settings of the benchmark's own tests (benchmark/tests/), which
run on the host; those that need a CUDA card carry the ``card`` marker and
skip where there is none, as decided inside the test."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "benchmark", "tests", "fixtures")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture(scope="session")
def tiny_spec():
    """BENCHMARK.json with the tests' tiny cells (tests/fixtures/cells.json,
    their traffic in tests/fixtures/workloads/) in place of its own."""
    from benchmark import harness

    with open(os.path.join(FIXTURES, "cells.json")) as f:
        cells = json.load(f)["workloads"]
    return dict(harness.load_spec(ROOT), paths=[os.path.relpath(FIXTURES, ROOT)], workloads=cells)
