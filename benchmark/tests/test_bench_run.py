"""Whole runs: without a card the command exits non-zero and prints no
result; on the host, the fixture cells run through the harness with the
program's host path (device="cpu") and come out correct; and with the timed
path broken underneath, and the program's own verify made to accept
anything, the reference alone turns ``correct`` false."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SEED = 2 ** 31 + 12345


def command(cwd, cell="chain-1x2e20"):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=600)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    r = command(ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA card" in r.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = command(tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_the_first_run_of_a_fresh_checkout(tmp_path):
    """Nothing built yet: the program builds its native libraries on first
    use, the pool's chains are then built side by side."""
    program = "starkpack_winterfell_tpu_torch"
    shutil.copytree(os.path.join(ROOT, program), tmp_path / program,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import json, sys; sys.path.insert(0, '.'); from benchmark import harness; "
            "spec = dict(harness.load_spec('.'), paths=['benchmark/tests/fixtures'], "
            "workloads=json.load(open('benchmark/tests/fixtures/cells.json'))['workloads']); "
            "r = harness.run_cell('.', 'chain-tiny', 7, 0.1, False, 'cpu', spec=spec); "
            "print(r['correct'])")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0 and r.stdout.strip().splitlines()[-1] == "True", r.stderr[-2000:]


@pytest.fixture
def run(tiny_spec):
    def run(cell, seconds=0.5):
        result = harness.run_cell(ROOT, cell, SEED, seconds, False, "cpu", spec=tiny_spec)
        result.pop("steps")
        return result
    return run


@pytest.mark.parametrize("cell", ["chain-tiny", "lamport-tiny"])
def test_fixture_cells_are_correct(run, cell):
    result = run(cell)
    assert result["correct"], result
    assert list(result)[-1] == "checks"
    assert {"proof_s", "setup_s"} <= set(result["metrics"])


@pytest.fixture
def judged_by_the_reference_alone(monkeypatch):
    import starkpack_winterfell_tpu_torch as program

    monkeypatch.setattr(program, "verify", lambda *a, **k: True)


def test_a_step_that_returns_its_state_unchanged(monkeypatch, judged_by_the_reference_alone, run):
    from starkpack_winterfell_tpu_torch.prover.pipeline import Prover

    prove, first = Prover.prove, []

    def stale(self, n, traces, device="cuda"):
        if not first:
            first.append(prove(self, n, traces, device=device))
        return first[0]

    monkeypatch.setattr(Prover, "prove", stale)
    result = run("chain-tiny")
    assert not result["correct"] and result["checks"]["rejected_proofs"]["value"] > 0


@pytest.mark.parametrize("cell", ["chain-tiny", "lamport-tiny"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, judged_by_the_reference_alone, run,
                                                cell):
    from starkpack_winterfell_tpu_torch.prover.pipeline import Prover

    prove = Prover.prove

    def altered(self, n, traces, device="cuda"):
        proof = prove(self, n, traces, device=device)
        proof.pow_nonce ^= 1
        return proof

    monkeypatch.setattr(Prover, "prove", altered)
    result = run(cell)
    assert not result["correct"] and result["checks"]["rejected_proofs"]["value"] > 0


def test_a_wrong_public_key_is_caught(monkeypatch, run):
    from benchmark.statements import lamport_agg

    build = lamport_agg.build

    def wrong_claims(*a, **k):
        pool = build(*a, **k)
        for stmt in pool.statements:
            stmt.reference[0]["pub_keys"] = [list(pk) for pk in stmt.reference[0]["pub_keys"]]
            stmt.reference[0]["pub_keys"][0][0] ^= 1
        return pool

    monkeypatch.setattr(lamport_agg, "build", wrong_claims)
    result = run("lamport-tiny")
    assert not result["correct"]


@pytest.mark.parametrize("cell", ["chain-tiny", "lamport-tiny"])
def test_control_is_rejected(tiny_spec, cell, capsys):
    """The control (benchmark/control.py): every proof's first FRI fold at a
    challenge one off, under a header that states the configuration's
    options; each distinct proof passes every check before the fold and is
    rejected there."""
    from benchmark.control import broken_fold

    with broken_fold():
        result = harness.run_cell(ROOT, cell, SEED, 0.5, False, "cpu", spec=tiny_spec)
    checks, judged = result["checks"], len({s["statement"] for s in result["steps"]})
    assert not result["correct"] and checks["failed_steps"]["value"] == 0
    assert checks["rejected_proofs"]["value"] == judged
    assert capsys.readouterr().err.count("FRI layer 1 does not fold the previous layer") == judged


@pytest.mark.card
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = command(ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
