"""PyTorch port, independence: importing starkpack_winterfell_tpu_torch, its
CLI or chip_smoke pulls in neither jax nor the JAX package, and sets up
none of that package's process state; the default device is the CUDA card,
and asking for it on a machine without one raises.

Each check runs in a fresh interpreter: this test process has both packages
loaded."""

import os
import subprocess
import sys

import pytest

import _torch_one_thread

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every child interpreter here takes seconds; a hung one fails its test long
# before the suite's own time limit
SUBPROCESS_TIMEOUT = 120

LEAK_CHECK = """
import sys
leaked = [m for m in sys.modules
          if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'
          or m == 'starkpack_winterfell_tpu' or m.startswith('starkpack_winterfell_tpu.')]
assert not leaked, leaked
"""


def _run(code, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(_torch_one_thread.ENV, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT,
    )


@pytest.mark.parametrize("module", [
    "starkpack_winterfell_tpu_torch",
    "starkpack_winterfell_tpu_torch.models.cli",
    "starkpack_winterfell_tpu_torch.prover.device_big",
    "starkpack_winterfell_tpu_torch.ops.ntt4",
    # the limb-field slice, one interpreter for all of its modules
    "starkpack_winterfell_tpu_torch.ops.limb_field, "
    "starkpack_winterfell_tpu_torch.ops.limb_ntt, "
    "starkpack_winterfell_tpu_torch.ops.cons_kernel, "
    "starkpack_winterfell_tpu_torch.ops.backend, "
    "starkpack_winterfell_tpu_torch.parallel.full_pipeline, "
    "starkpack_winterfell_tpu_torch.parallel.streamed, "
    "starkpack_winterfell_tpu_torch.prover.commitment, "
    "starkpack_winterfell_tpu_torch.models.rescue128_chain, "
    "starkpack_winterfell_tpu_torch.models.fib_multifield",
    # the DIT kernels and the small-trace slice
    "starkpack_winterfell_tpu_torch.ops.ntt_kernel, "
    "starkpack_winterfell_tpu_torch.ops.ntt, "
    "starkpack_winterfell_tpu_torch.ops.vec, "
    "starkpack_winterfell_tpu_torch.prover.device, "
    "starkpack_winterfell_tpu_torch.prover.constraints, "
    "starkpack_winterfell_tpu_torch.crypto.hashers, "
    "starkpack_winterfell_tpu_torch.models.do_work, "
    "starkpack_winterfell_tpu_torch.models.fibonacci",
    # the Lamport+ slice and SHA3
    "starkpack_winterfell_tpu_torch.models.lamport128, "
    "starkpack_winterfell_tpu_torch.models.lamport128_agg, "
    "starkpack_winterfell_tpu_torch.ops.keccak, "
    "starkpack_winterfell_tpu_torch.native",
    # the limb extensions and the merkle128 model
    "starkpack_winterfell_tpu_torch.models.merkle128",
    # auxiliary segments: the permutation AIR
    "starkpack_winterfell_tpu_torch.models.permutation",
    # the algebraic hashers, the sponge kernel and the f64 Rescue models
    "starkpack_winterfell_tpu_torch.crypto.rescue, "
    "starkpack_winterfell_tpu_torch.crypto.rescue62, "
    "starkpack_winterfell_tpu_torch.crypto._native_perm, "
    "starkpack_winterfell_tpu_torch.ops.rescue_sponge, "
    "starkpack_winterfell_tpu_torch.models.rescue_chain_pad, "
    "starkpack_winterfell_tpu_torch.models.lamport, "
    "starkpack_winterfell_tpu_torch.models.merkle",
    # the Jive hashers on the sponge kernel
    "starkpack_winterfell_tpu_torch.crypto.rescue_jive, "
    "starkpack_winterfell_tpu_torch.crypto.rescue_jive_constants, "
    "starkpack_winterfell_tpu_torch.crypto.griffin, "
    "starkpack_winterfell_tpu_torch.crypto.griffin_constants",
    # the verifier's C tier and the script that times it
    "starkpack_winterfell_tpu_torch.verifier.native_scalar, "
    "starkpack_winterfell_tpu_torch.fri.verifier, "
    "starkpack_winterfell_tpu_torch.crypto.merkle, "
    "verify_walls",
    # the multi-rank prover
    "starkpack_winterfell_tpu_torch.parallel.mesh, "
    "starkpack_winterfell_tpu_torch.utils.device",
    "chip_smoke",
    "profile_prove",
])
def test_import_leaves_jax_and_the_jax_package_out(module):
    code = (
        "import os\nbefore = dict(os.environ)\n"
        f"import {module}\n" + LEAK_CHECK +
        "changed = {k for k in set(before) | set(os.environ)"
        " if before.get(k) != os.environ.get(k)}\n"
        "assert not changed, changed  # no XLA_FLAGS, no compile cache set-up\n"
    )
    r = _run(code)
    assert r.returncode == 0, r.stderr


def test_default_device_raises_without_a_card():
    """prove() with the default device never carries on on the CPU."""
    code = """
import torch
import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.models.rescue_chain import RescueChainProver, build_chain_trace
from starkpack_winterfell_tpu_torch.ops import gl64, ntt4
assert not torch.cuda.is_available()
prover = RescueChainProver(T.ProofOptions(8, 8, 0, 1, 4, 31), T.Blake3_256)
trace = build_chain_trace([1] * 8, 2)
try:
    prover.prove(1, [trace])
except RuntimeError as e:
    assert 'cuda' in str(e).lower(), e
else:
    raise SystemExit('prove() ran without a CUDA device')
""" + LEAK_CHECK
    r = _run(code)
    assert r.returncode == 0, r.stderr


def test_cli_runs_on_the_cpu_and_refuses_the_default_device():
    base = [sys.executable, "-m", "starkpack_winterfell_tpu_torch.models.cli",
            "rescue-chain", "-n", "1", "-l", "128"]
    env = dict(os.environ, PYTHONPATH=ROOT, **_torch_one_thread.ENV)
    r = subprocess.run(base, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode != 0 and "cuda" in r.stderr.lower()
    # 1024 rows is below the big-trace path: the small-trace path proves it
    r = subprocess.run(base + ["--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode == 0 and "Proof verified" in r.stdout, r.stderr
    # a config without a counterpart (f128 at cubic) is refused, not carried on with
    limb = base[:3] + ["rescue128-chain", "-n", "1", "-l", "16"]
    r = subprocess.run(limb + ["--device", "cpu", "-e", "3"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode != 0 and "f128 does not support degree 3" in r.stderr


@pytest.mark.parametrize("args", [
    ["do-work", "-n", "4", "-l", "256"],
    ["fib", "-n", "2", "-l", "1024", "--hash", "blake3_192"],
])
def test_small_trace_cli_runs_on_the_cpu(args):
    base = [sys.executable, "-m", "starkpack_winterfell_tpu_torch.models.cli"] + args
    env = dict(os.environ, PYTHONPATH=ROOT, **_torch_one_thread.ENV)
    r = subprocess.run(base + ["--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode == 0 and "Proof verified" in r.stdout, r.stderr


@pytest.mark.parametrize("args", [
    ["lamport128", "-n", "2", "-l", "128", "--hash", "sha3_256"],
    ["lamport128-agg", "-n", "1", "-l", "2048", "--hash", "blake3_192", "-q", "8"],
])
def test_lamport_cli_runs_on_the_cpu(args):
    base = [sys.executable, "-m", "starkpack_winterfell_tpu_torch.models.cli"] + args
    env = dict(os.environ, PYTHONPATH=ROOT, **_torch_one_thread.ENV)
    r = subprocess.run(base + ["--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode == 0 and "Proof verified" in r.stdout, r.stderr


@pytest.mark.parametrize("args", [
    ["merkle128", "-n", "2", "-l", "64", "-e", "2", "--hash", "sha3_256"],
    ["fib-f62", "-n", "2", "-l", "256", "-e", "3"],
])
def test_limb_extension_cli_runs_on_the_cpu(args):
    base = [sys.executable, "-m", "starkpack_winterfell_tpu_torch.models.cli"] + args
    env = dict(os.environ, PYTHONPATH=ROOT, **_torch_one_thread.ENV)
    r = subprocess.run(base + ["--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode == 0 and "Proof verified" in r.stdout, r.stderr


def test_limb_cli_runs_on_the_cpu_and_refuses_the_default_device():
    base = [sys.executable, "-m", "starkpack_winterfell_tpu_torch.models.cli",
            "fib-f128", "-n", "2", "-l", "64"]
    env = dict(os.environ, PYTHONPATH=ROOT, **_torch_one_thread.ENV)
    r = subprocess.run(base, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode != 0 and "cuda" in r.stderr.lower()
    r = subprocess.run(base + ["--device", "cpu"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode == 0 and "Proof verified" in r.stdout, r.stderr


# every CLI example at a small -l (the hash chains: their chain length)
CLI_EXAMPLES = {"do-work": 16, "fib": 16, "rescue-chain": 8, "rescue-chain-pad": 5,
                "lamport": 64, "rescue128-chain": 8, "merkle128": 64, "lamport128": 64,
                "lamport128-agg": 1024, "fib-f128": 16, "fib-f62": 16, "perm": 16}


@pytest.mark.parametrize("example", sorted(CLI_EXAMPLES))
def test_cli_examples_build_the_jax_cli_traces(example):
    """Both packages' ``get_example`` build the same traces, instance by
    instance, so a CLI invocation proves the same statement in both."""
    from starkpack_winterfell_tpu.models import cli as jcli

    from starkpack_winterfell_tpu_torch.models import cli as tcli

    rows = CLI_EXAMPLES[example]
    for i in range(2):
        want = jcli.get_example(example)[2](i, rows)
        got = tcli.get_example(example)[2](i, rows)
        assert (got.width, got.length) == (want.width, want.length)
        for col in range(want.width):
            assert [got.get(col, s) for s in range(got.length)] == \
                [want.get(col, s) for s in range(want.length)], (example, i, col)


class _Parsed(Exception):
    pass


def _parser_defaults(main, monkeypatch):
    """The namespace and the example choices ``main`` parses for a bare
    ``do-work``: argparse is stopped right after parsing."""
    import argparse

    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        choices = next(a.choices for a in self._actions if a.dest == "example")
        raise _Parsed(vars(parse(self, args, namespace)), set(choices))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed) as got:
            main(["do-work"])
    return got.value.args


def test_cli_parsers_have_the_jax_cli_defaults(monkeypatch):
    """Every option of the JAX CLI has its default in the port's; only
    ``--device`` differs in kind (a flag there, the torch device here)."""
    from starkpack_winterfell_tpu.models import cli as jcli

    from starkpack_winterfell_tpu_torch.models import cli as tcli

    want, want_examples = _parser_defaults(jcli.main, monkeypatch)
    got, got_examples = _parser_defaults(tcli.main, monkeypatch)
    assert got_examples == want_examples
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k != "device"} == \
        {k: v for k, v in want.items() if k != "device"}
    assert want["device"] is False and got["device"] == "cuda"


def test_rescue128_chain_cli_prints_the_jax_cli_proof_hash(capsys):
    """``rescue128-chain -n 1 -l 8 -q 16`` proves one statement in both
    CLIs: the same proof hash (the JAX CLI's host pipeline; the port's on
    the CPU)."""
    from starkpack_winterfell_tpu.models import cli as jcli

    from starkpack_winterfell_tpu_torch.models import cli as tcli

    args = ["rescue128-chain", "-n", "1", "-l", "8", "-q", "16"]

    def proof_hash(out):
        return [line for line in out.splitlines() if line.startswith("Proof hash")]

    jcli.main(args)
    want = proof_hash(capsys.readouterr().out)
    tcli.main(args + ["--device", "cpu"])
    got = proof_hash(capsys.readouterr().out)
    assert len(want) == 1 and got == want


def test_cli_profile_writes_a_chrome_trace(tmp_path):
    base = [sys.executable, "-m", "starkpack_winterfell_tpu_torch.models.cli",
            "do-work", "-n", "1", "-l", "16", "-q", "4", "--device", "cpu",
            "--profile", str(tmp_path / "prof")]
    env = dict(os.environ, PYTHONPATH=ROOT, **_torch_one_thread.ENV)
    r = subprocess.run(base, cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode == 0 and "Proof verified" in r.stdout, r.stderr
    trace = tmp_path / "prof" / "prove_trace.json"
    assert "Profiler trace written to" in r.stdout
    with open(trace) as f:
        assert '"traceEvents"' in f.read(4096)


def test_chip_smoke_exits_nonzero_without_a_card():
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=dict(os.environ, **_torch_one_thread.ENV),
                       capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
