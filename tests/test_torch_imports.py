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


def test_chip_smoke_exits_nonzero_without_a_card():
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=ROOT, env=dict(os.environ, **_torch_one_thread.ENV),
                       capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
