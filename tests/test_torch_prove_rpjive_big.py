"""PyTorch port, RpJive64_256 through the f64 big-trace pipeline: the Rescue
chain of 2^14 rows with the bench options (``ProofOptions(28, 8, 16, NONE,
4, 31)``) proved by ``prove_big`` in two ce chunks (its proof-of-work
search on the C search), its sha256 equal to the pinned digest of the JAX
package's host proof (``golden/rescue14_bench_rpjive.sha256``) and the proof accepted by
both packages' verifiers.  The plain sponge is replaced by the port's host
C sponge, the same function; the helpers are test_torch_prove_jive.py's.

``test_pin_is_the_jax_host_proof`` (marked ``slow``: ``python -m pytest
tests/test_torch_prove_rpjive_big.py -m slow``; the JAX host prove takes ~2 min on one CPU
thread) proves the chain with the JAX package and holds the pin and the
port's bytes against it.  Tolerance zero."""

import pytest

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)
from test_torch_prove_jive import check_big, pin_is_the_jax_host_proof


def test_big_chain_equals_the_pin_and_both_verifiers_take_it():
    check_big("rp_jive64_256")


@pytest.mark.slow
def test_pin_is_the_jax_host_proof():
    pin_is_the_jax_host_proof("rp_jive64_256")
