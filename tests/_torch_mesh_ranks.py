"""The rank side of tests/test_torch_mesh.py: each spawned process joins a
gloo group through a ``file://`` rendezvous, wraps it with
``parallel/mesh.py:make_mesh(device="cpu")`` and proves the named cases with
``prove_mesh(..., mesh=)``; it writes what it got to ``rank<r>.pkl``.  This
module imports the port only (a rank never loads the JAX package); the
test module builds the same statements with the JAX package and holds the
ranks' bytes against them."""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.air import AirContext, Assertion, TransitionConstraintDegree
from starkpack_winterfell_tpu_torch.crypto.merkle import ShardedMerkleTree
from starkpack_winterfell_tpu_torch.models.do_work import DoWorkAir, DoWorkProver, build_do_work_trace
from starkpack_winterfell_tpu_torch.models.fib_multifield import get_fib_family
from starkpack_winterfell_tpu_torch.models.permutation import PermAir, PermProver, build_perm_trace
from starkpack_winterfell_tpu_torch.ops import gl64 as gl
from starkpack_winterfell_tpu_torch.ops.backend import get_backend
from starkpack_winterfell_tpu_torch.parallel import full_pipeline
from starkpack_winterfell_tpu_torch.parallel.mesh import (
    make_mesh,
    sharded_ntt,
    sharded_trace_commitment,
)

SEQ_STRIDE = 4


class SeqPub:
    def __init__(self, start, result, seq):
        self.start, self.result, self.seq = start, result, list(seq)

    def to_elements(self):
        return [self.start, self.result] + self.seq


class SeqDoWorkAir(DoWorkAir):
    """do-work with a sequence assertion from step 1 (JAX
    tests/test_full_pipeline_mesh.py:219)."""

    def __init__(self, trace_info, pub_inputs, options):
        self.context = AirContext(trace_info, [TransitionConstraintDegree(3)], 3, options)
        self.start = pub_inputs.start
        self.result = pub_inputs.result
        self.seq = pub_inputs.seq

    def get_assertions(self):
        last = self.trace_length() - 1
        return [Assertion.single(0, 0, self.start), Assertion.single(0, last, self.result),
                Assertion.sequence(0, 1, SEQ_STRIDE, self.seq)]


class SeqDoWorkProver(DoWorkProver):
    air_class = SeqDoWorkAir

    def get_pub_inputs(self, trace):
        last = trace.length - 1
        seq = [trace.get(0, 1 + i * SEQ_STRIDE) for i in range(trace.length // SEQ_STRIDE)]
        return SeqPub(trace.get(0, 0), trace.get(0, last), seq)


def _fib(field, hasher, options, rows, n=2):
    air, build, prover_cls, _ = get_fib_family(field)
    return air, prover_cls(T.ProofOptions(*options), hasher), [build(rows) for _ in range(n)]


# the counterparts of JAX tests/test_full_pipeline_mesh.py: name -> () ->
# (AIR class, prover, traces)
CASES = {
    "do_work_8": lambda: (DoWorkAir, DoWorkProver(T.ProofOptions(16, 8, 0, 1, 4, 7), T.Blake3_256),
                          [build_do_work_trace(i + 1, 16) for i in range(8)]),
    "do_work_8_quad": lambda: (DoWorkAir,
                               DoWorkProver(T.ProofOptions(16, 8, 0, 2, 4, 7), T.Blake3_256),
                               [build_do_work_trace(i + 5, 16) for i in range(8)]),
    "do_work_3": lambda: (DoWorkAir, DoWorkProver(T.ProofOptions(16, 8, 0, 1, 4, 7), T.Blake3_256),
                          [build_do_work_trace(i + 2, 16) for i in range(3)]),
    "perm_2_quad": lambda: (PermAir,
                            PermProver(T.ProofOptions(16, 8, 0, 2, 4, 7), T.Blake3_256),
                            [build_perm_trace(i + 1, 16) for i in range(2)]),
    "fib_f128_sha3": lambda: _fib("f128", T.Sha3_256, (16, 8, 0, 1, 4, 3), 16),
    "fib_f62": lambda: _fib("f62", T.Blake3_256, (16, 8, 0, 1, 4, 3), 16),
    "fib_f128_four_step": lambda: _fib("f128", T.Sha3_256, (8, 8, 0, 1, 4, 3), 256),
    # folding factor 2: over 2 ranks the last FRI layers, over 4 every
    # layer (d does not divide N) run on every rank alike
    "do_work_fold2": lambda: (DoWorkAir,
                              DoWorkProver(T.ProofOptions(16, 8, 0, 1, 2, 7), T.Blake3_256),
                              [build_do_work_trace(i + 7, 32) for i in range(4)]),
    "seq_do_work": lambda: (SeqDoWorkAir,
                            SeqDoWorkProver(T.ProofOptions(16, 8, 0, 1, 4, 7), T.Blake3_256),
                            [build_do_work_trace(i + 3, 16) for i in range(2)]),
}
# the case whose limb transforms take the four-step split: the f128 tile
# cap lowered below its length (JAX :104)
FOUR_STEP_CAP = 64

# P1's shard check and the commitment (JAX :278, tests/test_parallel.py):
# instances, width, trace length, blowup
SHARD = (8, 4, 64, 8)
# sharded_ntt: the (n1, n2) view of the transform
NTT = (64, 64)


def shard_inputs():
    """SHARD's traces, one-word Goldilocks, drawn from a seed: (n, w, length)."""
    n, w, length, _ = SHARD
    rng = np.random.default_rng(0)
    return gl.from_u64(rng.integers(0, gl.P, size=(n, w, length), dtype=np.uint64), "cpu")


def ntt_input():
    rng = np.random.default_rng(101)
    n1, n2 = NTT
    return gl.from_u64(rng.integers(0, gl.P, size=n1 * n2, dtype=np.uint64), "cpu")


def prove_case(name, mesh=None):
    """(AIR class, prover, traces, proof) of a case: over ``mesh``, or on
    one device where it is None."""
    air, prover, traces = CASES[name]()
    F = get_backend("f128").F
    if name == "fib_f128_four_step":
        F.MAX_NTT_TILE = FOUR_STEP_CAP
    try:
        if mesh is None:
            proof = prover.prove(len(traces), traces, device="cpu")
        else:
            proof = full_pipeline.prove_mesh(prover, len(traces), traces, "cpu", mesh=mesh)
    finally:
        F.__dict__.pop("MAX_NTT_TILE", None)
    return air, prover, traces, proof


def _mesh_pieces(mesh):
    """P1's shard shapes and root at SHARD, ``sharded_trace_commitment``'s
    root and this rank's part of ``sharded_ntt``."""
    n, w, length, blowup = SHARD
    B = get_backend("f64")
    traces = shard_inputs()
    n_loc = n // mesh.size
    local = ((traces[mesh.rank * n_loc:(mesh.rank + 1) * n_loc],),)
    polys, rows, levels = full_pipeline.sharded_segment_commit(
        B, T.Blake3_256, local, blowup, 7, 1, mesh=mesh, n=n)
    out = {
        "polys_shape": tuple(polys[0][0].shape),
        "rows_shape": tuple(rows[0][0].shape),
        "leaves_shape": tuple(levels[0][0].shape),
        "root": ShardedMerkleTree(*levels, T.Blake3_256, mesh).root(),
        "commitment": sharded_trace_commitment(mesh, T.Blake3_256, blowup)(local),
    }
    n1, n2 = NTT
    x = ntt_input().reshape(n1, n2)
    cols = n2 // mesh.size
    out["ntt"] = sharded_ntt(mesh, n1 * n2, n1)(x[:, mesh.rank * cols:(mesh.rank + 1) * cols])
    return out


def rank_main(rank, size, init, cases, out_dir, pieces):
    """One rank: join the group, prove every case in ``cases`` (and, with
    ``pieces``, run ``_mesh_pieces``), write the results."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=size)
    try:
        mesh = make_mesh(device="cpu")
        results = {name: prove_case(name, mesh)[3].to_bytes() for name in cases}
        if pieces:
            results["pieces"] = _mesh_pieces(mesh)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
