"""Several ranks, one proof: the process group of a multi-rank prove.

Counterpart of starkpack_winterfell_tpu/parallel/mesh.py (``make_mesh`` :21,
``sharded_ntt`` :31, ``sharded_trace_commitment`` :104) over
``torch.distributed`` instead of a ``jax.sharding.Mesh``: SPMD, one process a
rank, every rank holding its own copy of the Fiat-Shamir channel.  Its axis
is the JAX package's ``dp`` axis: instances ride it for the trace LDEs, LDE
row blocks for the Merkle leaves, the constraint evaluation and FRI
(parallel/full_pipeline.py:prove_mesh with ``mesh=``).

The caller initializes the process group (``torch.distributed.
init_process_group`` with its backend, rendezvous, world size and rank) and
wraps it with ``make_mesh``.  The pipeline uses a few collectives, each on
int64 tensors:

* ``all_gather``: every rank's tensor, stacked in rank order;
* ``all_to_all``: the tiled all-to-all of JAX ``jax.lax.all_to_all``;
* ``halo``: the first entries of the next rank's block (JAX ``ppermute``),
  built from ``all_gather`` because gloo's send and receive take host
  tensors only;
* ``take``: entries at global indexes of a block-distributed tensor, each
  from the rank that owns it.

Every cross-rank sum is an ``all_gather`` followed by a field sum
(``FieldBackend.vsum``): ``ReduceOp.SUM`` adds integers, which is not
modular and overflows the int64 words.

The collectives take the rank's tensors as they are, CPU or CUDA, under
gloo and NCCL alike: gloo in torch 2.11 takes CUDA tensors in
``all_gather`` and ``all_to_all_single`` (it copies them through host
memory itself), as chip_smoke.py's ``gloo_cuda_probe`` found on the card
(PERF.md).  NCCL, one card a rank, is the setup meant for several cards.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..utils.device import resolve_device, use_device


class Mesh:
    """The process group of a multi-rank prove: this rank, the number of
    ranks and this rank's device."""

    def __init__(self, group, rank: int, size: int, device: torch.device, backend: str):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, device={self.device}, "
                f"backend={self.backend})")

    def all_gather(self, t):
        """(...) -> (size, ...): every rank's ``t`` in rank order."""
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts)

    def all_to_all(self, t, split_dim: int, concat_dim: int):
        """JAX ``all_to_all(tiled=True)``: ``t`` cut into ``size`` equal
        blocks along ``split_dim``, block s sent to rank s; the blocks this
        rank receives joined along ``concat_dim`` in rank order."""
        d = self.size
        x = t.movedim(split_dim, 0)
        src = x.reshape((d, x.shape[0] // d) + tuple(x.shape[1:])).contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return torch.cat([out[s].movedim(0, split_dim) for s in range(d)], dim=concat_dim)

    def halo(self, t, k: int):
        """The first ``k`` entries along the last axis of the next rank's
        ``t`` (rank size-1 reads rank 0's: the domain wraps)."""
        return self.all_gather(t[..., :k])[(self.rank + 1) % self.size]

    def take(self, t, dim: int, positions, block: int):
        """``t`` holds entries [rank*block, (rank+1)*block) of a tensor
        distributed in blocks along ``dim``: returns, on every rank, the
        entries at the global ``positions`` along ``dim``, each from its
        owner (one ``all_gather`` of the selection, not of ``t``)."""
        q = len(positions)
        pos = torch.as_tensor(list(positions), dtype=torch.int64, device=t.device)
        owner = pos // block
        mine = (owner == self.rank).nonzero().flatten()
        shape = list(t.shape)
        shape[dim] = q
        sel = torch.zeros(shape, dtype=t.dtype, device=t.device)
        if mine.numel():
            local = pos.index_select(0, mine) - self.rank * block
            sel.index_copy_(dim, mine, t.index_select(dim, local))
        gathered = self.all_gather(sel).movedim(dim + 1, 1)  # (size, q, ...)
        picked = gathered[owner, torch.arange(q, device=t.device)]
        return picked.movedim(0, dim)


def make_mesh(group=None, device="cuda") -> Mesh:
    """Wraps the process group the caller initialized (the default group
    when ``group`` is None).  A rank's device is ``cuda:LOCAL_RANK`` (the
    rank itself where LOCAL_RANK is not set), made the current CUDA device
    here, before any kernel library loads (``native.load_kernels`` sets
    its limits on the current device, and ``native.launch`` refuses any
    other); ``device="cpu"`` runs the plain tensor code on the host.  Any
    other device raises without a card, as every entry point does."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_group first")
    rank = dist.get_rank(group)
    size = dist.get_world_size(group)
    backend = str(dist.get_backend(group))
    if torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        dev = resolve_device(device)
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        use_device(dev)
    return Mesh(group, rank, size, dev, backend)


def sharded_ntt(mesh: Mesh, n: int, n1: int = None):
    """Multi-rank Goldilocks NTT (JAX :31): the six-step decomposition with
    the transpose as an all-to-all.  A size-n transform viewed as (n1, n2)
    row-major is distributed by columns:

      1. local column NTTs (size n1) over this rank's n2/d columns;
      2. local twiddle multiply w^(i2*k1);
      3. all-to-all transpose -> (n2, n1) distributed by its columns;
      4. local column NTTs (size n2).

    Returns ``run(x)``: x is this rank's (n1, n2/d) columns of the input
    (one-word Goldilocks, int64), the result this rank's (n2, n1/d) columns
    of the output, whose row-major flattening is the natural-order NTT."""
    from ..ops import ntt
    from ..ops.backend import get_backend

    B = get_backend("f64")
    if n1 is None:
        n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    d = mesh.size
    root = B.get_root_of_unity(n.bit_length() - 1)
    # tw[k1, i2] = w^(k1*i2) over this rank's columns
    bases = B.b_from_ints([pow(root, k1, B.P) for k1 in range(n1)], mesh.device)
    full = B.pow_series_rows(B.cmap(lambda l: l.reshape(n1, 1), bases), n2)[0]
    tw = full[:, mesh.rank * (n2 // d):(mesh.rank + 1) * (n2 // d)].contiguous()

    def columns(x):  # NTT along axis 0
        return ntt.ntt_components((x.T.contiguous(),))[0].T

    def run(x):
        b = B.bmul((columns(x),), (tw,))[0]
        b = mesh.all_to_all(b, 0, 1)  # (n1/d, n2): rows k1 of this rank, every column
        return columns(b.T)

    return run


def sharded_trace_commitment(mesh: Mesh, hasher, blowup: int, domain_offset: int = 7):
    """JAX :104: returns ``fn(comps)`` -> the combined-row trace commitment
    root (digest bytes) of a batch of one-word Goldilocks traces shaped
    (n, width, length) and distributed over the ranks by instance (comps:
    this rank's (n/d, width, length) component tuple).  Local interpolate
    and coset LDE, one all-to-all to row blocks, local leaves and subtree,
    the subtree roots all-gathered, the top of the tree on every rank
    (parallel/full_pipeline.py:sharded_segment_commit)."""
    from ..crypto.merkle import ShardedMerkleTree
    from ..ops.backend import get_backend
    from .full_pipeline import sharded_segment_commit

    B = get_backend("f64")

    def fn(comps):
        _, _, levels = sharded_segment_commit(B, hasher, comps, blowup, domain_offset, 1,
                                              mesh=mesh)
        return ShardedMerkleTree(*levels, hasher, mesh).root()

    return fn
