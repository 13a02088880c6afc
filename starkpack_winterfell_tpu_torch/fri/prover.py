"""FRI prover pieces.

Counterpart of starkpack_winterfell_tpu/fri/prover.py cut to the three
functions prover/device.py borrows for f64 — ``drp_inv_offsets`` (:146),
``apply_drp_limbs`` (:160), ``fold_positions`` (:311) — and, for
parallel/full_pipeline.py on any field backend (the limb fields, and f64
through ``GL64Backend``), ``LimbFriProver`` (:175), ``limb_drp_inv_offsets``
(:288) and ``limb_apply_drp`` (:302) on tensors: every layer (transpose, row hash,
Merkle levels, fold) runs on the device of the evaluations; only roots,
alphas, the remainder and the queried rows reach the host.  The host
``FriProver`` class is not ported.  ``MeshFriProver`` is JAX
parallel/full_pipeline.py's (:1215): the layers split across the ranks of
a mesh (parallel/mesh.py).
"""

from __future__ import annotations

import torch

from ..math import scalar as fs
from ..ops import gl64 as gl, ntt, vec


def drp_inv_offsets(m: int, N: int, domain_offset: int, device="cpu"):
    """(c * w^i)^{-1} for i in 0..m — the per-row evaluation-point scale of
    the degree-respecting projection (w = root of the m*N source domain)."""
    src_size = m * N
    g = fs.get_root_of_unity(src_size.bit_length() - 1)
    inv_g = pow(g, fs.P - 2, fs.P)
    inv_c = pow(domain_offset, fs.P - 2, fs.P)
    inv_offs = ntt.power_series(inv_g, m, device)
    return gl.mul(inv_offs, gl.from_int(inv_c, (1,), device))  # (m,)


def apply_drp_limbs(transposed, domain_offset: int, alpha_l, ext_deg: int,
                    inv_offs=None):
    """Degree-respecting projection (fri/src/folding/mod.rs:85-117).

    transposed: tuple of tensors shaped (m, N) — row i holds f at the N
    source positions folding to position i.  Row i's micro-coset has offset
    c * w^i; interpolation + evaluation at alpha collapses to Horner at
    (c * w^i)^{-1} * alpha over the row's iNTT.  alpha_l: ext element as
    (1,)-shaped tensors."""
    m, N = transposed[0].shape
    coeffs = ntt.interpolate_poly(transposed)  # per-row iNTT incl. 1/N scale
    if inv_offs is None:
        inv_offs = drp_inv_offsets(m, N, domain_offset, transposed[0].device)
    x = vec.vmul(vec.vbroadcast(alpha_l, (m,)), (inv_offs,))
    return vec.horner(coeffs, x, axis=-1)


def fold_positions(positions, source_domain_size: int, folding_factor: int):
    """fri/src/folding/mod.rs:158-175 — mod + dedup preserving order."""
    target = source_domain_size // folding_factor
    result = []
    for p in positions:
        p = p % target
        if p not in result:
            result.append(p)
    return result


class LimbFriProver:
    """FRI prover over the field of a FieldBackend (f128, f62, or f64
    through ``GL64Backend``).  All arithmetic runs through the backend;
    evaluations are element tuples (``ext_deg`` components, each a tuple of
    word planes shaped (L,))."""

    def __init__(self, options, hasher, B, ext_deg: int = 1):
        self.options = options
        self.hasher = hasher
        self.B = B
        self.spec = B.spec
        self.ext_deg = ext_deg
        self.layers = []
        self.remainder_poly = None

    def build_layers(self, channel, evaluations):
        """evaluations: element tuple, components shaped (L,)."""
        assert not self.layers
        n_layers = self.options.num_fri_layers(evaluations[0][0].shape[-1])
        for _ in range(n_layers):
            evaluations = self._build_layer(channel, evaluations)
        self._set_remainder(channel, evaluations)

    def _build_layer(self, channel, evaluations):
        from ..crypto.merkle import MerkleTree, build_levels

        B = self.B
        N = self.options.folding_factor
        L = evaluations[0][0].shape[-1]
        m = L // N
        # transposed[i][j] = evals[i + j*m]: components reshaped (N, m).T
        transposed = tuple(
            B.cmap(lambda l: l.reshape(N, m).T.contiguous(), c) for c in evaluations
        )
        words = B.rows_to_words(transposed, self.ext_deg)
        leaves = self.hasher.hash_words(words, N * self.ext_deg * self.spec.ELEMENT_BYTES)
        tree = MerkleTree(build_levels(leaves, self.hasher), self.hasher)
        channel.commit_fri_layer(tree.root())
        alpha = channel.draw_fri_alpha()
        device = evaluations[0][0].device
        inv_offs = limb_drp_inv_offsets(B, m, N, self.options.domain_offset(), device)
        alpha_l = B.scalar_to_limbs(alpha, self.ext_deg, device=device)
        folded = limb_apply_drp(B, transposed, alpha_l, inv_offs, self.ext_deg)
        self.layers.append((transposed, tree, m, N))
        return folded

    def _set_remainder(self, channel, evaluations):
        B, spec = self.B, self.spec
        coeffs = B.interpolate_poly_with_offset(evaluations, self.options.domain_offset())
        size = evaluations[0][0].shape[-1] // self.options.blowup_factor
        remainder = B.limbs_to_elems(
            tuple(B.cmap(lambda l: l[:size], c) for c in coeffs), self.ext_deg
        )
        channel.commit_fri_layer(
            self.hasher.hash_elements(remainder, spec.ELEMENT_BYTES)
        )
        self.remainder_poly = remainder

    def build_proof(self, positions):
        from ..crypto.merkle import MerkleTree
        from .proof import FriProof, FriProofLayer

        assert self.remainder_poly is not None
        B, spec = self.B, self.spec
        proof_layers = []
        pos = list(positions)
        if self.layers:
            domain_size = self.layers[0][2] * self.layers[0][3]
            N = self.options.folding_factor
            layer_pos = []
            for _ in self.layers:
                pos = fold_positions(pos, domain_size, N)
                layer_pos.append(pos)
                domain_size //= N
            MerkleTree.prefetch_trees(
                [(t[1], p) for t, p in zip(self.layers, layer_pos)]
            )
            for layer, pos in zip(self.layers, layer_pos):
                gathered = self._layer_rows(layer, pos)
                mp = layer[1].prove_batch(pos)
                rows = [
                    B.limbs_to_elems(B.emap(lambda l: l[i], gathered), self.ext_deg)
                    for i in range(len(pos))
                ]
                proof_layers.append(FriProofLayer.new(rows, mp, self.ext_deg, spec))
        remainder = self.remainder_poly
        self.layers = []
        self.remainder_poly = None
        return FriProof.new(proof_layers, remainder, 1, spec)

    def _layer_rows(self, layer, pos):
        """A layer's queried rows on the host: one gather and one host copy
        a plane."""
        transposed = layer[0]
        idx = torch.as_tensor(pos, dtype=torch.int64, device=transposed[0][0].device)
        return self.B.emap(lambda l: l.index_select(0, idx).cpu(), transposed)


class MeshFriProver(LimbFriProver):
    """FRI over the ranks of a mesh (JAX ``MeshFriProver``
    parallel/full_pipeline.py:1215, ``_fri_layer_kernels`` :1128), byte for
    byte ``LimbFriProver``.  The evaluations arrive split in contiguous
    blocks, one a rank.  A layer's (m, N) rows take one element from each of
    N blocks of the (N, m) view, so one all-to-all gives each rank its m/d
    rows; their hashes, subtree and fold are local, the subtree roots are
    all-gathered, and every rank's channel commits the layer and draws
    alpha.  The fold of a rank's rows is its block of the next layer.  Once
    a layer's m is not a multiple of d, or m < 2d, or d does not divide N
    (the all-to-all's blocks), the evaluations are all-gathered and the
    remaining layers and the remainder run as ``LimbFriProver``'s, the same
    on every rank (JAX :1268).  There is no device coin: the host channel
    draws every alpha, as ``LimbFriProver`` does."""

    def __init__(self, options, hasher, B, ext_deg: int, mesh):
        super().__init__(options, hasher, B, ext_deg)
        self.mesh = mesh

    def build_layers(self, channel, evaluations):
        """evaluations: this rank's block of the element tuple, components
        shaped (L/d,)."""
        assert not self.layers
        B, mesh = self.B, self.mesh
        d, N = mesh.size, self.options.folding_factor
        n_layers = self.options.num_fri_layers(evaluations[0][0].shape[-1] * d)
        while len(self.layers) < n_layers:
            m = evaluations[0][0].shape[-1] * d // N
            if m % d or m < 2 * d or N % d:
                break
            evaluations = self._build_layer_split(channel, evaluations, m, N)
        evaluations = tuple(B.cmap(lambda l: mesh.all_gather(l).reshape(-1), c)
                            for c in evaluations)
        while len(self.layers) < n_layers:
            evaluations = self._build_layer(channel, evaluations)
        self._set_remainder(channel, evaluations)

    def _build_layer_split(self, channel, evaluations, m: int, N: int):
        from ..crypto.merkle import ShardedMerkleTree, sharded_levels

        B, mesh = self.B, self.mesh
        d = mesh.size

        def rows(l):  # this rank's N/d rows of the (N, m) view -> its m/d rows (m/d, N)
            return mesh.all_to_all(l.reshape(N // d, m), 1, 0).T.contiguous()

        transposed = tuple(B.cmap(rows, c) for c in evaluations)
        words = B.rows_to_words(transposed, self.ext_deg)
        leaves = self.hasher.hash_words(words, N * self.ext_deg * self.spec.ELEMENT_BYTES)
        tree = ShardedMerkleTree(*sharded_levels(leaves, self.hasher, mesh), self.hasher, mesh)
        channel.commit_fri_layer(tree.root())
        alpha = channel.draw_fri_alpha()
        device = evaluations[0][0].device
        m_loc = m // d
        inv_offs = B.cmap(
            lambda l: l[mesh.rank * m_loc:(mesh.rank + 1) * m_loc],
            limb_drp_inv_offsets(B, m, N, self.options.domain_offset(), device))
        alpha_l = B.scalar_to_limbs(alpha, self.ext_deg, device=device)
        folded = limb_apply_drp(B, transposed, alpha_l, inv_offs, self.ext_deg)
        self.layers.append((transposed, tree, m, N))
        return folded

    def _layer_rows(self, layer, pos):
        from ..crypto.merkle import ShardedMerkleTree

        transposed, tree, m, _ = layer
        if not isinstance(tree, ShardedMerkleTree):
            return super()._layer_rows(layer, pos)
        mesh = self.mesh
        return self.B.emap(lambda l: mesh.take(l, 0, pos, m // mesh.size).cpu(), transposed)


def limb_drp_inv_offsets(B, m: int, N: int, domain_offset: int, device="cpu"):
    """inv_offsets[i] = inv(offset) * inv(g_src)^i for a limb-field DRP at
    source size m*N — one component shaped (m,), log-doubled on ``device``."""
    spec = B.spec
    g = spec.get_root_of_unity((m * N).bit_length() - 1)
    inv_g = pow(g, spec.P - 2, spec.P)
    inv_c = pow(domain_offset, spec.P - 2, spec.P)
    series = B.power_series(inv_g, m, device)
    return B.bmul(series, B.b_from_int(inv_c, (1,), device))


def limb_apply_drp(B, transposed, alpha_l, inv_offs, ext_deg: int):
    """Limb-field DRP: transposed components shaped (m, N), alpha_l an ext
    element as (1,)-shaped planes, inv_offs a component (m,)."""
    coeffs = B.interpolate_poly(transposed)
    m = transposed[0][0].shape[0]
    x = B.vmul(B.vbroadcast(alpha_l, (m,)), (inv_offs,))
    return B.horner(coeffs, x, axis=-1)
