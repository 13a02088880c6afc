"""Device proving: routing and the phases shared by the device pipelines.

Counterpart of starkpack_winterfell_tpu/prover/device.py cut to what the
big-trace pipeline (prover/device_big.py) borrows: the FRI layer hash and
fold (``fri_hash_kernel`` :353, ``fri_fold_kernel`` :376), ``run_fri_phase``
:562, ``assemble_proof`` :600, the scalar stacking helpers, and the routing
of ``prove_device`` :400: a field other than f64 goes to the limb pipeline
(parallel/full_pipeline.py ``prove_mesh``), an f64 config the big-trace
pipeline supports goes to ``prove_big``, anything else raises.
The small-trace pipeline ``_generate_proof_device`` is not ported, and there
is no jit cache: the functions below are plain eager tensor code.
"""

from __future__ import annotations

import numpy as np
import torch

from ..math import scalar as fs
from ..ops import gl64 as gl, ntt
from ..utils.convert import limbs_to_elems, rows_to_words, scalar_to_limbs
from ..utils.device import resolve_device


# ---------------------------------------------------------------------------
# Phase 5: FRI layer step
# ---------------------------------------------------------------------------


def fri_hash_kernel(evals, N: int, ext_deg: int, hasher):
    """Transpose + row-hash + Merkle levels for one FRI layer (the root must
    reach the transcript before alpha is drawn, so folding is separate).
    evals: ext tuple of (L,) tensors.  Returns (transposed (L/N, N), levels)."""
    L = evals[0].shape[-1]
    m = L // N
    transposed = tuple(c.reshape(N, m).T for c in evals)
    words = rows_to_words(transposed, ext_deg)
    leaves = hasher.hash_words(words, N * ext_deg * 8)
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        cur = hasher.merge_words(cur[0::2], cur[1::2])
        levels.append(cur)
    return transposed, levels


def fri_fold_kernel(transposed, alpha_l, offset: int, ext_deg: int):
    from ..fri.prover import apply_drp_limbs

    return apply_drp_limbs(transposed, offset, alpha_l, ext_deg)


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def prove_device(prover, n: int, traces, device="cuda"):
    """Route a prove to the pipeline that supports its config: limb fields
    to ``prove_mesh``, f64 to the big-trace pipeline.  Anything they do not
    cover raises NotImplementedError naming the config (there is no host
    pipeline to fall back to)."""
    from . import device_big

    dev = resolve_device(device)
    options = prover.options()
    ext_deg = options.field_extension
    hasher = prover.hasher
    pub0 = prover.get_pub_inputs(traces[0])
    air0 = prover.air_class(traces[0].get_info(), pub0, options)
    length = traces[0].length

    def refuse(why):
        raise NotImplementedError(
            f"config not ported yet ({why}): air={type(air0).__name__}, "
            f"field={air0.field_spec().name}, extension degree={ext_deg}, "
            f"hasher={getattr(hasher, 'NAME', hasher)}, trace length={length}, "
            f"aux segments={traces[0].num_aux_segments()}"
        )

    if getattr(hasher, "NAME", None) != "blake3_256":
        refuse("only the blake3_256 hasher is ported")
    if traces[0].num_aux_segments() > 0:
        refuse("auxiliary trace segments are not ported")
    if ext_deg != 1:
        refuse("only extension degree 1 is ported")
    if air0.field_spec().name != "f64":
        if air0.field_spec().name not in ("f128", "f62"):
            refuse("no backend for this field")
        from ..parallel.full_pipeline import prove_mesh

        return prove_mesh(prover, n, traces, dev)
    if length < device_big.MIN_TRACE_LENGTH:
        refuse(f"trace lengths below {device_big.MIN_TRACE_LENGTH} need the "
               "small-trace pipeline")
    dummy_ccs = [0] * air0.context.num_assertions()
    bt = air0.get_boundary_constraints(None, dummy_ccs)
    if not device_big.supported(air0, bt, length, ext_deg):
        refuse("outside the big-trace pipeline (tile factorization or "
               "sequence assertions)")
    return device_big.prove_big(prover, n, traces, dev)


def run_fri_phase(channel, deep_evals, options, domain, ext_deg, hasher):
    """Phase 5: FRI layer commit/fold loop + remainder.  Returns
    ([(transposed, MerkleTree)], remainder_elements)."""
    from ..crypto.merkle import MerkleTree

    device = deep_evals[0].device
    L = deep_evals[0].shape[-1]
    fri_options = options.to_fri_options()
    N = fri_options.folding_factor
    evals = deep_evals
    fri_layers = []
    for _ in range(fri_options.num_fri_layers(L)):
        transposed, flevels = fri_hash_kernel(evals, N, ext_deg, hasher)
        tree = MerkleTree(flevels, hasher)
        channel.commit_fri_layer(tree.root())
        alpha = channel.draw_fri_alpha()
        evals = fri_fold_kernel(
            transposed, scalar_to_limbs(alpha, ext_deg, device=device),
            domain.domain_offset, ext_deg,
        )
        fri_layers.append((transposed, tree))

    # the final layer (at most a few hundred elements) is interpolated on
    # the host, as the JAX package does at this step (its prover/device.py
    # run_fri_phase): the coefficients go straight into the host transcript
    evals = tuple(c.cpu() for c in evals)
    coeffs = ntt.interpolate_poly_with_offset(evals, domain.domain_offset)
    rem_size = evals[0].shape[-1] // fri_options.blowup_factor
    remainder_elements = limbs_to_elems(
        tuple(c[:rem_size] for c in coeffs), ext_deg
    )
    channel.commit_fri_layer(hasher.hash_elements(remainder_elements))
    return fri_layers, remainder_elements


def _gather_host(comps, positions, axis: int):
    """Queried slices of each component, gathered on the device and brought
    to the host in one copy per component (numpy uint64)."""
    idx = torch.as_tensor(list(positions), dtype=torch.int64, device=comps[0].device)
    return tuple(gl.to_u64(c.index_select(axis, idx)) for c in comps)


def assemble_proof(channel, positions, lde, comp_lde, main_tree, constraint_tree,
                   fri_layers, remainder_elements, options, domain, n, ext_deg):
    """Phase 8: gather ONLY the queried rows off the device and build the
    StarkProof."""
    from ..air.proof import JointTraceQueries, Queries
    from ..crypto.merkle import MerkleTree
    from ..fri.proof import FriProof, FriProofLayer
    from ..fri.prover import fold_positions

    fri_options = options.to_fri_options()
    N = fri_options.folding_factor
    L = domain.lde_size

    layer_pos = []
    pos = list(positions)
    dsize = L
    for _ in fri_layers:
        pos = fold_positions(pos, dsize, N)
        layer_pos.append(pos)
        dsize //= N
    MerkleTree.prefetch_trees(
        [(tree, lp) for (_, tree), lp in zip(fri_layers, layer_pos)]
        + [(main_tree, positions), (constraint_tree, positions)]
    )

    proof_layers = []
    for (transposed, tree), pos in zip(fri_layers, layer_pos):
        gathered = _gather_host(transposed, pos, 0)  # ext tuple of (q, N)
        mp = tree.prove_batch(pos)
        rows = [
            _row_elems(tuple(c[i] for c in gathered), ext_deg)
            for i in range(len(pos))
        ]
        proof_layers.append(FriProofLayer.new(rows, mp, ext_deg))
    fri_proof = FriProof.new(proof_layers, remainder_elements, 1)

    main_rows = _gather_host(lde, positions, 2)  # (n, w, q)
    traces_states = []
    for i in range(n):
        rows = []
        for qi in range(len(positions)):
            rows.append(_row_elems(tuple(c[i, :, qi] for c in main_rows), 1))
        traces_states.append(rows)
    comb_states = []
    for qi in range(len(positions)):
        row = []
        for ts in traces_states:
            row.extend(ts[qi])
        comb_states.append(row)
    trace_queries = [
        JointTraceQueries.new(main_tree.prove_batch(positions), comb_states, traces_states)
    ]

    comp_rows = _gather_host(comp_lde, positions, 1)  # (num_cols, q)
    crows = [
        _row_elems(tuple(c[:, qi] for c in comp_rows), ext_deg)
        for qi in range(len(positions))
    ]
    constraint_queries = Queries.new(constraint_tree.prove_batch(positions), crows, ext_deg)

    return channel.build_proof(trace_queries, constraint_queries, fri_proof)


def _row_elems(comps_u64, deg: int):
    """Tuple of ``deg`` numpy uint64 rows -> list of ints/tuples."""
    if deg == 1:
        return [int(v) for v in comps_u64[0]]
    k = comps_u64[0].shape[0]
    return [tuple(int(comps_u64[c][i]) for c in range(deg)) for i in range(k)]


def _stack_scalars(rows, ext_deg, squeeze=False, device="cpu"):
    """rows: list (n) of lists (k) of elements -> ext tuple of (n, k) tensors
    (or (n,) when squeeze and k == 1)."""
    n = len(rows)
    k = len(rows[0])
    arr = np.zeros((ext_deg, n, k), dtype=np.uint64)
    for i, row in enumerate(rows):
        for j, e in enumerate(row):
            comps = fs.components(fs.embed(e, ext_deg))
            for c in range(ext_deg):
                arr[c, i, j] = comps[c]
    if squeeze:
        arr = arr[:, :, 0]
    return tuple(gl.from_u64(arr[c], device) for c in range(ext_deg))


def _stack_boundary_values(template, per_instance, device="cpu"):
    """Stack per-instance single-value boundary constraint values: a list,
    in group/constraint order, of (n, 1) tensors.  Sequence and periodic
    assertions are outside the ported slice."""
    n = len(per_instance)
    singles = []
    for gi, g in enumerate(template.main_constraints):
        for ci, c in enumerate(g.constraints):
            if len(c.poly) != 1:
                raise NotImplementedError(
                    "sequence/periodic boundary assertions are not ported yet"
                )
            vals = np.array(
                [per_instance[i].main_constraints[gi].constraints[ci].poly[0]
                 for i in range(n)],
                dtype=np.uint64,
            ).reshape(n, 1)
            singles.append(gl.from_u64(vals, device))
    return singles


def _elem_from(comps_u64, ext_deg):
    if ext_deg == 1:
        return int(comps_u64[0])
    return tuple(int(comps_u64[c]) for c in range(ext_deg))
