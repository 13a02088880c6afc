"""PyTorch port, extensions over the limb fields: the extension products of
ops/backend.py (quadratic over f128 and f62, cubic over f62) against the JAX
package's ``LimbBackend`` on numpy arrays, and the eager constraint phase of
parallel/full_pipeline.py against the JAX ``sharded_constraint_phase`` on a
one-device CPU mesh and against the constraint kernel's plain version.

Same inputs on both sides (numpy, fixed seed, carried across as python ints,
plus the elements 0, 1 and p - 1 in every component); the arithmetic is
exact, so the tolerance is zero."""

import logging

import numpy as np
import pytest
import torch

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.models.fib_multifield import get_fib_family as j_fib
from starkpack_winterfell_tpu.ops.backend import get_backend as j_backend
from starkpack_winterfell_tpu.parallel import full_pipeline as j_fp
from starkpack_winterfell_tpu.prover.domain import StarkDomain as JDomain

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.models import lamport128_agg as t_agg
from starkpack_winterfell_tpu_torch.models import merkle128 as t_mk
from starkpack_winterfell_tpu_torch.models import rescue128_chain as t_rc
from starkpack_winterfell_tpu_torch.models.fib_multifield import get_fib_family as t_fib
from starkpack_winterfell_tpu_torch.ops import backend as t_backend_mod
from starkpack_winterfell_tpu_torch.ops import cons_kernel as t_cons
from starkpack_winterfell_tpu_torch.ops.backend import get_backend as t_backend
from starkpack_winterfell_tpu_torch.parallel import full_pipeline as t_fp
from starkpack_winterfell_tpu_torch.prover.domain import StarkDomain as TDomain

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

CASES = [("f128", 2), ("f62", 2), ("f62", 3)]
IDS = [f"{f}-deg{d}" for f, d in CASES]


def _ints(field, count, rng):
    P = t_backend(field).P
    lo = rng.integers(0, 1 << 64, size=count, dtype=np.uint64)
    hi = rng.integers(0, 1 << 64, size=count, dtype=np.uint64)
    return [((int(h) << 64) | int(l)) % P for l, h in zip(lo, hi)]


def _elements(field, deg, seed, size=200):
    """``size`` random extension elements, after every combination of the
    edge values 0, 1 and p - 1 in each component, as tuples of ints."""
    P = t_backend(field).P
    edges = [0, 1, P - 1]
    grid = [tuple(int(v) for v in c)
            for c in np.array(np.meshgrid(*([edges] * deg), indexing="ij"),
                              dtype=object).reshape(deg, -1).T]
    rnd = _ints(field, size * deg, np.random.default_rng(seed))
    return grid + [tuple(rnd[i * deg:(i + 1) * deg]) for i in range(size)]


def _both(field, deg, elems):
    """The same elements in the JAX package (u32 limb planes) and the port
    (int64 word planes)."""
    return (j_backend(field).elems_to_limbs(elems, deg),
            t_backend(field).elems_to_limbs(elems, deg, "cpu"))


def _same(field, deg, j_comps, t_comps):
    want = j_backend(field).limbs_to_elems(tuple(tuple(np.asarray(l) for l in c)
                                                 for c in j_comps), deg)
    return t_backend(field).limbs_to_elems(t_comps, deg) == want


@pytest.mark.parametrize("field,deg", CASES, ids=IDS)
def test_products_and_inverse_match_the_jax_backend(field, deg):
    """``vmul`` (extension x extension and extension x base), ``vsquare`` and
    ``vinv`` equal the JAX backend's.  The quadratic inverse of zero is zero;
    the cubic one, a host round trip in both packages, refuses zero in
    both."""
    JB, TB = j_backend(field), t_backend(field)
    a = _elements(field, deg, 1)
    b = _elements(field, deg, 2)[::-1]
    ja, ta = _both(field, deg, a)
    jb, tb = _both(field, deg, b)
    base = [e[0] for e in b]
    jc, tc = (JB.elems_to_limbs(base, 1), TB.elems_to_limbs(base, 1, "cpu"))
    assert _same(field, deg, JB.vmul(ja, jb), TB.vmul(ta, tb))
    assert _same(field, deg, JB.vmul(ja, jc), TB.vmul(ta, tc))
    assert _same(field, deg, JB.vsquare(ja), TB.vsquare(ta))
    if deg == 3:
        zero = ((0, 0, 0),)
        for B, args in ((JB, ()), (TB, ("cpu",))):
            with pytest.raises(AssertionError, match="not invertible"):
                B.vinv(B.elems_to_limbs(zero, 3, *args))
        a = [e for e in a if any(e)]
        ja, ta = _both(field, deg, a)
    inv = TB.vinv(ta)
    assert _same(field, deg, JB.vinv(ja), inv)
    one = TB.limbs_to_elems(TB.vmul(ta, inv), deg)
    assert all(o == (tuple([1] + [0] * (deg - 1)) if any(e) else (0,) * deg)
               for o, e in zip(one, a))


@pytest.mark.parametrize("field,deg", CASES, ids=IDS)
def test_power_series_and_division_by_a_binomial_match_the_jax_backend(field, deg):
    """``power_series_elem`` of an extension point, ``syn_div_binomial`` of
    (k, n) coefficient rows that vanish at an extension z (the DEEP
    quotients), and ``horner`` at extension points."""
    JB, TB = j_backend(field), t_backend(field)
    x = _elements(field, deg, 3, size=1)[-1:]
    jx, tx = _both(field, deg, x)
    assert _same(field, deg, JB.power_series_elem(jx, 37), TB.power_series_elem(tx, 37))

    k, n = 3, 64
    coeffs = _elements(field, deg, 4, size=k * n)[-k * n:]
    jp, tp = _both(field, deg, coeffs)
    jp = JB.emap(lambda l: np.asarray(l).reshape(k, n), jp)
    tp = TB.emap(lambda l: l.reshape(k, n), tp)
    # p - p(z): coefficient 0 moved so that every row vanishes at z
    pz = TB.horner(tp, TB.vbroadcast(tx, (k,)))
    assert _same(field, deg, JB.horner(jp, JB.vbroadcast(jx, (k,))), pz)
    first = TB.vsub(TB.emap(lambda l: l[:, 0], tp), pz)
    tp = tuple(tuple(torch.cat([f[:, None], l[:, 1:]], dim=1) for f, l in zip(fc, c))
               for fc, c in zip(first, tp))
    jp = tuple(tuple(l.reshape(k, n) for l in c) for c in JB.elems_to_limbs(
        TB.limbs_to_elems(TB.emap(lambda l: l.reshape(-1), tp), deg), deg))
    assert _same(field, deg, JB.syn_div_binomial(jp, jx), TB.syn_div_binomial(tp, tx))


def test_f128_has_no_cubic_extension_in_either_package():
    """f128 at degree 3: the products refuse it in both backends, and
    ``prove`` refuses it with the reference's assertion before any phase."""
    elems = [(1, 2, 3)] * 4
    for B, args in ((j_backend("f128"), ()), (t_backend("f128"), ("cpu",))):
        a = B.elems_to_limbs(elems, 3, *args)
        with pytest.raises(AssertionError, match="no cubic extension"):
            B.vmul(a, a)
    prover = t_rc.Rescue128ChainProver(T.ProofOptions(8, 8, 0, 3, 4, 31), T.Blake3_256)
    logger = logging.getLogger("starkpack_winterfell_tpu_torch.prover.device")
    records = []
    handler = logging.Handler(logging.DEBUG)
    handler.emit = records.append
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.DEBUG)
    try:
        with pytest.raises(AssertionError, match="f128 does not support degree 3"):
            prover.prove(1, [t_rc.build_rescue128_chain_trace([1, 2], 8)], device="cpu")
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    assert records == []


def test_large_cubic_inverse_off_the_cpu_raises():
    """A cubic inverse goes through the host: off the CPU (here a tensor on
    the meta device, whose data cannot be read) more than HOST_INV_MAX
    elements raise before any value is read; on the CPU any count runs."""
    B = t_backend("f62")
    big = t_backend_mod.HOST_INV_MAX + 1
    meta = tuple((torch.empty(big, dtype=torch.int64, device="meta"),) for _ in range(3))
    with pytest.raises(NotImplementedError, match="on the host"):
        B.vinv(meta)
    cpu = B.elems_to_limbs([(5, 6, 7)] * big, 3, "cpu")
    assert len(B.vinv(cpu)[0][0]) == big


# ---------------------------------------------------------------------------
# the eager constraint phase
# ---------------------------------------------------------------------------


def _stack(B, ints, shape, deg, pkg):
    """Elements ``ints`` (deg-tuples for deg > 1) as comps of ``shape``."""
    if pkg == "jax":
        return tuple(tuple(np.asarray(l).reshape(shape) for l in c)
                     for c in B.elems_to_limbs(ints, deg))
    return B.emap(lambda l: l.reshape(shape), B.elems_to_limbs(ints, deg, "cpu"))


def _ext_ints(field, deg, count, rng):
    flat = _ints(field, count * deg, rng)
    return flat if deg == 1 else [tuple(flat[i * deg:(i + 1) * deg]) for i in range(count)]


def test_eager_phase_matches_the_jax_sharded_constraint_phase():
    """fib-f62, 2 instances of 64 rows, quadratic: ``eager_constraint_phase``
    against JAX ``sharded_constraint_phase`` on a one-device CPU mesh, on
    random LDE rows, coefficients, boundary values and final powers.  (f62:
    XLA:CPU compiles this body in ~40 s over f62 and ~300 s over f128; the
    f128 phase is held by the byte-identical quadratic proofs of
    tests/test_torch_prove_limb_ext.py.)"""
    from starkpack_winterfell_tpu.parallel.mesh import make_mesh

    field, n, w, length, deg = "f62", 2, 2, 64, 2
    jfam, tfam = j_fib(field), t_fib(field)
    opts = (8, 8, 0, deg, 4, 31)
    jair = jfam[0](J.TraceInfo(w, length), jfam[3](5), J.ProofOptions(*opts))
    tair = tfam[0](T.TraceInfo(w, length), tfam[3](5), T.ProofOptions(*opts))
    JB, TB = j_backend(field), t_backend(field)
    jdom, tdom = JDomain(jair, JB), TDomain(tair)
    jtemplate = jair.get_boundary_constraints(None, [0] * jair.context.num_assertions())
    ttemplate = tair.get_boundary_constraints(None, [0] * tair.context.num_assertions())
    jplan = j_fp._build_plan(jair, jtemplate, jdom, deg, JB)
    jplan["w_main"] = w
    tplan = t_fp._build_plan(tair, ttemplate, tdom, TB, "cpu")
    assert tplan["groups"] == jplan["groups"]
    K, L = tplan["K"], tdom.lde_size
    n_single = sum(len(g) for g in tplan["groups"])

    rng = np.random.default_rng(11)
    rows = _ext_ints(field, 1, n * w * L, rng)
    t_main = _ext_ints(field, deg, n * K, rng)
    singles = [_ext_ints(field, 1, n, rng) for _ in range(n_single)]
    ccs = [_ext_ints(field, deg, n, rng) for _ in range(n_single)]
    fp = _ext_ints(field, deg, n, rng)

    def args(B, pkg):
        return (_stack(B, rows, (n, w, L), 1, pkg), _stack(B, t_main, (n, K), deg, pkg),
                [_stack(B, s, (n, 1), 1, pkg) for s in singles],
                [_stack(B, c, (n, 1), deg, pkg) for c in ccs], _stack(B, fp, (n,), deg, pkg))

    j_rows, j_t, j_singles, j_ccs, j_fp_stack = args(JB, "jax")
    call = j_fp.sharded_constraint_phase(make_mesh(1), JB, jair, jdom, deg, n, jplan)
    want = call(j_rows, (), j_t, (), j_singles, [], j_ccs, [], j_fp_stack,
                jplan["div_tables"], jplan["periodic_tabs"])
    t_rows, t_t, t_singles, t_ccs, t_fp_stack = args(TB, "torch")
    got = t_fp.eager_constraint_phase(TB, tair, tdom, tplan, t_rows, t_t, t_singles, [],
                                      t_ccs, t_fp_stack)
    assert len(got) == deg and got[0][0].shape == (tdom.ce_size,)
    assert _same(field, deg, want, got)


def _deg1_air(case):
    options = T.ProofOptions(16, 8, 0, 1, 4, 31)
    if case == "rescue128":
        return t_rc.Rescue128ChainAir(T.TraceInfo(6, 64),
                                      t_rc.Rescue128ChainInputs([1, 2], [3, 4]), options)
    if case == "merkle128":
        return t_mk.Merkle128Air(T.TraceInfo(t_mk.TRACE_WIDTH, 64),
                                 t_mk.Merkle128Inputs([3, 4]), options)
    return t_agg.Lamport128AggAir(T.TraceInfo(14, 512), t_agg.LamportAggInputs(
        [9, 10, 11, 12], [[1, 2], [3, 4], [5, 6], [7, 8]]), options)


@pytest.mark.parametrize("case", ["rescue128", "merkle128", "lamport128-agg"])
def test_eager_phase_in_chunks_matches_the_plain_kernel_at_degree_one(case, monkeypatch):
    """At degree 1 the eager phase computes what the constraint kernel
    does: against ``constraint_eval_plain`` on random inputs, n = 2, with
    ``EAGER_POINTS`` lowered so that the ce domain runs in 8 chunks (the
    next-row slice crosses each chunk's end; Lamport-agg brings three
    sequence tables)."""
    air = _deg1_air(case)
    B = t_backend("f128")
    dom = TDomain(air)
    template = air.get_boundary_constraints(None, [0] * air.context.num_assertions())
    plan = t_fp._build_plan(air, template, dom, B, "cpu")
    n, w, K, ce, L = 2, air.trace_info().width(), plan["K"], dom.ce_size, dom.lde_size
    groups = plan["groups"]
    n_ccs = sum(len(g) for g in groups)
    n_seq = t_cons.seq_count(groups)
    rng = np.random.default_rng(5 + n_seq)

    def rand(shape):
        return _stack(B, _ints("f128", int(np.prod(shape)), rng), shape, 1, "torch")

    rows = rand((n, w, L))
    t_main = rand((n, K))
    singles = [rand((n, 1)) for _ in range(n_ccs - n_seq)]
    ccs = [rand((n, 1)) for _ in range(n_ccs)]
    fp = rand((n,))
    seqs = [rand((n, ce))[0] for _ in range(n_seq)]
    scal = t_cons.pack_scalar_bank(B, t_main, singles, ccs, fp, n, K)
    want = t_cons.constraint_eval_plain(
        B, air, groups, K, dom.ce_to_lde_blowup, dom.trace_to_lde_blowup, rows,
        plan["periodic_tabs"], plan["div_tables"], scal, seqs)
    monkeypatch.setattr(t_fp, "EAGER_POINTS", n * ce // 8)
    got = t_fp.eager_constraint_phase(B, air, dom, plan, rows, t_main, singles,
                                      [(s,) for s in seqs], ccs, fp)
    assert all(torch.equal(g, x) for g, x in zip(got[0], want[0]))
