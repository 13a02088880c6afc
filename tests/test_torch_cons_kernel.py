"""PyTorch port, whole-AIR constraint evaluation: the plain version of the
CUDA kernel (ops/cons_kernel.py constraint_eval_plain, i.e. eval_block on
tensors) against the JAX package's Pallas kernel in interpret mode on the
fib AIR over f128, f62 and f64, and the emitter's recorded operation list
against the AIR's own python on ints (Rescue128, and the f64 Rescue round of
the main path's chain).  Inputs from a numpy seed; tolerance zero.  The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py."""

import re

import numpy as np
import pytest
import torch

import starkpack_winterfell_tpu as J
from starkpack_winterfell_tpu.models.fib_multifield import get_fib_family as j_fib
from starkpack_winterfell_tpu.ops.backend import get_backend as j_backend
from starkpack_winterfell_tpu.ops.pallas import cons_kernel as j_cons

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.crypto import rescue128 as r128
from starkpack_winterfell_tpu_torch.models.fib_multifield import get_fib_family as t_fib
from starkpack_winterfell_tpu_torch.models.rescue128_chain import (
    Rescue128ChainAir,
    Rescue128ChainInputs,
)
from starkpack_winterfell_tpu_torch.ops import cons_kernel as t_cons
from starkpack_winterfell_tpu_torch.ops.backend import get_backend as t_backend
from starkpack_winterfell_tpu_torch.utils.convert import from_limb_planes, to_limb_planes

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

P = t_backend("f128").P
OPTIONS = (16, 8, 0, 1, 4, 3)
GROUPS = [[("main", 0, 1), ("main", 1, 1)], [("main", 1, 1)]]  # fib: first step, last step


def rand_planes(rng, shape, field="f128"):
    """Random canonical elements as the JAX package's u32 limb planes (f64:
    its (lo, hi) pair)."""
    if field == "f64":
        words = rng.integers(0, t_backend("f64").P, size=shape, dtype=np.uint64)
        return ((words & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                (words >> np.uint64(32)).astype(np.uint32))
    JF = j_backend(field).F
    lo = rng.integers(0, 1 << 64, size=int(np.prod(shape)), dtype=np.uint64)
    hi = rng.integers(0, 1 << 64, size=int(np.prod(shape)), dtype=np.uint64)
    ints = [((int(h) << 64) | int(l)) % JF.P for l, h in zip(lo, hi)]
    return tuple(l.reshape(shape) for l in JF.from_ints(ints))


@pytest.mark.parametrize("field", ["f128", "f62", "f64"])
def test_plain_version_matches_the_pallas_kernel_on_fib(field):
    import jax.numpy as jnp

    n, w, K, ce, shift, blowup = 2, 2, 2, 1024, 4, 8
    L = ce * shift
    n_ccs = 3
    NS = K + 2 * n_ccs + 1
    rng = np.random.default_rng(21)
    rows = rand_planes(rng, (n, w, L), field)
    divs = [rand_planes(rng, (ce,), field) for _ in range(1 + len(GROUPS))]
    bank = rand_planes(rng, (n, NS), field)

    # the JAX package's kernel: frames sliced as parallel/full_pipeline.py
    # :472-485 does, scalars in its LANES-padded u32 bank
    j_air = j_fib(field)[0](J.TraceInfo(w, 512), j_fib(field)[3](5), J.ProofOptions(*OPTIONS))
    JB = j_backend(field)
    call = j_cons.build_call(JB, j_air, [tuple(g) for g in GROUPS], 0, 0, n, w, K,
                             n_ccs, ce, interpret=True)
    ext = [np.concatenate([l, l[:, :, :blowup]], axis=2) for l in rows]
    cur = [(tuple(jnp.asarray(le[:, c, :-blowup:shift]) for le in ext),) for c in range(w)]
    nxt = [(tuple(jnp.asarray(le[:, c, blowup::shift]) for le in ext),) for c in range(w)]
    scal = np.zeros((n, NS, j_cons.LANES), dtype=np.uint32)
    for limb in range(len(bank)):
        scal[:, :, limb] = bank[limb]
    want = call(cur, nxt, [], [], [tuple(jnp.asarray(l) for l in d) for d in divs],
                jnp.asarray(scal))[0]

    t_air = t_fib(field)[0](T.TraceInfo(w, 512), t_fib(field)[3](5), T.ProofOptions(*OPTIONS))
    t_scal = torch.stack(from_limb_planes(bank), dim=-1).contiguous()
    args = (t_backend(field), t_air, GROUPS, K, shift, blowup,
            (from_limb_planes(rows),), [], [from_limb_planes(d) for d in divs], t_scal)
    got = t_cons.constraint_eval_plain(*args)[0]
    assert all(np.array_equal(g, np.asarray(x)) for g, x in zip(to_limb_planes(got), want))
    # a CPU tensor takes the plain version through the wrapper, and launches nothing
    t_cons.reset_launch_counts()
    again = t_cons.constraint_eval(*args)[0]
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert t_cons.LAUNCHES == 0 and not t_cons.LAUNCHES_BY_SHAPE


def test_pack_scalar_bank_orders_rows_as_the_kernel_reads_them():
    B = t_backend("f128")
    n, K = 3, 2
    t_main = (B.b_from_ints(range(1, 1 + n * K)),)
    t_main = B.emap(lambda l: l.reshape(n, K), t_main)
    singles = [(B.emap(lambda l: l.reshape(n, 1), (B.b_from_ints([10 + i, 20 + i, 30 + i]),))[0],)
               for i in range(2)]
    ccs = [(B.emap(lambda l: l.reshape(n, 1), (B.b_from_ints([(1 << 64) + i] * n),))[0],)
           for i in range(2)]
    fp = (B.b_from_ints([7, 8, 9]),)
    bank = t_cons.pack_scalar_bank(B, t_main, singles, ccs, fp, n, K)
    assert tuple(bank.shape) == (n, K + 2 + 2 + 1, 2)
    assert bank[1, :, 0].tolist() == [3, 4, 20, 21, 0, 1, 8]
    assert bank[1, :, 1].tolist() == [0, 0, 0, 0, 1, 1, 0]


def rescue_air():
    return Rescue128ChainAir(T.TraceInfo(6, 64), Rescue128ChainInputs([1, 2], [3, 4]),
                             T.ProofOptions(*OPTIONS))


@pytest.mark.parametrize("flag", [0, 1])
def test_recorded_rescue128_transition_evaluates_as_the_air_on_ints(flag):
    """The op list the CUDA emitter writes out, run on python ints, against
    enforce_round / the absorb rule on the same ints."""
    rng = np.random.default_rng(31 + flag)
    draw = lambda k: [int.from_bytes(rng.bytes(16), "little") % P for _ in range(k)]
    cur, nxt, ark = draw(6), draw(6), draw(12)
    ops, results = t_cons.record_transition(rescue_air(), 6, 13, 6)
    got = t_cons.eval_ops_int(ops, results, cur, nxt, [flag] + ark, P)

    step1 = r128._apply_mds([pow(c, r128.ALPHA, P) for c in cur], r128.MDS)
    step1 = [(s + k) % P for s, k in zip(step1, ark[:6])]
    step2 = r128._apply_mds([(x - k) % P for x, k in zip(nxt, ark[6:])], r128.INV_MDS)
    step2 = [pow(s, r128.ALPHA, P) for s in step2]
    absorb = [(nxt[0] - cur[0]) % P, (nxt[1] - cur[1]) % P] + nxt[2:]
    want = [(flag * (b - a) + (1 - flag) * ab) % P for a, b, ab in zip(step1, step2, absorb)]
    assert got == want


def test_recorded_transition_is_zero_on_a_real_round():
    state = [5, 6, 0, 0, 0, 0]
    nxt = r128.apply_round(state, 2)
    ops, results = t_cons.record_transition(rescue_air(), 6, 13, 6)
    assert t_cons.eval_ops_int(ops, results, state, nxt, [1] + r128.ARK[2], P) == [0] * 6


def test_emitted_source_is_straight_line_cuda_in_the_frame():
    air = rescue_air()
    groups = [[("main", c, 1) for c in range(6)], [("main", 0, 1), ("main", 1, 1)]]
    ops, results = t_cons.record_transition(air, 6, 13, 6)
    src = t_cons.emit_cuda("f128", "Rescue128ChainAir", ops, results, 6, 13, groups)
    counts = t_cons.count_ops(ops)
    assert counts["sqr"] == 24 and counts["mul"] >= 72 + 12  # 12 x^5, two 6x6 MDS
    # each role writes its schedule, one fe_mul a fold of t_coef[k] * ev[k]
    rules = t_cons.design(ops, results)
    scheds = [t_cons.schedule(ops, results, role) for role in rules["roles"]]
    muls = [t_cons.count_ops(s) for s in scheds]
    assert src.count("fe_mul(") == sum(m["mul"] for m in muls) + len(results)
    assert src.count("fe_sqr(") == sum(m["sqr"] for m in muls)
    assert sum(m["mul"] + m["sqr"] for m in muls) == 126 + rules["repeated_mul"]
    assert "#define CONS_NCC 8" in src and "CONS_GROUP_SIZE[CONS_NGROUPS + 1] = {6, 2, 0}" in src
    assert f"#define CONS_ROLES {len(scheds)}" in src
    head, roles = src.split('#include "cons_frame.cuh"')
    assert roles.rstrip().endswith("}  // namespace")
    assert not re.search(r"\bfor\s*\(", roles) and "cons_role0(const ConsPoint& q)" in roles
    # each use of one of the 73 field constants is a literal in the code
    uses = sum(op[0] == "const" for sched in scheds for op in sched)
    assert roles.count("F128::make(") == uses
    assert "// 73 field constants as literals" in head


def test_emitted_f62_source_uses_the_one_word_field():
    air = t_fib("f62")[0](T.TraceInfo(2, 64), t_fib("f62")[3](5), T.ProofOptions(*OPTIONS))
    ops, results = t_cons.record_transition(air, 2, 0, 2)
    src = t_cons.emit_cuda("f62", "FibAirF", ops, results, 2, 0, GROUPS)
    assert '#include "f62.cuh"' in src and "typedef F62 FE;" in src
    assert "F128" not in src and "fe_mul(cons_scalar(q.bank, 1), s" in src
    assert "#define CONS_ROLES 1" in src  # four additions: too small to split


def rescue64_air():
    from starkpack_winterfell_tpu_torch.models.rescue_chain import ChainInputs, RescueChainAir

    return RescueChainAir(T.TraceInfo(12, 64), ChainInputs([1] * 8, [2] * 4),
                          T.ProofOptions(*OPTIONS))


def rescue64_periodic(flag, r):
    """The f64 chain's periodic row: the round flag, ARK1[r], ARK2[r]."""
    from starkpack_winterfell_tpu_torch.crypto import rescue as r64

    return [flag] + list(r64.ARK1[r]) + list(r64.ARK2[r])


def test_recorded_f64_rescue_round_is_zero_on_a_real_round():
    """The main path's body (the f64 Rescue chain, 12 columns, 25 periodic)
    recorded and run on python ints modulo the Goldilocks prime: zero on a
    real round of Rp64_256 and on a copy row."""
    from starkpack_winterfell_tpu_torch.crypto import rescue as r64

    P64 = t_backend("f64").P
    ops, results = t_cons.record_transition(rescue64_air(), 12, 25, 12)
    state = list(range(3, 15))
    for r in (0, 6):
        nxt = r64.round_ints(state, r)
        assert t_cons.eval_ops_int(ops, results, state, nxt, rescue64_periodic(1, r),
                                   P64) == [0] * 12
    assert t_cons.eval_ops_int(ops, results, state, state, [0] * 25, P64) == [0] * 12


@pytest.mark.parametrize("flag", [0, 1])
def test_recorded_f64_rescue_transition_evaluates_as_the_air_on_ints(flag):
    """The f64 body's op list against the round rule on random frames:
    flag * (MDS(cur^7) + ARK1 - INV_MDS(next - ARK2)^7) + (1 - flag) *
    (next - cur), and its scheduled roles against sum t_coef[k] * ev[k]."""
    from starkpack_winterfell_tpu_torch.crypto import rescue as r64

    P64 = t_backend("f64").P
    rng = np.random.default_rng(51 + flag)
    draw = lambda k: [int(v) for v in rng.integers(0, P64, size=k, dtype=np.uint64)]
    cur, nxt, t = draw(12), draw(12), draw(12)
    air = rescue64_air()
    ops, results = t_cons.record_transition(air, 12, 25, 12)
    per = rescue64_periodic(flag, 3)
    got = t_cons.eval_ops_int(ops, results, cur, nxt, per, P64)

    def mds(rows, v):
        return [sum(int(m) * x for m, x in zip(row, v)) % P64 for row in rows]

    fwd = [(a + k) % P64 for a, k in zip(mds(r64.MDS, [pow(c, 7, P64) for c in cur]),
                                          r64.ARK1[3])]
    bwd = [pow(b, 7, P64) for b in mds(r64.INV_MDS, [(x - k) % P64
                                                      for x, k in zip(nxt, r64.ARK2[3])])]
    want = [(flag * (f - b) + (1 - flag) * (x - c)) % P64
            for f, b, x, c in zip(fwd, bwd, nxt, cur)]
    assert got == want
    roles = t_cons.design(ops, results)["roles"]
    folded = sum(t_cons.eval_schedule_int(t_cons.schedule(ops, results, role), cur, nxt,
                                          per, t, P64) for role in roles) % P64
    assert folded == sum(a * b for a, b in zip(t, want)) % P64


def test_emitted_f64_source_uses_the_goldilocks_field():
    """The main path's body emitted for f64: straight-line code in the
    frame, ``typedef GL64 FE``, each field constant one 64-bit literal."""
    air = rescue64_air()
    groups = [[("main", c, 1) for c in range(12)], [("main", c, 1) for c in range(4, 8)]]
    ops, results = t_cons.record_transition(air, 12, 25, 12)
    src = t_cons.emit_cuda("f64", "RescueChainAir", ops, results, 12, 25, groups)
    assert '#include "gl64_fe.cuh"' in src and "typedef GL64 FE;" in src
    assert "F128" not in src and "F62" not in src
    head, roles = src.split('#include "cons_frame.cuh"')
    assert not re.search(r"\bfor\s*\(", roles) and "cons_role0(const ConsPoint& q)" in roles
    rules = t_cons.design(ops, results)
    scheds = [t_cons.schedule(ops, results, role) for role in rules["roles"]]
    uses = sum(op[0] == "const" for sched in scheds for op in sched)
    literals = re.findall(r"GL64::make\(([^)]*)\)", roles)
    assert len(literals) == uses > 0
    assert all(re.fullmatch(r"0x[0-9A-F]{16}ULL", lit) for lit in literals)
    counts = t_cons.count_ops(ops)
    assert counts["mul"] + counts["sqr"] == 384 == sum(rules["mul_per_role"])
    assert src.count("fe_mul(") == sum(t_cons.count_ops(s)["mul"] for s in scheds) + 12
    assert "#define CONS_W 12" in src and "#define CONS_NPER 25" in src


def test_small_constant_rows_of_the_f64_rescue_body():
    """The sums of products by small constants that the f64 bound prices as
    rows: the Rescue round's MDS(cur^7) is 12 rows of 12 terms (120
    distinct products, as the circulant's repeated entries share some, and
    132 additions); INV_MDS's products (full-size constants) stay
    multiplies.  On a small list: a product read outside a sum is a row of
    one, and a sum read by another sum is inside that one's row, and a row
    of its own where something else reads it too."""
    ops, results = t_cons.record_transition(rescue64_air(), 12, 25, 12)
    counts, rows = t_cons.small_constant_rows(ops, results)
    full = t_cons.count_ops(ops)
    assert rows == [12] * 12
    assert full["mul"] - counts["mul"] == 120 and full["add"] - counts["add"] == 132
    assert (counts["sqr"], counts["sub"]) == (full["sqr"], full["sub"])
    big = ("const", 1 << 40)
    body = [("cur", 0), ("cur", 1), ("const", 3), ("const", 5), big,
            ("mul", 0, 2), ("mul", 1, 3), ("add", 5, 6), ("mul", 0, 4),
            ("add", 7, 8), ("mul", 5, 9), ("add", 7, 5)]
    counts, rows = t_cons.small_constant_rows(body, [10, 11])
    assert sorted(rows) == [1, 2, 3] and counts == {"mul": 2, "sqr": 0, "add": 1, "sub": 0,
                                                "neg": 0}


@pytest.mark.parametrize("group", [("aux", 0, 1), ("main", 0, 4)])
def test_kernel_refuses_aux_and_sequence_assertions(group):
    """Aux segments are still refused; a main-segment sequence (poly_len 4)
    is taken since the kernel reads sequence tables."""
    if group[0] == "aux":
        with pytest.raises(NotImplementedError):
            t_cons._check_groups([[group]])
    else:
        t_cons._check_groups([[group]])
        assert t_cons.seq_count([[group], [("main", 1, 1)]]) == 1


def test_plain_version_matches_the_kernel_body_on_lamport_agg_sequences():
    """The Lamport-agg plan (4 signatures at k = 15: 11 single values, three
    sequence assertions over 4 values each) with random sequence tables,
    periodic columns of periods 8 and 128 and n = 2 instances: the plain
    version against the Pallas kernel's body, ``eval_block`` of the JAX
    package, run on numpy arrays (as the JAX package's own tests do, the
    Lamport-agg body is not compiled in interpret mode: XLA:CPU takes many
    minutes over it).  0 mismatching words."""
    from starkpack_winterfell_tpu.air.transition import EvaluationFrame as JFrame
    from starkpack_winterfell_tpu.models import lamport128_agg as j_agg
    from starkpack_winterfell_tpu.ops.felt import Felt as JFelt
    from starkpack_winterfell_tpu_torch.models import lamport128_agg as t_agg
    from starkpack_winterfell_tpu_torch.parallel.full_pipeline import plan_groups

    msgs, pks = [9, 10, 11, 12], [[1, 2], [3, 4], [5, 6], [7, 8]]
    j_air = j_agg.Lamport128AggAir(J.TraceInfo(14, 512), j_agg.LamportAggInputs(msgs, pks),
                                   J.ProofOptions(*OPTIONS))
    t_air = t_agg.Lamport128AggAir(T.TraceInfo(14, 512), t_agg.LamportAggInputs(msgs, pks),
                                   T.ProofOptions(*OPTIONS))
    groups = plan_groups(t_air.get_boundary_constraints(None, [0] * t_air.context.num_assertions()))
    n_seq = t_cons.seq_count(groups)
    assert n_seq == 3
    n, w, K, ce, shift, blowup = 2, 14, 14, 256, 2, 8
    L = ce * shift
    n_ccs = sum(len(g) for g in groups)
    n_singles = n_ccs - n_seq
    NS = K + n_singles + n_ccs + 1
    periods = [len(c) * 2 for c in t_air.get_periodic_column_values()]
    rng = np.random.default_rng(41)
    rows = rand_planes(rng, (n, w, L))
    pers = [rand_planes(rng, (p,)) for p in periods]
    divs = [rand_planes(rng, (ce,)) for _ in range(1 + len(groups))]
    seqs = [rand_planes(rng, (n, ce)) for _ in range(n_seq)]
    bank = rand_planes(rng, (n, NS))

    # the JAX package's body on its u32 limb planes: frames sliced as
    # parallel/full_pipeline.py :472-485 does, periodic columns ce-expanded
    JB = j_backend("f128")
    ext = [np.concatenate([l, l[:, :, :blowup]], axis=2) for l in rows]
    cur = [JFelt((tuple(le[:, c, :-blowup:shift] for le in ext),), B=JB) for c in range(w)]
    nxt = [JFelt((tuple(le[:, c, blowup::shift] for le in ext),), B=JB) for c in range(w)]
    pv = [JFelt((tuple(np.tile(l, ce // l.shape[0]) for l in p),), B=JB) for p in pers]

    def scal(row):
        return (tuple(l[:, row : row + 1] for l in bank),)

    acc = j_cons.eval_block(
        JB, j_air, [tuple(g) for g in groups], K, JFrame(cur, nxt), pv,
        [scal(r) for r in range(K)], [scal(K + r) for r in range(n_singles)],
        [(t,) for t in seqs], [scal(K + n_singles + r) for r in range(n_ccs)],
        [(d,) for d in divs])
    want = JB.vsum(JB.vmul(acc, scal(NS - 1)), axis=0)[0]

    t_scal = torch.stack(from_limb_planes(bank), dim=-1).contiguous()
    got = t_cons.constraint_eval_plain(
        t_backend("f128"), t_air, groups, K, shift, blowup, (from_limb_planes(rows),),
        [from_limb_planes(p) for p in pers], [from_limb_planes(d) for d in divs], t_scal,
        [from_limb_planes(t) for t in seqs])[0]
    mismatching = sum(int((np.asarray(x) != g).sum()) for g, x in zip(to_limb_planes(got), want))
    assert mismatching == 0


def five_bodies():
    """The AIR bodies the port's proves emit (five, merkle128's since the
    limb extensions came, and two of the f64 bodies): (AIR, w, periodic
    columns, K)."""
    from starkpack_winterfell_tpu_torch.models import lamport128 as t_lam
    from starkpack_winterfell_tpu_torch.models import lamport128_agg as t_agg
    from starkpack_winterfell_tpu_torch.models import merkle128 as t_mk

    options = T.ProofOptions(*OPTIONS)
    airs = {
        "rescue128": rescue_air(),
        "fib-f128": t_fib("f128")[0](T.TraceInfo(2, 64), t_fib("f128")[3](5), options),
        "fib-f62": t_fib("f62")[0](T.TraceInfo(2, 64), t_fib("f62")[3](5), options),
        "lamport128": t_lam.Lamport128Air(T.TraceInfo(t_lam.TRACE_WIDTH, 128),
                                          t_lam.Lamport128Inputs(1, [1, 2]), options),
        "lamport128-agg": t_agg.Lamport128AggAir(
            T.TraceInfo(14, 512), t_agg.LamportAggInputs([9, 10, 11, 12], [[1, 2]] * 4),
            options),
        "merkle128": t_mk.Merkle128Air(T.TraceInfo(t_mk.TRACE_WIDTH, 64),
                                       t_mk.Merkle128Inputs([3, 4]), options),
    }
    airs["f64 rescue-chain"] = rescue64_air()
    airs["f64 merkle"] = f64_merkle_air(options)
    return {name: (air, air.trace_info().width(), len(air.get_periodic_column_values()),
                   air.context.num_transition_constraints()) for name, air in airs.items()}


def f64_merkle_air(options):
    from starkpack_winterfell_tpu_torch.models import merkle

    return merkle.MerklePathAir(T.TraceInfo(merkle.TRACE_WIDTH, 64),
                                merkle.MerklePathInputs([1, 2, 3, 4]), options)


@pytest.mark.parametrize("roles", ["rules", "one", "two", "rules, inputs held"])
@pytest.mark.parametrize("body", ["rescue128", "fib-f128", "fib-f62", "lamport128",
                                  "lamport128-agg", "merkle128", "f64 rescue-chain",
                                  "f64 merkle"])
def test_scheduled_roles_evaluate_as_the_recorded_body(body, roles, monkeypatch):
    """The roles, each in its schedule, evaluated on python ints and summed:
    equal to sum t_coef[k] * ev[k] of ``eval_ops_int`` on the recorded list,
    for random frames.  ``roles``: the emitter's rules, one role, the best
    two-way split (whether or not the rules take it), or the rules with
    inputs held from their first use (only constants written again)."""
    air, w, n_per, K = five_bodies()[body]
    P = air.field_spec().P
    ops, results = t_cons.record_transition(air, w, n_per, K)
    if roles.endswith("inputs held"):
        monkeypatch.setattr(t_cons, "RELOADED", ("const",))
        roles = "rules"
    split = {"rules": t_cons.design(ops, results)["roles"], "one": [list(range(K))],
             "two": list(t_cons.split_roles(ops, results)[:2])}[roles]
    assert sorted(k for role in split for k in role) == list(range(K))
    scheds = [t_cons.schedule(ops, results, role) for role in split]
    if t_cons.RELOADED == ("const",):  # each input read once a role
        for sched in scheds:
            reads = [op for op in sched if op[0] in ("cur", "nxt", "per")]
            assert len(reads) == len(set(reads))
    rng = np.random.default_rng(K * 10 + w + len(split))
    for _ in range(3):
        cur, nxt, per, t = ([int.from_bytes(rng.bytes(16), "little") % P for _ in range(m)]
                            for m in (w, w, n_per, K))
        want = sum(a * b for a, b in zip(t, t_cons.eval_ops_int(ops, results, cur, nxt,
                                                                per, P))) % P
        got = sum(t_cons.eval_schedule_int(s, cur, nxt, per, t, P) for s in scheds) % P
        assert got == want


def test_lamport_agg_roles_repeat_no_multiply():
    """The two roles of the Lamport-agg body are sponge A with the bit and
    message constraints, and sponge B: they share no multiply, and each
    role's schedule holds exactly its cone's multiplies."""
    air, w, n_per, K = five_bodies()["lamport128-agg"]
    ops, results = t_cons.record_transition(air, w, n_per, K)
    rules = t_cons.design(ops, results)
    assert rules["roles"] == [[0, 1, 2, 3, 4, 5, 12, 13], [6, 7, 8, 9, 10, 11]]
    assert rules["repeated_mul"] == 0 and rules["mul_per_role"] == [131, 154]
    counts = t_cons.count_ops(ops)
    assert sum(rules["mul_per_role"]) == counts["mul"] + counts["sqr"]
    for role, muls in zip(rules["roles"], rules["mul_per_role"]):
        c = t_cons.count_ops(t_cons.schedule(ops, results, role))
        assert c["mul"] + c["sqr"] == muls
    # the Rescue128 round splits too, repeating the cubes of the current row
    r_ops, r_results = t_cons.record_transition(rescue_air(), 6, 13, 6)
    assert t_cons.split_roles(r_ops, r_results)[2:] == ((72, 72), 18)


def test_schedule_shortens_what_is_live():
    """Depth-first by cone, inputs read at every use: the values a role
    holds at once, against the recorded order (the first design's)."""
    air, w, n_per, K = five_bodies()["lamport128-agg"]
    ops, results = t_cons.record_transition(air, w, n_per, K)
    recorded = t_cons.peak_live(list(ops) + [("fold", k, r) for k, r in enumerate(results)])
    roles = t_cons.design(ops, results)["roles"]
    live = [t_cons.peak_live(t_cons.schedule(ops, results, role)) for role in roles]
    assert recorded > 100 and max(live) <= 24
