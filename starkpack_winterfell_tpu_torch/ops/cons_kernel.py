"""Whole-AIR constraint evaluation in one hand-written CUDA kernel.

Counterpart of starkpack_winterfell_tpu/ops/pallas/cons_kernel.py.  Per
point j of the constraint-evaluation (ce) domain and per instance i the
function computes the AIR's ``evaluate_transition`` on the frame (LDE row
j*shift, LDE row j*shift + blowup), sum_k t_coef[i][k] * ev_k, the boundary
groups sum cc * (state - value), each times its divisor table, the whole
times final_power[i], summed over the instances.  A single-value assertion's
value is a per-instance scalar; a sequence assertion's is its per-instance
``(n, ce)`` table (the interpolated value polynomial over the ce domain).

The Pallas kernel gets its body by running the AIR's python
``evaluate_transition`` inside ``pallas_call``.  Here the same python runs
ONCE on a recording Felt (``record_transition``): every add, subtract,
multiply, square, negation and integer constant becomes one SSA operation.
``emit_cuda`` applies the rules of ``design`` to that list and writes it as
straight-line CUDA C++ into a translation unit whose frame
(``csrc/cons_frame.cuh``, written by hand) walks the instances and does
everything around the transition.  The source goes to the build directory
and is compiled with nvcc at first use, keyed by (AIR class, field, plan
groups: which assertions are sequences shows in the source).

``constraint_eval`` is the wrapper: CPU tensors take the plain version
``constraint_eval_plain`` (the same python AIR code, eager, through
``eval_block``), CUDA tensors launch the kernel or raise.

Bound on an H100: operations, a few hundred f128 multiplies per point and
instance against the card's INT32 rate, far above the bytes of the LDE rows
read once.  What binds below that is the register file: with the body
written in the order the python recorded it, one thread a point and every
input loaded up front, ptxas took 255 registers and spilled on the Lamport+
body, and an SM held two blocks.  So the emitter applies rules to the
recorded list (``design``):

* roles: the results are split into two cones that share few multiplies
  (``split_roles``) where the body is large and the split repeats little;
  each role is its own function, run by whole warps of a block on the same
  points, and the partials meet in shared memory;
* schedule: each role's operations depth-first over each result's cone, so
  each is written just before its first use; inputs and constants are
  written again at every use (``RELOADED``), and each result is folded into
  sum t_coef[k] * ev[k] as soon as it exists (``schedule``;
  ``eval_schedule_int`` checks it on ints);
* constants as literals, which IMAD takes as immediates;
* a register ceiling: ``__launch_bounds__(128, MIN_BLOCKS)``.

The frame's loads keep their address arithmetic inside the load's asm, so
the compiler holds no column address across the body.  The arithmetic of
each operation is the recorded one, so the work per point is the recorded
list's, plus the frame's multiplies once per role.
"""

from __future__ import annotations

import ctypes
import hashlib
import os

import torch

from ..air.transition import EvaluationFrame
from ..native import launch
from .felt import Felt

# launches of the CUDA kernel made by ``constraint_eval`` (and nowhere
# else): the total, and the same split by (field, AIR class name, n, w, ce,
# sequence tables)
LAUNCHES = 0
LAUNCHES_BY_SHAPE: dict = {}

_LIBS: dict = {}


def reset_launch_counts():
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_SHAPE.clear()


# ---------------------------------------------------------------------------
# the per-tile constraint math (plain version's body)
# ---------------------------------------------------------------------------


def eval_block(B, air0, plan_groups, K, frame, pv, t_coefs, singles, seqs,
               ccs, div_vals, aux=None):
    """The constraint math on same-shaped (or broadcastable) element arrays:
    returns acc comps (tuple over ext components of word-plane tuples).
    ``aux``: (aux frame, random elements, aux t_coefs) of an AIR with
    auxiliary segments, whose aux transition joins the combination and
    whose aux groups read the aux frame (JAX ``sharded_constraint_phase``
    :365-386); the kernel itself takes main-segment AIRs only."""
    t_result = [None] * K
    air0.evaluate_transition(frame, pv, t_result)
    terms = list(zip(t_coefs, t_result))
    aux_cur = None
    if aux is not None:
        aux_frame, rand, t_aux_coefs = aux
        a_result = [None] * len(t_aux_coefs)
        air0.evaluate_aux_transition(frame, aux_frame, pv, rand, a_result)
        terms += zip(t_aux_coefs, a_result)
        aux_cur = aux_frame.current()
    combined = None
    for coef, ev in terms:
        term = B.vmul(coef, ev.c)
        combined = term if combined is None else B.vadd(combined, term)

    columns = [combined]
    sv = sq = ci = 0
    cur_f = frame.current()
    for group in plan_groups:
        acc = None
        for seg, column, poly_len in group:
            state = (cur_f if seg == "main" else aux_cur)[column].c
            if poly_len == 1:
                value = singles[sv]
                sv += 1
            else:
                value = seqs[sq]
                sq += 1
            diff = B.vsub(state, value)
            term = B.vmul(ccs[ci], diff)
            acc = term if acc is None else B.vadd(acc, term)
            ci += 1
        columns.append(acc)

    out = None
    for col, zt in zip(columns, div_vals):
        term = B.vmul(col, zt)
        out = term if out is None else B.vadd(out, term)
    return out


def pack_scalar_bank(B, t_main, singles, ccs, fp_stack, n, K):
    """(n, NS, words) int64 bank of per-instance scalars in kernel row
    order: t_coefs (K), the single-value assertions' values, the ccs of all
    assertions (sequences' included), final_power (all ext degree 1)."""
    rows = [tuple(l[:, k_i] for l in t_main[0]) for k_i in range(K)]
    rows += [tuple(l[:, 0] for l in s[0]) for s in singles]
    rows += [tuple(l[:, 0] for l in c[0]) for c in ccs]
    rows.append(tuple(fp_stack[0]))
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=1).contiguous()


def _check_groups(plan_groups):
    for group in plan_groups:
        for seg, _, poly_len in group:
            if seg != "main":
                raise NotImplementedError(
                    "the constraint kernel takes main-segment assertions only, "
                    f"got ({seg}, poly_len={poly_len})"
                )


def seq_count(plan_groups) -> int:
    """Sequence assertions of a plan (the (n, ce) tables the kernel reads)."""
    return sum(pl > 1 for g in plan_groups for (_, _, pl) in g)


def constraint_eval_plain(B, air0, plan_groups, K, shift: int, blowup: int,
                          main_rows, periodic_tabs, div_tabs, scal, seq_tabs=()):
    """Plain PyTorch version of the kernel.

    main_rows: comps (n, w, L) LDE rows; periodic_tabs: list of components
    (period_p,) over one period of the ce domain; div_tabs: list of
    components (ce,), the transition divisor first; scal: the
    ``pack_scalar_bank`` tensor; seq_tabs: one component (n, ce) per
    sequence assertion, in walk order.  Returns comps (ce,)."""
    _check_groups(plan_groups)
    n, w, L = main_rows[0][0].shape
    ce = L // shift
    n_ccs = sum(len(g) for g in plan_groups)
    n_singles = n_ccs - seq_count(plan_groups)

    def column(sl, c):
        return Felt((tuple(sl(l[:, c]) for l in main_rows[0]),), B=B)

    def nxt_slice(l):
        return torch.cat([l, l[:, :blowup]], dim=1)[:, blowup::shift]

    cur_f = [column(lambda l: l[:, ::shift], c) for c in range(w)]
    nxt_f = [column(nxt_slice, c) for c in range(w)]
    pv = [Felt((tuple(l.repeat(ce // l.shape[0]) for l in tab),), B=B)
          for tab in periodic_tabs]

    def scal_comps(row):
        return (tuple(scal[:, row, l : l + 1] for l in range(scal.shape[2])),)

    t_coefs = [scal_comps(r) for r in range(K)]
    singles = [scal_comps(K + r) for r in range(n_singles)]
    ccs = [scal_comps(K + n_singles + r) for r in range(n_ccs)]
    fp = scal_comps(K + n_singles + n_ccs)
    acc = eval_block(B, air0, plan_groups, K, EvaluationFrame(cur_f, nxt_f), pv,
                     t_coefs, singles, [(t,) for t in seq_tabs], ccs,
                     [(d,) for d in div_tabs])
    return B.vsum(B.vmul(acc, fp), axis=0)


# ---------------------------------------------------------------------------
# recording the AIR's transition, emitting CUDA
# ---------------------------------------------------------------------------


class _Recorder:
    """SSA list of the field operations an AIR's transition performs.
    Operations: ("cur"|"nxt"|"per", index), ("const", value),
    ("add"|"sub"|"mul", a, b), ("sqr"|"neg", a); operands are positions in
    the list.  Equal operations are recorded once."""

    def __init__(self, modulus: int):
        self.P = modulus
        self.ops = []
        self._seen = {}

    def node(self, *op):
        if op not in self._seen:
            self._seen[op] = len(self.ops)
            self.ops.append(op)
        return _SymFelt(self, self._seen[op])


class _SymFelt:
    """The recording Felt: arithmetic appends to the recorder's list."""

    __slots__ = ("rec", "id")

    def __init__(self, rec, node_id):
        self.rec = rec
        self.id = node_id

    def _coerce(self, other):
        if isinstance(other, int):
            return self.rec.node("const", other % self.rec.P)
        if isinstance(other, _SymFelt):
            return other
        return None

    def _binary(self, op, other, swap=False):
        o = self._coerce(other)
        if o is None:
            return NotImplemented
        a, b = (o.id, self.id) if swap else (self.id, o.id)
        if op != "sub" and a > b:
            a, b = b, a  # commutative: one record for both orders
        return self.rec.node(op, a, b)

    def __add__(self, other):
        return self._binary("add", other)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary("sub", other)

    def __rsub__(self, other):
        return self._binary("sub", other, swap=True)

    def __mul__(self, other):
        o = self._coerce(other)
        if o is not None and o.id == self.id:
            return self.square()
        return self._binary("mul", other)

    __rmul__ = __mul__

    def __neg__(self):
        return self.rec.node("neg", self.id)

    def square(self):
        return self.rec.node("sqr", self.id)

    def double(self):
        return self + self

    def __pow__(self, e: int):
        e = int(e)
        if e == 0:
            return self.rec.node("const", 1)
        result = None
        base = self
        while e:
            if e & 1:
                result = base if result is None else result * base
            e >>= 1
            if e:
                base = base.square()
        return result


def record_transition(air0, w: int, n_periodic: int, K: int):
    """Run ``air0.evaluate_transition`` once on recording Felts.  Returns
    (ops, results): the SSA operation list and the K positions holding the
    constraint evaluations."""
    rec = _Recorder(air0.field_spec().P)
    cur = [rec.node("cur", c) for c in range(w)]
    nxt = [rec.node("nxt", c) for c in range(w)]
    per = [rec.node("per", p) for p in range(n_periodic)]
    result = [None] * K
    air0.evaluate_transition(EvaluationFrame(cur, nxt), per, result)
    results = []
    for r in result:
        if isinstance(r, int):
            r = rec.node("const", r % rec.P)
        results.append(r.id)
    return rec.ops, results


def _operands(op):
    """Positions in the list that an operation reads."""
    if op[0] in ("add", "sub", "mul"):
        return op[1:3]
    if op[0] in ("sqr", "neg"):
        return op[1:2]
    return ()


def _value(op, vals, cur, nxt, per, modulus: int):
    """One operation on python ints; ``vals`` holds the earlier values."""
    kind = op[0]
    if kind == "cur":
        v = cur[op[1]]
    elif kind == "nxt":
        v = nxt[op[1]]
    elif kind == "per":
        v = per[op[1]]
    elif kind == "const":
        v = op[1]
    elif kind == "add":
        v = vals[op[1]] + vals[op[2]]
    elif kind == "sub":
        v = vals[op[1]] - vals[op[2]]
    elif kind == "mul":
        v = vals[op[1]] * vals[op[2]]
    elif kind == "sqr":
        v = vals[op[1]] * vals[op[1]]
    elif kind == "neg":
        v = -vals[op[1]]
    else:
        raise ValueError(f"unknown operation {op!r}")
    return v % modulus


def eval_ops_int(ops, results, cur, nxt, per, modulus: int):
    """Evaluate a recorded operation list on python ints."""
    vals = []
    for op in ops:
        vals.append(_value(op, vals, cur, nxt, per, modulus))
    return [vals[r] for r in results]


def count_ops(ops):
    """{"mul": .., "sqr": .., "add": .., "sub": .., "neg": ..} of a list."""
    counts = {k: 0 for k in ("mul", "sqr", "add", "sub", "neg")}
    for op in ops:
        if op[0] in counts:
            counts[op[0]] += 1
    return counts


# ---------------------------------------------------------------------------
# the emitter's rules: roles, schedule, constants, register ceiling
# ---------------------------------------------------------------------------

# a body is split across two roles when it has at least this many multiplies
# (mul + sqr; below that registers do not bound it) ...
SPLIT_MIN_MULS = 64
# ... and its best two-way split repeats at most this share of them (the
# Rescue128 round repeats 18 of 126, the cubes of the current row that both
# halves need, and runs faster as one role on an H100)
SPLIT_MAX_REPEAT = 0.1
# the exhaustive split looks at 2^(K-1) partitions; above this many results a
# body is not split
SPLIT_MAX_RESULTS = 20
# blocks of CONS_THREADS an SM must hold: ptxas's register ceiling is
# 65536 / (128 * CONS_MIN_BLOCKS), 168 registers a thread for 3
MIN_BLOCKS = 3
# the kinds of operation the schedule writes again at every use instead of
# holding in a register from the first (an input is read again from L1; on
# an H100 as fast as holding it, and the Rescue128 body does not spill)
RELOADED = ("const", "cur", "nxt", "per")


def cone_masks(ops):
    """Bit set (a python int) of each operation's cone: the operation and
    everything it reads, directly or through others."""
    masks = []
    for i, op in enumerate(ops):
        m = 1 << i
        for a in _operands(op):
            m |= masks[a]
        masks.append(m)
    return masks


def _mul_mask(ops):
    return sum(1 << i for i, op in enumerate(ops) if op[0] in ("mul", "sqr"))


def split_roles(ops, results):
    """The two-way split of the results whose heavier role has the fewest
    multiplies (mul + sqr of the union of its results' cones), the fewest
    repeated between the two on a tie: (role 0, role 1, multiplies of each,
    repeated multiplies); role 0 is the lighter, since it also takes the
    boundary groups.  None for fewer than two results or more than
    SPLIT_MAX_RESULTS."""
    K = len(results)
    if K < 2 or K > SPLIT_MAX_RESULTS:
        return None
    cones = cone_masks(ops)
    muls = _mul_mask(ops)
    result_cones = [cones[r] for r in results]
    unions = [0] * (1 << K)
    for s in range(1, 1 << K):
        low = s & -s
        unions[s] = unions[s ^ low] | result_cones[low.bit_length() - 1]
    full = (1 << K) - 1
    total = (unions[full] & muls).bit_count()
    best = None
    for s in range(1, 1 << K, 2):  # result 0 on side s: each split once
        if s == full:
            continue
        a = (unions[s] & muls).bit_count()
        b = (unions[full ^ s] & muls).bit_count()
        score = (max(a, b), a + b)
        if best is None or score < best[0]:
            best = (score, s, a, b)
    _, s, a, b = best
    sides = [[k for k in range(K) if s >> k & 1], [k for k in range(K) if not s >> k & 1]]
    if a > b:
        sides, (a, b) = sides[::-1], (b, a)
    return sides[0], sides[1], (a, b), a + b - total


def design(ops, results):
    """The rules the emitter applies to a recorded body: {"roles": result
    indices of each role, "mul_per_role", "repeated_mul", "min_blocks"}."""
    K = len(results)
    cones, union = cone_masks(ops), 0
    for r in results:
        union |= cones[r]
    total = (union & _mul_mask(ops)).bit_count()
    out = {"roles": [list(range(K))], "mul_per_role": [total], "repeated_mul": 0,
           "min_blocks": MIN_BLOCKS}
    split = split_roles(ops, results) if total >= SPLIT_MIN_MULS else None
    if split is not None:
        role0, role1, (a, b), repeated = split
        if repeated <= SPLIT_MAX_REPEAT * total:
            out.update(roles=[role0, role1], mul_per_role=[a, b], repeated_mul=repeated)
    return out


def _register_need(ops):
    """Sethi-Ullman numbers of the operations (as if the list were a tree):
    the registers an operation's evaluation needs when the operand that
    needs more goes first."""
    need = []
    for op in ops:
        args = _operands(op)
        if not args:
            need.append(1)
        elif len(args) == 1 or args[0] == args[1]:
            need.append(need[args[0]])
        else:
            x, y = need[args[0]], need[args[1]]
            need.append(max(x, y) if x != y else x + 1)
    return need


def schedule(ops, results, role):
    """The operations of one role in the order the emitter writes them:
    depth-first over the cone of each of the role's results in turn, so each
    operation comes just before its first use, the operand that needs more
    registers first; right after result k exists, ("fold", k, position)
    adds t_coef[k] * value to the role's sum.  The kinds in ``RELOADED``
    are written again at every use, so none is held in registers between
    its uses.  Operands are positions in the returned list."""
    need = _register_need(ops)
    local, out = {}, []

    def fresh(i):  # written again at every use
        return ops[i][0] in RELOADED

    def ref(a):
        if fresh(a):
            out.append(ops[a])
            return len(out) - 1
        return local[a]

    for k in role:
        stack = [(results[k], False)]
        while stack:
            i, expanded = stack.pop()
            if i in local or fresh(i):
                continue
            args = _operands(ops[i])
            if expanded or not args:
                pos = {a: ref(a) for a in dict.fromkeys(args)}
                local[i] = len(out)
                out.append((ops[i][0], *(pos[a] for a in args)) if args else ops[i])
                continue
            stack.append((i, True))
            for a in sorted(set(args), key=lambda a: need[a]):  # the last pushed goes first
                stack.append((a, False))
        out.append(("fold", k, ref(results[k])))
    return out


def eval_schedule_int(sched, cur, nxt, per, t_coefs, modulus: int):
    """sum of t_coefs[k] * value over the folds of one role's schedule, on
    python ints."""
    vals, total = [], 0
    for op in sched:
        if op[0] == "fold":
            total = (total + t_coefs[op[1]] * vals[op[2]]) % modulus
            vals.append(None)
        else:
            vals.append(_value(op, vals, cur, nxt, per, modulus))
    return total


def peak_live(sched):
    """Most values of a schedule live at once (a value lives from the
    operation that makes it to its last use)."""
    last = {}
    for i, op in enumerate(sched):
        for a in (op[2:3] if op[0] == "fold" else _operands(op)):
            last[a] = i
    live = peak = 0
    for i, op in enumerate(sched):
        if op[0] != "fold" and i in last:
            live += 1
            peak = max(peak, live)
        live -= sum(1 for a in set(op[2:3] if op[0] == "fold" else _operands(op))
                    if last[a] == i)
    return peak


# field name -> (C++ field type, its header, 64-bit words per element)
_FIELD_TYPES = {"f128": ("F128", "f128.cuh", 2), "f62": ("F62", "f62.cuh", 1)}


def emit_cuda(field_name: str, air_name: str, ops, results, w: int,
              n_periodic: int, plan_groups) -> str:
    """CUDA C++ translation unit: the plan's boundary structure as constant
    tables, the body's field constants, the frame, then each role of the
    recorded transition as straight-line code in its schedule."""
    fe, header, words = _FIELD_TYPES[field_name]
    rules = design(ops, results)
    roles = rules["roles"]
    scheds = [schedule(ops, results, role) for role in roles]
    n_consts = len({op[1] for sched in scheds for op in sched if op[0] == "const"})

    def constant(v):
        word_list = (f"0x{(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF:016X}ULL" for i in range(words))
        return f"{fe}::make({', '.join(word_list)})"

    body = []
    for r, sched in enumerate(scheds):
        body.append(f"__device__ __forceinline__ FE cons_role{r}(const ConsPoint& q) {{")
        folded = False
        for i, op in enumerate(sched):
            kind = op[0]
            if kind == "fold":
                term = f"fe_mul(cons_scalar(q.bank, {op[1]}), s{op[2]})"
                body.append(f"  col = fe_add(col, {term});" if folded else f"  FE col = {term};")
                folded = True
                continue
            if kind in ("cur", "nxt", "per"):
                expr = f"cons_{kind}(q, {op[1]})"
            elif kind == "const":
                expr = constant(op[1])
            elif kind in ("add", "sub", "mul"):
                expr = f"fe_{kind}(s{op[1]}, s{op[2]})"
            elif kind == "sqr":
                expr = f"fe_sqr(s{op[1]})"
            elif kind == "neg":
                expr = f"fe_sub({fe}::zero(), s{op[1]})"
            else:
                raise ValueError(f"unknown operation {op!r}")
            body.append(f"  const FE s{i} = {expr};")
        body += ["  return col;", "}"]
    body.append("__device__ __forceinline__ FE cons_role(int role, const ConsPoint& q) {")
    body += [f"  if (role == {r}) return cons_role{r}(q);" for r in range(1, len(roles))]
    body += ["  return cons_role0(q);", "}"]

    cc_cols = [column for group in plan_groups for (_, column, _) in group]
    sizes = [len(group) for group in plan_groups]
    # the value of assertion ci: single s at bank row K + s (>= 0), or the
    # table of sequence q (-1 - q), numbered in walk order
    cc_vals, n_single, n_seq = [], 0, 0
    for group in plan_groups:
        for _, _, poly_len in group:
            if poly_len == 1:
                cc_vals.append(n_single)
                n_single += 1
            else:
                cc_vals.append(-1 - n_seq)
                n_seq += 1
    role_notes = [
        f"//   role {r}: results {' '.join(str(k) for k in role)}, "
        f"{rules['mul_per_role'][r]} mul+sqr" for r, role in enumerate(roles)]
    return "\n".join([
        f"// Constraint kernel of {air_name} over {field_name}: the transition",
        "// below was recorded from the AIR's python evaluate_transition and",
        "// written by ops/cons_kernel.py emit_cuda; the frame is",
        "// csrc/cons_frame.cuh.",
        f"// {len(roles)} role(s), {rules['repeated_mul']} mul+sqr repeated between them:",
        *role_notes,
        f"// {n_consts} field constants as literals; "
        f"__launch_bounds__(CONS_THREADS, {rules['min_blocks']})",
        "#include <cstdint>",
        "#include <cuda_runtime.h>",
        f'#include "{header}"',
        f"typedef {fe} FE;",
        f"#define CONS_W {w}",
        f"#define CONS_K {len(results)}",
        f"#define CONS_NPER {n_periodic}",
        f"#define CONS_NGROUPS {len(sizes)}",
        f"#define CONS_NCC {len(cc_cols)}",
        f"#define CONS_NSINGLE {n_single}",
        f"#define CONS_NSEQ {n_seq}",
        f"#define CONS_ROLES {len(roles)}",
        f"#define CONS_MIN_BLOCKS {rules['min_blocks']}",
        "static __device__ const int CONS_GROUP_SIZE[CONS_NGROUPS + 1] = {"
        + ", ".join(str(s) for s in sizes + [0]) + "};",
        "static __device__ const int CONS_CC_COL[CONS_NCC + 1] = {"
        + ", ".join(str(c) for c in cc_cols + [0]) + "};",
        "static __device__ const int CONS_CC_VAL[CONS_NCC + 1] = {"
        + ", ".join(str(v) for v in cc_vals + [0]) + "};",
        '#include "cons_frame.cuh"',
        "namespace {",
        *body,
        "}  // namespace",
        "",
    ])


def kernel_source(air0, w: int, n_periodic: int, K: int, plan_groups):
    """(library name, path of the emitted source) of the kernel for this
    (AIR class, field, plan groups); writes the source under the build
    directory when it is missing or differs."""
    from ..native import BUILD_DIR

    field_name = air0.field_spec().name
    if field_name not in _FIELD_TYPES:
        raise NotImplementedError(f"no constraint kernel for field {field_name}")
    air_name = type(air0).__name__
    ops, results = record_transition(air0, w, n_periodic, K)
    src = emit_cuda(field_name, air_name, ops, results, w, n_periodic, plan_groups)
    tag = hashlib.sha256(src.encode()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"cons_{air_name}_{field_name}_{tag}.cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    if not os.path.exists(path) or open(path).read() != src:
        with open(path, "w") as f:
            f.write(src)
    return f"starkcons_{air_name}_{field_name}_{tag}", path


def _lib(air0, w, n_periodic, K, plan_groups):
    """Emit, build (first use) and load the kernel library for a config."""
    key = (type(air0).__qualname__, air0.field_spec().name, w, n_periodic, K,
           tuple(tuple(g) for g in plan_groups))
    if key not in _LIBS:
        from ..native import build_cuda

        name, path = kernel_source(air0, w, n_periodic, K, plan_groups)
        lib = build_cuda(name, [path])
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.cons_eval_launch.argtypes = [p] * 11 + [i, q, q, i, i, i, p]
        lib.cons_eval_launch.restype = ctypes.c_int
        _LIBS[key] = lib
    return _LIBS[key]


def constraint_eval(B, air0, plan_groups, K, shift: int, blowup: int,
                    main_rows, periodic_tabs, div_tabs, scal, seq_tabs=()):
    """Constraint evaluation over the ce domain; see
    ``constraint_eval_plain`` for the arguments.  CPU tensors take the plain
    version.  CUDA tensors launch the emitted kernel on the current stream
    (no synchronisation) or raise."""
    global LAUNCHES
    lo = main_rows[0][0]
    if lo.device.type == "cpu":
        return constraint_eval_plain(B, air0, plan_groups, K, shift, blowup,
                                     main_rows, periodic_tabs, div_tabs, scal, seq_tabs)
    if lo.device.type != "cuda":
        raise ValueError(f"unsupported device {lo.device}")
    _check_groups(plan_groups)
    if len(main_rows) != 1:
        raise NotImplementedError("the constraint kernel takes extension degree 1")
    n, w, L = lo.shape
    k = len(main_rows[0])  # word planes per element
    ce = L // shift
    n_ccs = sum(len(g) for g in plan_groups)
    n_seq = seq_count(plan_groups)
    n_div = 1 + len(plan_groups)
    if L & (L - 1) or L % shift:
        raise ValueError(f"LDE length {L} and shift {shift} must be powers of two")
    if (tuple(scal.shape) != (n, K + 2 * n_ccs - n_seq + 1, k) or len(div_tabs) != n_div
            or len(seq_tabs) != n_seq):
        raise ValueError("scalar bank, divisor or sequence tables do not match the plan")
    # one (n_seq, n, ce) table per word plane, the sequences in walk order
    seq = tuple(
        torch.stack([t[l] for t in seq_tabs]).contiguous() if seq_tabs
        else torch.zeros((1, 1, 1), dtype=torch.int64, device=lo.device)
        for l in range(k)
    )
    if seq_tabs and tuple(seq[0].shape) != (n_seq, n, ce):
        raise ValueError(f"sequence tables must be (n, ce) = ({n}, {ce})")
    # one (n_periodic, period) table: every column tiled to the longest period
    per_len = max([t[0].shape[0] for t in periodic_tabs] + [1])
    per = tuple(
        torch.stack([t[l].repeat(per_len // t[l].shape[0]) for t in periodic_tabs])
        if periodic_tabs else torch.zeros((1, 1), dtype=torch.int64, device=lo.device)
        for l in range(k)
    )
    div = tuple(torch.stack([t[l] for t in div_tabs]) for l in range(k))
    rows = tuple(l.contiguous() for l in main_rows[0])
    scal = scal.contiguous()
    if tuple(div[0].shape) != (n_div, ce) or per_len & (per_len - 1):
        raise ValueError("divisor tables must be (ce,), periods powers of two")
    for t in (*rows, *per, *div, *seq, scal):
        if t.dtype != torch.int64 or t.device != lo.device:
            raise ValueError("constraint kernel inputs must be int64 on one device")
    lib = _lib(air0, w, len(periodic_tabs), K, plan_groups)
    out = tuple(torch.empty((ce,), dtype=torch.int64, device=lo.device)
                for _ in range(k))

    def ptrs(planes):
        # (low plane, high plane); a one-word field has no high plane
        return [l.data_ptr() for l in planes] + [None] * (2 - k)

    rc = launch(lib.cons_eval_launch, lo.device,
                *ptrs(rows), *ptrs(per), *ptrs(div), *ptrs(seq), scal.data_ptr(), *ptrs(out),
                n, L, ce, shift, blowup, per_len)
    if rc != 0:
        raise RuntimeError(
            f"constraint kernel launch failed: cudaError {rc} "
            f"(air={type(air0).__name__}, n={n}, w={w}, ce={ce})"
        )
    LAUNCHES += 1
    key = (air0.field_spec().name, type(air0).__name__, n, w, ce, n_seq)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return (out,)
