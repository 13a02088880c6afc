"""Whole-AIR constraint evaluation in one hand-written CUDA kernel.

Counterpart of starkpack_winterfell_tpu/ops/pallas/cons_kernel.py.  Per
point j of the constraint-evaluation (ce) domain and per instance i the
function computes the AIR's ``evaluate_transition`` on the frame (LDE row
j*shift, LDE row j*shift + blowup), sum_k t_coef[i][k] * ev_k, the boundary
groups sum cc * (state - value), each times its divisor table, the whole
times final_power[i], summed over the instances.

The Pallas kernel gets its body by running the AIR's python
``evaluate_transition`` inside ``pallas_call``.  Here the same python runs
ONCE on a recording Felt (``record_transition``): every add, subtract,
multiply, square, negation and integer constant becomes one SSA operation,
and ``emit_cuda`` writes them as straight-line CUDA C++ into a translation
unit whose frame (``csrc/cons_frame.cuh``, written by hand) loads the frame
rows by index, walks the instances and does everything around the
transition.  The source goes to the build directory and is compiled with
nvcc at first use, keyed by (AIR class, field, plan groups).

``constraint_eval`` is the wrapper: CPU tensors take the plain version
``constraint_eval_plain`` (the same python AIR code, eager, through
``eval_block``), CUDA tensors launch the kernel or raise.

Bound on an H100: up to a few hundred field multiplies per point and instance
against the card's INT32 rate, far above the bytes of the LDE rows read
once; the kernel keeps every intermediate in registers, so the only device
memory traffic is the inputs and the (ce,) output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os

import torch

from ..air.transition import EvaluationFrame
from ..native import launch
from .felt import Felt

THREADS = 128

# launches of the CUDA kernel made by ``constraint_eval`` (and nowhere
# else): the total, and the same split by (field, AIR class name, n, w, ce)
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
               ccs, div_vals):
    """The constraint math on same-shaped (or broadcastable) element arrays:
    returns acc comps (tuple over ext components of word-plane tuples)."""
    t_result = [None] * K
    air0.evaluate_transition(frame, pv, t_result)
    combined = None
    for k_i, ev in enumerate(t_result):
        term = B.vmul(t_coefs[k_i], ev.c)
        combined = term if combined is None else B.vadd(combined, term)

    columns = [combined]
    sv = sq = ci = 0
    cur_f = frame.current()
    for group in plan_groups:
        acc = None
        for seg, column, poly_len in group:
            assert seg == "main"
            state = cur_f[column].c
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
    order: t_coefs (K), singles, ccs, final_power (all ext degree 1)."""
    rows = [tuple(l[:, k_i] for l in t_main[0]) for k_i in range(K)]
    rows += [tuple(l[:, 0] for l in s[0]) for s in singles]
    rows += [tuple(l[:, 0] for l in c[0]) for c in ccs]
    rows.append(tuple(fp_stack[0]))
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=1).contiguous()


def _check_groups(plan_groups):
    for group in plan_groups:
        for seg, _, poly_len in group:
            if seg != "main" or poly_len != 1:
                raise NotImplementedError(
                    "the constraint kernel takes main-segment single-value "
                    f"assertions only, got ({seg}, poly_len={poly_len})"
                )


def constraint_eval_plain(B, air0, plan_groups, K, shift: int, blowup: int,
                          main_rows, periodic_tabs, div_tabs, scal):
    """Plain PyTorch version of the kernel.

    main_rows: comps (n, w, L) LDE rows; periodic_tabs: list of components
    (period_p,) over one period of the ce domain; div_tabs: list of
    components (ce,), the transition divisor first; scal: the
    ``pack_scalar_bank`` tensor.  Returns comps (ce,)."""
    _check_groups(plan_groups)
    n, w, L = main_rows[0][0].shape
    ce = L // shift
    n_ccs = sum(len(g) for g in plan_groups)

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
    singles = [scal_comps(K + r) for r in range(n_ccs)]
    ccs = [scal_comps(K + n_ccs + r) for r in range(n_ccs)]
    fp = scal_comps(K + 2 * n_ccs)
    acc = eval_block(B, air0, plan_groups, K, EvaluationFrame(cur_f, nxt_f), pv,
                     t_coefs, singles, [], ccs, [(d,) for d in div_tabs])
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


def eval_ops_int(ops, results, cur, nxt, per, modulus: int):
    """Evaluate a recorded operation list on python ints."""
    vals = []
    for op in ops:
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
        vals.append(v % modulus)
    return [vals[r] for r in results]


def count_ops(ops):
    """{"mul": .., "sqr": .., "add": .., "sub": .., "neg": ..} of a list."""
    counts = {k: 0 for k in ("mul", "sqr", "add", "sub", "neg")}
    for op in ops:
        if op[0] in counts:
            counts[op[0]] += 1
    return counts


# field name -> (C++ field type, its header, 64-bit words per element)
_FIELD_TYPES = {"f128": ("F128", "f128.cuh", 2), "f62": ("F62", "f62.cuh", 1)}


def emit_cuda(field_name: str, air_name: str, ops, results, w: int,
              n_periodic: int, plan_groups) -> str:
    """CUDA C++ translation unit: the recorded transition as straight-line
    code, the plan's boundary structure as constant tables, then the frame."""
    fe, header, words = _FIELD_TYPES[field_name]

    def literal(v):
        parts = ", ".join(f"0x{(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF:016X}ULL"
                          for i in range(words))
        return f"{fe}::make({parts})"

    body = []
    for i, op in enumerate(ops):
        kind = op[0]
        if kind in ("cur", "nxt", "per"):
            expr = f"{kind}[{op[1]}]"
        elif kind == "const":
            expr = literal(op[1])
        elif kind in ("add", "sub", "mul"):
            expr = f"fe_{kind}(t{op[1]}, t{op[2]})"
        elif kind == "sqr":
            expr = f"fe_sqr(t{op[1]})"
        elif kind == "neg":
            expr = f"fe_sub({fe}::zero(), t{op[1]})"
        else:
            raise ValueError(f"unknown operation {op!r}")
        body.append(f"  const FE t{i} = {expr};")
    for k, r in enumerate(results):
        body.append(f"  ev[{k}] = t{r};")
    cc_cols = [column for group in plan_groups for (_, column, _) in group]
    sizes = [len(group) for group in plan_groups]
    return "\n".join([
        f"// Constraint kernel of {air_name} over {field_name}: the transition",
        "// below was recorded from the AIR's python evaluate_transition and",
        "// written by ops/cons_kernel.py emit_cuda; the frame is",
        "// csrc/cons_frame.cuh.",
        "#include <cstdint>",
        "#include <cuda_runtime.h>",
        f'#include "{header}"',
        f"typedef {fe} FE;",
        f"#define CONS_W {w}",
        f"#define CONS_K {len(results)}",
        f"#define CONS_NPER {n_periodic}",
        f"#define CONS_NGROUPS {len(sizes)}",
        f"#define CONS_NCC {len(cc_cols)}",
        "static __device__ const int CONS_GROUP_SIZE[CONS_NGROUPS + 1] = {"
        + ", ".join(str(s) for s in sizes + [0]) + "};",
        "static __device__ const int CONS_CC_COL[CONS_NCC + 1] = {"
        + ", ".join(str(c) for c in cc_cols + [0]) + "};",
        "__device__ __forceinline__ void air_transition(",
        "    const FE* cur, const FE* nxt, const FE* per, FE* ev) {",
        *body,
        "}",
        '#include "cons_frame.cuh"',
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
        lib.cons_eval_launch.argtypes = [p] * 9 + [i, q, q, i, i, i, i, p]
        lib.cons_eval_launch.restype = ctypes.c_int
        _LIBS[key] = lib
    return _LIBS[key]


def constraint_eval(B, air0, plan_groups, K, shift: int, blowup: int,
                    main_rows, periodic_tabs, div_tabs, scal):
    """Constraint evaluation over the ce domain; see
    ``constraint_eval_plain`` for the arguments.  CPU tensors take the plain
    version.  CUDA tensors launch the emitted kernel on the current stream
    (no synchronisation) or raise."""
    global LAUNCHES
    lo = main_rows[0][0]
    if lo.device.type == "cpu":
        return constraint_eval_plain(B, air0, plan_groups, K, shift, blowup,
                                     main_rows, periodic_tabs, div_tabs, scal)
    if lo.device.type != "cuda":
        raise ValueError(f"unsupported device {lo.device}")
    _check_groups(plan_groups)
    if len(main_rows) != 1:
        raise NotImplementedError("the constraint kernel takes extension degree 1")
    n, w, L = lo.shape
    k = len(main_rows[0])  # word planes per element
    ce = L // shift
    n_ccs = sum(len(g) for g in plan_groups)
    n_div = 1 + len(plan_groups)
    if L & (L - 1) or L % shift:
        raise ValueError(f"LDE length {L} and shift {shift} must be powers of two")
    if tuple(scal.shape) != (n, K + 2 * n_ccs + 1, k) or len(div_tabs) != n_div:
        raise ValueError("scalar bank or divisor tables do not match the plan")
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
    for t in (*rows, *per, *div, scal):
        if t.dtype != torch.int64 or t.device != lo.device:
            raise ValueError("constraint kernel inputs must be int64 on one device")
    lib = _lib(air0, w, len(periodic_tabs), K, plan_groups)
    out = tuple(torch.empty((ce,), dtype=torch.int64, device=lo.device)
                for _ in range(k))

    def ptrs(planes):
        # (low plane, high plane); a one-word field has no high plane
        return [l.data_ptr() for l in planes] + [None] * (2 - k)

    rc = launch(lib.cons_eval_launch, lo.device,
                *ptrs(rows), *ptrs(per), *ptrs(div), scal.data_ptr(), *ptrs(out),
                n, L, ce, shift, blowup, per_len, THREADS)
    if rc != 0:
        raise RuntimeError(
            f"constraint kernel launch failed: cudaError {rc} "
            f"(air={type(air0).__name__}, n={n}, w={w}, ce={ce})"
        )
    LAUNCHES += 1
    key = (air0.field_spec().name, type(air0).__name__, n, w, ce)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1
    return (out,)
