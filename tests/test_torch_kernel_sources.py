"""PyTorch port, kernel CUDA sources on the CPU: csrc/ntt_tile.cu (kernel 1),
csrc/ntt_dit.cu (kernels 2 and 3), the constraint kernel (kernel 5: the
body ops/cons_kernel.py emits, in the frame csrc/cons_frame.cuh) and the
Rescue sponge (csrc/rescue_sponge.cu) compiled by
the host's C++ compiler against a stub ``cuda_runtime.h`` and run with ONE
thread per block, held against the plain PyTorch versions beside their
wrappers.

With one thread a block, every ``for (t = threadIdx.x; ...; t +=
blockDim.x)`` loop walks all of a pass's tasks in turn and the barriers are
no-ops, so what this checks is the kernels' index algebra (the register
passes, the swizzled tile, the bit reversal on the load, the options) and
their arithmetic, not their parallel behaviour, which only the card shows
(``chip_smoke.py``).  Exact arithmetic: tolerance 0."""

import ctypes
import itertools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import starkpack_winterfell_tpu_torch as T
from starkpack_winterfell_tpu_torch.models.fib_multifield import get_fib_family
from starkpack_winterfell_tpu_torch.models.lamport128 import (
    TRACE_WIDTH,
    Lamport128Air,
    Lamport128Inputs,
)
from starkpack_winterfell_tpu_torch.models.lamport128_agg import (
    Lamport128AggAir,
    LamportAggInputs,
)
from starkpack_winterfell_tpu_torch.models.merkle128 import (
    TRACE_WIDTH as MERKLE_WIDTH,
    Merkle128Air,
    Merkle128Inputs,
)
from starkpack_winterfell_tpu_torch.models.rescue128_chain import (
    Rescue128ChainAir,
    Rescue128ChainInputs,
)
from starkpack_winterfell_tpu_torch.ops import cons_kernel as tcons
from starkpack_winterfell_tpu_torch.ops import gl64 as tgl, ntt4 as tntt4, ntt_kernel as tk
from starkpack_winterfell_tpu_torch.ops import rescue_sponge as rsp
from starkpack_winterfell_tpu_torch.ops.backend import get_backend
from starkpack_winterfell_tpu_torch.parallel.full_pipeline import plan_groups

import _torch_one_thread  # noqa: F401  (one torch thread a test worker)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "starkpack_winterfell_tpu_torch", "csrc")

STUB = """
#pragma once
#include <algorithm>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
struct Dim { unsigned x = 0; };
inline Dim threadIdx, blockIdx, blockDim;
inline void __syncthreads() {}
template <class T> inline T __ldg(const T* p) { return *p; }
using std::min;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline uint64_t smem[1 << 16];
inline uint64_t sm[1 << 16];
"""

HARNESS = """
#include "cuda_runtime.h"
#include "tile_body.inc"
extern "C" void host_ntt_tile(const uint64_t* x, uint64_t* out, const uint64_t* tw,
                              const uint64_t* ep, const uint64_t* pre, int B, int n,
                              int lanes, int log_lg, int dif, int log_f, int transposed,
                              int radix_log) {
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const int groups = (lanes + (1 << log_lg) - 1) >> log_lg;
  TileArgs a{x, out, tw, ep, pre, n, log_n, lanes, log_lg, groups, log_f, transposed};
  blockDim.x = 1;
  for (int blk = 0; blk < B * groups; ++blk) {
    blockIdx.x = blk;
    std::fill(smem, smem + (1 << 16), 0xDEADBEEFDEADBEEFULL);
    if (dif) { if (radix_log == 4) ntt_tile_kernel<true, 4>(a); else ntt_tile_kernel<true, 3>(a); }
    else { if (radix_log == 4) ntt_tile_kernel<false, 4>(a); else ntt_tile_kernel<false, 3>(a); }
  }
}
"""

HARNESS_DIT = """
#include "cuda_runtime.h"
#include "dit_body.inc"
extern "C" void host_ntt_last(const uint64_t* x, uint64_t* out, const uint64_t* tw,
                              const uint64_t* pre, uint64_t scale, int has_scale,
                              long long rs, long long cs, int rows, int n, int n_in,
                              int log_rb) {
  const int log_n = log2_exact(n);
  LastArgs a{x, out, tw, pre, scale, rs, cs, has_scale, rows, n, log_n, n_in, log_rb};
  blockDim.x = 1;
  if (log_n <= 5) {
    for (int r = 0; r < rows; ++r) {
      blockIdx.x = r;
      switch (log_n) {
        case 1: ntt_last_reg_kernel<1>(a); break;
        case 2: ntt_last_reg_kernel<2>(a); break;
        case 3: ntt_last_reg_kernel<3>(a); break;
        case 4: ntt_last_reg_kernel<4>(a); break;
        default: ntt_last_reg_kernel<5>(a); break;
      }
    }
    return;
  }
  for (int blk = 0; blk < ((rows + (1 << log_rb) - 1) >> log_rb); ++blk) {
    blockIdx.x = blk;
    std::fill(smem, smem + (1 << 16), 0xDEADBEEFDEADBEEFULL);
    ntt_last_kernel(a);
  }
}
"""


def _kernels_only(source: str) -> str:
    """The source up to the end of its anonymous namespace (the kernels),
    without the launchers, whose <<<>>> a host compiler cannot read."""
    body = open(os.path.join(CSRC, source)).read()
    end = body.index("}  // namespace\n") + len("}  // namespace\n")
    body = body[:end].replace("extern __shared__ uint64_t smem[];", "")
    body = body.replace("extern __shared__ uint64_t sm[];", "")
    if "set_smem_limit" in body:  # the attribute helper takes a device function
        start = body.index("template <bool DIF, int K>\ncudaError_t set_smem_limit()")
        body = body[:start] + body[body.index("}\n", start) + 2:]
    return body


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    cxx = next((c for c in ("g++", "c++", "clang++") if shutil.which(c)), None)
    assert cxx is not None, "no host C++ compiler"
    d = tmp_path_factory.mktemp("kernels")
    (d / "cuda_runtime.h").write_text(STUB)
    (d / "tile_body.inc").write_text(_kernels_only("ntt_tile.cu"))
    (d / "dit_body.inc").write_text(_kernels_only("ntt_dit.cu"))
    libs = {}
    for name, src in (("tile", HARNESS), ("dit", HARNESS_DIT)):
        (d / f"{name}.cpp").write_text(src)
        so = d / f"lib{name}.so"
        r = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(d), "-I", CSRC,
                            "-o", str(so), str(d / f"{name}.cpp")], capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
        libs[name] = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["tile"].host_ntt_tile.argtypes = [p] * 5 + [i] * 8
    libs["dit"].host_ntt_last.argtypes = ([p] * 4 + [ctypes.c_uint64, i] + [ctypes.c_longlong] * 2
                                          + [i] * 4)
    return libs


def _rand(shape, rng):
    return tgl.from_u64(rng.integers(0, tgl.P, size=shape, dtype=np.uint64))


def _ptr(t):
    return None if t is None else t.data_ptr()


@pytest.mark.parametrize("B,rows_in,lanes,f", [
    (2, 2, 3, 1), (3, 64, 9, 1), (1, 4096, 2, 1), (2, 32, 7, 8), (1, 512, 3, 4),
])
def test_tile_kernel_source_matches_the_plain_version(host_kernels, B, rows_in, lanes, f):
    rng = np.random.default_rng(B * 1000 + rows_in)
    n = rows_in * f
    for dif, ep_on, pre_on, transposed, radix_log in itertools.product(
            (True, False), (False, True), (False, True), (False, True), (3, 4)):
        if dif and f > 1:
            continue
        x = _rand((B, rows_in, lanes), rng)
        tw = tntt4.tile_twiddles(n, dif, "cpu")
        ep = _rand((n, lanes), rng) if ep_on else None
        pre = _rand((rows_in, lanes), rng) if pre_on else None
        want = tntt4.ntt_tile_plain(x, tw, dif, ep, f, pre, transposed)
        log_lg, _, _ = tntt4._block_shape(n, rows_in, lanes, transposed)
        got = torch.zeros(want.shape, dtype=torch.int64)
        host_kernels["tile"].host_ntt_tile(
            _ptr(x), _ptr(got), _ptr(tw), _ptr(ep), _ptr(pre), B, n, lanes, log_lg,
            int(dif), f.bit_length() - 1, int(transposed), radix_log)
        assert torch.equal(got, want), (dif, ep_on, pre_on, transposed, radix_log)


@pytest.mark.parametrize("rows,n,n_in,view", [
    (5, 2, 2, "rows"), (7, 4, 4, "rows"), (9, 32, 32, "rows"), (6, 32, 4, "rows"),
    (25, 64, 8, "rows"), (33, 256, 256, "rows"), (4, 1024, 1024, "rows"), (3, 4096, 512, "rows"),
    (37, 4, 4, "columns"), (5, 128, 128, "columns"),
])
def test_last_axis_kernel_source_matches_the_plain_version(host_kernels, rows, n, n_in, view):
    """``view`` "columns": x is the transposed view of an (n_in, rows) array,
    read through its strides (the FRI fold's rows)."""
    rng = np.random.default_rng(rows * 10000 + n)
    for inverse, pre_on, scaled in itertools.product((False, True), repeat=3):
        x = _rand((rows, n_in), rng) if view == "rows" else _rand((n_in, rows), rng).T
        tw = tntt4.tile_twiddles(n, inverse, "cpu")
        pre = _rand((n_in,), rng) if pre_on else None
        scale = pow(n, tgl.P - 2, tgl.P) if scaled else None
        want = tk.ntt_last_plain(x, tw, n, pre, scale)
        log_rb, _ = tk._last_block_shape(n, rows)
        got = torch.zeros((rows, n), dtype=torch.int64)
        host_kernels["dit"].host_ntt_last(_ptr(x), _ptr(got), _ptr(tw), _ptr(pre),
                                          scale or 0, int(scaled), x.stride(0), x.stride(1),
                                          rows, n, n_in, log_rb)
        assert torch.equal(got, want), (inverse, pre_on, scaled)


HARNESS_SPONGE = """
#include "cuda_runtime.h"
#include "sponge_body.inc"
#include <cstring>
extern "C" void host_sponge_constants(int slot, const uint64_t* c) {
  std::memcpy(&kConsts[slot], c, sizeof(SpongeConsts));
}
template <class L>
static void run_rows(int mode, const SpongeArgs& a) {
  blockDim.x = 1;
  for (long long r = 0; r < a.rows; ++r) {
    blockIdx.x = (unsigned)r;
    if (mode == MODE_HASH) rescue_sponge_kernel<L, MODE_HASH>(a);
    else if (mode == MODE_MERGE) rescue_sponge_kernel<L, MODE_MERGE>(a);
    else rescue_sponge_kernel<L, MODE_SEARCH>(a);
  }
}
static void run(int slot, int mode, const SpongeArgs& a) {
  switch (slot) {
    case 0: run_rows<Rp64Layout>(mode, a); break;
    case 1: run_rows<Rp62Layout>(mode, a); break;
    case 2: run_rows<RpJiveLayout>(mode, a); break;
    default: run_rows<GriffinLayout>(mode, a); break;
  }
}
extern "C" void host_sponge(int slot, int merge, const uint64_t* x, const uint64_t* y,
                            uint64_t* out, long long xs, long long ys, long long rows,
                            int n_elems) {
  SpongeArgs a{};
  a.x = x; a.y = y; a.out = out; a.x_stride = xs; a.y_stride = ys; a.rows = rows;
  a.n_elems = n_elems;
  run(slot, merge ? MODE_MERGE : MODE_HASH, a);
}
extern "C" void host_sponge_search(int slot, const uint64_t* seed, uint64_t start,
                                   long long count, int bits, unsigned long long* found,
                                   uint64_t* digests) {
  SpongeArgs a{};
  for (int k = 0; k < 4; ++k) a.seed[k] = seed[k];
  a.start = start; a.rows = count; a.bits = bits; a.found = found; a.out = digests;
  run(slot, MODE_SEARCH, a);
}
"""

# the Montgomery f62 arithmetic of the sponge (csrc/f62_mont.cuh) on the host
HARNESS_F62M = """
#include "f62_mont.cuh"
extern "C" uint64_t host_f62m_mul(uint64_t a, uint64_t b) { return f62m::mul(a, b); }
extern "C" uint64_t host_f62m_to_mont(uint64_t x) { return f62m::to_mont(x); }
extern "C" uint64_t host_f62m_from_mont(uint64_t x) { return f62m::from_mont(x); }
extern "C" uint64_t host_f62m_row(const uint64_t* m, const uint64_t* s, int n) {
  uint64_t lo = 0, hi = 0;
  for (int j = 0; j < n; ++j) f62m::mul_acc(m[j], s[j], lo, hi);
  return f62m::redc(lo, hi);
}
"""


def _host_lib(tmp_path_factory, name, harness, body=None):
    """A harness built with the host C++ compiler against the stub
    ``cuda_runtime.h`` (``body``: the kernels of a csrc source, included as
    ``sponge_body.inc``)."""
    cxx = next((c for c in ("g++", "c++", "clang++") if shutil.which(c)), None)
    assert cxx is not None, "no host C++ compiler"
    d = tmp_path_factory.mktemp(name)
    (d / "cuda_runtime.h").write_text(STUB + SPONGE_STUB)
    if body is not None:
        (d / "sponge_body.inc").write_text(body)
    (d / f"{name}.cpp").write_text(harness)
    so = d / f"lib{name}.so"
    r = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(d), "-I", CSRC,
                        "-o", str(so), str(d / f"{name}.cpp")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(so))


SPONGE_STUB = """
#define __constant__
inline unsigned long long atomicMin(unsigned long long* a, unsigned long long v) {
  const unsigned long long old = *a;
  if (v < old) *a = v;
  return old;
}
"""


@pytest.fixture(scope="module")
def host_sponge(tmp_path_factory):
    """csrc/rescue_sponge.cu's kernels built with the host compiler, with
    the definitions ops/rescue_sponge.py builds them with (the addition
    chains), every layout's constants copied into the kernel's constant
    table at its slot."""
    lib = _host_lib(tmp_path_factory, "sponge", HARNESS_SPONGE,
                    rsp.kernel_prelude() + _kernels_only("rescue_sponge.cu"))
    p, i, ll, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64
    lib.host_sponge_constants.argtypes = [i, p]
    lib.host_sponge.argtypes = [i, i, p, p, p, ll, ll, ll, i]
    lib.host_sponge_search.argtypes = [i, p, u64, ll, i, p, p]
    for name, slot in rsp.SLOTS.items():
        lib.host_sponge_constants(slot, rsp.kernel_constants(rsp.LAYOUTS[name]).ctypes.data_as(p))
    return lib


def _edge_elements(rng, P, rows, n):
    """(rows, n) elements: random, with 0, 1 and p - 1 among them."""
    vals = rng.integers(0, P, size=(rows, n), dtype=np.uint64)
    edges = np.array([0, 1, P - 1], dtype=np.uint64)
    vals.reshape(-1)[: min(vals.size, 3 * rows)] = np.resize(edges, min(vals.size, 3 * rows))
    return vals


@pytest.mark.parametrize("name", list(rsp.LAYOUTS))
def test_sponge_kernel_source_matches_the_plain_version(host_sponge, name):
    """Row hashes of 0 ... 24 elements (rows wider than they hash, as the
    wrapper's row stride allows; elements at 0, 1 and p - 1 among random
    ones; every length from 0 to 9 for the Jive layouts) and merges of
    random words read through a Merkle level's row stride, for every
    layout; Rp62_248 merges also of digests whose four words all lie in
    [p, 2^62)."""
    layout = rsp.LAYOUTS[name]
    field = int(layout.field == "f62")
    slot = rsp.SLOTS[name]
    rng = np.random.default_rng(slot + 17)
    for n in (0, 1, 7, 8, 9, 12, 16, 23, 24) + ((2, 3, 4, 5, 6) if layout.jive else ()):
        vals = _edge_elements(rng, layout.P, 5, n + 2)
        x = tgl.from_u64(np.stack([vals & np.uint64(0xFFFFFFFF), vals >> np.uint64(32)],
                                  axis=-1).reshape(5, -1))
        want = rsp.rescue_sponge_plain(layout, x, n)
        got = torch.zeros((5, 8), dtype=torch.int64)
        host_sponge.host_sponge(slot, 0, _ptr(x), None, _ptr(got), x.stride(0), 0, 5, n)
        assert torch.equal(got, want), n
    cur = torch.from_numpy(rng.integers(0, 1 << 32, size=(10, 8)).astype(np.int64))
    if field:  # packed digests of four values in [p, 2^62)
        v = [int(a) for a in rng.integers(layout.P, 1 << 62, size=40, dtype=np.uint64)]
        packed = [sum(v[4 * r + k] << (62 * k) for k in range(4)) for r in range(10)]
        cur[5:] = torch.tensor([[(w >> (32 * j)) & 0xFFFFFFFF for j in range(8)]
                                for w in packed[5:]], dtype=torch.int64)
    left, right = cur[0::2], cur[1::2]
    want = rsp.rescue_sponge_plain(layout, left, None, right)
    got = torch.zeros((5, 8), dtype=torch.int64)
    host_sponge.host_sponge(slot, 1, _ptr(left), _ptr(right), _ptr(got), left.stride(0),
                            right.stride(0), 5, 0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", list(rsp.LAYOUTS))
def test_sponge_kernel_search_mode_matches_the_plain_version(host_sponge, name):
    """The search mode: every digest of a range of nonces and the lowest
    nonce with 4 trailing zero bits, against ``first_merge_with_int_plain``;
    a range with no such nonce leaves the found word as it was."""
    layout = rsp.LAYOUTS[name]
    field = int(layout.field == "f62")
    slot = rsp.SLOTS[name]
    rng = np.random.default_rng(slot + 29)
    top = 1 << 62 if field else layout.P  # Rp62_248 seeds: masked, not reduced
    seed = [int(v) for v in rng.integers(0, top, size=4, dtype=np.uint64)]
    for start, count, bits in ((1, 96, 4), (layout.P - 40, 40, 3), (7, 3, 12)):
        want_nonce, want = rsp.first_merge_with_int_plain(layout, seed, start, count, bits)
        found = np.array([np.iinfo(np.uint64).max], dtype=np.uint64)
        got = torch.zeros((count, 8), dtype=torch.int64)
        host_sponge.host_sponge_search(slot, np.array(seed, dtype=np.uint64).ctypes.data,
                                       start, count, bits, found.ctypes.data, _ptr(got))
        assert torch.equal(got, want), (start, count)
        assert (None if found[0] == np.iinfo(np.uint64).max else int(found[0])) == want_nonce


@pytest.fixture(scope="module")
def host_f62m(tmp_path_factory):
    lib = _host_lib(tmp_path_factory, "f62m", HARNESS_F62M)
    u64, p = ctypes.c_uint64, ctypes.c_void_p
    for fn, args in (("host_f62m_mul", [u64, u64]), ("host_f62m_to_mont", [u64]),
                     ("host_f62m_from_mont", [u64]), ("host_f62m_row", [p, p, ctypes.c_int])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = u64
    return lib


def test_f62_montgomery_reduction_matches_python_ints(host_f62m):
    """csrc/f62_mont.cuh against python ints at the edges: a multiply of
    lazy values (below 2p) stays below 2p and is a*b/R mod p; to_mont maps
    any 64-bit word (digest words in [p, 2^62) among them) to x*R mod p
    below 2p; from_mont is canonical; a row of twelve products of values
    below p, at their largest, reduces to below 4p."""
    P, R = rsp.RP62_248.P, 1 << 64
    rinv = pow(R, -1, P)
    edges = [0, 1, 2, P - 1, P, P + 1, 2 * P - 1, (1 << 62) - 1, 12345678901234567]
    for a in edges:
        for b in edges:
            got = host_f62m.host_f62m_mul(a, b)
            assert got < 2 * P and got % P == a * b * rinv % P, (a, b)
    for x in edges + [(1 << 64) - 1, 1 << 63]:
        got = host_f62m.host_f62m_to_mont(x)
        assert got < 2 * P and got % P == x * R % P, x
    for x in [0, 1, P - 1, P, P + 1, 2 * P - 1]:
        assert host_f62m.host_f62m_from_mont(x) == x * rinv % P, x
    for m, s in (([P - 1] * 12, [P - 1] * 12), ([0] * 12, [P - 1] * 12),
                 (list(range(1, 13)), [P - 1 - k for k in range(12)])):
        ma, sa = np.array(m, dtype=np.uint64), np.array(s, dtype=np.uint64)
        got = host_f62m.host_f62m_row(ma.ctypes.data, sa.ctypes.data, 12)
        assert got < 4 * P and got % P == sum(x * y for x, y in zip(m, s)) * rinv % P


HARNESS_CONS = """
extern "C" void host_cons_eval(const uint64_t* lde_lo, const uint64_t* lde_hi,
                               const uint64_t* per_lo, const uint64_t* per_hi,
                               const uint64_t* div_lo, const uint64_t* div_hi,
                               const uint64_t* seq_lo, const uint64_t* seq_hi,
                               const uint64_t* scal, uint64_t* out_lo, uint64_t* out_hi,
                               int n, long long L, long long ce, int shift, int blowup,
                               int per_len) {
  const ConsArgs a{lde_lo, lde_hi, per_lo, per_hi, div_lo, div_hi, seq_lo, seq_hi, scal,
                   out_lo, out_hi, n, L, ce, shift, blowup, per_len};
  static FE part[CONS_ROLES][CONS_PPB];
  blockDim.x = CONS_THREADS;
  for (long long b = 0; b < (ce + CONS_PPB - 1) / CONS_PPB; ++b) {
    blockIdx.x = (unsigned)b;
    std::fill((uint64_t*)part, (uint64_t*)part + sizeof(part) / 8, 0xDEADBEEFDEADBEEFULL);
    // the barrier between the passes: every thread of the block runs its
    // role, then role 0's threads meet the partials
    for (unsigned t = 0; t < CONS_THREADS; ++t) {
      threadIdx.x = t;
      cons_role_pass(a, part);
    }
    for (unsigned t = 0; t < CONS_THREADS; ++t) {
      threadIdx.x = t;
      cons_meet_pass(a, part);
    }
  }
}
"""


def _cons_air(case):
    """(AIR, field) of a constraint-kernel rehearsal: the Lamport-agg body
    with its three sequence tables (4 signatures at k = 15), the lamport128,
    Rescue128 chain and merkle128 bodies (single values), or fib-f62
    (one-word field, a body too small to split)."""
    options = T.ProofOptions(16, 8, 0, 1, 4, 31)
    if case == "merkle128":
        return Merkle128Air(T.TraceInfo(MERKLE_WIDTH, 64), Merkle128Inputs([3, 4]),
                            options), "f128"
    if case == "lamport-agg":
        pub = LamportAggInputs([9, 10, 11, 12], [[1, 2], [3, 4], [5, 6], [7, 8]])
        return Lamport128AggAir(T.TraceInfo(14, 512), pub, options), "f128"
    if case == "lamport128":
        return Lamport128Air(T.TraceInfo(TRACE_WIDTH, 128), Lamport128Inputs(1, [1, 2]),
                             options), "f128"
    if case == "rescue128":
        return Rescue128ChainAir(T.TraceInfo(6, 64), Rescue128ChainInputs([1, 2], [3, 4]),
                                 options), "f128"
    fam = get_fib_family("f62")
    return fam[0](T.TraceInfo(2, 64), fam[3](5), options), "f62"


@pytest.mark.parametrize("case", ["lamport-agg", "fib-f62", "rescue128", "lamport128",
                                  "rescue128 two roles", "merkle128"])
def test_constraint_kernel_source_matches_the_plain_version(tmp_path, monkeypatch, case):
    """The emitted body in its frame against ``constraint_eval_plain`` on
    random inputs: every thread of a block runs its role, then role 0's
    threads meet the partials (the roles the emitter chose: two for the
    Lamport+ bodies, one for Rescue128 and fib-f62); periodic columns of two
    periods tiled as the wrapper tiles them, sequence tables, n = 2.  The
    last case splits the Rescue128 body into two roles that repeat the cubes
    of the current row, the split the rules measured against one role."""
    two_roles = case.endswith("two roles")
    if two_roles:
        monkeypatch.setattr(tcons, "SPLIT_MAX_REPEAT", 1.0)
        case = case.split()[0]
    air, field = _cons_air(case)
    B = get_backend(field)
    template = air.get_boundary_constraints(None, [0] * air.context.num_assertions())
    groups = plan_groups(template)
    w, K = air.trace_info().width(), air.context.num_transition_constraints()
    periods = [len(c) for c in air.get_periodic_column_values()]
    n_seq = tcons.seq_count(groups)
    assert n_seq == (3 if case == "lamport-agg" else 0)
    ops, results = tcons.record_transition(air, w, len(periods), K)
    assert len(tcons.design(ops, results)["roles"]) == (
        2 if case.startswith("lamport") or two_roles else 1)
    _, src = tcons.kernel_source(air, w, len(periods), K, groups)

    cxx = next((c for c in ("g++", "c++", "clang++") if shutil.which(c)), None)
    (tmp_path / "cuda_runtime.h").write_text(STUB)
    (tmp_path / "cons_frame.cuh").write_text(_kernels_only("cons_frame.cuh"))
    (tmp_path / "cons.cpp").write_text(open(src).read() + HARNESS_CONS)
    so = tmp_path / "libcons.so"
    r = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(tmp_path),
                        "-I", CSRC, "-o", str(so), str(tmp_path / "cons.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    lib.host_cons_eval.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 3

    n, ce, shift, blowup = 2, 256, 2, 8
    L = ce * shift
    n_ccs = sum(len(g) for g in groups)
    rng = np.random.default_rng(7 + n_seq)

    def rand(shape):
        ints = [int.from_bytes(rng.bytes(16), "little") % B.P
                for _ in range(int(np.prod(shape)))]
        return tuple(l.reshape(shape) for l in B.b_from_ints(ints))

    rows = (rand((n, w, L)),)
    per_len = max(periods, default=1) * 2
    pers = [rand((p * 2,)) for p in periods]
    divs = [rand((ce,)) for _ in range(1 + len(groups))]
    seqs = [rand((n, ce)) for _ in range(n_seq)]
    scal = torch.stack(rand((n, K + 2 * n_ccs - n_seq + 1)), dim=-1).contiguous()
    want = tcons.constraint_eval_plain(B, air, groups, K, shift, blowup, rows, pers, divs,
                                       scal, seqs)[0]

    k = len(rows[0])
    per = [torch.stack([t[l].repeat(per_len // t[l].shape[0]) for t in pers]) if pers
           else torch.zeros(1, dtype=torch.int64) for l in range(k)]
    div = [torch.stack([t[l] for t in divs]) for l in range(k)]
    seq = [torch.stack([t[l] for t in seqs]) if seqs else torch.zeros(1, dtype=torch.int64)
           for l in range(k)]
    out = [torch.zeros(ce, dtype=torch.int64) for _ in range(k)]

    def pair(planes):
        return [_ptr(p) for p in planes] + [None] * (2 - k)

    lib.host_cons_eval(*pair(rows[0]), *pair(per), *pair(div), *pair(seq), _ptr(scal),
                       *pair(out), n, L, ce, shift, blowup, per_len)
    assert all(torch.equal(g, x) for g, x in zip(out, want))
