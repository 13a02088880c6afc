"""Build-on-first-use helpers for the port's compiled sources.

Two kinds of shared library are built into ``starkpack_winterfell_tpu_torch/
build/`` (ignored by git) and loaded through ctypes:

* host C/C++ (``native/builders.cpp``, ``native/rescue128.c``,
  ``native/rescue_perm.c``, ``native/griffin_perm.c``) with the host
  compiler — the sequential trace builders and the host sponges of the
  algebraic hashers;
* CUDA C++ (``csrc/*.cu``) with ``nvcc`` for ``sm_90a`` — the hand-written
  kernels.  Plain C interface, no PyTorch headers, so a build takes seconds.

Counterpart of starkpack_winterfell_tpu/native/__init__.py:19-41, except
that a failed build raises with the compiler's output instead of returning
None: the port has no slower tier to fall back to."""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")
_CACHE: dict = {}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# library name -> (nvcc seconds, ptxas's report: registers, spills and
# shared memory of each kernel) of the builds this process ran
BUILD_LOGS: dict = {}


def _stale(so: str, sources) -> bool:
    if not os.path.exists(so):
        return True
    t = os.path.getmtime(so)
    return any(os.path.getmtime(s) > t for s in sources)


def _run(cmd, what: str):
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    except OSError as e:
        raise RuntimeError(f"{what}: cannot run {cmd[0]}: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(
            f"{what} failed (exit {r.returncode}):\n{' '.join(cmd)}\n"
            f"{r.stdout}\n{r.stderr}"
        )
    return r


def find_nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and $CUDA_HOME/bin); the CUDA "
        "kernels cannot be built on this machine"
    )


CSRC_DIR = os.path.join(_PKG, "csrc")


def build_cuda(name: str, sources) -> ctypes.CDLL:
    """Compile CUDA sources (absolute paths) with nvcc into
    build/lib<name>.so and load the library; ``csrc/`` is on the include
    path.  Raises RuntimeError carrying nvcc's output when the build fails."""
    if name not in _CACHE:
        os.makedirs(BUILD_DIR, exist_ok=True)
        headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                   if f.endswith(".cuh")]
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        if _stale(so, list(sources) + headers):
            t0 = time.perf_counter()
            r = _run([find_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", so, *sources],
                     f"nvcc build of {name}")
            BUILD_LOGS[name] = (time.perf_counter() - t0, r.stdout + r.stderr)
        _CACHE[name] = ctypes.CDLL(so)
    return _CACHE[name]


def load_kernels(name: str, sources, init: str, signatures: dict):
    """``build_cuda`` + the library's ``init`` entry (which raises each
    kernel's dynamic shared-memory limit once, so no launch pays for it) +
    the ctypes signatures of its launchers: {function name: argtypes}, each
    returning a cudaError_t as int.  Returns {function name: ctypes
    function}, resolved once so a launch does no attribute lookup.

    The limit is a setting of the current device's context, so the port's
    kernels run on the device that is current when their library loads
    (``launch`` refuses any other)."""
    lib = build_cuda(name, sources)
    rc = getattr(lib, init)()
    if rc != 0:
        raise RuntimeError(f"{name}: {init} failed with cudaError {rc}")
    fns = {}
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[fn_name] = fn
    return fns


def _stream_of(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


# the current stream's handle of a device, without building a Stream object
# where this build of torch offers that
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", _stream_of)


def launch(fn, device, *args) -> int:
    """Calls the kernel launcher ``fn(*args, stream)`` with the current
    stream of ``device``, which must be the current CUDA device (the one
    ``load_kernels`` set the shared-memory limits on; the port runs on one
    device).  Returns the launcher's cudaError_t."""
    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise ValueError(f"the port's kernels run on the current CUDA device "
                         f"(cuda:{current}); the tensor lies on {device}")
    return fn(*args, _raw_stream(current))


def _build_host(name: str, source: str, compilers, headers=()) -> ctypes.CDLL:
    """Compile one file of native/ (including ``headers`` of native/) with
    the first host compiler found into build/lib<name>.so and load it.
    Built with -fopenmp: rescue128.c's batch digests and Lamport+ trace
    builders run one OpenMP thread a core."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, source)
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if _stale(so, [src] + [os.path.join(here, h) for h in headers]):
        cc = next((c for c in compilers if shutil.which(c)), None)
        if cc is None:
            raise RuntimeError(f"no host compiler found for {source}")
        _run([cc, "-O3", "-fopenmp", "-shared", "-fPIC", src, "-o", so],
             f"host build of {source}")
    return ctypes.CDLL(so)


def get_builders() -> ctypes.CDLL:
    """ctypes handle for the sequential trace builders (native/builders.cpp:
    rescue chain, do_work chain, fibonacci), compiled with the host C++
    compiler."""
    if "builders" not in _CACHE:
        lib = _build_host("starkbuilders", "builders.cpp",
                          ("c++", "g++", "clang++", "cc", "gcc"))
        u64 = ctypes.c_uint64
        p = ctypes.c_void_p
        lib.rescue_chain_trace.argtypes = [p, u64, p, p, p, u64, p]
        lib.rescue_chain_trace.restype = None
        lib.do_work_chain.argtypes = [u64, u64, p]
        lib.do_work_chain.restype = None
        lib.fib_trace.argtypes = [u64, p]
        lib.fib_trace.restype = None
        _CACHE["builders"] = lib
    return _CACHE["builders"]


def get_rescue128() -> ctypes.CDLL:
    """ctypes handle for the f128 Rescue128 kernels (native/rescue128.c: the
    chain-trace builder, the batched sponge digest, the Merkle-path and the
    Lamport+ trace builders), initialized with the protocol constants."""
    if "r128" not in _CACHE:
        import numpy as np

        from ..crypto import rescue128_constants as rc

        lib = _build_host("starkr128", "rescue128.c", ("cc", "gcc", "clang"))
        p, u64 = ctypes.c_void_p, ctypes.c_uint64
        for fn, argtypes in (("r128_init", [p, p, p]),
                             ("r128_chain_trace", [p, u64, p, p]),
                             ("r128_digest_batch", [p, u64, u64, p]),
                             ("r128_merkle_trace_batch", [u64, u64, p, p, p, p, p]),
                             ("lamport128_trace", [u64, p, p, p, p, p]),
                             ("lamport128_trace_batch", [u64, u64, p, p, p, p, p])):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = None

        def pairs(vals):
            flat = []
            for v in vals:
                flat.append(v & 0xFFFFFFFFFFFFFFFF)
                flat.append(v >> 64)
            return np.array(flat, dtype=np.uint64)

        consts = (pairs([v for row in rc.MDS for v in row]),
                  pairs([v for r in rc.ARK for v in r]), pairs([rc.INV_ALPHA]))
        lib.r128_init(*[c.ctypes.data_as(p) for c in consts])
        _CACHE["r128"] = lib
    return _CACHE["r128"]


_RP_SLOTS: dict = {}


def get_rescue_perm(name: str, P: int, width: int, rounds: int, alpha: int,
                    inv_alpha: int, mds, ark1, ark2, inv_chain=()):
    """(lib, slot) of a registered Rescue-Prime permutation config in
    native/rescue_perm.c (the host sponge of Rp64_256, Rp62_248 and
    RpJive64_256); each
    distinct ``name`` gets its own slot.  mds / ark1 / ark2 are nested int
    lists; ``inv_chain`` an addition chain (a, n, b) for x^inv_alpha
    (ops/rescue_sponge.py), else square-and-multiply.  Raises if the host
    compiler is missing or the build fails."""
    if "rp" not in _CACHE:
        lib = _build_host("starkrp", "rescue_perm.c", ("cc", "gcc", "clang"), ("sponge.h",))
        u64, i32, p = ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p
        for fn, argtypes in (
                ("rp_init", [i32, u64, i32, i32, u64, u64, p, p, p]),
                ("rp_permute_batch", [i32, p, u64]),
                ("rp_hash_elements_batch", [i32, p, u64, u64, i32, i32, i32, i32, i32, p]),
                ("rp_merge_batch", [i32, p, p, u64, i32, i32, i32, i32, p]),
                ("rp_round_states_batch", [i32, p, u64, p]),
                ("rp_set_inv_chain", [i32, i32, p]),
                ("rp_jive_hash_batch", [i32, p, u64, u64, i32, i32, i32, p]),
                ("rp_jive_merge_batch", [i32, p, p, u64, p])):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = None
        lib.rp_jive_search.argtypes = [i32, p, u64, u64, i32]
        lib.rp_jive_search.restype = u64
        _CACHE["rp"] = lib
    lib = _CACHE["rp"]
    if name not in _RP_SLOTS:
        import numpy as np

        slot = len(_RP_SLOTS)
        if slot >= 8:
            raise RuntimeError("rescue_perm.c holds at most 8 permutation configs")
        tables = [np.array([v for row in t for v in row], dtype=np.uint64)
                  for t in (mds, ark1, ark2)]
        lib.rp_init(slot, P, width, rounds, alpha, inv_alpha,
                    *[t.ctypes.data_as(ctypes.c_void_p) for t in tables])
        if inv_chain:
            steps = np.array([v if v is not None else -1 for step in inv_chain for v in step],
                             dtype=np.int32)
            lib.rp_set_inv_chain(slot, len(inv_chain), steps.ctypes.data_as(ctypes.c_void_p))
        _RP_SLOTS[name] = slot
    return lib, _RP_SLOTS[name]


def get_griffin_perm() -> ctypes.CDLL:
    """ctypes handle for the host Griffin permutation and Jive sponge of
    GriffinJive64_256 (native/griffin_perm.c), initialized with the
    protocol constants and x^(1/7)'s addition chain (ops/rescue_sponge.py
    INV_CHAIN_RP64).  Raises if the host compiler is missing or the build
    fails."""
    if "griffin" not in _CACHE:
        import numpy as np

        from ..crypto import griffin_constants as gc
        from ..ops.rescue_sponge import INV_CHAIN_RP64

        lib = _build_host("starkgriffin", "griffin_perm.c", ("cc", "gcc", "clang"),
                          ("sponge.h",))
        u64, i32, p = ctypes.c_uint64, ctypes.c_int, ctypes.c_void_p
        for fn, argtypes in (("gr_init", [p, p, p, p, i32, p]),
                             ("gr_permute_batch", [p, u64]),
                             ("gr_hash_batch", [p, u64, u64, p]),
                             ("gr_merge_batch", [p, p, u64, p])):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = None
        lib.gr_search.argtypes = [p, u64, u64, i32]
        lib.gr_search.restype = u64
        tables = [np.array([v for row in t for v in row], dtype=np.uint64)
                  for t in (gc.MDS_G, gc.ARK_G, [gc.ALPHA_G], [gc.BETA_G])]
        chain = np.array([-1 if v is None else v for step in INV_CHAIN_RP64 for v in step],
                         dtype=np.int32)
        lib.gr_init(*[t.ctypes.data_as(p) for t in tables], len(INV_CHAIN_RP64),
                    chain.ctypes.data_as(p))
        _CACHE["griffin"] = lib
    return _CACHE["griffin"]
