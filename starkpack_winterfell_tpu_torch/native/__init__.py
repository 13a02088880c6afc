"""Build-on-first-use helpers for the port's compiled sources.

Two kinds of shared library are built into ``starkpack_winterfell_tpu_torch/
build/`` (ignored by git) and loaded through ctypes:

* host C++ (``native/builders.cpp``) with the host compiler — the sequential
  trace builder;
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

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")
_CACHE: dict = {}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


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


def build_cuda(name: str, sources) -> ctypes.CDLL:
    """Compile CUDA sources (absolute paths) with nvcc into
    build/lib<name>.so and load the library.  Raises RuntimeError carrying
    nvcc's output when the build fails."""
    if name not in _CACHE:
        os.makedirs(BUILD_DIR, exist_ok=True)
        headers = [
            os.path.join(os.path.dirname(sources[0]), f)
            for f in os.listdir(os.path.dirname(sources[0]))
            if f.endswith(".cuh")
        ]
        so = os.path.join(BUILD_DIR, f"lib{name}.so")
        if _stale(so, list(sources) + headers):
            _run([find_nvcc(), *NVCC_FLAGS, "-o", so, *sources],
                 f"nvcc build of {name}")
        _CACHE[name] = ctypes.CDLL(so)
    return _CACHE[name]


def get_builders() -> ctypes.CDLL:
    """ctypes handle for the sequential rescue-chain trace builder
    (native/builders.cpp), compiled with the host C++ compiler."""
    if "builders" not in _CACHE:
        os.makedirs(BUILD_DIR, exist_ok=True)
        src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "builders.cpp")
        so = os.path.join(BUILD_DIR, "libstarkbuilders.so")
        if _stale(so, [src]):
            cxx = next((c for c in ("c++", "g++", "clang++", "cc", "gcc")
                        if shutil.which(c)), None)
            if cxx is None:
                raise RuntimeError("no host C++ compiler found for builders.cpp")
            _run([cxx, "-O3", "-shared", "-fPIC", src, "-o", so],
                 "host build of builders.cpp")
        lib = ctypes.CDLL(so)
        u64 = ctypes.c_uint64
        p = ctypes.c_void_p
        lib.rescue_chain_trace.argtypes = [p, u64, p, p, p, u64, p]
        lib.rescue_chain_trace.restype = None
        _CACHE["builders"] = lib
    return _CACHE["builders"]
