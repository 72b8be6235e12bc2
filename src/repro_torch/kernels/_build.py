"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (``<name>_launch``), loaded with ``ctypes``. The
libraries are built at first use, from the sources in this checkout, into
``kernels/_build/`` (listed in ``.gitignore``); a library's file name
carries a digest of its source, of every shared header ``csrc/*.cuh`` and
of the flags, so an edited source or header rebuilds.
``build_all`` starts one ``nvcc`` per source at once.

Nothing here runs at import: CPU-only installs import every module, and a
build is needed only once a CUDA tensor reaches a wrapper.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v"]
KERNELS = ("qboundary", "qgemm", "qtopk", "qcoarse", "qhnsw")

_LIBS: Dict[str, ctypes.CDLL] = {}
PTXAS_LOG: Dict[str, str] = {}

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "qboundary": [_P, _P, _I64, _I64, _P, _P],
    "qgemm": [_P, _P, _P, _I64, _I64, _I64, _I32, _P],
    "qtopk": [_P, _P, _I64, _I64, _I64, _I64, _I64, _I32, _P, _P, _I64, _I64,
              _I32, _I32, _P],
    "qcoarse": [_P, _P, _P, _P, _I64, _I64, _I64, _P],
    "qhnsw": [_P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def lib_path(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.name.encode() + header.read_bytes()
    tag = hashlib.sha256(src + " ".join(ARCH_FLAGS + FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns seconds per compiled kernel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists() or name in _LIBS:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, *FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {}
    for name, (proc, _, _, t0) in procs.items():  # wait for every nvcc
        PTXAS_LOG[name] = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0
    for name, (proc, tmp, out, _) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{PTXAS_LOG[name]}")
        tmp.replace(out)
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The kernel's loaded library, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def launcher(name: str):
    """The ``<name>_launch`` C function, building the library on first use."""
    return getattr(library(name), f"{name}_launch")


def helper(name: str, fn_name: str, argtypes, restype=ctypes.c_int):
    """Another exported C function of a kernel's library (a path or a
    scratch size), typed."""
    fn = getattr(library(name), fn_name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def check(name: str, err: int) -> None:
    """Raise on a refused or failed launch (the C side returns
    ``cudaGetLastError()``)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
