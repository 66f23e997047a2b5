"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so`` with a plain C interface
(no PyTorch headers, so a build takes seconds, not minutes). The libraries
go into ``_build/<hash>/`` beside this file, where the hash covers every
source and the compiler flags, so an edited source never loads a stale
library. Builds run at first use, all sources at once (one ``nvcc`` each),
and never when a module is imported: the CPU tests import every module on
machines that have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel sources by name (``csrc/<name>.cu``).
SOURCES = ("gram", "kmvp")

_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas register/shared-memory report of the last build, by source name.
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME/bin): "
                       "the CUDA kernels are compiled on the GPU machine")


def build_dir() -> Path:
    """``_build/<hash of sources and flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile every source whose library is missing, in parallel; return the
    build directory. Raises with nvcc's output if a compile fails."""
    out_dir = build_dir()
    todo = [s for s in SOURCES if not (out_dir / f"lib{s}.so").exists()]
    if not todo:
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(dir=out_dir, prefix=f".lib{name}-",
                                   suffix=".so")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")   # atomic publish
    if failed:
        raise RuntimeError("\n".join(failed))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, building it on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build() / f"lib{name}.so"))
        _declare(name, lib)
        _libs[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """argtypes/restype of each exported function: every pointer and the
    stream as c_void_p, or ctypes would pass them as 32-bit ints."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "gram":
        lib.gram_launch.argtypes = [p, p, p, i, i, i, i, f, p]
        lib.gram_launch.restype = i
    elif name == "kmvp":
        lib.kmvp_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, f, p]
        lib.kmvp_fwd_launch.restype = i
        lib.kmvp_fwd_spans.argtypes = [i]
        lib.kmvp_fwd_spans.restype = i
        lib.kmvp_fwd_max_k.argtypes = []
        lib.kmvp_fwd_max_k.restype = i
    else:
        raise KeyError(f"unknown kernel source {name!r}; known: {SOURCES}")
