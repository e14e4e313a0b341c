"""Build and load the port's native libraries, and check the kernels'
operands.

Each ``verticut_tpu_torch/csrc/<name>.cu`` is a plain-C-interface source
that ``nvcc`` compiles for ``sm_90a`` into its own shared library,
``verticut_tpu_torch/_build/libvt_<name>.so``, at first use and again when
the source, or a ``csrc`` header it includes, is newer than the library;
each ``csrc/<name>.cc`` (host code: the hash directory's builder, the
key-value store) is compiled the same way by the host C++ compiler. The
library is loaded with ctypes. A failed build raises: no caller falls back
to a plain twin.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

#: compiler output of each build made in this process, by kernel name
build_logs: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
# one lock per library: threads of one process (dispatch workers) share a
# pid and so a temporary file; different libraries still build in parallel
_locks: Dict[str, threading.RLock] = {}
_locks_guard = threading.Lock()


def _lock(name: str) -> threading.RLock:
    with _locks_guard:
        return _locks.setdefault(name, threading.RLock())


def source(name: str) -> str:
    """``csrc/<name>.cu`` (a CUDA kernel) or else ``csrc/<name>.cc`` (host
    code)."""
    cu = os.path.join(CSRC, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC, f"{name}.cc")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libvt_{name}.so")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built")


def _host_cxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found; the host libraries cannot be "
                           "built")
    return cxx


def dependencies(src: str) -> List[str]:
    """``src`` and every header of its directory that it includes with
    ``#include "..."``, directly or through another such header."""
    out, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in out:
            continue
        out.append(path)
        with open(path) as f:
            for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(),
                                  re.M):
                dep = os.path.join(os.path.dirname(src), inc)
                if os.path.exists(dep):
                    todo.append(dep)
    return out


def build(name: str) -> None:
    """Compile ``csrc/<name>.cu`` with nvcc, or ``csrc/<name>.cc`` with the
    host compiler, if its library is missing or older than the source or a
    header the source includes."""
    with _lock(name):
        src, lib = source(name), lib_path(name)
        if os.path.exists(lib) and os.path.getmtime(lib) >= max(
                os.path.getmtime(p) for p in dependencies(src)):
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = ([_nvcc(), *NVCC_FLAGS] if src.endswith(".cu")
               else [_host_cxx(), *HOST_FLAGS]) + ["-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_logs[name] = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cmd[0])} failed ({proc.returncode}):\n"
                f"{build_logs[name]}")
        os.replace(tmp, lib)


def load(name: str, entries: Dict[str, Sequence],
         restypes: Optional[Dict[str, object]] = None) -> ctypes.CDLL:
    """The library, built if needed and loaded once per process.
    ``entries`` maps each entry function to its ctypes argument types and
    ``restypes`` an entry to its return type (``None`` for ``void``); an
    entry not in ``restypes`` returns an int (a CUDA library's, a
    ``cudaError_t``). Every CUDA library exports ``const char*
    vt_error_string(int)``."""
    restypes = restypes or {}
    with _lock(name):
        if name not in _libs:
            build(name)
            lib = ctypes.CDLL(lib_path(name))
            for fn, argtypes in entries.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restypes.get(fn, ctypes.c_int)
            if source(name).endswith(".cu"):
                lib.vt_error_string.argtypes = [ctypes.c_int]
                lib.vt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.vt_error_string(err).decode())


def check_codes(name: str, queries: torch.Tensor, db: torch.Tensor) -> None:
    """Operands of a kernel and of its twin: int32 codes ``[Q, W]`` and
    ``[N, W]`` on one device."""
    if queries.dtype != torch.int32 or db.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 codes, got {queries.dtype}, "
                        f"{db.dtype}")
    if queries.ndim != 2 or db.ndim != 2 or queries.shape[1] != db.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} x {tuple(db.shape)}"
                         " are not [Q, W] x [N, W]")
    if queries.device != db.device:
        raise ValueError(f"queries on {queries.device}, db on {db.device}")


def check_kernel_operands(name: str, queries: torch.Tensor,
                          db: torch.Tensor) -> None:
    """What the kernels take beyond :func:`check_codes`: CUDA tensors with
    contiguous rows. Every code width and block has a kernel instance."""
    if queries.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for {queries.device}")
    if not (queries.is_contiguous() and db.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
