"""Block-min Hamming scan: the CUDA kernel's wrapper and its plain twin.

``blockmin(queries, db, n, block)`` returns ``int32[Q, ceil(N / block)]``:
the minimum Hamming distance from each query to the rows of each
``block``-row block of ``db``, counting only rows ``< n``; a block with no
such row reports ``bits + 1``.

A CPU tensor takes :func:`blockmin_reference`, the plain PyTorch version.
A CUDA tensor launches ``csrc/blockmin.cu`` or raises: there is no
fallback. The kernel is compiled with ``nvcc`` for ``sm_90a`` into
``verticut_tpu_torch/_build/`` at first use (again when the source is
newer than the library) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Optional

import torch

from verticut_tpu_torch.codes import pairwise_hamming

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "blockmin.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libvt_blockmin.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: block sizes the kernel is instantiated for
KERNEL_BLOCKS = (128, 512)
KERNEL_WORDS = 4

#: kernel launches made by :func:`blockmin` (never by the twin)
launches = 0
#: compiler output of the last build in this process ("" if none)
build_log = ""

_lib: Optional[ctypes.CDLL] = None
#: elements of the twin's [Q, rows, W] temporaries per corpus chunk
_TWIN_CHUNK_ELEMS = 1 << 25


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the blockmin kernel "
                       "cannot be built")


def build() -> None:
    """Compile the kernel library if it is missing or older than its
    source."""
    global build_log
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)):
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, LIB_PATH)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        vp = ctypes.c_void_p
        lib.vt_blockmin.argtypes = [vp, vp, vp, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_longlong,
                                    ctypes.c_int, vp]
        lib.vt_blockmin.restype = ctypes.c_int
        lib.vt_error_string.argtypes = [ctypes.c_int]
        lib.vt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(queries: torch.Tensor, db: torch.Tensor, n: int, block: int):
    if queries.dtype != torch.int32 or db.dtype != torch.int32:
        raise TypeError(f"blockmin takes int32 codes, got {queries.dtype}, "
                        f"{db.dtype}")
    if queries.ndim != 2 or db.ndim != 2 or queries.shape[1] != db.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} x {tuple(db.shape)}"
                         " are not [Q, W] x [N, W]")
    if not 0 <= n <= db.shape[0]:
        raise ValueError(f"n={n} outside [0, {db.shape[0]}]")
    if block <= 0:
        raise ValueError(f"block={block}")
    if queries.device != db.device:
        raise ValueError(f"queries on {queries.device}, db on {db.device}")


def blockmin_reference(queries: torch.Tensor, db: torch.Tensor, n: int,
                       block: int) -> torch.Tensor:
    """Plain PyTorch block-min: chunked SWAR distance matrices, then the
    minimum per block; rows >= n and empty blocks count as ``bits + 1``."""
    _check(queries, db, n, block)
    nq, w = queries.shape
    n_rows = db.shape[0]
    bits = 32 * w
    nb = -(-n_rows // block)
    out = torch.empty((nq, nb), dtype=torch.int32, device=queries.device)
    if nq == 0 or nb == 0:
        return out
    rows = max(block, (_TWIN_CHUNK_ELEMS // max(nq * w, 1)) // block * block)
    for r0 in range(0, nb * block, rows):
        r1 = min(r0 + rows, nb * block)
        d = torch.full((nq, r1 - r0), bits + 1, dtype=torch.int32,
                       device=queries.device)
        hi = min(r1, n)
        if hi > r0:
            d[:, :hi - r0] = pairwise_hamming(queries, db[r0:hi])
        out[:, r0 // block:r1 // block] = d.reshape(
            nq, (r1 - r0) // block, block).amin(dim=-1)
    return out


def blockmin(queries: torch.Tensor, db: torch.Tensor, n: int,
             block: int) -> torch.Tensor:
    """Per-block minimum distances ``int32[Q, ceil(N / block)]``. CPU
    tensors take the plain twin; CUDA tensors launch the kernel."""
    _check(queries, db, n, block)
    if queries.device.type == "cpu":
        return blockmin_reference(queries, db, n, block)
    if queries.device.type != "cuda":
        raise ValueError(f"blockmin has no kernel for {queries.device}")
    if queries.shape[1] != KERNEL_WORDS:
        raise ValueError(f"the kernel takes {32 * KERNEL_WORDS}-bit codes, "
                         f"got {32 * queries.shape[1]}-bit")
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"block={block} not in {KERNEL_BLOCKS}")
    if not (queries.is_contiguous() and db.is_contiguous()):
        raise ValueError("blockmin takes contiguous tensors")
    global launches
    lib = _load()
    nq = queries.shape[0]
    out = torch.empty((nq, -(-db.shape[0] // block)), dtype=torch.int32,
                      device=queries.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vt_blockmin(queries.data_ptr(), db.data_ptr(),
                              out.data_ptr(), nq, n, db.shape[0], block,
                              stream)
    if err:
        raise RuntimeError("blockmin kernel launch failed: "
                           + lib.vt_error_string(err).decode())
    launches += 1
    return out
