"""All-pairs Hamming distances: the CUDA kernel's wrapper and its plain twin.

``pairwise(queries, db)`` returns ``int32[Q, N]`` with ``out[q, j]`` the
Hamming distance between ``queries[q]`` and ``db[j]``, for any Q and N.

A CPU tensor takes :func:`pairwise_reference`, the plain PyTorch version.
A CUDA tensor launches ``csrc/pairwise.cu`` or raises: there is no
fallback. The kernel is built and loaded by :mod:`._build`. It has a fast
instance for 128-bit codes and a generic one for every other width.

This is the counterpart of the TPU kernel K4 ``pallas_pairwise_hamming``
(``verticut_tpu/ops/pallas/linear_scan.py``), a ±1 bf16 MXU GEMM over
``(256, 512)`` tiles that its caller pads to; the port pads nothing.
"""

from __future__ import annotations

import ctypes

import torch

from verticut_tpu_torch.codes import pairwise_hamming
from verticut_tpu_torch.kernels import _build

NAME = "pairwise"
SOURCE = _build.source(NAME)

#: kernel launches made by :func:`pairwise`, either instance (never by the
#: twin)
launches = 0

#: elements of the twin's [Q, rows, W] temporaries per corpus chunk
_TWIN_CHUNK_ELEMS = 1 << 25


def build() -> None:
    """Compile the kernel library if it is missing or older than its
    source."""
    _build.build(NAME)


def _load():
    vp = ctypes.c_void_p
    return _build.load(NAME, {"vt_pairwise": (
        vp, vp, vp, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, vp)})


def pairwise_reference(queries: torch.Tensor,
                       db: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch distance matrix: ``codes.pairwise_hamming`` over
    corpus chunks that bound its ``[Q, rows, W]`` temporaries."""
    _build.check_codes(NAME, queries, db)
    nq, w = queries.shape
    n = db.shape[0]
    out = torch.empty((nq, n), dtype=torch.int32, device=queries.device)
    rows = max(1, _TWIN_CHUNK_ELEMS // max(nq * w, 1))
    for r0 in range(0, n, rows):
        out[:, r0:r0 + rows] = pairwise_hamming(queries, db[r0:r0 + rows])
    return out


def pairwise(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Distance matrix ``int32[Q, N]``. CPU tensors take the plain twin;
    CUDA tensors launch the kernel."""
    _build.check_codes(NAME, queries, db)
    if queries.device.type == "cpu":
        return pairwise_reference(queries, db)
    _build.check_kernel_operands(NAME, queries, db)
    global launches
    lib = _load()
    nq, n = queries.shape[0], db.shape[0]
    out = torch.empty((nq, n), dtype=torch.int32, device=queries.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vt_pairwise(queries.data_ptr(), db.data_ptr(),
                              out.data_ptr(), nq, n, queries.shape[1], stream)
    _build.check_launch(lib, err, "pairwise")
    launches += 1
    return out
